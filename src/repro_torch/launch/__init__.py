"""Entry points of the port: the LM half's step builders and serving command,
and ``kernel_ab``, which times the graph kernels of two checkouts in turns."""

"""Entry points of the port: the LM half's step builders, training and
serving commands and dry run; the sharding policy of batches and decode
caches on a mesh (``shardings.py``; the mesh itself and its collectives are
:mod:`repro_torch.parallel`'s); and ``kernel_ab``, which times the graph
kernels of two checkouts in turns."""

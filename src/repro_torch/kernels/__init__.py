"""Hand-written CUDA kernels of the port, one family per directory.

Each family keeps three modules: ``ref.py`` (the plain PyTorch version),
``kernel.py`` (the launch wrapper of the CUDA kernel in ``csrc/``, with its
launch counter) and ``ops.py`` (dispatch by the tensors' device).
"""

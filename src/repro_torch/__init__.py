"""repro_torch — the wait-free graph of ``repro``, ported to PyTorch and
hand-written CUDA kernels for an NVIDIA H100.

It imports ``torch`` and never ``jax`` nor anything of ``repro``; ``repro``
stays the reference every result is held against (bit-identical, since all
graph state is int32/bool).
"""

"""Public entry point for forward attention.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain chunked version (``ref.mha_chunked``).
``impl="reference"`` forces the plain version on any device (the comparison
in ``chip_smoke.py`` uses it).  Positions count from 0 for q and k alike on
both routes, as in the TPU kernel and ``mha_reference``.  ``block_q`` and
``block_k`` size the plain version's chunks; the kernel's tiles are fixed.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, sm_scale: float | None = None,
              impl: str | None = None, block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    if impl == "reference" or (impl is None and not q.is_cuda):
        return _ref.mha_chunked(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                                block_q=block_q, block_k=block_k, q_offset=0)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return _kernel.flash_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)

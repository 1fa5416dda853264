"""Public entry point for the SSD / gated linear-attention scan.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain chunked version (``ref.linear_scan_chunked``).
``impl="reference"`` forces the plain version on any device (the
comparison in ``chip_smoke.py`` uses it).  The plain version computes the
per-channel formula whatever ``scalar_decay`` says, as the reference's
chunked version does; the kernel with ``scalar_decay`` reads the decay of
channel 0 only, which is exact where w is one value per (b, h, t) broadcast
over K (Mamba-2).  With ``scalar_decay`` w may also be that one value, as
(B, H, S, 1): the kernel then reads only it, and the plain version
broadcasts it over K.

With ``h0=None`` and ``return_state=False`` this is the function of
``repro.kernels.ssd_scan.kernel.ssd_scan``.  ``h0`` (f32 (B, H, K, V)) is
the state to start from, and ``return_state`` also returns the f32 final
state, as ``linear_scan_chunked`` does for the reference's blocks.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, *,
             chunk: int = 64, scalar_decay: bool = False, strict: bool = False,
             h0: torch.Tensor | None = None, return_state: bool = False,
             impl: str | None = None):
    """Returns y (B, H, S, V), or (y, final state) with ``return_state``."""
    if impl == "reference" or (impl is None and not q.is_cuda):
        if scalar_decay:
            w = w.expand_as(q)
        y, hT = _ref.linear_scan_chunked(q, k, v, w, h0=h0, chunk=chunk, strict=strict)
        return (y, hT) if return_state else y
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return _kernel.ssd_scan(q, k, v, w, chunk=chunk, scalar_decay=scalar_decay,
                            strict=strict, h0=h0, return_state=return_state)

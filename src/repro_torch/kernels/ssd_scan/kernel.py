"""Launch wrapper for the CUDA SSD / gated linear-attention scan
(``csrc/ssd_scan.cu``).

Replaces the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::ssd_scan``.
The note on what bounds it and how it is laid out is in the CUDA source.
"""

from __future__ import annotations

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_KV = 128
_MAX_CHUNK = 64
_INT_MAX = 2**31 - 1


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, *,
             chunk: int = 64, scalar_decay: bool = False, strict: bool = False,
             h0: torch.Tensor | None = None, return_state: bool = False):
    """The scan over contiguous CUDA tensors q, k, w (B, H, S, K) and v
    (B, H, S, V) of one dtype, f32 or bf16; y (B, H, S, V) in that dtype.
    With ``scalar_decay`` w may be (B, H, S, 1), and only its column 0 is
    read.
    ``h0`` is an optional f32 (B, H, K, V) initial state; with
    ``return_state`` the f32 final state comes back too, as (y, hT)."""
    _build.require_cuda("ssd_scan", q, k, v, w, *(() if h0 is None else (h0,)))
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, w)):
        raise TypeError("ssd_scan: q, k, v, w must share one dtype, float32 or bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3] \
            or (w.shape != q.shape and not (scalar_decay and w.shape == (*q.shape[:3], 1))):
        raise ValueError("ssd_scan: q, k, w (B, H, S, K) and v (B, H, S, V); w may be "
                         "(B, H, S, 1) with scalar_decay")
    B, H, S, K = q.shape
    V = v.shape[3]
    if not (1 <= K <= _MAX_KV and 1 <= V <= _MAX_KV):
        raise ValueError(f"ssd_scan: K {K} and V {V} must lie in 1..{_MAX_KV}")
    if not 1 <= chunk <= _MAX_CHUNK or S < 1 or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must lie in 1..{_MAX_CHUNK} and divide S {S}")
    if min(B, H) < 1 or B * H > _INT_MAX or B * H * S * max(K, V) > 2**62:
        raise ValueError(f"ssd_scan: shape {tuple(q.shape)} out of range")
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (B, H, K, V)):
        raise ValueError("ssd_scan: h0 must be float32 (B, H, K, V)")
    y = torch.empty_like(v)
    hT = torch.empty(B, H, K, V, dtype=torch.float32, device=q.device) if return_state else None
    code = _build.library().rt_ssd_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), y.data_ptr(),
        None if h0 is None else h0.data_ptr(), None if hT is None else hT.data_ptr(),
        B * H, S, K, V, chunk, w.shape[3], int(strict), int(scalar_decay), _DTYPES[q.dtype],
        _build.stream_ptr(q),
    )
    _build.check(code, "rt_ssd_scan")
    ssd_scan.launches += 1
    return (y, hT) if return_state else y


ssd_scan.launches = 0

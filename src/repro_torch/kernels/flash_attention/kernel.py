"""Launch wrapper for the CUDA flash attention (``csrc/flash_attention.cu``).

Replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``.  bf16 runs on
Hopper's own machinery (TMA loads into a ring of shared-memory stages, a
producer warpgroup and two consumer warpgroups, ``wgmma`` for both
products); f32 on the FMA lanes.  The note on what bounds it and how it is
laid out is in the CUDA source.
"""

from __future__ import annotations

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128
_INT_MAX = 2**31 - 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Attention over contiguous CUDA tensors q (B, Hq, Sq, D), k and v
    (B, Hkv, Sk, D) of one dtype, f32 or bf16; out has q's shape and dtype.
    k positions count from 0, q positions from ``q_offset`` (a rank's block
    of q rows in the sequence-parallel layout attends over every key with
    its rows' absolute positions); a causal call needs
    ``q_offset + Sq <= Sk`` unless ``q_offset`` is 0."""
    _build.require_cuda("flash_attention", q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype, float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D)")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % max(Hkv, 1):
        raise ValueError("flash_attention: batch and head dim must match, Hq % Hkv == 0")
    if D % 8 or not 0 < D <= _MAX_D:
        raise ValueError(f"flash_attention: head dim {D} must be a multiple of 8, at most {_MAX_D}")
    if min(B, Hq, Hkv, Sq, Sk) < 1 or max(Hq, B) > 65535 or max(Sq, Sk) > _INT_MAX // D:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / {tuple(k.shape)} out of range")
    q_offset = int(q_offset)
    if q_offset < 0 or q_offset + Sq > _INT_MAX // D or (causal and q_offset and q_offset + Sq > Sk):
        raise ValueError(f"flash_attention: q_offset {q_offset} with Sq {Sq} and Sk {Sk} "
                         f"(causal: q_offset + Sq <= Sk)")
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: tensors must start on a 16-byte boundary")
    if sm_scale is None:
        sm_scale = D ** -0.5
    code = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
        float(sm_scale), int(causal), int(window is not None), int(window or 0), q_offset,
        _DTYPES[q.dtype], _build.stream_ptr(q),
    )
    _build.check(code, "rt_flash_attention")
    flash_attention.launches += 1
    flash_attention.calls += 1
    flash_attention.launches_at_offset += bool(q_offset)
    return out


flash_attention.launches = 0
flash_attention.calls = 0
flash_attention.launches_at_offset = 0  # of the launches, those with q_offset != 0

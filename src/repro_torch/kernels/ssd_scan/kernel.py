"""Launch wrapper for the CUDA SSD / gated linear-attention scan
(``csrc/ssd_scan.cu``).

Replaces the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::ssd_scan``.
A call is three launches (chunk states, the state pass, chunk outputs) over
an f32 scratch of the chunks' states that the wrapper allocates; the note on
what bounds it and how it is laid out is in the CUDA source.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_KV = 128
_MAX_CHUNK = 64
_INT_MAX = 2**31 - 1


PASSES = ("chunk states", "state pass", "chunk outputs")  # one launch each, a call


def prepare(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, *,
            chunk: int = 64, scalar_decay: bool = False, strict: bool = False,
            h0: torch.Tensor | None = None, return_state: bool = False):
    """Checks the inputs of :func:`ssd_scan` and allocates its outputs and
    scratch: (y, hT or None, scratch, launches), where ``launches`` holds one callable
    a pass, in the order of ``PASSES``, each one CUDA launch on the current
    stream; running them in order is the scan."""
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
    n_chunks = S // chunk
    if B * H * n_chunks > _INT_MAX:
        raise ValueError(f"ssd_scan: {B * H * n_chunks} chunks out of range")
    y = torch.empty_like(v)
    hT = torch.empty(B, H, K, V, dtype=torch.float32, device=q.device) if return_state else None
    # each chunk's f32 K x V state, then its decays e^{L_C} (one a chunk when scalar)
    scratch = torch.empty(B * H * n_chunks * (K * V + (1 if scalar_decay else K)),
                          dtype=torch.float32, device=q.device)
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if h0 is None else h0.data_ptr(), None if hT is None else hT.data_ptr(),
            scratch.data_ptr(), B * H, S, K, V, chunk, w.shape[3], int(strict),
            int(scalar_decay), _DTYPES[q.dtype])

    keep = (q, k, v, w, h0, scratch)  # alive as long as the launches are

    def launch(pass_no: int):
        _build.check(lib.rt_ssd_scan(pass_no, *args, _build.stream_ptr(keep[0])), "rt_ssd_scan")

    return y, hT, scratch, [functools.partial(launch, p) for p in range(len(PASSES))]


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, *,
             chunk: int = 64, scalar_decay: bool = False, strict: bool = False,
             h0: torch.Tensor | None = None, return_state: bool = False):
    """The scan over contiguous CUDA tensors q, k, w (B, H, S, K) and v
    (B, H, S, V) of one dtype, f32 or bf16; y (B, H, S, V) in that dtype.
    With ``scalar_decay`` w may be (B, H, S, 1), and only its column 0 is
    read.
    ``h0`` is an optional f32 (B, H, K, V) initial state; with
    ``return_state`` the f32 final state comes back too, as (y, hT)."""
    y, hT, _, launches = prepare(q, k, v, w, chunk=chunk, scalar_decay=scalar_decay, strict=strict,
                              h0=h0, return_state=return_state)
    for launch in launches:
        launch()
        ssd_scan.launches += 1
    ssd_scan.calls += 1
    return (y, hT) if return_state else y


ssd_scan.launches = 0
ssd_scan.calls = 0

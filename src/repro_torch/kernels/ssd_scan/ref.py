"""Plain PyTorch versions of the gated linear-attention / SSD state scan.

Port of ``repro/kernels/ssd_scan/ref.py``.  Per batch b and head h, with a
per-channel decay w_t in (0, 1]^K:

    H_t = diag(w_t) H_{t-1} + k_t v_tᵀ          (state: K x V, f32)
    y_t = q_t · H_t,  or q_t · H_{t-1} when ``strict``

* :func:`linear_scan_reference` is the exact sequential recurrence.
* :func:`linear_scan_chunked` is the chunked form with every exponent
  ≤ 0; it is what :func:`..ops.ssd_scan` runs for CPU tensors and what
  ``chip_smoke.py`` holds the CUDA kernel against.  The reference wraps its
  chunk body in ``jax.checkpoint`` for training; the port is inference only
  and loops over the chunks in Python.
* :func:`linear_scan_step` is the O(1) decode step.

q, k, w are (B, H, S, K) and v (B, H, S, V); ``h0`` and the returned state
are f32 (B, H, K, V); y comes back in q's dtype.  Mamba-2's scalar decay is
w broadcast over K: these functions take it in that per-channel form.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def linear_scan_reference(q, k, v, w, h0=None, *, strict: bool = False):
    """``strict=False``: y_t = q_t·H_t (SSD readout-after-update);
    ``strict=True``: y_t = q_t·H_{t-1} (RWKV-6 readout-before-update)."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    h = torch.zeros(B, H, K, V, dtype=F32, device=q.device) if h0 is None else h0
    ys = []
    for t in range(S):
        qt = q[:, :, t].to(F32)
        if strict:
            ys.append(torch.einsum("bhk,bhkv->bhv", qt, h))
        h = h * w[:, :, t, :, None].to(F32) + (
            k[:, :, t, :, None].to(F32) * v[:, :, t, None, :].to(F32))
        if not strict:
            ys.append(torch.einsum("bhk,bhkv->bhv", qt, h))
    return torch.stack(ys, dim=2).to(q.dtype), h


def linear_scan_step(q, k, v, w, h, *, strict: bool = False):
    """One decode step: q, k, w (B, H, K); v (B, H, V); h (B, H, K, V) ->
    (y, h')."""
    if strict:
        y = torch.einsum("bhk,bhkv->bhv", q.to(F32), h)
    h = h * w[..., None].to(F32) + k[..., :, None].to(F32) * v[..., None, :].to(F32)
    if not strict:
        y = torch.einsum("bhk,bhkv->bhv", q.to(F32), h)
    return y.to(q.dtype), h


def linear_scan_chunked(q, k, v, w, h0=None, *, chunk: int = 64, strict: bool = False):
    """Chunked scan: the state is carried across chunks; within a chunk

      y_t   = (q_t ⊙ e^{Lq_t}) · H_in + Σ_s (q_t · (k_s ⊙ e^{Lq_t - L_s})) v_s
      H_out = diag(e^{L_C}) H_in + Σ_t (k_t ⊙ e^{L_C - L_t}) ⊗ v_t

    with L_t the within-chunk cumulative log-decay (≤ 0, decreasing), Lq = L
    or, under ``strict``, the exclusive sum L - log w; s runs over s ≤ t, or
    s < t under ``strict``.  Every exponent is ≤ 0."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    dev = q.device
    h = torch.zeros(B, H, K, V, dtype=F32, device=dev) if h0 is None else h0
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=dev),
                      diagonal=-1 if strict else 0)
    ys = []
    for c0 in range(0, S, chunk):
        qt, kt, vt, wt = (x[:, :, c0:c0 + chunk].to(F32) for x in (q, k, v, w))
        logw = torch.log(torch.clamp(wt, min=1e-30))
        L = torch.cumsum(logw, dim=2)                                   # (B,H,C,K)
        Lq = (L - logw) if strict else L
        y = torch.einsum("bhck,bhkv->bhcv", qt * torch.exp(Lq), h)
        diff = Lq[:, :, :, None, :] - L[:, :, None, :, :]               # (B,H,C,C,K)
        scores = torch.einsum("bhtk,bhsk,bhtsk->bhts", qt, kt,
                              torch.exp(torch.clamp(diff, max=0.0)))
        scores = torch.where(mask, scores, torch.zeros((), dtype=F32, device=dev))
        ys.append(y + torch.einsum("bhts,bhsv->bhtv", scores, vt))
        Lc = L[:, :, -1:, :]
        k_out = kt * torch.exp(Lc - L)
        h = h * torch.exp(Lc[:, :, 0, :, None]) + torch.einsum("bhck,bhcv->bhkv", k_out, vt)
    return torch.cat(ys, dim=2).to(q.dtype), h

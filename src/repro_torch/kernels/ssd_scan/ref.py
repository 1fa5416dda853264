"""Plain PyTorch versions of the gated linear-attention / SSD state scan.

Port of ``repro/kernels/ssd_scan/ref.py``.  Per batch b and head h, with a
per-channel decay w_t in (0, 1]^K:

    H_t = diag(w_t) H_{t-1} + k_t v_tᵀ          (state: K x V, f32)
    y_t = q_t · H_t,  or q_t · H_{t-1} when ``strict``

* :func:`linear_scan_reference` is the exact sequential recurrence.
* :func:`linear_scan_chunked` is the chunked form with every exponent
  ≤ 0; it is what :func:`..ops.ssd_scan` runs for CPU tensors and what
  ``chip_smoke.py`` holds the CUDA kernel against.  It loops over the
  chunks in Python; under autograd each chunk body runs under a checkpoint,
  as the reference's under ``jax.checkpoint``, so only the (B, H, K, V)
  states are kept between chunks.
* :func:`linear_scan_chunked_vjp` is its gradient, chunk by chunk from the
  carried states, as XLA takes the reference's; the kernel's backward
  (``ops.KernelScan``) is this.
* :func:`linear_scan_step` is the O(1) decode step.
* :func:`linear_scan_passes` is the CUDA kernel's decomposition of the
  chunked form (chunk states, a state pass, chunk outputs, and the
  per-channel intra-chunk term on sub-chunks of 16); no path calls it, the
  tests hold its algebra to the reference on the CPU.

q, k, w are (B, H, S, K) and v (B, H, S, V); ``h0`` and the returned state
are f32 (B, H, K, V); y comes back in q's dtype.  Mamba-2's scalar decay is
w broadcast over K: these functions take it in that per-channel form.
"""

from __future__ import annotations

import torch

from .._grad import checkpointed

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
    h = torch.zeros(B, H, K, V, dtype=F32, device=q.device) if h0 is None else h0
    ys = []
    for c0 in range(0, S, chunk):
        y, h = checkpointed(lambda *xs: _chunk(*xs, strict=strict),
                            *(x[:, :, c0:c0 + chunk] for x in (q, k, v, w)), h)
        ys.append(y)
    return torch.cat(ys, dim=2).to(q.dtype), h


def _chunk(q, k, v, w, h, *, strict: bool):
    """One chunk of :func:`linear_scan_chunked`: (y in f32, the state after
    it)."""
    chunk = q.shape[2]
    qt, kt, vt, wt = (x.to(F32) for x in (q, k, v, w))
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=q.device),
                      diagonal=-1 if strict else 0)
    logw, L = _log_decays(wt)
    Lq = (L - logw) if strict else L
    y = torch.einsum("bhck,bhkv->bhcv", qt * torch.exp(Lq), h)
    diff = Lq[:, :, :, None, :] - L[:, :, None, :, :]                   # (B,H,C,C,K)
    scores = torch.einsum("bhtk,bhsk,bhtsk->bhts", qt, kt,
                          torch.exp(torch.clamp(diff, max=0.0)))
    scores = torch.where(mask, scores, torch.zeros((), dtype=F32, device=q.device))
    y = y + torch.einsum("bhts,bhsv->bhtv", scores, vt)
    return y, _state_after(kt, vt, L, h)


def _log_decays(wt):
    """log w (clamped at 1e-30) and its within-chunk cumulative sum L."""
    logw = torch.log(torch.clamp(wt, min=1e-30))
    return logw, torch.cumsum(logw, dim=2)                              # (B,H,C,K)


def _state_after(kt, vt, L, h):
    """H_out = diag(e^{L_C}) H_in + Σ_t (k_t ⊙ e^{L_C - L_t}) ⊗ v_t."""
    Lc = L[:, :, -1:, :]
    k_out = kt * torch.exp(Lc - L)
    return h * torch.exp(Lc[:, :, 0, :, None]) + torch.einsum("bhck,bhcv->bhkv", k_out, vt)


def linear_scan_chunked_vjp(q, k, v, w, h0, grad_y, grad_hT, *, chunk: int = 64,
                            strict: bool = False):
    """The gradient of :func:`linear_scan_chunked` with respect to q, k, v,
    w and ``h0`` (None for ``h0=None``), given the gradients of y and of the
    final state (either may be None).  w may be one decay a step (B, H, S,
    1), broadcast over K as ``ops.ssd_scan``'s plain route does.

    As XLA differentiates the reference's scan over a checkpointed chunk
    body, whose carries it keeps: the states entering each chunk come from
    one pass forward of the state update alone (the same ops as
    :func:`_chunk`'s, without the pairwise term), then each chunk, last
    first, is recomputed under autograd and differentiated, its state's
    gradient handed to the chunk before it."""
    B, H, S, K = q.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    n = S // chunk

    def part(x, c):
        return x[:, :, c * chunk:(c + 1) * chunk]

    def wide(wc):
        return wc.expand(*wc.shape[:3], K)

    with torch.no_grad():
        h = torch.zeros(B, H, K, v.shape[-1], dtype=F32, device=q.device) if h0 is None else h0
        states = []
        for c in range(n):
            states.append(h)
            h = _state_after(part(k, c).to(F32), part(v, c).to(F32),
                             _log_decays(wide(part(w, c)).to(F32))[1], h)
    gh = grad_hT
    grads = [[] for _ in range(4)]
    for c in reversed(range(n)):
        with torch.enable_grad():
            xs = [part(x, c).detach().requires_grad_() for x in (q, k, v, w)]
            h_in = states[c].detach().requires_grad_()
            y, h_out = _chunk(xs[0], xs[1], xs[2], wide(xs[3]), h_in, strict=strict)
            outs = [(o, g) for o, g in ((y, None if grad_y is None else part(grad_y, c)),
                                        (h_out, gh)) if g is not None]
            if outs:
                got = torch.autograd.grad([o for o, _ in outs], xs + [h_in],
                                          [g.to(o.dtype) for o, g in outs], allow_unused=True)
            else:
                got = [None] * 5
        for acc, g, x in zip(grads, got[:4], xs):
            acc.append(torch.zeros_like(x) if g is None else g)
        gh = got[4]
    dq, dk, dv, dw = (torch.cat(acc[::-1], dim=2) for acc in grads)
    return dq, dk, dv, dw, (None if h0 is None else gh)


SUB = 16  # the sub-chunk of the per-channel intra-chunk term (the kernel's mma tile rows)


def _subchunk_scores(q, k, L, Lq):
    """The per-channel scores S[t, s] = Σ_k q_t k_s e^{Lq_t - L_s} of chunks
    q, k (..., C, K) with log-decays L, Lq -> (..., C, C), for s in the
    sub-chunk of t or before it (the caller masks s > t, or s ≥ t under
    ``strict``).  Sub-chunks are 16 steps (a chunk of 16 or less is its
    own).  On a diagonal block the pairwise exponents stay; for t in
    sub-chunk i and s in an earlier sub-chunk j, with b_i the step before
    sub-chunk i and e_j the last step of sub-chunk j,

      e^{Lq_t - L_s} = e^{Lq_t - L_{b_i}} · e^{L_{b_i} - L_{e_j}} · e^{L_{e_j} - L_s},

    each exponent ≤ 0: q̃_t and k̃_s take one scaling each and the pair (i, j)
    one K-vector of decays, so the block is a product (q̃ ⊙ d_ij) · k̃ᵀ."""
    C = q.shape[-2]
    starts = list(range(0, C, SUB))
    s = q.new_zeros(*q.shape[:-1], C)
    zero = torch.zeros_like(L[..., :1, :])
    bnd = [zero if i0 == 0 else L[..., i0 - 1:i0, :] for i0 in starts]  # L_{b_i}
    for i, i0 in enumerate(starts):
        i1 = min(i0 + SUB, C)
        qi, lqi = q[..., i0:i1, :], Lq[..., i0:i1, :]
        diff = torch.clamp(lqi[..., :, None, :] - L[..., None, i0:i1, :], max=0.0)
        s[..., i0:i1, i0:i1] = torch.einsum("...tk,...sk,...tsk->...ts", qi, k[..., i0:i1, :],
                                            _exp(diff))
        q_t = qi * _exp(torch.clamp(lqi - bnd[i], max=0.0))
        for j0 in starts[:i]:
            j1 = j0 + SUB
            last = L[..., j1 - 1:j1, :]                                   # L_{e_j}
            k_t = k[..., j0:j1, :] * _exp(last - L[..., j0:j1, :])
            s[..., i0:i1, j0:j1] = torch.einsum("...tk,...sk->...ts",
                                                q_t * _exp(bnd[i] - last), k_t)
    return s


def _exp(x):
    """e^x of float64 log-decays, as f32."""
    return torch.exp(x).to(F32)


def linear_scan_passes(q, k, v, w, h0=None, *, chunk: int = 64, strict: bool = False,
                       scalar_decay: bool = False):
    """:func:`linear_scan_chunked` as the CUDA kernel decomposes it (the
    three passes of Mamba-2's SSD, arXiv:2405.21060), in plain PyTorch:

    1. chunk states: per chunk c, ΔH_c = Σ_t (k_t ⊙ e^{L_C - L_t}) v_tᵀ and
       its decay e^{L_C};
    2. state pass: H_in[c] = H, then H = e^{L_C[c]} ⊙ H + ΔH_c, from ``h0``
       (or 0); the last H is the final state;
    3. chunk outputs: y = (q ⊙ e^{Lq}) · H_in[c] + the intra-chunk term,
       (q·kᵀ ⊙ D) · v with D[t, s] = e^{min(Lq_t - L_s, 0)} under
       ``scalar_decay`` (w's column 0), else :func:`_subchunk_scores` · v.

    Every exponent is ≤ 0.  The log-decays are summed in float64, so that
    with decays of 1e-30 (L near -650 after ten of them) the exponents' f32
    rounding does not hide the algebra; every product is f32.  Returns (y
    in q's dtype, the f32 final state)."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    dev = q.device

    def chunks(x):
        return x.to(F32).reshape(B, H, nc, chunk, x.shape[-1])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    logw = torch.log(torch.clamp(chunks(w[..., :1] if scalar_decay else w).double(),
                                 min=1e-30))
    L = torch.cumsum(logw, dim=3)                                   # (B, H, nc, C, K or 1)
    Lq = (L - logw) if strict else L
    Lc = L[:, :, :, -1:]
    # 1. chunk states
    dH = torch.einsum("bhnck,bhncv->bhnkv", kc * _exp(Lc - L), vc)
    dec = _exp(Lc[:, :, :, 0, :, None])                             # (B, H, nc, K or 1, 1)
    # 2. the state pass
    h = torch.zeros(B, H, K, V, dtype=F32, device=dev) if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = dec[:, :, c] * h + dH[:, :, c]
    h_in = torch.stack(h_in, dim=2)
    # 3. chunk outputs
    y = torch.einsum("bhnck,bhnkv->bhncv", qc * _exp(Lq), h_in)
    if scalar_decay:
        dd = _exp(torch.clamp(Lq[..., :, None, 0] - L[..., None, :, 0], max=0.0))
        scores = torch.einsum("bhntk,bhnsk->bhnts", qc, kc) * dd
    else:
        scores = _subchunk_scores(qc, kc, L, Lq)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=dev),
                      diagonal=-1 if strict else 0)
    scores = torch.where(mask, scores, torch.zeros((), dtype=F32, device=dev))
    y = y + torch.einsum("bhnts,bhnsv->bhntv", scores, vc)
    return y.reshape(B, H, S, V).to(q.dtype), h

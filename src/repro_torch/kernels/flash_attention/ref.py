"""Plain PyTorch versions of forward attention.

Port of ``repro/kernels/flash_attention/ref.py``:

* :func:`mha_reference` is naive full-matrix attention (it materialises the
  Sq x Sk scores), the mathematical ground truth for small shapes.
* :func:`mha_chunked` is the online softmax over (q block, KV block) pairs,
  memory-linear.  It is what :func:`..ops.attention` runs for CPU tensors
  and what ``chip_smoke.py`` holds the CUDA kernel against.  The
  reference's sequence-parallel pins (``seq_spec``: q blocks over "model",
  K and V whole) are layout, not arithmetic: in the port each rank of a
  mesh calls this on its own q block with ``q_offset`` its first token's
  position and the whole K and V (``models.layers.attn_apply`` under
  ``sp``).
* :func:`mha_chunked_vjp` is its gradient, q block by q block, as XLA
  takes the reference's; the kernel's backward (``ops.KernelAttention``)
  is this.

Both take q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) with Hq a multiple of
Hkv (GQA: q head h reads KV head h // (Hq // Hkv)), compute in f32 and
return q's dtype.

One deliberate difference from the reference's ``mha_chunked``: a masked
score contributes p = 0, where the reference takes exp(-1e30 - m), which is
1 while a row has seen no visible key.  The two agree bit for bit on every
row with at least one visible key (the reference's transient terms are
multiplied by exp(-1e30 - m) = 0 when the first visible key arrives); on a
row whose keys are all masked the port gives 0, as the CUDA kernel does.
"""

from __future__ import annotations

import torch

from .._grad import checkpointed

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int | None):
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return ok


def mha_reference(q, k, v, *, causal: bool = True, window: int | None = None,
                  sm_scale: float | None = None):
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq % Hkv:
        raise ValueError("GQA needs Hq % Hkv == 0")
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * sm_scale
    dev = q.device
    ok = _mask(torch.arange(Sq, device=dev), torch.arange(Sk, device=dev), causal, window)
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def _plan(q, k, sm_scale, q_offset, block_q: int, block_k: int):
    """(GQA group, scale, q_offset, q block, KV block) of a chunked call: the
    scale defaults to D^-1/2, q_offset to Sk - Sq, and the q block is halved
    until it divides Sq."""
    _, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq % Hkv:
        raise ValueError("GQA needs Hq % Hkv == 0")
    block_q = min(block_q, Sq)
    while Sq % block_q:
        block_q //= 2
    return (Hq // Hkv, D ** -0.5 if sm_scale is None else sm_scale,
            Sk - Sq if q_offset is None else q_offset, block_q, min(block_k, Sk))


def mha_chunked(q, k, v, *, causal: bool = True, window: int | None = None,
                sm_scale: float | None = None, block_k: int = 512, block_q: int = 512,
                q_offset: int | None = None):
    """Double-chunked online-softmax attention (q blocks outside, KV blocks
    inside).  ``q_offset`` is the absolute position of q[0]; it defaults to
    ``Sk - Sq`` (right-aligned causal), as in the reference.  Under autograd
    each q block runs under a checkpoint, as the reference's ``q_body``
    under ``jax.checkpoint``: a block's scores are recomputed in the
    backward instead of kept."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    g, sm_scale, q_offset, block_q, block_k = _plan(q, k, sm_scale, q_offset, block_q, block_k)
    qb = (q.float() * sm_scale).reshape(B, Hkv, g, Sq, D)
    outs = []
    for q0 in range(0, Sq, block_q):
        outs.append(checkpointed(
            lambda qi, k, v, q0=q0: _q_block(qi, k, v, q_offset + q0, causal, window, block_k,
                                             q.dtype),
            qb[:, :, :, q0:q0 + block_q], k, v))
    return torch.cat(outs, dim=3).reshape(B, Hq, Sq, D)


def mha_chunked_vjp(q, k, v, grad_out, *, causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None, block_k: int = 512, block_q: int = 512,
                    q_offset: int | None = None):
    """The gradient (dq, dk, dv) of :func:`mha_chunked` given the gradient
    of its output: each q block recomputed under autograd and differentiated
    alone, as XLA differentiates the reference's scan over its checkpointed
    q body; dk and dv summed over the q blocks in f32."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    g, sm_scale, q_offset, block_q, block_k = _plan(q, k, sm_scale, q_offset, block_q, block_k)
    kf, vf = k.detach().float(), v.detach().float()
    dqs, dk, dv = [], torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, Sq, block_q):
        with torch.enable_grad():
            qi = q[:, :, q0:q0 + block_q].detach().requires_grad_()
            ks, vs = kf.requires_grad_(), vf.requires_grad_()
            out = _q_block((qi.float() * sm_scale).reshape(B, Hkv, g, block_q, D), ks, vs,
                           q_offset + q0, causal, window, block_k, q.dtype)
            go = grad_out[:, :, q0:q0 + block_q].reshape(out.shape)
            gq, gk, gv = torch.autograd.grad(out, (qi, ks, vs), go)
        dqs.append(gq)
        dk += gk
        dv += gv
    return torch.cat(dqs, dim=2), dk.to(k.dtype), dv.to(v.dtype)


def _q_block(qi, k, v, q_start: int, causal: bool, window: int | None, block_k: int, dtype):
    """One q block (B, Hkv, g, block_q, D), already scaled, against every
    KV block that holds a visible key; skipped blocks are those the mask
    hides whole, which would add p = 0 and rescale by exp(0) = 1."""
    B, Hkv, g, bq, D = qi.shape
    Sk = k.shape[2]
    dev = qi.device
    q_pos = q_start + torch.arange(bq, device=dev)
    m = torch.full((B, Hkv, g, bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, g, bq, D, dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        hidden = (causal and k0 > q_start + bq - 1) or \
            (window is not None and k1 - 1 <= q_start - window)
        if hidden:
            continue
        kblk = k[:, :, k0:k1].float()
        vblk = v[:, :, k0:k1].float()
        k_pos = k0 + torch.arange(k1 - k0, device=dev)
        ok = _mask(q_pos, k_pos, causal, window)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kblk)
        s = torch.where(ok, s, torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), torch.tensor(0.0, device=dev))
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vblk)
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).to(dtype)

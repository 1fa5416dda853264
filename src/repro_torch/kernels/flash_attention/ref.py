"""Plain PyTorch versions of forward attention.

Port of ``repro/kernels/flash_attention/ref.py``:

* :func:`mha_reference` is naive full-matrix attention (it materialises the
  Sq x Sk scores), the mathematical ground truth for small shapes.
* :func:`mha_chunked` is the online softmax over (q block, KV block) pairs,
  memory-linear.  It is what :func:`..ops.attention` runs for CPU tensors
  and what ``chip_smoke.py`` holds the CUDA kernel against.  The sequence
  sharding pins of the reference (``seq_spec``) have no meaning on one card
  and are left out.

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


def mha_chunked(q, k, v, *, causal: bool = True, window: int | None = None,
                sm_scale: float | None = None, block_k: int = 512, block_q: int = 512,
                q_offset: int | None = None):
    """Double-chunked online-softmax attention (q blocks outside, KV blocks
    inside).  ``q_offset`` is the absolute position of q[0]; it defaults to
    ``Sk - Sq`` (right-aligned causal), as in the reference."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq % Hkv:
        raise ValueError("GQA needs Hq % Hkv == 0")
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    block_q = min(block_q, Sq)
    while Sq % block_q:
        block_q //= 2
    block_k = min(block_k, Sk)
    dev = q.device

    qb = (q.float() * sm_scale).reshape(B, Hkv, g, Sq, D)
    out = torch.empty(B, Hkv, g, Sq, D, dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, block_q):
        qi = qb[:, :, :, q0:q0 + block_q]
        q_pos = q_offset + q0 + torch.arange(block_q, device=dev)
        m = torch.full((B, Hkv, g, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, g, block_q, D, dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, block_k):
            kblk = k[:, :, k0:k0 + block_k].float()
            vblk = v[:, :, k0:k0 + block_k].float()
            k_pos = k0 + torch.arange(kblk.shape[2], device=dev)
            ok = _mask(q_pos, k_pos, causal, window)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kblk)
            s = torch.where(ok, s, torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), torch.tensor(0.0, device=dev))
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vblk)
            m = m_new
        out[:, :, :, q0:q0 + block_q] = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, Hq, Sq, D)

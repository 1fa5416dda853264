"""Core layers: norm, RoPE, embeddings (multi-codebook too), attention
(self and cross), MLP, MoE.

Port of ``repro.models.layers``.  Every layer is a (meta, apply) pair of
plain functions on tensors.  Activation layout is (B, S, d_model); attention
internals use (B, H, S, Dh).  Reductions are taken in f32, as in the
reference.

The full-sequence attention goes through the port's
:func:`repro_torch.kernels.flash_attention.attention`, which dispatches on
the device: on the card both ``attn_impl="chunked"`` (the reference's
memory-linear XLA formulation) and ``attn_impl="kernel"`` launch the one
CUDA kernel the port has, and on the CPU both take the plain chunked
version.  ``attn_impl="reference"`` forces the plain version on any device.
Cross attention (the vlm family) goes through the same entry point,
non-causal and without a window, at Sq != Sk; its one-token decode against
the precomputed image K/V too.  Decode self-attention, every projection and
the MoE FFN (dispatch, three batched expert products, combine) are plain
tensor code, as they are jnp in the reference.  ``moe_apply_shardmap``
runs the MoE FFN on a rank's rows of a (data, model) mesh with explicit
collectives (:mod:`repro_torch.parallel.collectives`).

A layer on a mesh takes its place there as one ``layout=`` argument: a
:class:`SeqParallel` or a :class:`StripedCache`, each holding the mesh (the
recurrent blocks take a :class:`DSharded` one, ``blocks``' module
docstring).

**The sequence-parallel layout** (:class:`SeqParallel`: the mesh, and the
position of this rank's first token): ``x`` is the rank's
block of S / M tokens of its rows, the tokens [m S / M, (m + 1) S / M) of
model index m.  :func:`attn_apply` takes whole projection weights,
computes q, k and v for its tokens, all-gathers K and V over "model" along
S (backward a reduce-scatter) and attends its q block over every key with
``q_offset`` its first token's position, as the reference's
``mha_chunked(seq_spec=...)`` pins q blocks over "model" and K/V whole
(heads need not divide the model axis: qwen2-7b's 28 and 4 do not divide
16).  :func:`mlp_apply` is tensor parallel: the normed tokens all-gathered
over "model" along S (backward a reduce-scatter), this rank's column
block of ``wi``/``wg`` and row block of ``wo``, and the partial (B, S, d)
reduce-scattered in f32 back onto the rank's tokens (backward an
all-gather).  ``moe_apply_shardmap(..., sp=True)`` gathers the whole
sequence over "model" (the reference's shard_map takes x whole over it)
and reduce-scatters its output onto the rank's tokens.

**The striped-cache decode** (:class:`StripedCache`): the decode hidden
(B / D, 1, d) is alike on every model rank, and the cache's T axis is
striped over "model", the rank at model index m holding the global slots
[m T / M, (m + 1) T / M).  :func:`attn_apply` takes whole projection
weights, so every model rank computes q, k and v alike; only the rank whose
stripe holds slot ``len % T`` writes the new row, each attends over its own
stripe with the masks taken on the global slot, and the partial softmaxes
are merged over "model" (:func:`_striped_attention`, the reference's
flash-decoding merge).  The vlm's cross attention merges the same way over
its striped image K/V.  :func:`mlp_apply` runs on the rank's "model"
blocks and sums its partial over "model" in f32.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from ..parallel import collectives as C
from ..parallel.mesh import data_axes
from ..parallel.spec import axis_index, axis_size
from .config import ArchConfig
from .module import ParamMeta

F32 = torch.float32

_ATTN_IMPLS = {"chunked": None, "kernel": None, "reference": "reference"}


class SeqParallel(NamedTuple):
    """A rank's place in the sequence-parallel layout: the mesh, and the
    position of its first token (its block of S / M tokens over "model")."""

    mesh: Any
    start: int


class DSharded(NamedTuple):
    """A rank's place in the d-sharded layout of the recurrent stacks
    (``blocks``' module docstring): the mesh, whose "model" axis splits the
    residual's d and deals each layer's heads."""

    mesh: Any


class StripedCache(NamedTuple):
    """A rank's place in the striped-cache decode: the mesh, whose "model"
    axis stripes the cache's T."""

    mesh: Any


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_meta(cfg: ArchConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    m = {"scale": ParamMeta((d,), F32, (None,), "ones")}
    if cfg.norm == "layernorm" and cfg.norm_bias:
        m["bias"] = ParamMeta((d,), F32, (None,), "zeros")
    return m


def norm_apply(p, cfg: ArchConfig, x):
    xf = x.to(F32)
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"]
        if "bias" in p:
            out = out + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_apply(x, positions, theta: float):
    """x: (B, H, S, D); positions: (S,) or (B, S)."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    if positions.dim() == 1:
        ang = positions.to(F32)[:, None] * freqs[None, :]              # (S, half)
        ang = ang[None, None]                                           # (1,1,S,half)
    else:
        ang = positions.to(F32)[:, None, :, None] * freqs[None, None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_embed(positions, d: int):
    """positions: (S,) int -> (S, d) sinusoidal embedding (no table)."""
    pos = positions.to(F32)[:, None]
    dim = torch.arange(0, d, 2, dtype=F32, device=positions.device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=positions.device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_vocab(cfg: ArchConfig) -> int:
    return round_up(cfg.vocab, 128)


def embed_meta(cfg: ArchConfig):
    """The token table and head; one of each per codebook (audio), stacked
    along a leading codebook dim."""
    vp, d, ncb = padded_vocab(cfg), cfg.d_model, cfg.n_codebooks
    multi = ncb > 1
    m = {"tok": ParamMeta((ncb, vp, d) if multi else (vp, d), cfg.param_dtype,
                          (None, "tp", "fsdp") if multi else ("tp", "fsdp"), "embed",
                          scale=0.02)}
    if not cfg.tie_embeddings:
        m["head"] = ParamMeta((ncb, d, vp) if multi else (d, vp), cfg.param_dtype,
                              (None, "fsdp", "tp") if multi else ("fsdp", "tp"), "normal")
    return m


def embed_apply(p, cfg: ArchConfig, tokens):
    """tokens: (B, S) integer, or (B, S, n_codebooks) for audio, whose
    embedding is the sum of the per-codebook embeddings, added in codebook
    order (MusicGen)."""
    if cfg.n_codebooks > 1:
        out = torch.zeros(tuple(tokens.shape[:2]) + (cfg.d_model,), dtype=cfg.param_dtype,
                          device=tokens.device)
        for c in range(cfg.n_codebooks):
            out = out + p["tok"][c][tokens[..., c].long()]
        return out
    return p["tok"][tokens.long()]


def logits_apply(p, cfg: ArchConfig, x, codebook: Optional[int] = None):
    """x: (B, S, d) -> (B, S, padded_vocab), of codebook ``codebook`` for
    audio."""
    if cfg.tie_embeddings:
        w = p["tok"].to(cfg.param_dtype)
        if cfg.n_codebooks > 1:
            w = w[codebook]
        return torch.einsum("bsd,vd->bsv", x, w)
    w = p["head"] if cfg.n_codebooks == 1 else p["head"][codebook]
    return torch.einsum("bsd,dv->bsv", x, w)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_meta(cfg: ArchConfig, cross: bool = False):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    m = {
        "wq": ParamMeta((d, hq * dh), dt, ("fsdp", "tp"), "normal"),
        "wk": ParamMeta((d, hkv * dh), dt, ("fsdp", "tp"), "normal"),
        "wv": ParamMeta((d, hkv * dh), dt, ("fsdp", "tp"), "normal"),
        "wo": ParamMeta((hq * dh, d), dt, ("tp", "fsdp"), "normal"),
    }
    if cfg.qkv_bias:
        m["bq"] = ParamMeta((hq * dh,), F32, ("tp",), "zeros")
        m["bk"] = ParamMeta((hkv * dh,), F32, ("tp",), "zeros")
        m["bv"] = ParamMeta((hkv * dh,), F32, ("tp",), "zeros")
    if cross:
        m["gate"] = ParamMeta((1,), F32, (None,), "zeros")  # tanh-gated (llama-3.2)
    return m


def _split_heads(x, n_heads, d_head):
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, d_head).transpose(1, 2)


def _gqa_scores(q, k, mask, fill: float):
    """The scaled scores (B, Hkv, g, S, T) in f32 of q (B, Hq, S, Dh)
    against k (B, Hkv, T, Dh), each of the g = Hq / Hkv query heads of a
    group against its K/V head; ``fill`` where ``mask`` (B or 1, T) is
    False, or nowhere where it is None."""
    B, Hq, S, Dh = q.shape
    Hkv = k.shape[1]
    qf = q.reshape(B, Hkv, Hq // Hkv, S, Dh).to(F32) * (Dh ** -0.5)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(F32))
    if mask is None:
        return s
    return torch.where(mask[:, None, None, None, :], s, torch.tensor(fill, device=q.device))


def _decode_attention(q, k, v, valid, start=None):
    """q: (B,Hq,1,Dh); k,v: (B,Hkv,T,Dh); attend over slots < valid.

    ``start`` (B,) optionally masks slots below a per-sequence admission
    offset: the serving engine reuses cache slots, and a re-admitted
    sequence must not attend to its predecessor's stale rows."""
    B, Hq, S, Dh = q.shape
    T = k.shape[2]
    slot = torch.arange(T, device=q.device)
    mask = slot[None, :] < torch.as_tensor(valid, device=q.device).expand(B)[:, None]
    if start is not None:
        mask = mask & (slot[None, :] >= start[:, None])
    p = torch.softmax(_gqa_scores(q, k, mask, -1e30), dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(F32))
    return out.reshape(B, Hq, S, Dh).to(q.dtype)


def _striped_attention(q, k, v, mask, mesh):
    """Attention of q (B, Hq, S, Dh) over this rank's stripe of the keys, k
    and v (B, Hkv, T / M, Dh), merged over "model" into attention over all
    T.  ``mask`` (B or 1, T / M) marks the valid keys, or is None (all
    valid).  Each rank's partial, in f32, is its running max, its sum of
    exponentials and their product with v; the partials are all-gathered
    and merged in rank order, so every model rank ends with the same bits.
    The merge rescales by the global max: a stripe without a valid key has
    the max -inf and weight exactly 0 (normalised alone, the one-device
    fill of -1e30 would give it the mean of v).  A row with no valid key at
    all gives 0."""
    B, Hq, S, Dh = q.shape
    s = _gqa_scores(q, k, mask, float("-inf"))
    mx = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0.0))
    part = torch.cat([mx, e.sum(-1, keepdim=True),
                      torch.einsum("bhgst,bhtd->bhgsd", e, v.to(F32))], dim=-1)
    parts = C.all_gather(part[None], mesh, "model", 0)
    top = parts[..., :1].amax(0)
    w = torch.exp(parts[..., :1] - torch.where(torch.isfinite(top), top, 0.0))
    tot = (w * parts[..., 1:]).sum(0)
    out = tot[..., 1:] / torch.where(tot[..., :1] > 0, tot[..., :1], 1.0)
    return out.reshape(B, Hq, S, Dh).to(q.dtype)


def _striped_decode(q, k, v, kv_cache, mesh):
    """The decode step's write and attention over a K/V ring striped over
    "model" (see the module docstring): ``kv_cache``'s k and v are the
    rank's stripe (B, Hkv, T / M, Dh) of the ring of T rows, its local row
    t the global slot m T / M + t.  The rank whose stripe holds slot
    ``len % T`` writes the new row in place (the others write their row back
    unchanged, which reads nothing from the device); the masks ``slot <
    min(len + S, T)`` and ``slot >= start`` are taken on the global slot."""
    ck, cv, idx = kv_cache["k"], kv_cache["v"], kv_cache["len"]
    S, local_T = q.shape[2], ck.shape[2]
    T = local_T * axis_size(mesh, "model")
    first = axis_index(mesh, "model") * local_T
    row = torch.remainder(idx, T) - first
    mine = (row >= 0) & (row < local_T)
    at = torch.clamp(row, 0, local_T - 1).reshape(1).long()
    ck.index_copy_(2, at, torch.where(mine, k, ck.index_select(2, at)))
    cv.index_copy_(2, at, torch.where(mine, v, cv.index_select(2, at)))
    slot = first + torch.arange(local_T, device=q.device)
    mask = (slot < torch.clamp(idx + S, max=T))[None, :]
    start = kv_cache.get("start")
    if start is not None:
        mask = mask & (slot[None, :] >= start[:, None])
    return _striped_attention(q, ck, cv, mask, mesh)


def attn_apply(
    p,
    cfg: ArchConfig,
    x,                      # (B, S, d)
    *,
    positions=None,         # (S,) absolute positions (for rope)
    kv_cache=None,          # optional dict(k=(B,Hkv,T,Dh), v=..., len=(), start=(B,))
    memory=None,            # (B, M, d) cross-attention memory
    kv_override=None,       # precomputed (k, v) heads (cross-attention decode)
    attn_impl: str = "chunked",
    block_k: int = 512,
    block_q: int = 512,
    layout=None,            # a SeqParallel or a StripedCache on a mesh
):
    """Returns (out, new_kv_cache or None).

    Decode caches are ring buffers of capacity T (= window for SWA archs):
    the step writes at ``len % T`` and attends over ``min(len+1, T)`` valid
    slots.  The port writes the new row into the given cache tensors in
    place (the reference returns updated copies); the returned dict holds
    the same tensors and the advanced length.

    With ``memory`` or ``kv_override`` the attention is cross attention: K
    and V come from the memory (or are given), without RoPE, and no bias is
    added to a given K/V; it is non-causal and unwindowed, and its output is
    scaled by ``tanh(gate)``.

    With a :class:`SeqParallel` ``layout`` (a prefill; see the module
    docstring) ``x`` is the rank's tokens and ``positions`` their absolute
    positions; self attention gathers K and V over "model" and attends
    with ``q_offset`` the rank's first position; cross attention takes the
    whole ``memory`` (the caller gathers it) without an offset.

    With a :class:`StripedCache` ``layout`` (a decode step; see the module
    docstring) ``kv_cache``'s k and v, or the ``kv_override`` of cross
    attention, are the rank's stripe of the keys, and the partial softmaxes
    are merged over "model"; on a model axis of one rank the stripe is the
    whole ring, which attends as on one device.
    """
    if attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    sp = layout if isinstance(layout, SeqParallel) else None
    stripes = (layout.mesh if isinstance(layout, StripedCache)
               and axis_size(layout.mesh, "model") > 1 else None)
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cross = memory is not None or kv_override is not None

    q = _split_heads(x @ p["wq"], hq, dh)
    if kv_override is not None:
        k, v = kv_override
    else:
        kv_src = memory if cross else x
        k = _split_heads(kv_src @ p["wk"], hkv, dh)
        v = _split_heads(kv_src @ p["wv"], hkv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(hq, 1, dh).to(q.dtype)
        if kv_override is None:
            k = k + p["bk"].reshape(hkv, 1, dh).to(k.dtype)
            v = v + p["bv"].reshape(hkv, 1, dh).to(v.dtype)

    if cfg.rope and not cross:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    q_offset = 0
    if sp is not None and not cross:
        if kv_cache is not None:
            raise ValueError("attn_apply: the sequence-parallel layout is a prefill's, not "
                             "a decode step's")
        k = C.gather(k, sp.mesh, "model", 2)
        v = C.gather(v, sp.mesh, "model", 2)
        q_offset = sp.start

    new_cache = None
    if kv_cache is not None:
        # decode (S == 1): ring-buffer write + attend over the valid slots
        ck, cv = kv_cache["k"], kv_cache["v"]
        idx = kv_cache["len"]
        new_cache = {"k": ck, "v": cv, "len": idx + S}
        if stripes is not None:
            out = _striped_decode(q, k, v, kv_cache, stripes)
        else:
            T = ck.shape[2]
            write = torch.remainder(idx, T).reshape(1).long()
            ck.index_copy_(2, write, k)
            cv.index_copy_(2, write, v)
            valid = torch.clamp(idx + S, max=T)
            out = _decode_attention(q, ck, cv, valid, start=kv_cache.get("start"))
    elif cross and stripes is not None:
        out = _striped_attention(q, k, v, None, stripes)
    else:
        out = flash_ops.attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=not cross,
            window=None if cross else cfg.window, impl=_ATTN_IMPLS[attn_impl],
            block_q=block_q, block_k=block_k, q_offset=q_offset,
        )

    out = out.transpose(1, 2).reshape(B, S, hq * dh) @ p["wo"]
    if cross:
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp_meta(cfg: ArchConfig):
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    m = {
        "wi": ParamMeta((d, ff), dt, ("fsdp", "tp"), "normal"),
        "wo": ParamMeta((ff, d), dt, ("tp", "fsdp"), "normal"),
    }
    if cfg.act == "swiglu":
        m["wg"] = ParamMeta((d, ff), dt, ("fsdp", "tp"), "normal")
    if cfg.mlp_bias:
        m["bi"] = ParamMeta((ff,), F32, ("tp",), "zeros")
        m["bo"] = ParamMeta((d,), F32, (None,), "zeros")
    return m


def mlp_apply(p, cfg: ArchConfig, x, layout=None):
    """The dense FFN.  In either ``layout`` (see the module docstring) ``p``
    holds the rank's "model" blocks of ``wi``, ``wg``, ``bi`` (columns) and
    ``wo`` (rows), ``bo`` whole.  With a :class:`SeqParallel` one ``x`` is
    the rank's tokens; with a :class:`StripedCache` one ``x`` is alike on
    every model rank and the partial is summed over "model" in f32."""
    sp = layout if isinstance(layout, SeqParallel) else None
    if sp is not None:
        x = C.gather(x, sp.mesh, "model", 1)
    h = x @ p["wi"]
    if cfg.mlp_bias:
        h = h + p["bi"].to(h.dtype)
    if cfg.act == "swiglu":
        g = x @ p["wg"]
        h = F.silu(g.to(F32)).to(h.dtype) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.to(F32), approximate="tanh").to(h.dtype)
    out = h @ p["wo"]
    if sp is not None:
        out = C.scatter(out.to(F32), sp.mesh, "model", 1).to(x.dtype)
    elif layout is not None:
        out = C.reduce_forward(out.to(F32), layout.mesh, "model").to(x.dtype)
    if cfg.mlp_bias:
        out = out + p["bo"].to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# MoE (capacity-based top-k dispatch; deterministic phase-order drops)
#
# Two engines, as in the reference:
#   * moe_apply          — global dispatch over the token set it is given
#                          (one card, and the oracle of the sharded path);
#   * moe_apply_shardmap — token-local dispatch on each rank's rows of a
#                          (data, model) mesh: the experts' FSDP blocks
#                          gathered over the data axes, the expert FFN over
#                          the rank's TP block of its hidden width, and one
#                          sum over "model" completing it.
# ---------------------------------------------------------------------------

def moe_meta(cfg: ArchConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    e, ff = cfg.moe.n_experts, cfg.moe.expert_ff
    return {
        "router": ParamMeta((d, e), F32, ("fsdp", None), "normal"),
        "wi": ParamMeta((e, d, ff), dt, (None, "fsdp", "tp"), "normal"),
        "wg": ParamMeta((e, d, ff), dt, (None, "fsdp", "tp"), "normal"),
        "wo": ParamMeta((e, ff, d), dt, (None, "tp", "fsdp"), "normal"),
    }


def moe_dispatch(router, cfg: ArchConfig, xt, capacity: int):
    """Token -> expert slots, as the reference's ``_moe_local`` grants them.

    router (d, e); xt (T, d).  Returns (probs (T, e) f32, gate_vals (T, k)
    f32, gate_idx (T, k), keep (T, k) bool, slot (T, k)): each (token, k)
    pair's slot ``expert * capacity + position`` in the expert buffer, or the
    out-of-range ``e * capacity`` where it is dropped.

    Top-k is the first k of a stable descending sort, so ties go to the lower
    expert index as in ``jax.lax.top_k`` (``torch.topk`` promises no order
    among ties).  Slots are granted in (expert, phase) order: a stable
    argsort of the expert ids (the phase is the pair's index, already
    ascending), a position within the expert's segment, and the pairs past
    ``capacity`` dropped."""
    T = xt.shape[0]
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n = T * k
    probs = torch.softmax(xt.to(F32) @ router, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    eid = gate_idx.reshape(n)
    order = torch.argsort(eid, stable=True)
    eid_sorted = eid[order]
    seg_start = torch.searchsorted(eid_sorted, torch.arange(e, device=xt.device))
    pos = torch.empty_like(eid)
    pos[order] = torch.arange(n, device=xt.device) - seg_start[eid_sorted]
    keep = pos < capacity
    slot = torch.where(keep, eid * capacity + pos, e * capacity)
    return probs, gate_vals, gate_idx, keep.reshape(T, k), slot.reshape(T, k)


def _moe_local(router, wi, wg, wo, cfg: ArchConfig, xt, capacity: int, *, enter=None):
    """Dispatch + expert FFN + combine over a token set, no collectives.

    router (d, e); wi/wg (e, d, F); wo (e, F, d); xt (T, d).  Returns (out
    (T, d) — partial where F is a TP block — probs, gate_idx).  ``enter``
    (identity when None) is applied to the two values that go from the
    routing, which every TP rank computes alike, into the FFN, which each
    computes in part: the expert buffer and the slot weights (the sharded
    engine's "identity forward, sum backward").

    Dispatch is inverted as in the reference: each slot holds a token index
    (T for the zero row), and one row gather builds the (e, capacity, d)
    expert buffer.  The combine adds each token's kept slot rows, weighted
    by their gates, in ascending slot order (the reference's scatter-add
    order), rounding to x's dtype after each add, with no atomics, so it
    gives the same bits on every run."""
    T, d = xt.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    probs, gate_vals, gate_idx, _, slot = moe_dispatch(router, cfg, xt, capacity)
    # every pair writes through its slot, the dropped ones into the spare row
    # e * capacity, which is then cut off: kept slots are unique, so no mask
    # gather (a host sync, and no meta shape) is needed
    flat = slot.reshape(T * k)
    src_tok = torch.arange(T, device=xt.device)[:, None].expand(T, k).reshape(T * k)
    slot_tok = torch.full((e * capacity + 1,), T, dtype=torch.long, device=xt.device)
    slot_tok[flat] = src_tok
    xtp = torch.cat([xt, xt.new_zeros(1, d)])
    buf = xtp[slot_tok[:-1]].reshape(e, capacity, d)
    del xtp, slot_tok
    if enter is not None:
        buf = enter(buf)

    h = torch.bmm(buf, wi)
    g = torch.bmm(buf, wg)
    del buf
    h = F.silu(g.to(F32)).to(h.dtype) * h
    del g
    out_buf = torch.bmm(h, wo).reshape(e * capacity, d)
    del h

    slot_w = torch.zeros(e * capacity + 1, dtype=F32, device=xt.device)
    slot_w[flat] = gate_vals.reshape(T * k)
    slot_w[-1] = 0.0
    if enter is not None:
        slot_w = enter(slot_w)
    # row e * capacity is the dropped pairs' zero row
    weighted = torch.cat([out_buf, out_buf.new_zeros(1, d)]) * slot_w[:, None].to(out_buf.dtype)
    del out_buf
    slots = torch.sort(slot, dim=-1).values  # dropped pairs last
    out = torch.zeros((T, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        out = out + weighted[slots[:, j]]
    return out, probs, gate_idx


def _moe_aux(probs, gate_idx, e):
    """Switch load-balancing loss from the routing stats."""
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], e).to(F32).mean(dim=0)
    return e * torch.sum(me * ce)


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the reference's
    ``int(capacity_factor * k * T / e) or 1``."""
    return int(cfg.moe.capacity_factor * cfg.moe.top_k * n_tokens / cfg.moe.n_experts) or 1


def moe_apply(p, cfg: ArchConfig, x, *, capacity: Optional[int] = None):
    """Global-dispatch MoE (one card).  Token -> expert assignment is
    resolved as the graph engine resolves conflicting ops: the (expert,
    phase) pairs sorted, a segmented position count granting capacity slots
    in phase (= token) order, the losers dropped deterministically.
    Returns (out, aux_loss)."""
    B, S, d = x.shape
    T = B * S
    if capacity is None:
        capacity = moe_capacity(cfg, T)
    out, probs, gate_idx = _moe_local(p["router"], p["wi"], p["wg"], p["wo"], cfg,
                                      x.reshape(T, d), capacity)
    return out.reshape(B, S, d), _moe_aux(probs, gate_idx, cfg.moe.n_experts)


def moe_apply_shardmap(p, cfg: ArchConfig, x, *, mesh, capacity: Optional[int] = None,
                       sp: bool = False):
    """The sharded MoE: token-local dispatch on this rank's rows.

    ``x`` (B_local, S, d) is the rank's rows, alike on every rank of its
    "model" group; ``p`` holds the rank's blocks of the expert weights as
    the reference's ``shard_map`` hands them over: router (d / n_dp, e), wi
    and wg (e, d / n_dp, F / n_model), wo (e, F / n_model, d / n_dp).  Per
    rank, as the reference's body:

    * the FSDP blocks gathered over the mesh's data axes (router at dim 0,
      wi and wg at 1, wo at 2; the gather's backward is a reduce-scatter);
    * ``_moe_local`` over the rank's B_local × S tokens, capacity
      ``int(factor · k · T_local / e) or 1``;
    * the TP partial output summed over "model" in f32, then cast (its
      backward the identity: what follows is computed alike on every model
      rank), and the values entering the TP'd FFN summed over "model" in
      the backward (``enter``);
    * the balancing loss averaged over the data axes (forward the mean,
      backward 1 / n_dp to each rank's own).

    With ``sp`` (the sequence-parallel layout) ``x`` is this rank's block of
    S / M tokens of its rows: it is all-gathered over "model" first (the
    backward one's own block, since the gradient of the whole sequence comes
    out alike on every model rank), so the dispatch is the same as without
    ``sp``, and the sum over "model" is a reduce-scatter along S (backward
    an all-gather) onto the rank's tokens.

    Returns (out, of ``x``'s shape, aux)."""
    if sp:
        x = C.gather(x, mesh, "model", 1, grad="slice")
    Bl, S, d = x.shape
    e = cfg.moe.n_experts
    cap = capacity or moe_capacity(cfg, Bl * S)
    dp_axes = data_axes(mesh)
    router = C.gather(p["router"], mesh, dp_axes, 0)
    wi = C.gather(p["wi"], mesh, dp_axes, 1)
    wg = C.gather(p["wg"], mesh, dp_axes, 1)
    wo = C.gather(p["wo"], mesh, dp_axes, 2)
    out, probs, gate_idx = _moe_local(
        router, wi, wg, wo, cfg, x.reshape(Bl * S, d), cap,
        enter=lambda t: C.reduce_backward(t, mesh, "model"))
    if sp:
        out = C.scatter(out.to(F32).reshape(Bl, S, d), mesh, "model", 1).to(x.dtype)
    else:
        out = C.reduce_forward(out.to(F32), mesh, "model").to(x.dtype).reshape(Bl, S, d)
    aux = C.reduce_forward(_moe_aux(probs, gate_idx, e), mesh, dp_axes) / axis_size(mesh,
                                                                                dp_axes)
    return out, aux

"""Residual blocks.

Port of ``repro.models.blocks``:

* ``attn``   — pre-norm attention + MLP or MoE FFN (dense transformers,
               mixtral and granite, the musicgen backbone, the text layers
               of llama-3.2-vision, and the shared block of zamba2);
* ``xattn``  — tanh-gated cross-attention to image tokens (llama-3.2-vision);
* ``rwkv6``  — Finch time-mix (data-dependent per-channel decay, strict
               readout + bonus) and channel-mix;
* ``mamba2`` — SSD block (causal conv, scalar-decay scan, gated norm).

Each kind has ``*_meta(cfg)`` and ``*_apply(params, cfg, x, ...)`` and a
decode-state initialiser.  The recurrent blocks run their prefill (S > 1)
through :func:`repro_torch.kernels.ssd_scan.ssd_scan`, which launches the
CUDA kernel for tensors on the card and takes the plain chunked version on
the CPU; ``scan_impl="reference"`` forces the plain version anywhere.  Their
one-token decode step is the plain ``linear_scan_step``, as it is jnp in the
reference.  ``shard=True`` runs the MoE FFN as the reference's
``moe_apply_shardmap`` on the ``mesh`` it is given (a ``ValueError``
without one).

``layout=`` (``layers``' module docstring) places an attention or
cross-attention block on a mesh.  A
:class:`~repro_torch.models.layers.SeqParallel` runs it in the
sequence-parallel layout on the rank's token block, with ``p`` the rank's
blocks of the layer's weights:
the block gathers them itself (:func:`sp_block_view`), so a caller that
checkpoints the block holds one layer's gathered weights at a time and
gathers them again when the backward recomputes it, as the reference's
remat does.

A :class:`~repro_torch.models.layers.DSharded` layout runs a recurrent
block (rwkv6, mamba2) in the d-sharded layout of ``lm.py``'s docstring:
``x`` is the rank's d block (B, S, d / M), ``p`` its blocks of the layer,
and the block deals its H heads over "model" in contiguous ranges
[⌊H m / M⌋, ⌊H (m + 1) / M⌋).  It gathers its normed inputs whole along d
(backward a reduce-scatter: each rank's heads read them) and projects them
onto its heads' channels only; each leaf whose "model" block is the rank's
channels stays that block, every other is gathered whole with its gradient
summed over "model" and sliced (:meth:`_HeadSplit.view`).  rwkv6 runs its
scan, bonus and per-head group norm on its heads, and ``wo``'s rows of its
channels give a (B, S, d) partial reduce-scattered onto its d block; its
channel mix runs ``cwk``/``cwv`` on its "model" block of d_ff, their partial
reduce-scattered, and ``cwr``'s column block gives the gate of its own d
block.  mamba2 takes ``in_proj``'s columns of its heads' z, x and dt and the
shared B and C (every rank computes those), its conv over its x channels
and B and C, its heads of ``A_log``, ``D`` and ``dt_bias``; the gated
RMSNorm's variance over the whole d_inner is an all-reduce over "model" of
the (B, S, 1) f32 sums of squares (backward a sum as well: each rank
normalises its own channels with it), and ``out_proj``'s rows of its
channels give the partial reduce-scattered.  At its end the block gathers
its heads' new state over "model" (padded to the largest share for the
all-gather, and trimmed), so the state leaves whole on every model rank.

A :class:`~repro_torch.models.layers.StripedCache` runs its decode step in
the striped-cache layout: ``x`` is alike on every model rank, ``p`` the
rank's blocks, which the block gathers
as :func:`sp_block_view` does (attention whole, the dense FFN's "model"
blocks, the MoE's as they are), so one layer's gathered weights are alive at
a time.  The recurrent blocks' decode step on a mesh reads its layer
gathered whole (:func:`whole_block_view`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan.ref import linear_scan_step
from ..parallel import collectives as C
from ..parallel.mesh import is_multi_pod
from ..parallel.spec import axis_index, axis_size, dealt
from ..parallel.spec import names as axis_names
from .config import ArchConfig
from .layers import (
    DSharded,
    SeqParallel,
    _split_heads,
    attn_apply,
    attn_meta,
    mlp_apply,
    mlp_meta,
    moe_apply,
    moe_apply_shardmap,
    moe_meta,
    norm_apply,
    norm_meta,
)
from .module import ParamMeta, build_pspecs, tree_map

F32 = torch.float32

_SCAN_IMPLS = {"chunked": None, "reference": "reference"}


def _pick_chunk(S: int, target: int = 64) -> int:
    """Largest power-of-two chunk ≤ target that divides S."""
    c = 1
    while c * 2 <= min(target, S) and S % (c * 2) == 0:
        c *= 2
    return c


def _scan(q, k, v, w, h0, *, chunk, strict, scalar_decay, scan_impl):
    """The prefill scan on contiguous operands, with the final state."""
    if scan_impl not in _SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {scan_impl!r}")
    return ssd_ops.ssd_scan(
        q.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
        chunk=_pick_chunk(q.shape[2], chunk), strict=strict, scalar_decay=scalar_decay,
        h0=h0, return_state=True, impl=_SCAN_IMPLS[scan_impl],
    )


def attn_block_meta(cfg: ArchConfig, *, moe: bool = False):
    return {
        "ln1": norm_meta(cfg),
        "attn": attn_meta(cfg),
        "ln2": norm_meta(cfg),
        "ffn": moe_meta(cfg) if moe else mlp_meta(cfg),
    }


def sp_block_view(p, meta, mesh, *, moe: bool = False):
    """A layer's blocks ``p`` (laid out by the specs of ``meta``, its meta
    tree) as the layer's sequence-parallel forward, or its striped-cache
    decode step, reads them: attention
    weights, norms and gates gathered whole over every axis (their
    gradients summed over "model" too, whose ranks hold different tokens);
    a dense FFN's leaves gathered over the data axes only, each rank keeping
    its "model" column and row blocks; an MoE FFN's blocks as they are
    (``moe_apply_shardmap`` gathers them)."""
    specs = build_pspecs(meta, multi_pod=is_multi_pod(mesh))
    out = {}
    for name in sorted(p):
        if name == "ffn" and moe:
            out[name] = p[name]
            continue
        model = "block" if name == "ffn" else "whole"
        out[name] = tree_map(lambda t, s: C.param_view(t, s, mesh, model=model), p[name],
                             specs[name])
    return out


def whole_block_view(p, meta, mesh):
    """A layer's blocks ``p`` (laid out by the specs of ``meta``) gathered
    whole, every model rank computing alike with them."""
    specs = build_pspecs(meta, multi_pod=is_multi_pod(mesh))
    return tree_map(lambda t, s: C.param_view(t, s, mesh, model="alike"), p, specs)


class _HeadSplit:
    """A rank's share of a recurrent layer in the d-sharded layout (the
    module docstring): the heads [lo, hi) of its contiguous deal over
    "model" (:func:`~repro_torch.parallel.spec.dealt`), their channels
    [lo · hd, hi · hd), and the collectives over the residual's d."""

    def __init__(self, layout: DSharded, n_heads: int, head_dim: int):
        self.mesh = layout.mesh
        self.n = axis_size(self.mesh, "model")
        self.deal = dealt(n_heads, self.n)
        self.lo, self.hi = self.deal[axis_index(self.mesh, "model")]
        self.hd = head_dim
        self.heads = slice(self.lo, self.hi)
        self.chans = slice(self.lo * head_dim, self.hi * head_dim)

    def chan_ranges(self, r: int, offset: int = 0, unit: int = None) -> list:
        """Rank ``r``'s [start, stop) of its heads' items, ``unit`` a head
        (``hd`` by default), from ``offset``."""
        unit = self.hd if unit is None else unit
        lo, hi = self.deal[r]
        return [(offset + lo * unit, offset + hi * unit)]

    def gather(self, x):
        """The residual's d block gathered whole along d; its backward sums
        every rank's share (each feeds its own heads)."""
        return C.gather(x, self.mesh, "model", x.dim() - 1)

    def scatter(self, out):
        """A (B, S, d) partial of the rank's heads or d_ff block summed over
        "model" onto the rank's d block (in f32 where ``out`` is narrower)."""
        return C.scatter(out, self.mesh, "model", out.dim() - 1)

    def view(self, p, meta, picks: dict):
        """The layer's blocks ``p`` as the rank's share reads them.  A leaf
        named in ``picks`` ({name: (dim, ranges of rank r)}) is the
        concatenation of its ranges along dim: where they are the leaf's
        "model" block on every rank, that block (``"block"``), else the leaf
        gathered whole with its gradient summed over "model" and sliced.
        Every other leaf is gathered whole, its gradient summed over "model"
        (each rank reads it for other heads)."""
        specs = build_pspecs(meta, multi_pod=is_multi_pod(self.mesh))
        out = {}
        for name in sorted(p):
            t, spec = p[name], specs[name]
            if name not in picks:
                out[name] = tree_map(lambda t, sp: C.param_view(t, sp, self.mesh, model="whole"),
                                     t, spec)
                continue
            dim, ranges = picks[name]
            entry = spec[dim] if dim < len(spec) else None
            if axis_names(entry) == ("model",):
                size = t.shape[dim]
                if all(ranges(r) == [(r * size, (r + 1) * size)] for r in range(self.n)):
                    out[name] = C.param_view(t, spec, self.mesh, model="block")
                    continue
            w = C.param_view(t, spec, self.mesh, model="whole")
            own = [w.narrow(dim, a, b - a) for a, b in ranges(axis_index(self.mesh, "model"))]
            out[name] = own[0] if len(own) == 1 else torch.cat(own, dim)
        return out

    def whole_heads(self, t, dim: int, unit: int = 1):
        """The rank's heads' items of ``t`` along ``dim`` (``unit`` a head)
        gathered over "model" into every head's: each rank's padded to the
        largest share for the all-gather, and trimmed after."""
        most = max(hi - lo for lo, hi in self.deal) * unit
        t = t.detach()
        have = t.shape[dim]
        if have < most:
            pad = list(t.shape)
            pad[dim] = most - have
            t = torch.cat([t, t.new_zeros(pad)], dim)
        every = C.all_gather(t.contiguous(), self.mesh, "model", dim)
        return torch.cat([every.narrow(dim, r * most, (hi - lo) * unit)
                          for r, (lo, hi) in enumerate(self.deal)], dim)


def attn_block_apply(p, cfg: ArchConfig, x, *, moe=False, positions=None, kv_cache=None,
                     attn_impl="chunked", shard=False, mesh=None,
                     block_q=512, block_k=512, layout=None):
    """Returns (x', new_cache, aux); aux is the MoE balancing loss, 0.0 for
    the dense MLP.  ``shard=True`` runs the MoE FFN as
    ``moe_apply_shardmap`` on ``mesh`` (``x`` this rank's rows, ``p["ffn"]``
    its blocks of the expert weights); it raises ``ValueError`` without a
    mesh, as the reference's shard_map does.  With a ``layout`` (see the
    module docstring) ``p`` is the rank's blocks of the layer, and an MoE
    FFN needs ``shard``: in a :class:`SeqParallel` one ``x`` is the rank's
    token block and ``positions`` their absolute positions, in a
    :class:`StripedCache` one ``kv_cache`` is the rank's stripe."""
    if moe and shard and mesh is None:
        raise ValueError("attn_block_apply(shard=True): moe_apply_shardmap needs a mesh "
                         "(pass mesh=, or run['mesh'] to the LM)")
    if layout is not None:
        if moe and not shard:
            raise ValueError("attn_block_apply(layout=...): an MoE FFN on a mesh runs as "
                             "moe_apply_shardmap (shard=True)")
        p = sp_block_view(p, attn_block_meta(cfg, moe=moe), layout.mesh, moe=moe)
    h, new_cache = attn_apply(
        p["attn"], cfg, norm_apply(p["ln1"], cfg, x),
        positions=positions, kv_cache=kv_cache, attn_impl=attn_impl,
        block_q=block_q, block_k=block_k, layout=layout,
    )
    x = x + h
    if moe and shard:
        f, aux = moe_apply_shardmap(p["ffn"], cfg, norm_apply(p["ln2"], cfg, x), mesh=mesh,
                                    sp=isinstance(layout, SeqParallel))
    elif moe:
        f, aux = moe_apply(p["ffn"], cfg, norm_apply(p["ln2"], cfg, x))
    else:
        f, aux = mlp_apply(p["ffn"], cfg, norm_apply(p["ln2"], cfg, x), layout), 0.0
    return x + f, new_cache, aux


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, hkv, max_len, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, dh), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# cross-attention block (vlm)
# ---------------------------------------------------------------------------

def xattn_block_meta(cfg: ArchConfig):
    return {
        "ln1": norm_meta(cfg),
        "attn": attn_meta(cfg, cross=True),
        "ln2": norm_meta(cfg),
        "ffn": mlp_meta(cfg),
        "ffn_gate": ParamMeta((1,), F32, (None,), "zeros"),
    }


def xattn_block_apply(p, cfg: ArchConfig, x, memory=None, kv_override=None, *,
                      attn_impl="chunked", layout=None):
    """Cross attention to ``memory`` (or to its precomputed K/V heads) and
    the MLP, each scaled by its tanh gate.  With neither given the attention
    is the reference's: its self-attention path with this block's weights
    (no gate on it).  With a ``layout`` ``p`` is the rank's blocks of the
    block's weights: in a :class:`SeqParallel` one the queries are the
    rank's token block and ``memory`` the whole image memory (the caller
    gathers its token axis over "model"), in a :class:`StripedCache` one
    ``kv_override`` is the rank's stripe of the image K/V."""
    if layout is not None:
        p = sp_block_view(p, xattn_block_meta(cfg), layout.mesh)
    h, _ = attn_apply(
        p["attn"], cfg, norm_apply(p["ln1"], cfg, x),
        memory=memory, kv_override=kv_override, attn_impl=attn_impl, layout=layout,
    )
    x = x + h
    f = mlp_apply(p["ffn"], cfg, norm_apply(p["ln2"], cfg, x), layout)
    return x + f * torch.tanh(p["ffn_gate"]).to(f.dtype)


def xattn_precompute_kv(p, cfg: ArchConfig, memory):
    """Project the (fixed) image memory to K/V heads once for decode."""
    k = _split_heads(memory @ p["attn"]["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(memory @ p["attn"]["wv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) block
# ---------------------------------------------------------------------------

def _rwkv_heads(cfg: ArchConfig):
    hd = cfg.ssm.head_dim
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the head dim {hd}")
    return cfg.d_model // hd, hd


def rwkv6_block_meta(cfg: ArchConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    lora = cfg.ssm.decay_lora
    H, hd = _rwkv_heads(cfg)
    return {
        "ln1": norm_meta(cfg),
        "ln2": norm_meta(cfg),
        # time-mix
        "mu": ParamMeta((5, d), F32, (None, None), "zeros"),   # r,k,v,w,g lerps
        "wr": ParamMeta((d, d), dt, ("fsdp", "tp"), "normal"),
        "wk": ParamMeta((d, d), dt, ("fsdp", "tp"), "normal"),
        "wv": ParamMeta((d, d), dt, ("fsdp", "tp"), "normal"),
        "wg": ParamMeta((d, d), dt, ("fsdp", "tp"), "normal"),
        "wo": ParamMeta((d, d), dt, ("tp", "fsdp"), "normal"),
        "w0": ParamMeta((d,), F32, (None,), "zeros"),          # decay base
        "wA": ParamMeta((d, lora), F32, ("fsdp", None), "normal"),
        "wB": ParamMeta((lora, d), F32, (None, "fsdp"), "normal"),
        "bonus": ParamMeta((H, hd), F32, (None, None), "zeros"),
        "gn": ParamMeta((d,), F32, (None,), "ones"),           # per-head groupnorm
        # channel-mix
        "cmu": ParamMeta((2, d), F32, (None, None), "zeros"),  # r,k lerps
        "cwr": ParamMeta((d, d), dt, ("fsdp", "tp"), "normal"),
        "cwk": ParamMeta((d, cfg.d_ff), dt, ("fsdp", "tp"), "normal"),
        "cwv": ParamMeta((cfg.d_ff, d), dt, ("tp", "fsdp"), "normal"),
    }


def _token_shift(x, prev):
    """x: (B,S,d); prev: (B,d) last token of the previous segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _onto_block(out, split):
    """A layer's output: as it is, or with a :class:`_HeadSplit` the rank's
    (B, S, d) partial summed over "model" onto its d block (a temporary, so
    that the partial is freed as soon as the residual takes it)."""
    return out if split is None else split.scatter(out)


def _rwkv6_picks(cfg: ArchConfig, split: _HeadSplit) -> dict:
    """The leaves of an rwkv6 layer that a rank of the d-sharded layout
    reads in part: its heads' columns of the r/k/v/g projections, of the
    decay's second factor and base, the bonus and the group norm, its
    heads' rows of ``wo``; the channel mix's "model" blocks (``cwr``'s
    columns of the rank's d block, ``cwk``'s of its d_ff block, ``cwv``'s
    rows)."""
    own = split.chan_ranges
    dm, fm = cfg.d_model // split.n, cfg.d_ff // split.n
    cols = (1, own)
    return {"wr": cols, "wk": cols, "wv": cols, "wg": cols, "wB": cols,
            "w0": (0, own), "gn": (0, own), "wo": (0, own),
            "bonus": (0, lambda r: own(r, unit=1)),
            "cwr": (1, lambda r: [(r * dm, (r + 1) * dm)]),
            "cwk": (1, lambda r: [(r * fm, (r + 1) * fm)]),
            "cwv": (0, lambda r: [(r * fm, (r + 1) * fm)])}


def rwkv6_block_apply(p, cfg: ArchConfig, x, state=None, *, chunk=64, scan_impl="chunked",
                      layout=None):
    """state: None (fresh) or dict(tshift (B,d), cshift (B,d), h (B,H,K,V)).
    S > 1 runs the chunked scan (prefill, state-continuing); S == 1 with a
    state runs the O(1) recurrent step (decode).  Returns (x', new_state).
    With a :class:`DSharded` ``layout`` (the module docstring) ``x`` is the
    rank's d block (B, S, d / M), ``p`` its blocks of the layer, and
    ``state`` and the new state whole on every model rank."""
    H, hd = _rwkv_heads(cfg)
    split = None if layout is None else _HeadSplit(layout, H, hd)
    if split is not None:
        p = split.view(p, rwkv6_block_meta(cfg), _rwkv6_picks(cfg, split))
        H = split.hi - split.lo
    xw = x if split is None else split.gather(x)
    B, S, d = xw.shape
    decode = state is not None and S == 1
    zeros = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    tprev = zeros if state is None else state["tshift"].to(x.dtype)
    cprev = zeros if state is None else state["cshift"].to(x.dtype)
    h0 = None if state is None else state["h"]
    if h0 is not None and split is not None:
        h0 = h0[:, split.heads].contiguous()

    # ---- time mix ----
    xa = norm_apply(p["ln1"], cfg, xw)
    xs = _token_shift(xa, tprev)
    mu = p["mu"].to(xa.dtype)

    def mix(i):
        return xa + (xs - xa) * mu[i]

    r = mix(0) @ p["wr"]
    kk = mix(1) @ p["wk"]
    vv = mix(2) @ p["wv"]
    g = F.silu((mix(4) @ p["wg"]).to(F32)).to(xa.dtype)
    # data-dependent decay (low-rank, Finch)
    dw = torch.tanh(mix(3).to(F32) @ p["wA"])
    dw = dw @ p["wB"] + p["w0"]
    w = torch.exp(-torch.exp(dw))                               # (B,S,d) in (0,1)

    def to_heads(t):
        return t.reshape(B, S, H, hd).transpose(1, 2)

    rh, kh, vh, wh = to_heads(r), to_heads(kk), to_heads(vv), to_heads(w.to(x.dtype))

    if decode:
        y1, hT = linear_scan_step(rh[:, :, 0], kh[:, :, 0], vh[:, :, 0], wh[:, :, 0], h0,
                                  strict=True)
        y = y1[:, :, None, :]
    else:
        y, hT = _scan(rh, kh, vh, wh, h0, chunk=chunk, strict=True, scalar_decay=False,
                      scan_impl=scan_impl)
    # bonus: y += (r · (u ⊙ k)) v
    u = p["bonus"].to(F32)
    s_bonus = torch.einsum("bhsk,hk,bhsk->bhs", rh.to(F32), u, kh.to(F32))
    y = y.to(F32) + s_bonus[..., None] * vh.to(F32)

    # per-head groupnorm (population variance, as jnp.var) then output proj
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.transpose(1, 2).reshape(B, S, H * hd) * p["gn"]
    y = y.to(x.dtype) * g
    x = x + _onto_block(y @ p["wo"], split)

    # ---- channel mix ----
    xc = norm_apply(p["ln2"], cfg, x if split is None else split.gather(x))
    xcs = _token_shift(xc, cprev)
    cmu = p["cmu"].to(xc.dtype)
    xr = xc + (xcs - xc) * cmu[0]
    xk = xc + (xcs - xc) * cmu[1]
    kc = xk @ p["cwk"]
    kc = torch.square(F.relu(kc.to(F32))).to(xc.dtype)
    vc = _onto_block(kc @ p["cwv"], split)
    rc = torch.sigmoid((xr @ p["cwr"]).to(F32)).to(xc.dtype)
    x = x + rc * vc

    if split is not None:  # every head's state, whole on every model rank
        hT = split.whole_heads(hT, 1)
    return x, {"tshift": xa[:, -1, :], "cshift": xc[:, -1, :], "h": hT}


def rwkv6_state_init(cfg: ArchConfig, batch: int, dtype, device):
    H, hd = _rwkv_heads(cfg)
    return {
        "tshift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cshift": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "h": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
    }


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model
    hd = cfg.ssm.head_dim
    if d_inner % hd:
        raise ValueError(f"d_inner {d_inner} is not a multiple of the head dim {hd}")
    return d_inner, d_inner // hd, hd, cfg.ssm.state


def mamba2_block_meta(cfg: ArchConfig):
    d, dt = cfg.d_model, cfg.param_dtype
    d_inner, H, hd, N = _mamba_dims(cfg)
    conv_dim = d_inner + 2 * N
    return {
        "ln": norm_meta(cfg),
        "in_proj": ParamMeta((d, 2 * d_inner + 2 * N + H), dt, ("fsdp", "tp"), "normal"),
        "conv_w": ParamMeta((cfg.ssm.conv, conv_dim), F32, (None, "tp"), "normal", scale=0.5),
        "conv_b": ParamMeta((conv_dim,), F32, ("tp",), "zeros"),
        "A_log": ParamMeta((H,), F32, (None,), "zeros"),
        "D": ParamMeta((H,), F32, (None,), "ones"),
        "dt_bias": ParamMeta((H,), F32, (None,), "zeros"),
        "gn": ParamMeta((d_inner,), F32, ("tp",), "ones"),
        "out_proj": ParamMeta((d_inner, d), dt, ("tp", "fsdp"), "normal"),
    }


def _causal_conv(x, w, b, prev):
    """x: (B,S,C); w: (K,C) depthwise; prev: (B,K-1,C) left context.  The
    taps are cast to x's dtype and summed in order in that dtype."""
    K = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([prev, x], dim=1)                           # (B, S+K-1, C)
    out = xp[:, 0:S, :] * w[0][None, None, :].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(K - 1):, :]


def _mamba2_picks(cfg: ArchConfig, split: _HeadSplit) -> dict:
    """The leaves of a mamba2 layer that a rank of the d-sharded layout
    reads in part: ``in_proj``'s columns of its heads' z, x and dt and the
    shared B and C; the conv's channels of its x and B and C; its heads of
    ``A_log``, ``D``, ``dt_bias``; its channels of the gated norm's scale and
    its rows of ``out_proj``."""
    d_inner, H, hd, N = _mamba_dims(cfg)
    own = split.chan_ranges

    def heads(r):
        return own(r, unit=1)

    def conv(r):
        return own(r) + [(d_inner, d_inner + 2 * N)]

    def proj(r):
        return own(r) + [(a + d_inner, b + d_inner) for a, b in conv(r)] + \
            own(r, offset=2 * d_inner + 2 * N, unit=1)

    return {"in_proj": (1, proj), "conv_w": (1, conv), "conv_b": (0, conv),
            "A_log": (0, heads), "D": (0, heads), "dt_bias": (0, heads),
            "gn": (0, own), "out_proj": (0, own)}


def mamba2_block_apply(p, cfg: ArchConfig, x, state=None, *, chunk=64, scan_impl="chunked",
                       layout=None):
    """state: None (fresh) or dict(conv (B,K-1,C), h (B,H,N,hd)).  S > 1 runs
    the chunked scan; S == 1 with a state runs the decode step.  Returns
    (x', new_state).  With a :class:`DSharded` ``layout`` (the module
    docstring) ``x`` is the rank's d block, ``p`` its blocks of the layer,
    and ``state`` and the new state whole on every model rank."""
    d_inner, H, hd, N = _mamba_dims(cfg)
    split = None if layout is None else _HeadSplit(layout, H, hd)
    inner = d_inner
    if split is not None:
        p = split.view(p, mamba2_block_meta(cfg), _mamba2_picks(cfg, split))
        H = split.hi - split.lo
        inner = H * hd
    xw = x if split is None else split.gather(x)
    B, S, d = xw.shape
    decode = state is not None and S == 1

    xa = norm_apply(p["ln"], cfg, xw)
    proj = xa @ p["in_proj"]
    z, xbc, dt_raw = torch.split(proj, [inner, inner + 2 * N, H], dim=-1)

    if state is None:
        conv_prev = torch.zeros((B, cfg.ssm.conv - 1, inner + 2 * N), dtype=xbc.dtype,
                                device=x.device)
    else:
        conv_prev = state["conv"].to(xbc.dtype)
        if split is not None:
            conv_prev = torch.cat([conv_prev[..., split.chans], conv_prev[..., d_inner:]], -1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_prev)
    xbc = F.silu(xbc.to(F32)).to(x.dtype)
    xin, Bmat, Cmat = torch.split(xbc, [inner, N, N], dim=-1)

    dt_a = F.softplus(dt_raw.to(F32) + p["dt_bias"])            # (B,S,H)
    a = torch.exp(-torch.exp(p["A_log"])[None, None] * dt_a)    # (B,S,H) decay

    # onto the generalized scan: per head, k = B, q = C (shared), v = dt * x;
    # B and C are broadcast over heads and materialised, as in the reference;
    # the decay stays one value per (b, h, t), which the scan's scalar mode
    # takes as is and its plain version broadcasts over N
    xh = xin.reshape(B, S, H, hd).transpose(1, 2)               # (B,H,S,hd)
    vh = xh * dt_a.transpose(1, 2)[..., None].to(xh.dtype)
    kh = Bmat[:, None].expand(B, H, S, N).to(xh.dtype)
    qh = Cmat[:, None].expand(B, H, S, N).to(xh.dtype)
    wh = a.transpose(1, 2)[..., None].to(xh.dtype)             # (B,H,S,1)

    h0 = None if state is None else state["h"]
    if h0 is not None and split is not None:
        h0 = h0[:, split.heads].contiguous()
    if decode:
        y1, hT = linear_scan_step(qh[:, :, 0], kh[:, :, 0], vh[:, :, 0], wh[:, :, 0], h0)
        y = y1[:, :, None, :]
    else:
        # one decay per (b, h, t): the kernel's scalar mode is exact here
        y, hT = _scan(qh, kh, vh, wh, h0, chunk=chunk, strict=False, scalar_decay=True,
                      scan_impl=scan_impl)

    y = y.to(F32) + p["D"][None, :, None, None] * xh.to(F32)
    y = y.transpose(1, 2).reshape(B, S, inner)

    # gated RMSNorm (f32 gate), then the out projection; d-sharded, its
    # variance sums every rank's channels
    y = y * F.silu(z.to(F32))
    if split is None:
        var = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        var = C.psum(torch.sum(y * y, dim=-1, keepdim=True), split.mesh, "model") / d_inner
    y = y * torch.rsqrt(var + 1e-6) * p["gn"]
    if split is not None:  # every head's state, whole on every model rank
        conv_state = torch.cat([split.whole_heads(conv_state[..., :inner], 2, hd),
                                conv_state[..., inner:].detach()], -1)
        hT = split.whole_heads(hT, 1)
    return x + _onto_block(y.to(x.dtype) @ p["out_proj"], split), {"conv": conv_state, "h": hT}


def mamba2_state_init(cfg: ArchConfig, batch: int, dtype, device):
    d_inner, H, hd, N = _mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.conv - 1, d_inner + 2 * N), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, H, N, hd), dtype=F32, device=device),
    }

"""Core layers of the dense LM family: norm, RoPE, embeddings, attention, MLP.

Port of the dense subset of ``repro.models.layers``.  Every layer is a
(meta, apply) pair of plain functions on tensors.  Activation layout is
(B, S, d_model); attention internals use (B, H, S, Dh).  Reductions are
taken in f32, as in the reference.

The full-sequence attention goes through the port's
:func:`repro_torch.kernels.flash_attention.attention`, which dispatches on
the device: on the card both ``attn_impl="chunked"`` (the reference's
memory-linear XLA formulation) and ``attn_impl="kernel"`` launch the one
CUDA kernel the port has, and on the CPU both take the plain chunked
version.  ``attn_impl="reference"`` forces the plain version on any device.
Decode attention and every projection are plain tensor code, as they are
jnp in the reference.  MoE and cross-attention wait for later slices
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops
from .config import ArchConfig
from .module import ParamMeta

F32 = torch.float32

_ATTN_IMPLS = {"chunked": None, "kernel": None, "reference": "reference"}


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
    """One token table (and head); the multi-codebook tables of the audio
    family wait for its slice."""
    vp = padded_vocab(cfg)
    m = {"tok": ParamMeta((vp, cfg.d_model), cfg.param_dtype, ("tp", "fsdp"), "embed",
                          scale=0.02)}
    if not cfg.tie_embeddings:
        m["head"] = ParamMeta((cfg.d_model, vp), cfg.param_dtype, ("fsdp", "tp"), "normal")
    return m


def embed_apply(p, cfg: ArchConfig, tokens):
    """tokens: (B, S) integer."""
    return p["tok"][tokens.long()]


def logits_apply(p, cfg: ArchConfig, x):
    """x: (B, S, d) -> (B, S, padded_vocab)."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["tok"].to(cfg.param_dtype))
    return torch.einsum("bsd,dv->bsv", x, p["head"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_meta(cfg: ArchConfig):
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
    return m


def _split_heads(x, n_heads, d_head):
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, d_head).transpose(1, 2)


def _decode_attention(q, k, v, valid, start=None):
    """q: (B,Hq,1,Dh); k,v: (B,Hkv,T,Dh); attend over slots < valid.

    ``start`` (B,) optionally masks slots below a per-sequence admission
    offset: the serving engine reuses cache slots, and a re-admitted
    sequence must not attend to its predecessor's stale rows."""
    B, Hq, S, Dh = q.shape
    _, Hkv, T, _ = k.shape
    g = Hq // Hkv
    qf = q.reshape(B, Hkv, g, S, Dh).to(F32) * (Dh ** -0.5)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k.to(F32))
    slot = torch.arange(T, device=q.device)
    mask = slot[None, :] < torch.as_tensor(valid, device=q.device).expand(B)[:, None]
    if start is not None:
        mask = mask & (slot[None, :] >= start[:, None])
    s = torch.where(mask[:, None, None, None, :], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(F32))
    return out.reshape(B, Hq, S, Dh).to(q.dtype)


def attn_apply(
    p,
    cfg: ArchConfig,
    x,                      # (B, S, d)
    *,
    positions=None,         # (S,) absolute positions (for rope)
    kv_cache=None,          # optional dict(k=(B,Hkv,T,Dh), v=..., len=(), start=(B,))
    attn_impl: str = "chunked",
    block_k: int = 512,
    block_q: int = 512,
):
    """Returns (out, new_kv_cache or None).

    Decode caches are ring buffers of capacity T (= window for SWA archs):
    the step writes at ``len % T`` and attends over ``min(len+1, T)`` valid
    slots.  The port writes the new row into the given cache tensors in
    place (the reference returns updated copies); the returned dict holds
    the same tensors and the advanced length.
    """
    if attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = _split_heads(x @ p["wq"], hq, dh)
    k = _split_heads(x @ p["wk"], hkv, dh)
    v = _split_heads(x @ p["wv"], hkv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(hq, 1, dh).to(q.dtype)
        k = k + p["bk"].reshape(hkv, 1, dh).to(k.dtype)
        v = v + p["bv"].reshape(hkv, 1, dh).to(v.dtype)

    if cfg.rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        # decode (S == 1): ring-buffer write + attend over the valid slots
        ck, cv = kv_cache["k"], kv_cache["v"]
        T = ck.shape[2]
        idx = kv_cache["len"]
        write = torch.remainder(idx, T).reshape(1).long()
        ck.index_copy_(2, write, k)
        cv.index_copy_(2, write, v)
        new_cache = {"k": ck, "v": cv, "len": idx + S}
        valid = torch.clamp(idx + S, max=T)
        out = _decode_attention(q, ck, cv, valid, start=kv_cache.get("start"))
    else:
        out = flash_ops.attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=cfg.window,
            impl=_ATTN_IMPLS[attn_impl], block_q=block_q, block_k=block_k,
        )

    out = out.transpose(1, 2).reshape(B, S, hq * dh)
    return out @ p["wo"], new_cache


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


def mlp_apply(p, cfg: ArchConfig, x):
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
    if cfg.mlp_bias:
        out = out + p["bo"].to(out.dtype)
    return out

"""Residual blocks.

Port of ``repro.models.blocks`` for the dense family: the pre-norm
attention + MLP block and its decode-cache initialiser.  The other block
kinds (``xattn``, ``rwkv6``, ``mamba2``) wait for the slices of their
families and raise ``NotImplementedError``; the MoE FFN waits too, and
``LM`` refuses its family.
"""

from __future__ import annotations

import torch

from .config import ArchConfig
from .layers import attn_apply, attn_meta, mlp_apply, mlp_meta, norm_apply, norm_meta


def _later(kind: str):
    raise NotImplementedError(f"{kind} blocks: ROADMAP.md queue 1, the other LM families")


def attn_block_meta(cfg: ArchConfig):
    return {
        "ln1": norm_meta(cfg),
        "attn": attn_meta(cfg),
        "ln2": norm_meta(cfg),
        "ffn": mlp_meta(cfg),
    }


def attn_block_apply(p, cfg: ArchConfig, x, *, positions=None, kv_cache=None,
                     attn_impl="chunked", block_q=512, block_k=512):
    """Returns (x', new_cache, aux); aux is the MoE balancing loss of the
    reference's signature, 0.0 for the dense MLP."""
    h, new_cache = attn_apply(
        p["attn"], cfg, norm_apply(p["ln1"], cfg, x),
        positions=positions, kv_cache=kv_cache, attn_impl=attn_impl,
        block_q=block_q, block_k=block_k,
    )
    x = x + h
    f = mlp_apply(p["ffn"], cfg, norm_apply(p["ln2"], cfg, x))
    return x + f, new_cache, 0.0


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype, device):
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, hkv, max_len, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, dh), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def xattn_block_meta(cfg: ArchConfig):
    _later("cross-attention (vlm)")


def rwkv6_block_meta(cfg: ArchConfig):
    _later("rwkv6")


def mamba2_block_meta(cfg: ArchConfig):
    _later("mamba2")

"""Architecture configuration for the assigned model families.

Port of ``repro.models.config``: the same dataclasses, with torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int            # per-expert hidden width
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 64           # N (mamba2) / head K dim (rwkv6)
    head_dim: int = 64        # P per head
    conv: int = 4             # causal conv width (mamba2)
    decay_lora: int = 64      # low-rank width of the data-dependent decay (rwkv6)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None     # default d_model // n_heads
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_bias: bool = False
    act: str = "swiglu"              # swiglu | gelu
    mlp_bias: bool = False
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    window: Optional[int] = None     # sliding-window attention
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): mamba stack with a shared attention block
    shared_attn_every: Optional[int] = None
    # vlm (llama-3.2-vision-style): cross-attention to image tokens
    xattn_every: Optional[int] = None
    n_img_tokens: int = 4096
    # audio (musicgen-style): multi-codebook token streams
    n_codebooks: int = 1
    # numerics
    dtype: str = "bfloat16"          # parameter/activation dtype
    # which layer kinds make up the stack; derived in __post_init__-style
    max_seq: int = 8192              # positional table cap (abs-pos archs)

    @property
    def param_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: constant-size or windowed state."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)


def reduced_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Same family, tiny dims: one fwd/train step must run on CPU."""
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            expert_ff=64,
            capacity_factor=2.0,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(state=16, head_dim=16, conv=4, decay_lora=8)
    return cfg.scaled(
        n_layers=(
            min(cfg.n_layers, 4)
            if cfg.shared_attn_every is None and cfg.xattn_every is None
            else 6
        ),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32 if cfg.n_heads else None,
        d_ff=256,
        vocab=512,
        window=min(cfg.window, 32) if cfg.window else None,
        moe=moe,
        ssm=ssm,
        shared_attn_every=3 if cfg.shared_attn_every else None,
        xattn_every=3 if cfg.xattn_every else None,
        n_img_tokens=16,
        max_seq=128,
        dtype="float32",
    )

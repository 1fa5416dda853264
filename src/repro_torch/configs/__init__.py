"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro.configs`` (the same ten published configurations, kept as
data in this package, and the input-shape cells ``SHAPES`` with
``cell_is_runnable``, copies of ``src/repro/configs/__init__.py:29-51``).  Each module exports ``CONFIG`` and the registry
derives the reduced smoke config via
``repro_torch.models.config.reduced_for_smoke``.  Every family runs in the
port (``repro_torch.models.LM``), on one card or on a mesh.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig, reduced_for_smoke

_MODULES = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-7b": "qwen2_7b",
    "starcoder2-15b": "starcoder2_15b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "rwkv6-3b": "rwkv6_3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "zamba2-1.2b": "zamba2_1_2b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_NAMES = tuple(_MODULES)

# input-shape cells shared by the LM family (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return reduced_for_smoke(get_config(name))



def cell_is_runnable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k requires sub-quadratic attention (DESIGN.md §5)."""
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True

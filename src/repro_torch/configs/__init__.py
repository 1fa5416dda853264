"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro.configs`` (the same ten published configurations, kept as
data in this package).  Each module exports ``CONFIG`` and the registry
derives the reduced smoke config via
``repro_torch.models.config.reduced_for_smoke``.  Every family runs in the
port (``repro_torch.models.LM``); only MoE experts over several cards wait
for a multi-card slice (ROADMAP.md queue 1).
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


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return reduced_for_smoke(get_config(name))


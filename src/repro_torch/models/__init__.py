"""The LM half of the port: layers, blocks and decoder.

Port of ``repro.models`` for every family: dense, moe (mixtral, granite),
ssm (rwkv6), hybrid (zamba2: mamba2 with a shared attention block), vlm
(llama-3.2-vision: gated cross attention to image tokens) and audio
(musicgen: multi-codebook tokens), on one card or on the ranks of a
(data, model) mesh (the MoE FFN then as the reference's
``moe_apply_shardmap``).  See ``lm.py``.
"""

from .config import ArchConfig, MoEConfig, SSMConfig, reduced_for_smoke
from .lm import LM, params_from_numpy, params_to_numpy

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "reduced_for_smoke", "LM",
           "params_from_numpy", "params_to_numpy"]

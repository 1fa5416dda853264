"""The LM half of the port: layers, blocks and decoder.

Port of ``repro.models`` for the dense, ssm (rwkv6) and hybrid (zamba2:
mamba2 with a shared attention block) families; moe, vlm and audio still
raise ``NotImplementedError``.  See ``lm.py``.
"""

from .config import ArchConfig, MoEConfig, SSMConfig, reduced_for_smoke
from .lm import LM, params_from_numpy, params_to_numpy

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "reduced_for_smoke", "LM",
           "params_from_numpy", "params_to_numpy"]

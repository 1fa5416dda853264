"""The LM half of the port: the dense family's layers, blocks and decoder.

Port of ``repro.models`` for ``family == "dense"``; see ``lm.py``.
"""

from .config import ArchConfig, MoEConfig, SSMConfig, reduced_for_smoke
from .lm import LM, params_from_numpy, params_to_numpy

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "reduced_for_smoke", "LM",
           "params_from_numpy", "params_to_numpy"]

from .ops import masked_compact, probe_place
from .ref import masked_compact_reference, probe_place_reference

__all__ = [
    "masked_compact",
    "probe_place",
    "masked_compact_reference",
    "probe_place_reference",
]

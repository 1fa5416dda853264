from .ops import hash_probe
from .ref import hash_probe_reference

__all__ = ["hash_probe", "hash_probe_reference"]

"""Serving for the port's LM half: the wait-free paged KV table and the
continuous-batching engine.  Port of ``repro.serving``."""

from .engine import Request, ServingEngine
from .paged_cache import PagedKVManager

__all__ = ["PagedKVManager", "ServingEngine", "Request"]

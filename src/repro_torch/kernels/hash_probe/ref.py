"""Plain PyTorch version of the batched hash probe.

The semantics of ``repro_torch.core.locate._locate`` specialized to the
vertex table with every lane active: for each query key, walk the triangular
probe chain until the key or an empty slot is found (bounded by MAX_PROBES).
Vectorized over the queries as ``MAX_PROBES`` gather steps.
"""

from __future__ import annotations

import torch

from ...core.hashing import hash_vertex, probe_slot
from ...core.types import EMPTY_KEY, MAX_PROBES


def hash_probe_reference(table_keys: torch.Tensor, query_keys: torch.Tensor):
    """Returns (found_slot, insert_slot): i32[n] each, -1 where absent/full."""
    cap = table_keys.shape[0]
    n = query_keys.shape[0]
    home = hash_vertex(query_keys, cap)
    found = torch.full((n,), -1, dtype=torch.int32, device=query_keys.device)
    empty = torch.full((n,), -1, dtype=torch.int32, device=query_keys.device)
    for step in range(MAX_PROBES):
        pending = (found < 0) & (empty < 0)
        s = probe_slot(home, step, cap)
        k = table_keys[s.long()]
        found = torch.where(pending & (k == query_keys), s, found)
        empty = torch.where(pending & (k == EMPTY_KEY) & (k != query_keys), s, empty)
    return found, empty

"""Launch wrapper for the CUDA hash probe (``csrc/hash_probe.cu``).

Replaces the Pallas kernel ``repro/kernels/hash_probe/kernel.py::hash_probe``.
What bounds it is dependent memory latency, not bytes: a query's key, then
one dependent load a probe step, and almost every query stops at its first.
The note in the CUDA source says how it is laid out, and which designs did
not beat it.
:func:`latency_floor` launches the same grid with less work, to measure what
no probe can go below.
"""

from __future__ import annotations

import torch

from .. import _build


def hash_probe(table_keys: torch.Tensor, query_keys: torch.Tensor):
    """(found i32[n], empty i32[n]) for int32 CUDA tensors; the table's
    capacity must be a power of two."""
    _build.require_cuda("hash_probe", table_keys, query_keys)
    if table_keys.dtype != torch.int32 or query_keys.dtype != torch.int32:
        raise TypeError("hash_probe: table and queries must be int32")
    cap = table_keys.shape[0]
    if table_keys.dim() != 1 or query_keys.dim() != 1 or cap & (cap - 1):
        raise ValueError("hash_probe: 1-d tensors and a power-of-two table")
    n = query_keys.shape[0]
    found = torch.empty(n, dtype=torch.int32, device=query_keys.device)
    empty = torch.empty(n, dtype=torch.int32, device=query_keys.device)
    code = _build.library().rt_hash_probe(
        table_keys.data_ptr(), cap, query_keys.data_ptr(), n,
        found.data_ptr(), empty.data_ptr(), _build.stream_ptr(query_keys),
    )
    _build.check(code, "rt_hash_probe")
    hash_probe.launches += 1
    hash_probe.calls += 1
    return found, empty


hash_probe.launches = 0
hash_probe.calls = 0


FLOOR_MODES = ("empty", "one dependent load")


def latency_floor(table_keys: torch.Tensor, query_keys: torch.Tensor, mode: str) -> torch.Tensor:
    """The probe's grid with less work, for measurement (not counted as a
    launch): ``"empty"`` returns at once; ``"one dependent load"`` reads
    each query and then its home slot, and writes that slot's key."""
    _build.require_cuda("hash_probe", table_keys, query_keys)
    n = query_keys.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=query_keys.device)
    code = _build.library().rt_hash_probe_floor(
        table_keys.data_ptr(), table_keys.shape[0], query_keys.data_ptr(), n,
        FLOOR_MODES.index(mode), out.data_ptr(), _build.stream_ptr(query_keys))
    _build.check(code, "rt_hash_probe_floor")
    return out

"""Hash mixing and probe sequences for the open-addressing tables.

Port of ``repro.core.hashing``: the MurmurHash3 finalizer on 32-bit lanes,
its edge-key combination, power-of-two home slots and the triangular probe
sequence, plus the numpy twins the host rehash reads.

torch on the CPU has no ``>>`` for ``uint32``, so the tensor versions work in
int64 holding values in ``[0, 2**32)``.  A product of two such values can
reach 2**64 and overflow int64; each multiply by a constant is therefore split
into the constant's 16-bit halves, which keeps every intermediate below 2**49
and the result exact modulo 2**32 (pinned against the numpy twins in
``tests/test_torch_hashing.py``).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` without int64
    overflow: ``x*c = x*c_lo + ((x*c_hi) mod 2**16) << 16`` modulo 2**32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Finalizer from MurmurHash3 (public domain): int64 tensor holding the
    uint32 hash of the int32 keys ``x``."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _mix32_np(x: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`_mix32` (uint32 wraparound)."""
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def vertex_hash32_np(key: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`vertex_hash32`."""
    return _mix32_np(key)


def edge_hash32_np(us: np.ndarray, vs: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`edge_hash32`."""
    return _mix32_np(us.astype(np.uint32) * np.uint32(0x9E3779B9) + _mix32_np(vs))


def vertex_hash32(key: torch.Tensor) -> torch.Tensor:
    """The full 32-bit vertex hash, as int64 in ``[0, 2**32)``."""
    return _mix32(key)


def edge_hash32(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The full 32-bit edge hash (int64 in ``[0, 2**32)``); directed."""
    uu = u.to(torch.int64) & _M32
    return _mix32((_mul32(uu, 0x9E3779B9) + _mix32(v)) & _M32)


def hash_vertex(key: torch.Tensor, capacity: int) -> torch.Tensor:
    """Home slot (int32) for a vertex key in a power-of-two table."""
    return (vertex_hash32(key) & (capacity - 1)).to(torch.int32)


def hash_edge(u: torch.Tensor, v: torch.Tensor, capacity: int) -> torch.Tensor:
    """Home slot (int32) for an edge key pair (u, v); directed."""
    return (edge_hash32(u, v) & (capacity - 1)).to(torch.int32)


def probe_slot(home: torch.Tensor, step: int, capacity: int) -> torch.Tensor:
    """Triangular probing: home + step*(step+1)/2 mod capacity.

    For power-of-two capacities triangular probing visits every slot.
    """
    off = (step * (step + 1)) // 2
    return (home + off) & (capacity - 1)

"""Core types for the wait-free concurrent graph engine, on torch tensors.

Port of ``repro.core.types``.  The paper's shared-memory structures map onto
fixed-size int32/bool tensors exactly as in the JAX package:

* ``VNode{val, vnext, enext, marked}``  -> open-addressing vertex table with a
  ``live`` bit (inverse of ``marked``) and an ``inc`` incarnation counter.
* ``ENode{val, enext, marked}``         -> open-addressing edge table keyed by
  ``(u_key, v_key)`` carrying the incarnations of both endpoints at bind time.
* ``ODA`` (operation descriptor array)  -> an :class:`OpBatch` of
  ``(phase, op_type, u, v)`` descriptor columns.

The engine functions never write into a tensor of the state they were given:
the host wrapper keeps the pre-state alive for transactional grow-and-retry,
so every write-back works on a clone.

:func:`state_from_numpy` / :func:`state_to_numpy` carry a state across
packages as eight numpy columns, so a test can load one table into both
implementations and continue from it in each.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

# --- Operation codes (the paper's OpType enum) -------------------------------
OP_NOP = 0
OP_ADD_VERTEX = 1
OP_REMOVE_VERTEX = 2
OP_CONTAINS_VERTEX = 3
OP_ADD_EDGE = 4
OP_REMOVE_EDGE = 5
OP_CONTAINS_EDGE = 6

VERTEX_OPS = (OP_ADD_VERTEX, OP_REMOVE_VERTEX, OP_CONTAINS_VERTEX)
EDGE_OPS = (OP_ADD_EDGE, OP_REMOVE_EDGE, OP_CONTAINS_EDGE)

# Sentinel for an empty hash slot / absent incarnation.
EMPTY_KEY = -1
ABSENT_INC = -1
INT32_MAX = 2**31 - 1

# Bounded probe chain: the wait-free locate bound.  A chain that would exceed
# it makes the engine report failure, and the host grows the table.
MAX_PROBES = 32
MAX_INSERT_ROUNDS = 16
GROW_LOAD_FACTOR = 0.5

# --- Engine stats vector (same layout as the JAX package) ----------------------
N_STATS = 8
STAT_CONFLICTED = 0     # FPSP: ops on the slow path (lockfree: claim rounds)
STAT_V_CONFLICTS = 1    # FPSP: vertex-lane conflict-mask hits
STAT_E_CONFLICTS = 2    # FPSP: edge-lane conflict-mask hits
STAT_INSERTED = 3       # new physical slots claimed this batch
STAT_EDGE_DUP = 4       # duplicate (u, v) edge lanes (shard-invariant)
STAT_VOPS = 5           # vertex-op lanes in the batch (non-NOP)
STAT_EOPS = 6           # edge-op lanes in the batch (non-NOP)
STAT_CLAIM_ROUNDS = 7   # scatter-claim rounds consumed (helping bound)


def is_pow2(n: int) -> bool:
    """Power-of-two check for table capacities."""
    return n > 0 and (n & (n - 1)) == 0


class GraphState(NamedTuple):
    """State of the concurrent graph: eight tensors on one device.

    ``live=False`` with a retained key is a Harris "marked" node: logically
    deleted, physically present until a rehash reclaims it.
    """

    # vertex table (capacity Cv)
    v_key: torch.Tensor   # i32[Cv], EMPTY_KEY for empty slots
    v_live: torch.Tensor  # bool[Cv]
    v_inc: torch.Tensor   # i32[Cv], bumped on every dead->live transition

    # edge table (capacity Ce), keyed by (u_key, v_key)
    e_key_u: torch.Tensor  # i32[Ce]
    e_key_v: torch.Tensor  # i32[Ce]
    e_live: torch.Tensor   # bool[Ce]
    e_inc_u: torch.Tensor  # i32[Ce] endpoint incarnations at bind time
    e_inc_v: torch.Tensor  # i32[Ce]

    @property
    def v_capacity(self) -> int:
        return self.v_key.shape[0]

    @property
    def e_capacity(self) -> int:
        return self.e_key_u.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_key.device


class OpBatch(NamedTuple):
    """A batch of operation descriptors — the ODA.

    ``phase`` is the linearization order (unique int32 per op): the engine
    resolves every op exactly as if the batch ran sequentially in phase order.
    """

    op: torch.Tensor     # i32[n] in OP_*
    u: torch.Tensor      # i32[n] vertex key / edge source key
    v: torch.Tensor      # i32[n] edge destination key (ignored for vertex ops)
    phase: torch.Tensor  # i32[n] unique linearization stamps

    @property
    def size(self) -> int:
        return self.op.shape[0]


class ApplyResult(NamedTuple):
    state: GraphState
    success: torch.Tensor  # bool[n] per-op result, original batch order
    ok: torch.Tensor       # bool[] False => table overflow, host must grow+retry
    stats: torch.Tensor    # i32[N_STATS], indexed by the STAT_* constants


def make_state(
    v_capacity: int = 1024, e_capacity: int = 4096, device="cpu"
) -> GraphState:
    """Fresh empty graph with the given table capacities (powers of two)."""
    if not (is_pow2(v_capacity) and is_pow2(e_capacity)):
        raise ValueError("table capacities must be powers of two")
    i32 = torch.int32
    return GraphState(
        v_key=torch.full((v_capacity,), EMPTY_KEY, dtype=i32, device=device),
        v_live=torch.zeros((v_capacity,), dtype=torch.bool, device=device),
        v_inc=torch.full((v_capacity,), ABSENT_INC, dtype=i32, device=device),
        e_key_u=torch.full((e_capacity,), EMPTY_KEY, dtype=i32, device=device),
        e_key_v=torch.full((e_capacity,), EMPTY_KEY, dtype=i32, device=device),
        e_live=torch.zeros((e_capacity,), dtype=torch.bool, device=device),
        e_inc_u=torch.full((e_capacity,), ABSENT_INC, dtype=i32, device=device),
        e_inc_v=torch.full((e_capacity,), ABSENT_INC, dtype=i32, device=device),
    )


def make_batch(ops, us, vs=None, phase_base: int = 0, device="cpu") -> OpBatch:
    """Build an OpBatch from Python/numpy sequences; phases = base + iota."""
    op = torch.as_tensor(np.asarray(ops, dtype=np.int32), device=device)
    u = torch.as_tensor(np.asarray(us, dtype=np.int32), device=device)
    if vs is None:
        v = torch.zeros_like(u)
    else:
        v = torch.as_tensor(np.asarray(vs, dtype=np.int32), device=device)
    n = op.shape[0]
    phase = phase_base + torch.arange(n, dtype=torch.int32, device=device)
    return OpBatch(op=op, u=u, v=v, phase=phase)


_BOOL_FIELDS = ("v_live", "e_live")


def state_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu") -> GraphState:
    """A :class:`GraphState` from the eight columns of a state, keyed by field
    name (``GraphState._asdict()`` of either package, as numpy arrays)."""
    cols = {}
    for name in GraphState._fields:
        dtype = np.bool_ if name in _BOOL_FIELDS else np.int32
        cols[name] = torch.as_tensor(
            np.array(arrays[name], dtype=dtype), device=device
        )
    return GraphState(**cols)


def state_to_numpy(state: GraphState) -> Dict[str, np.ndarray]:
    """The eight columns of ``state`` as numpy arrays, keyed by field name."""
    return {name: getattr(state, name).cpu().numpy() for name in GraphState._fields}

"""Baseline engines matching the paper's comparison set (Fig. 4).

Port of ``repro.core.baselines``, on the port's ``fastpath._fast_apply``:

Paper baseline        -> analogue here
---------------------------------------------------------------------------
coarse lock [7]       -> ``apply_coarse``: host loop in phase order, one
                         ``_fast_apply`` per op with its result read back —
                         global serialization.
HoH / lazy locks [6,7]-> ``apply_serial``: one ``_fast_apply`` per op in
                         batch order (the reference's ``lax.scan``), nothing
                         read back until the end — device-side serialization
                         with a per-op locate.
lock-free [4]         -> ``apply_lockfree``: optimistic vectorized rounds;
                         per conflict group the minimum-phase op "wins the
                         CAS", losers retry next round.  System-wide progress
                         every round, but no per-op bound (lock-freedom).
                         The round loop runs on the host and reads one flag
                         a round (the reference's ``lax.while_loop``).
wait-free (paper)     -> ``repro_torch.core.engine.apply_batch``.
fast-path-slow-path   -> ``repro_torch.core.fastpath.apply_batch_fpsp``.

All five give results equal to the sequential oracle in phase order, and
each baseline's state, success bits, ``ok`` and stats equal those of the
reference's same engine; they differ in how (and in how many steps) they
get there, which is what the paper's Fig. 4 measures.  Plain tensor code:
the kernels they reach are the locates' ``hash_probe``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .fastpath import _fast_apply
from .hashing import hash_edge, hash_vertex
from .types import (
    INT32_MAX,
    N_STATS,
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    ApplyResult,
    GraphState,
    OpBatch,
)

_I32 = torch.int32


def _bucket_min(nb: int, buckets: torch.Tensor, phase: torch.Tensor, active: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-min of ``phase`` into ``nb`` buckets over the active lanes
    (inactive lanes add INT32_MAX to bucket 0, as the reference does)."""
    if out is None:
        out = torch.full((nb,), INT32_MAX, dtype=_I32, device=phase.device)
    idx = torch.where(active, buckets, 0).long()
    return out.scatter_reduce_(0, idx, torch.where(active, phase, INT32_MAX), "amin")


# ---------------------------------------------------------------------------
# lock-free: optimistic rounds, min-phase wins each conflict group
# ---------------------------------------------------------------------------


def apply_lockfree(state: GraphState, batch: OpBatch) -> ApplyResult:
    op, u, v, phase = batch.op, batch.u, batch.v, batch.phase
    n = op.shape[0]
    nb = max(2 * n, 64)
    dev = op.device

    is_vop = (op == OP_ADD_VERTEX) | (op == OP_REMOVE_VERTEX) | (op == OP_CONTAINS_VERTEX)
    is_eop = (op == OP_ADD_EDGE) | (op == OP_REMOVE_EDGE) | (op == OP_CONTAINS_EDGE)

    hv_u = hash_vertex(u, nb)
    hv_v = hash_vertex(v, nb)
    he = hash_edge(u, v, nb)
    hv_ul, hv_vl, he_l = hv_u.long(), hv_v.long(), he.long()

    success = torch.zeros(n, dtype=torch.bool, device=dev)
    pending = is_vop | is_eop
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    rounds = 0
    while bool(pending.any()):
        # min pending phase per vertex bucket (vertex ops + edge endpoints)
        pv = pending & is_vop
        pe = pending & is_eop
        vmin = _bucket_min(nb, hv_u, phase, pv)
        _bucket_min(nb, hv_u, phase, pe, vmin)
        _bucket_min(nb, hv_v, phase, pe, vmin)
        emin = _bucket_min(nb, he, phase, pe)

        # an op "wins its CAS" iff it is the min across every bucket it
        # touches (>= on the endpoints: the edge op's own phase is there)
        v_win = pv & (vmin[hv_ul] == phase)
        e_win = pe & (vmin[hv_ul] >= phase) & (vmin[hv_vl] >= phase) & (emin[he_l] == phase)
        winner = v_win | e_win

        state, win_success, over, _, _ = _fast_apply(state, batch, winner)
        success = torch.where(winner, win_success, success)
        pending = pending & ~winner
        overflow = overflow | over
        rounds += 1
    # stats[0] = optimistic retry rounds (the lock-freedom-not-wait-freedom
    # witness); the other slots stay 0
    stats = torch.zeros(N_STATS, dtype=_I32, device=dev)
    stats[0] = rounds
    return ApplyResult(state=state, success=success, ok=~overflow, stats=stats)


# ---------------------------------------------------------------------------
# serialized: one op a step, in batch order (HoH / lazy locking analogue)
# ---------------------------------------------------------------------------


def _one(batch: OpBatch, i: int) -> OpBatch:
    return OpBatch(op=batch.op[i:i + 1], u=batch.u[i:i + 1], v=batch.v[i:i + 1],
                   phase=batch.phase[i:i + 1])


def apply_serial(state: GraphState, batch: OpBatch) -> ApplyResult:
    n = batch.size
    dev = batch.op.device
    lane = torch.ones(1, dtype=torch.bool, device=dev)
    successes, overs = [], []
    for i in range(n):
        state, succ, over, _, _ = _fast_apply(state, _one(batch, i), lane)
        successes.append(succ)
        overs.append(over.reshape(1))
    success = torch.cat(successes) if n else torch.zeros(0, dtype=torch.bool, device=dev)
    overflow = torch.cat(overs).any() if n else torch.zeros((), dtype=torch.bool, device=dev)
    stats = torch.zeros(N_STATS, dtype=_I32, device=dev)
    return ApplyResult(state=state, success=success, ok=~overflow, stats=stats)


# ---------------------------------------------------------------------------
# coarse: host loop in phase order, each op's result read back (global lock)
# ---------------------------------------------------------------------------


def apply_coarse(state: GraphState, batch: OpBatch) -> ApplyResult:
    n = batch.size
    dev = batch.op.device
    lane = torch.ones(1, dtype=torch.bool, device=dev)
    success = np.zeros(n, bool)
    overflow = False
    for i in np.argsort(batch.phase.cpu().numpy(), kind="stable"):
        state, succ, over, _, _ = _fast_apply(state, _one(batch, int(i)), lane)
        success[i] = bool(succ[0])
        overflow = overflow or bool(over)
    return ApplyResult(
        state=state,
        success=torch.as_tensor(success, device=dev),
        ok=torch.tensor(not overflow, device=dev),
        stats=torch.zeros(N_STATS, dtype=_I32, device=dev),
    )


ENGINES = {
    "coarse": apply_coarse,
    "serial": apply_serial,
    "lockfree": apply_lockfree,
}

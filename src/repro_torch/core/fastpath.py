"""Fast-path-slow-path (paper §3.4, after Kogan–Petrank / Timnat et al.).

Port of ``repro.core.fastpath`` for one shard.  An op needs none of the
wait-free engine's (key, phase) sorts and scans if nothing else in the batch
can interfere with it:

  * vertex op on key u — no other op in the batch touches u (as a vertex op
    or as an edge endpoint);
  * edge op on (u, v) — (u, v) is unique among edge ops AND neither endpoint
    has any vertex op in the batch (Fig. 3: a concurrent vertex op is exactly
    what moves an edge op's linearization point).

Such ops are resolved directly from the table (one locate, one masked write):
the fast path.  The conflicted remainder is resolved by the full wait-free
engine with the fast ops masked to NOPs.

The reference skips the slow pass with ``lax.cond`` when nothing conflicts.
Here that is a host branch on the conflict count (one read back per batch):
the skipped pass yields exactly the zero results, ``ok`` and zero stats the
reference's ``skip`` branch returns, so state and ``stats`` stay
byte-identical.

Under hash-prefix sharding (:mod:`repro_torch.core.sharding`) each shard's
sub-batch holds only its owned ops, and endpoint liveness arrives from the
cross-shard stabbing wave instead of the local table: the partitioned entry
point is :func:`settle_edges_fpsp`, whose conflict mask reduces to duplicate
``(u, v)`` detection because the stab answers already fold in every
concurrent vertex op.
"""

from __future__ import annotations

import torch

from . import engine
from .locate import claim_edge_slots, claim_vertex_slots, locate_edges, locate_vertices
from .types import (
    ABSENT_INC,
    INT32_MAX,
    N_STATS,
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_NOP,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    STAT_CLAIM_ROUNDS,
    STAT_CONFLICTED,
    STAT_E_CONFLICTS,
    STAT_EDGE_DUP,
    STAT_EOPS,
    STAT_INSERTED,
    STAT_V_CONFLICTS,
    STAT_VOPS,
    ApplyResult,
    GraphState,
    OpBatch,
)

_I32 = torch.int32


def _neighbour_dup(sorted_keys_eq: torch.Tensor, active_sorted: torch.Tensor) -> torch.Tensor:
    false1 = torch.zeros(1, dtype=torch.bool, device=active_sorted.device)
    return (torch.cat([false1, sorted_keys_eq]) | torch.cat([sorted_keys_eq, false1])) & active_sorted


def _dup_mask(keys: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Exact: True where ``keys[i]`` appears more than once among active
    lanes.  One stable sort + neighbour compare; inactive lanes carry the
    INT32_MAX sentinel and are masked out."""
    k = torch.where(active, keys, INT32_MAX)
    order = torch.argsort(k, stable=True)
    ks = k[order]
    dup_s = _neighbour_dup(ks[1:] == ks[:-1], active[order])
    return engine._unpermute(order, dup_s)


def _edge_dup_mask(u: torch.Tensor, v: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Exact duplicate-(u,v) detection via a lexicographic (two-pass stable)
    sort + neighbour compare."""
    uu = torch.where(active, u, INT32_MAX)
    vv = torch.where(active, v, INT32_MAX)
    p1 = torch.argsort(vv, stable=True)
    perm = p1[torch.argsort(uu[p1], stable=True)]
    us, vs = uu[perm], vv[perm]
    eq = (us[1:] == us[:-1]) & (vs[1:] == vs[:-1])
    return engine._unpermute(perm, _neighbour_dup(eq, active[perm]))


def _membership_count(query: torch.Tensor, ref: torch.Tensor, ref_active: torch.Tensor):
    """Exact count of each ``query`` key among active ``ref`` keys
    (searchsorted over the sorted reference; sentinels sort to the top and
    never match real keys)."""
    r = torch.sort(torch.where(ref_active, ref, INT32_MAX)).values
    lo = torch.searchsorted(r, query, side="left")
    hi = torch.searchsorted(r, query, side="right")
    return (hi - lo).to(_I32)


def _conflict_mask(batch: OpBatch):
    """True where an op may interact with another op in the same batch.
    Returns (conflicted, is_vop, is_eop, v_conf, e_conf, edge_dup); the
    per-reason masks feed the stats vector."""
    op, u, v = batch.op, batch.u, batch.v
    is_vop = engine._is_vop(op)
    is_eop = engine._is_eop(op)

    # vertex op conflicts: another vertex op on u, or any edge op touching u
    e_endpoints = torch.cat([u, v])
    e_ep_active = torch.cat([is_eop, is_eop])
    v_conf = is_vop & (
        _dup_mask(u, is_vop) | (_membership_count(u, e_endpoints, e_ep_active) > 0)
    )
    # edge op conflicts: duplicate (u,v), or any vertex op on either endpoint
    edge_dup = is_eop & _edge_dup_mask(u, v, is_eop)
    e_conf = edge_dup | (
        is_eop
        & ((_membership_count(u, u, is_vop) > 0) | (_membership_count(v, u, is_vop) > 0))
    )
    return (v_conf | e_conf) & (is_vop | is_eop), is_vop, is_eop, v_conf, e_conf, edge_dup


def _set_where(col: torch.Tensor, slot: torch.Tensor, write: torch.Tensor, values) -> torch.Tensor:
    """``col.at[where(write, slot, cap)].set(values, mode="drop")`` on a
    clone: only the written lanes reach the table."""
    out = col.clone()
    idx = slot[write].long()
    out[idx] = values[write] if isinstance(values, torch.Tensor) else values
    return out


def _fast_apply(state: GraphState, batch: OpBatch, fast: torch.Tensor):
    """Resolve conflict-free ops straight from the table state."""
    op, u, v = batch.op, batch.u, batch.v
    is_vop = engine._is_vop(op)
    is_eop = ~is_vop & (op != OP_NOP)
    fv = fast & is_vop
    fe = fast & is_eop

    # ---- vertices ----
    vloc = locate_vertices(state.v_key, torch.where(fv, u, INT32_MAX), fv)
    vlive = engine._gather_found(state.v_live, vloc, False)
    vinc = engine._gather_found(state.v_inc, vloc, ABSENT_INC)

    addv = fv & (op == OP_ADD_VERTEX)
    remv = fv & (op == OP_REMOVE_VERTEX)
    conv = fv & (op == OP_CONTAINS_VERTEX)
    v_success = (addv & ~vlive) | ((remv | conv) & vlive)

    # revive/insert on successful add; mark dead on successful remove
    wr = (addv | remv) & v_success & vloc.found
    v_live_new = _set_where(state.v_live, vloc.slot, wr, addv & v_success)
    v_inc_new = _set_where(state.v_inc, vloc.slot, wr, torch.where(addv, vinc + 1, vinc))
    # brand-new keys (not found): insert via scatter-claim (keys unique by
    # construction of the fast set)
    need_ins = addv & v_success & ~vloc.found
    v_key_new, new_slots, v_over, v_rounds = claim_vertex_slots(
        state.v_key, torch.where(need_ins, u, INT32_MAX), need_ins
    )
    placed = need_ins & (new_slots >= 0)
    v_live_new = _set_where(v_live_new, new_slots, placed, True)
    v_inc_new = _set_where(v_inc_new, new_slots, placed, 0)

    state = state._replace(v_key=v_key_new, v_live=v_live_new, v_inc=v_inc_new)

    # ---- edges ----
    # endpoints: table state is authoritative (no concurrent vertex ops on
    # them — that is the fast-path precondition)
    uloc = locate_vertices(state.v_key, torch.where(fe, u, INT32_MAX), fe)
    vloc2 = locate_vertices(state.v_key, torch.where(fe, v, INT32_MAX), fe)
    endpoint = (
        engine._gather_found(state.v_live, uloc, False),
        engine._gather_found(state.v_inc, uloc, ABSENT_INC),
        engine._gather_found(state.v_live, vloc2, False),
        engine._gather_found(state.v_inc, vloc2, ABSENT_INC),
    )
    state, e_success, e_over, e_ins, e_rounds = _fast_apply_edges(state, batch, fe, endpoint)

    success = torch.where(fv, v_success, torch.where(fe, e_success, False))
    overflow = vloc.overflow | uloc.overflow | vloc2.overflow | v_over | e_over
    n_ins = placed.sum().to(_I32) + e_ins
    return state, success, overflow, n_ins, v_rounds + e_rounds


def _fast_apply_edges(state: GraphState, batch: OpBatch, fe: torch.Tensor, endpoint):
    """The edge half of :func:`_fast_apply`, fed endpoint (live, inc)
    answers: read from the table by :func:`_fast_apply`, or settled at each
    op's phase by the cross-shard stabbing wave, in which case the fast-path
    precondition shrinks to "``(u, v)`` unique among this shard's edge ops".
    Returns ``(state', success, overflow, n_inserted, claim_rounds)``."""
    op, u, v = batch.op, batch.u, batch.v
    u_live, u_inc, v_live, v_inc = endpoint
    eligible = u_live & v_live & fe

    eloc = locate_edges(
        state.e_key_u, state.e_key_v,
        torch.where(fe, u, INT32_MAX), torch.where(fe, v, INT32_MAX), fe,
    )
    esafe = torch.where(eloc.found, eloc.slot, 0).long()
    e_valid = (
        eloc.found
        & state.e_live[esafe]
        & (state.e_inc_u[esafe] == u_inc)
        & (state.e_inc_v[esafe] == v_inc)
        & eligible
    )

    adde = fe & (op == OP_ADD_EDGE)
    reme = fe & (op == OP_REMOVE_EDGE)
    cone = fe & (op == OP_CONTAINS_EDGE)
    e_success = (adde & eligible & ~e_valid) | ((reme | cone) & e_valid)

    ewr = (adde | reme) & e_success & eloc.found
    e_live_new = _set_where(state.e_live, eloc.slot, ewr, adde & e_success)
    e_bu_new = _set_where(state.e_inc_u, eloc.slot, ewr, u_inc)
    e_bv_new = _set_where(state.e_inc_v, eloc.slot, ewr, v_inc)

    e_need_ins = adde & e_success & ~eloc.found
    e_ku_new, e_kv_new, e_new_slots, e_over, e_rounds = claim_edge_slots(
        state.e_key_u, state.e_key_v,
        torch.where(e_need_ins, u, INT32_MAX), torch.where(e_need_ins, v, INT32_MAX),
        e_need_ins,
    )
    e_placed = e_need_ins & (e_new_slots >= 0)
    e_live_new = _set_where(e_live_new, e_new_slots, e_placed, True)
    e_bu_new = _set_where(e_bu_new, e_new_slots, e_placed, u_inc)
    e_bv_new = _set_where(e_bv_new, e_new_slots, e_placed, v_inc)

    state = state._replace(
        e_key_u=e_ku_new, e_key_v=e_kv_new,
        e_live=e_live_new, e_inc_u=e_bu_new, e_inc_v=e_bv_new,
    )
    return state, e_success, eloc.overflow | e_over, e_placed.sum().to(_I32), e_rounds


def settle_edges_fpsp(state: GraphState, batch: OpBatch, u_live, u_inc, v_live, v_inc):
    """FPSP twin of :func:`repro_torch.core.engine.settle_edges` for the
    partitioned pipeline: edge ops whose ``(u, v)`` is unique in this
    shard's sub-batch take the sort-free direct path (the stab answers stand
    in for the endpoint reads), and only duplicate-key groups pay the
    phase-ordered epoch scan — skipped on the host when there are none, with
    the reference's skip-branch results.  Returns ``(state', results,
    overflow, stats)``, ``stats`` = ``i32[4]: [n_edge_dup, n_inserted,
    claim_rounds, n_eops]``, the layout of ``settle_edges``."""
    is_eop = engine._is_eop(batch.op)
    conflicted = is_eop & _edge_dup_mask(batch.u, batch.v, is_eop)
    fast = is_eop & ~conflicted
    endpoint = (u_live, u_inc, v_live, v_inc)

    state, fast_success, fast_over, fast_ins, fast_rounds = _fast_apply_edges(
        state, batch, fast, endpoint
    )

    n_conf = conflicted.sum().to(_I32)
    dev = batch.op.device
    if int(n_conf) > 0:
        masked = batch._replace(op=torch.where(conflicted, batch.op, OP_NOP))
        state, slow_success, slow_over, slow_ins, slow_rounds = engine._edge_wave(
            state, masked, conflicted, endpoint
        )
    else:
        slow_success = torch.zeros(batch.size, dtype=torch.bool, device=dev)
        slow_over = torch.tensor(False, device=dev)
        slow_ins = slow_rounds = torch.zeros((), dtype=_I32, device=dev)
    success = torch.where(fast, fast_success, slow_success)
    stats = torch.stack([
        n_conf,
        fast_ins + slow_ins,
        (fast_rounds + slow_rounds).to(_I32),
        is_eop.sum().to(_I32),
    ])
    return state, success, fast_over | slow_over, stats


def apply_batch_fpsp(state: GraphState, batch: OpBatch) -> ApplyResult:
    """Fast-path-slow-path: direct apply for conflict-free ops, the full
    wait-free engine only for the conflicted remainder.  ``state`` is left
    untouched, so the caller can retry from it."""
    conflicted, is_vop, is_eop, v_conf, e_conf, edge_dup = _conflict_mask(batch)
    fast = (is_vop | is_eop) & ~conflicted

    state, fast_success, fast_over, fast_ins, fast_rounds = _fast_apply(state, batch, fast)

    # slow path: fast ops masked to NOP; skipped on the host when nothing
    # conflicts, with the reference's skip-branch results
    n_conf = conflicted.sum().to(_I32)
    dev = batch.op.device
    if int(n_conf) > 0:
        masked = batch._replace(op=torch.where(conflicted, batch.op, OP_NOP))
        res = engine.apply_batch(state, masked)
    else:
        res = ApplyResult(
            state=state,
            success=torch.zeros(batch.size, dtype=torch.bool, device=dev),
            ok=torch.tensor(True, device=dev),
            stats=torch.zeros(N_STATS, dtype=_I32, device=dev),
        )

    success = torch.where(fast, fast_success, res.success)
    # the slow engine's inserted/rounds counters accumulate with the fast
    # lane's; the conflict split and the lane totals are full-batch
    # quantities, so they overwrite the masked-batch values
    stats = res.stats.clone()
    stats[STAT_CONFLICTED] = n_conf
    stats[STAT_V_CONFLICTS] = v_conf.sum().to(_I32)
    stats[STAT_E_CONFLICTS] = e_conf.sum().to(_I32)
    stats[STAT_INSERTED] += fast_ins
    stats[STAT_EDGE_DUP] = edge_dup.sum().to(_I32)
    stats[STAT_VOPS] = is_vop.sum().to(_I32)
    stats[STAT_EOPS] = is_eop.sum().to(_I32)
    stats[STAT_CLAIM_ROUNDS] += fast_rounds
    return ApplyResult(state=res.state, success=success, ok=res.ok & ~fast_over, stats=stats)

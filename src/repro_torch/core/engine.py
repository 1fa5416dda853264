"""The wait-free batch-combine engine — the paper's contribution, in dataflow.

Port of ``repro.core.engine.apply_batch``.  ``apply_batch(state, batch)``
resolves a whole ODA in one bounded-depth pass, with exactly the results of
applying the ops sequentially in phase order:

  A. **Vertex wave** — locate every vertex key, sort vertex ops by
     (key, phase); each key's liveness under its ops is a 2-state DFA whose
     transitions compose associatively, so one scan resolves every key.
  B. **Stabbing wave** — a merged (key, phase)-sorted scan over vertex
     transitions and per-edge-op endpoint queries answers "was u live, and
     at which incarnation, at phase p?" (the paper's Fig. 3 subtlety).
  C. **Edge wave** — edge ops sorted by (u, v, phase) split into epochs of
     fixed endpoint incarnations; within an epoch validity is a 1-bit DFA.
  D. Results back to batch order; table write-back; new keys inserted by
     deterministic scatter-claim.

Everything is int32/bool, and the result is bit-identical to ``repro``'s.
Three JAX idioms have no direct torch twin and are spelled out here:
``jnp.lexsort`` becomes stable argsorts from the minor key to the major key;
``.at[i].set(x, mode="drop")`` becomes a masked index write (the dropped
lanes are masked out, never sent out of range); and every gather index is
guarded the way ``repro`` guards it, since torch does not clamp.

The sharded pipeline (:mod:`repro_torch.core.sharding`) runs the same three
waves split across shards, with the stab exchange in the middle:
:func:`settle_vertices`, :func:`answer_stabs` and :func:`settle_edges`.
"""

from __future__ import annotations

import torch

from .locate import claim_edge_slots, claim_vertex_slots, locate_edges, locate_vertices
from .scanutils import scan_fnpairs, scan_last_set, seg_cumsum_exclusive, shift_right
from .types import (
    ABSENT_INC,
    INT32_MAX,
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


def _sort_by(keys, *arrays):
    """Stable sort of arrays by key tuple (major first); returns perm + sorted
    — ``jnp.lexsort`` as stable argsorts from the minor key up."""
    perm = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm, tuple(a[perm] for a in arrays)


def _heads(key: torch.Tensor) -> torch.Tensor:
    first = torch.ones(1, dtype=torch.bool, device=key.device)
    return torch.cat([first, key[1:] != key[:-1]])


def _lasts(head: torch.Tensor) -> torch.Tensor:
    return torch.cat([head[1:], torch.ones(1, dtype=torch.bool, device=head.device)])


def _unpermute(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _gather_found(col: torch.Tensor, loc, absent):
    """``col[slot]`` where the key was found, ``absent`` elsewhere."""
    return torch.where(loc.found, col[torch.where(loc.found, loc.slot, 0).long()], absent)


def _is_vop(op):
    return (op == OP_ADD_VERTEX) | (op == OP_REMOVE_VERTEX) | (op == OP_CONTAINS_VERTEX)


def _is_eop(op):
    return (op == OP_ADD_EDGE) | (op == OP_REMOVE_EDGE) | (op == OP_CONTAINS_EDGE)


# ---------------------------------------------------------------------------
# A. vertex wave
# ---------------------------------------------------------------------------

def _vertex_wave(state: GraphState, batch: OpBatch):
    op, u, phase = batch.op, batch.u, batch.phase

    is_vop = _is_vop(op)
    vkey = torch.where(is_vop, u, INT32_MAX)

    loc = locate_vertices(state.v_key, vkey, is_vop)
    init_live = _gather_found(state.v_live, loc, False)
    init_inc = _gather_found(state.v_inc, loc, ABSENT_INC)

    perm, (s_op, s_key, s_init_live, s_init_inc, s_slot, s_found, s_isv) = _sort_by(
        (vkey, phase), op, vkey, init_live, init_inc, loc.slot, loc.found, is_vop
    )
    head = _heads(s_key)

    # 2-state DFA transition (f(dead), f(live)) per op:
    #   AddVertex -> const live, RemVertex -> const dead, Contains -> identity
    is_add = s_op == OP_ADD_VERTEX
    is_rem = s_op == OP_REMOVE_VERTEX
    f0 = is_add.to(_I32)
    f1 = (~is_rem).to(_I32)
    # head elements become f ∘ const(init): a constant function, which makes
    # the plain scan segment-safe (constants absorb everything to the left)
    hf = torch.where(s_init_live, f1, f0)
    f0 = torch.where(head, hf, f0)
    f1 = torch.where(head, hf, f1)

    after0, _ = scan_fnpairs(f0, f1)  # after head-collapse, f0 == f1
    live_after = after0.to(torch.bool)
    live_before = torch.where(head, s_init_live, shift_right(live_after, False))

    # contains and remove succeed iff live before; add iff dead before
    success = torch.where(is_add, ~live_before, live_before) & s_isv

    # incarnation: bumps on every successful Add (dead -> live transition)
    revive = (is_add & success).to(_I32)
    inc_before = s_init_inc + seg_cumsum_exclusive(revive, head)
    inc_after = inc_before + revive

    last = _lasts(head)

    # --- write-back (on clones: the caller keeps the pre-state) ------------
    v_live = state.v_live.clone()
    v_inc = state.v_inc.clone()
    upd = last & s_isv & s_found
    wslot = s_slot[upd].long()
    v_live[wslot] = live_after[upd]
    v_inc[wslot] = inc_after[upd]

    # brand-new keys: insert if the key was ever successfully added (inc >= 0)
    # even when finally dead — the tombstone pins the incarnation so stale
    # edges bound during this batch can never be revived by a later AddVertex.
    need_insert = last & s_isv & ~s_found & (inc_after >= 0)
    v_key_col, new_slots, ins_overflow, rounds = claim_vertex_slots(
        state.v_key, s_key, need_insert
    )
    ins = need_insert & (new_slots >= 0)
    islot = new_slots[ins].long()
    v_live[islot] = live_after[ins]
    v_inc[islot] = inc_after[ins]

    state = state._replace(v_key=v_key_col, v_live=v_live, v_inc=v_inc)

    results = _unpermute(perm, success)
    # transition events for the stabbing wave, in original batch order
    ev_live = _unpermute(perm, live_after)
    ev_inc = _unpermute(perm, inc_after)

    overflow = loc.overflow | ins_overflow
    n_inserted = ins.sum().to(_I32)
    return state, results, (ev_live, ev_inc), overflow, n_inserted, rounds


# ---------------------------------------------------------------------------
# B. stabbing wave: endpoint (live, inc) at each edge op's phase
# ---------------------------------------------------------------------------

def _stab_scan(state: GraphState, tkeys, tphases, t_set, ev_live, ev_inc, qkeys, qphases):
    """Merge vertex-transition events ``(tkeys, tphases)`` carrying post-op
    payloads ``(ev_live, ev_inc)`` with endpoint queries ``(qkeys,
    qphases)``, sort by (key, phase), and answer every query with its key's
    (live, inc) at its phase via one head-seeded last-set scan.  Inert lanes
    carry the INT32_MAX key.  Returns ``(q_live, q_inc, overflow)``."""
    nt = tkeys.shape[0]
    nq = qkeys.shape[0]
    dev = tkeys.device
    ekey = torch.cat([tkeys, qkeys])
    ephase = torch.cat([tphases, qphases])
    is_set = torch.cat([t_set, torch.zeros(nq, dtype=torch.bool, device=dev)])

    # every event knows its key's initial table state (for segment heads)
    loc = locate_vertices(state.v_key, ekey, ekey != INT32_MAX)
    init_live = _gather_found(state.v_live, loc, False)
    init_inc = _gather_found(state.v_inc, loc, ABSENT_INC)

    pay_live = torch.cat([ev_live, torch.zeros(nq, dtype=torch.bool, device=dev)])
    pay_inc = torch.cat([ev_inc, torch.zeros(nq, dtype=_I32, device=dev)])

    perm, (s_key, s_set, s_pl, s_pi, s_il, s_ii) = _sort_by(
        (ekey, ephase), ekey, is_set, pay_live, pay_inc, init_live, init_inc
    )
    head = _heads(s_key)

    # head elements are always "set": a head transition keeps its own payload,
    # a head query seeds the segment with the table's initial state.
    seed = head & ~s_set
    val_live = torch.where(seed, s_il, s_pl)
    val_inc = torch.where(seed, s_ii, s_pi)
    val_set = head | s_set

    (scan_live, scan_inc), _ = scan_last_set((val_live, val_inc), val_set)

    out_live = _unpermute(perm, scan_live)
    out_inc = _unpermute(perm, scan_inc)
    return out_live[nt:], out_inc[nt:], loc.overflow


def _stabbing_wave(state: GraphState, batch: OpBatch, is_eop, ev_live, ev_inc, is_vop):
    op, u, v, phase = batch.op, batch.u, batch.v, batch.phase
    n = op.shape[0]

    # Event list (3n): vertex transitions + u-queries + v-queries of edge ops
    # (the concat order is load-bearing: the stable sort's tie-breaks — and
    # therefore bit-identity with repro — depend on it).
    tkey = torch.where(is_vop, u, INT32_MAX)
    qkeys = torch.cat([torch.where(is_eop, u, INT32_MAX), torch.where(is_eop, v, INT32_MAX)])
    qphases = torch.cat([phase, phase])

    # ``state`` is the *pre-batch* table: head queries precede every in-batch
    # transition of their key.
    q_live, q_inc, overflow = _stab_scan(
        state, tkey, phase, is_vop, ev_live, ev_inc, qkeys, qphases
    )
    return (q_live[:n], q_inc[:n], q_live[n:], q_inc[n:]), overflow


# ---------------------------------------------------------------------------
# C. edge wave
# ---------------------------------------------------------------------------

def _edge_wave(state: GraphState, batch: OpBatch, is_eop, endpoint):
    op, u, v, phase = batch.op, batch.u, batch.v, batch.phase
    u_live, u_inc, v_live, v_inc = endpoint

    eku = torch.where(is_eop, u, INT32_MAX)
    ekv = torch.where(is_eop, v, INT32_MAX)
    loc = locate_edges(state.e_key_u, state.e_key_v, eku, ekv, is_eop)
    init_live = _gather_found(state.e_live, loc, False)
    init_bu = _gather_found(state.e_inc_u, loc, ABSENT_INC)
    init_bv = _gather_found(state.e_inc_v, loc, ABSENT_INC)

    perm, (s_op, s_ku, s_kv, s_ul, s_ui, s_vl, s_vi, s_il, s_ibu, s_ibv,
           s_slot, s_found, s_ise) = _sort_by(
        (eku, ekv, phase), op, eku, ekv, u_live, u_inc, v_live, v_inc,
        init_live, init_bu, init_bv, loc.slot, loc.found, is_eop,
    )
    first = torch.ones(1, dtype=torch.bool, device=op.device)
    head = torch.cat([first, (s_ku[1:] != s_ku[:-1]) | (s_kv[1:] != s_kv[:-1])])

    eligible = s_ul & s_vl & s_ise
    # epoch id changes at group heads and whenever (eligibility, incs) changes
    prev_elig = shift_right(eligible, False)
    prev_ui = shift_right(s_ui, -2)
    prev_vi = shift_right(s_vi, -2)
    epoch_change = head | (eligible != prev_elig) | (
        eligible & ((s_ui != prev_ui) | (s_vi != prev_vi))
    )

    # epoch seed: the stored binding is valid iff it matches this epoch exactly
    seed = s_il & (s_ibu == s_ui) & (s_ibv == s_vi) & eligible

    # 1-bit validity DFA: AddE -> const 1, RemE -> const 0, Contains/⊥ -> id
    is_adde = (s_op == OP_ADD_EDGE) & eligible
    is_reme = (s_op == OP_REMOVE_EDGE) & eligible
    f0 = is_adde.to(_I32)
    f1 = (~is_reme).to(_I32)
    hf = torch.where(seed, f1, f0)
    f0 = torch.where(epoch_change, hf, f0)
    f1 = torch.where(epoch_change, hf, f1)

    after0, _ = scan_fnpairs(f0, f1)
    valid_after = after0.to(torch.bool)
    valid_before = torch.where(epoch_change, seed, shift_right(valid_after, False))

    is_cone = s_op == OP_CONTAINS_EDGE
    success = torch.where(
        is_adde, ~valid_before,
        torch.where(is_reme, valid_before, eligible & is_cone & valid_before),
    ) & s_ise

    last = _lasts(head)

    # --- write-back (on clones: the caller keeps the pre-state) ------------
    e_live = state.e_live.clone()
    e_bu = state.e_inc_u.clone()
    e_bv = state.e_inc_v.clone()

    upd = last & s_ise & s_found
    wslot = s_slot[upd].long()
    e_live[wslot] = valid_after[upd]
    e_bu[wslot] = s_ui[upd]
    e_bv[wslot] = s_vi[upd]

    need_insert = last & s_ise & ~s_found & valid_after
    e_ku_col, e_kv_col, new_slots, ins_overflow, rounds = claim_edge_slots(
        state.e_key_u, state.e_key_v, s_ku, s_kv, need_insert
    )
    ins = need_insert & (new_slots >= 0)
    islot = new_slots[ins].long()
    e_live[islot] = valid_after[ins]
    e_bu[islot] = s_ui[ins]
    e_bv[islot] = s_vi[ins]

    state = state._replace(
        e_key_u=e_ku_col, e_key_v=e_kv_col, e_live=e_live, e_inc_u=e_bu, e_inc_v=e_bv
    )
    results = _unpermute(perm, success)
    overflow = loc.overflow | ins_overflow
    n_inserted = ins.sum().to(_I32)
    return state, results, overflow, n_inserted, rounds


# ---------------------------------------------------------------------------
# full pass
# ---------------------------------------------------------------------------

def apply_batch(state: GraphState, batch: OpBatch) -> ApplyResult:
    """Resolve a whole op batch in phase order; bounded depth (wait-free).
    ``state`` is left untouched, so the caller can retry from it."""
    op = batch.op
    is_vop = _is_vop(op)
    is_eop = _is_eop(op)

    pre_state = state
    state, v_results, (ev_live, ev_inc), v_over, v_ins, v_rounds = _vertex_wave(
        state, batch
    )
    # the stabbing wave reads *pre-batch* init states, so pass the pre-wave table
    endpoint, s_over = _stabbing_wave(pre_state, batch, is_eop, ev_live, ev_inc, is_vop)
    state, e_results, e_over, e_ins, e_rounds = _edge_wave(state, batch, is_eop, endpoint)

    success = torch.where(is_vop, v_results, is_eop & e_results)
    ok = ~(v_over | s_over | e_over)

    # stats the waves compute anyway (types.STAT_*); slots 0-2 and 4 are
    # FPSP-only and stay 0
    zero = torch.zeros((), dtype=_I32, device=op.device)
    stats = torch.stack(
        [
            zero,
            zero,
            zero,
            (v_ins + e_ins).to(_I32),
            zero,
            is_vop.sum().to(_I32),
            is_eop.sum().to(_I32),
            (v_rounds + e_rounds).to(_I32),
        ]
    )
    return ApplyResult(state=state, success=success, ok=ok, stats=stats)


# ---------------------------------------------------------------------------
# phase entry points for the partitioned (cross-shard) pipeline
# ---------------------------------------------------------------------------
#
#   settle_vertices  — per shard, over its owned vertex ops;
#   answer_stabs     — per endpoint-owner shard, answering the (endpoint,
#                      phase) queries of every shard's edge ops against its
#                      own transitions;
#   settle_edges     — per shard, over its owned edge ops, fed the gathered
#                      endpoint answers.


def settle_vertices(state: GraphState, batch: OpBatch):
    """The vertex wave alone.  Returns ``(state', results, ev_live, ev_inc,
    overflow, stats)``: the ev tensors are the per-lane post-op (live, inc)
    payloads :func:`answer_stabs` reads; ``stats`` is ``i32[3]:
    [n_inserted, claim_rounds, n_vops]``."""
    is_vop = _is_vop(batch.op)
    state, results, (ev_live, ev_inc), overflow, n_ins, rounds = _vertex_wave(state, batch)
    stats = torch.stack([n_ins, rounds.to(_I32), is_vop.sum().to(_I32)])
    return state, results, ev_live, ev_inc, overflow, stats


def answer_stabs(pre_state: GraphState, batch: OpBatch, ev_live, ev_inc, qkeys, qphases):
    """Answer endpoint (live, inc)-at-phase queries against this shard's
    vertex transitions.

    ``pre_state`` is the shard's *pre-vertex-wave* table (head queries
    precede every in-batch transition of their key); ``batch``, ``ev_live``
    and ``ev_inc`` are the shard's own sub-batch and the payloads
    :func:`settle_vertices` returned for it.  ``qkeys``/``qphases`` are the
    gathered queries (INT32_MAX lanes are inert padding).  Returns ``(live,
    inc, overflow)`` per query."""
    is_vop = _is_vop(batch.op)
    tkey = torch.where(is_vop, batch.u, INT32_MAX)
    return _stab_scan(pre_state, tkey, batch.phase, is_vop, ev_live, ev_inc, qkeys, qphases)


def settle_edges(state: GraphState, batch: OpBatch, u_live, u_inc, v_live, v_inc):
    """The edge wave alone, fed externally gathered endpoint answers.
    Returns ``(state', results, overflow, stats)`` with ``stats`` =
    ``i32[4]: [n_edge_dup, n_inserted, claim_rounds, n_eops]`` (dup is
    FPSP-only and 0 here: the layout of the FPSP twin)."""
    is_eop = _is_eop(batch.op)
    state, results, overflow, n_ins, rounds = _edge_wave(
        state, batch, is_eop, (u_live, u_inc, v_live, v_inc)
    )
    zero = torch.zeros((), dtype=_I32, device=batch.op.device)
    stats = torch.stack([zero, n_ins, rounds.to(_I32), is_eop.sum().to(_I32)])
    return state, results, overflow, stats

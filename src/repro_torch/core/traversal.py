"""Batched wait-free reachability + snapshot traversal engine.

Port of ``repro.core.traversal``:

1. **Snapshot compaction** (:func:`build_csr`) — compacts the live,
   incarnation-valid edge set of a :class:`GraphState` into CSR form.  Vertex
   identity is the table slot; edges resolve their endpoint slots through the
   same bounded-probe :func:`~repro_torch.core.locate.locate_vertices` the
   engine uses (the ``hash_probe`` kernel on the card), stale bindings are
   masked out, survivors are sorted by source slot, and row offsets come from
   two ``searchsorted`` calls.
2. **Incremental maintenance** (:func:`apply_delta`) — folds an applied
   update batch into the previous snapshot: the touched keys are re-probed
   against the post state (O(batch) locates), lanes invalidated by vertex
   churn are dropped, and the new lanes are merged into the surviving runs —
   on the state's device by :func:`repro_torch.core.maintenance.delta_merge`
   (two ``masked_compact`` calls around a sort of the delta), or by the
   numpy splice, the oracle.  The result is bit-identical to ``build_csr``
   of the post state; a capacity change or a delta past
   ``max_delta_frac`` of the edge capacity falls back to the rebuild.
3. **Batched frontier BFS** (:func:`bfs_levels` / :func:`bfs_parents`) — all
   S source frontiers expand together, one
   :func:`repro_torch.kernels.frontier.frontier_expand` per level (its
   "no proposer" value ``NBR_INF`` is ``INT32_MAX``).  The scatter-min
   result is both the new frontier and the BFS parent of every newly reached
   slot.  The level loop runs on the host and reads one flag
   per level; it is bounded by the live vertex count, and an edge-free
   snapshot skips it.  ``impl`` picks the frontier step: ``None`` dispatches
   on the tensors' device, ``"reference"`` forces the plain version and
   ``"kernel"`` the CUDA kernel.
4. **Query forms** — :func:`reachable`, :func:`bfs_levels`,
   :func:`bfs_parents`, :func:`path_probe` and :func:`khop_mask`.

**Linearization point:** every query against a ``TraversalCSR`` linearizes
at the boundary of the update batch whose post-state the CSR was built (or
delta-folded) from; all queries sharing one CSR observe the same abstract
graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# the family's ops module, not its names: either package may be imported first
from ..kernels.frontier import ops as frontier_ops
# ambient telemetry: a no-op unless a registry is active
from ..obs import metrics as obsm
from .locate import locate_edges, locate_vertices
from .types import (
    EMPTY_KEY,
    INT32_MAX,
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    GraphState,
)

_NO_LEVEL = -1
_NO_PARENT = -1
_I32 = torch.int32


class TraversalCSR(NamedTuple):
    """A compacted, consistent snapshot of one :class:`GraphState`.

    Vertices are identified by their slot in the originating vertex table
    (``0 .. Cv-1``); ``Cv`` itself is the sentinel slot for "no vertex".
    Edge arrays are sorted by ``src`` with invalid lanes pushed to the end
    (``src == dst == Cv``); ``lane`` records each entry's pre-sort edge-table
    lane.
    """

    v_key: torch.Tensor      # i32[Cv] — table keys (EMPTY_KEY where unused)
    v_live: torch.Tensor     # bool[Cv]
    v_inc: torch.Tensor      # i32[Cv]
    n_live: torch.Tensor     # i32[] — live vertex count (BFS depth bound)
    src: torch.Tensor        # i32[Ce] — source slot per edge lane, sorted; Cv = invalid
    dst: torch.Tensor        # i32[Ce] — destination slot, aligned with src
    lane: torch.Tensor       # i32[Ce] — originating edge-table lane per entry
    row_start: torch.Tensor  # i32[Cv] — CSR offsets into src/dst
    row_end: torch.Tensor    # i32[Cv]
    n_edges: torch.Tensor    # i32[] — valid edge count

    @property
    def v_capacity(self) -> int:
        return self.v_key.shape[0]

    @property
    def e_capacity(self) -> int:
        return self.src.shape[0]


def _edge_validity(state: GraphState):
    """Per-edge-lane validity — the Fig. 3 hazard mask: a lane is valid iff
    it is live, both endpoint keys locate to table slots, both endpoints are
    live, and both stored incarnations equal the endpoints' current ones.
    Returns (src_slot, dst_slot, valid)."""
    active = (state.e_key_u != EMPTY_KEY) & state.e_live
    loc_u = locate_vertices(state.v_key, state.e_key_u, active)
    loc_v = locate_vertices(state.v_key, state.e_key_v, active)
    su = torch.where(loc_u.found, loc_u.slot, 0)
    sv = torch.where(loc_v.found, loc_v.slot, 0)
    su_l, sv_l = su.long(), sv.long()
    valid = (
        state.e_live
        & loc_u.found
        & loc_v.found
        & state.v_live[su_l]
        & state.v_live[sv_l]
        & (state.v_inc[su_l] == state.e_inc_u)
        & (state.v_inc[sv_l] == state.e_inc_v)
    )
    return su, sv, valid


def build_csr(state: GraphState) -> TraversalCSR:
    """Compact the live, incarnation-valid edge set into CSR form."""
    cv = state.v_capacity
    su, sv, valid = _edge_validity(state)

    src = torch.where(valid, su, cv)
    dst = torch.where(valid, sv, cv)
    order = torch.argsort(src, stable=True)
    src = src[order]
    dst = dst[order]

    rows = torch.arange(cv, dtype=_I32, device=src.device)
    return TraversalCSR(
        v_key=state.v_key,
        v_live=state.v_live,
        v_inc=state.v_inc,
        n_live=state.v_live.sum().to(_I32),
        src=src,
        dst=dst,
        lane=order.to(_I32),
        row_start=torch.searchsorted(src, rows, right=False).to(_I32),
        row_end=torch.searchsorted(src, rows, right=True).to(_I32),
        n_edges=valid.sum().to(_I32),
    )


def _pad_pow2(a: np.ndarray, fill: int, floor: int = 16) -> np.ndarray:
    """Pad to a power-of-two bucket, as ``repro`` pads query batches."""
    n = a.shape[0]
    bucket = max(floor, 1 << max(n - 1, 1).bit_length())
    out = np.full(bucket, fill, a.dtype)
    out[:n] = a
    return out


# ---------------------------------------------------------------------------
# incremental CSR maintenance
# ---------------------------------------------------------------------------


class DeltaProbe(NamedTuple):
    """Everything a delta fold needs to know about the touched keys, as
    resolved against the *post* state (tensors on the state's device)."""

    v_found: torch.Tensor     # bool[nv] — touched vertex key present (live or tomb)
    v_slot: torch.Tensor      # i32[nv]
    v_live_now: torch.Tensor  # bool[nv]
    v_inc_now: torch.Tensor   # i32[nv]
    e_found: torch.Tensor     # bool[ne] — touched edge key has a table lane
    e_lane: torch.Tensor      # i32[ne]
    e_valid: torch.Tensor     # bool[ne] — lane live + incarnation-valid now
    e_su: torch.Tensor        # i32[ne] — endpoint slots (where e_found)
    e_sv: torch.Tensor        # i32[ne]
    n_live: torch.Tensor      # i32[] — post-state live vertex count


def _delta_probe_parts(
    state: GraphState, vkeys: torch.Tensor, eus: torch.Tensor, evs: torch.Tensor
) -> DeltaProbe:
    """Resolve the touched keys against the post state: vertex slots,
    liveness and incarnations, edge lanes, endpoint slots and validity, and
    the new live count.  O(batch) probes instead of ``build_csr``'s
    O(capacity).  Shared by the packed host transfer (:func:`_delta_probe`)
    and the device merge (:func:`repro_torch.core.maintenance.delta_merge`)."""
    vloc = locate_vertices(state.v_key, vkeys, vkeys != EMPTY_KEY)
    v_safe = torch.where(vloc.found, vloc.slot, 0)

    e_active = eus != EMPTY_KEY
    eloc = locate_edges(state.e_key_u, state.e_key_v, eus, evs, e_active)
    e_safe = torch.where(eloc.found, eloc.slot, 0)
    lu = locate_vertices(state.v_key, eus, eloc.found)
    lv = locate_vertices(state.v_key, evs, eloc.found)
    su = torch.where(lu.found, lu.slot, 0)
    sv = torch.where(lv.found, lv.slot, 0)
    v_l, e_l, su_l, sv_l = v_safe.long(), e_safe.long(), su.long(), sv.long()
    e_valid = (
        eloc.found
        & state.e_live[e_l]
        & lu.found
        & lv.found
        & state.v_live[su_l]
        & state.v_live[sv_l]
        & (state.v_inc[su_l] == state.e_inc_u[e_l])
        & (state.v_inc[sv_l] == state.e_inc_v[e_l])
    )
    return DeltaProbe(
        v_found=vloc.found,
        v_slot=v_safe,
        v_live_now=state.v_live[v_l],
        v_inc_now=state.v_inc[v_l],
        e_found=eloc.found,
        e_lane=e_safe,
        e_valid=e_valid,
        e_su=su,
        e_sv=sv,
        n_live=state.v_live.sum().to(_I32),
    )


def _delta_probe(state: GraphState, pack: np.ndarray, nv: int, ne: int):
    """Packed-transfer wrapper around :func:`_delta_probe_parts` for the host
    splice: the touched keys go over as one packed i32 buffer (vkeys | e_us
    | e_vs, each padded to a power-of-two bucket) and the answers come back
    as one (bools widened).  ``n_live`` stays on the device."""
    keys = torch.as_tensor(pack, device=state.device)
    p = _delta_probe_parts(state, keys[:nv], keys[nv:nv + ne], keys[nv + ne:])
    out = torch.cat(
        [
            p.v_found.to(_I32),
            p.v_slot,
            p.v_live_now.to(_I32),
            p.v_inc_now,
            p.e_found.to(_I32),
            p.e_lane,
            p.e_valid.to(_I32),
            p.e_su,
            p.e_sv,
        ]
    )
    return out.cpu().numpy(), p.n_live


def _delta_splice(pack: np.ndarray, ce: int, cv: int, device):
    """Unpack the host-assembled sorted edge arrays (one transfer) and derive
    the row offsets on the device — the same ``searchsorted`` calls as
    :func:`build_csr`, so the result is bit-identical by construction."""
    t = torch.as_tensor(pack, device=device)
    src = t[:ce]
    rows = torch.arange(cv, dtype=_I32, device=device)
    return (
        src,
        t[ce:2 * ce],
        t[2 * ce:3 * ce],
        torch.searchsorted(src, rows, right=False).to(_I32),
        torch.searchsorted(src, rows, right=True).to(_I32),
        t[3 * ce],
    )


def _distinct(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` for a 1-d array, by one sort and a neighbour compare:
    on the card's host numpy 2.3.5's ``np.unique`` took about 1 s for a
    million int64 edge codes, 37 times this (PERF.md §6)."""
    a = np.sort(a)
    return a[np.concatenate([[True], a[1:] != a[:-1]])] if a.size else a


def touched_keys(ops, us, vs=None):
    """The distinct vertex keys and edge keys an update batch touches:
    ``(v_touch, e_us, e_vs)``, int32 numpy, each ascending (edges by
    ``(u, v)``).  Read-only ops touch nothing."""
    ops = np.asarray(ops, np.int32)
    us = np.asarray(us, np.int32)
    vs = np.zeros_like(us) if vs is None else np.asarray(vs, np.int32)
    v_touch = _distinct(us[(ops == OP_ADD_VERTEX) | (ops == OP_REMOVE_VERTEX)])
    e_mask = (ops == OP_ADD_EDGE) | (ops == OP_REMOVE_EDGE)
    # dedup edge keys as int64 codes (cheaper than a dedup of (u, v) rows)
    e_code = _distinct(
        (us[e_mask].astype(np.int64) << 32) | (vs[e_mask].astype(np.int64) & 0xFFFFFFFF)
    )
    return v_touch, (e_code >> 32).astype(np.int32), e_code.astype(np.int32)


def apply_delta(
    csr: TraversalCSR,
    state: GraphState,
    ops,
    us,
    vs=None,
    *,
    max_delta_frac: float = 0.25,
    impl: Optional[str] = None,
) -> TraversalCSR:
    """Fold one applied update batch into an existing snapshot.

    ``csr`` must be the snapshot of the pre-batch state and ``state`` the
    post-batch state the engine returned for ``(ops, us, vs)``.  The result
    is bit-identical to ``build_csr(state)``: the same sorted edge arrays,
    lane provenance and offsets.

    ``impl`` picks the splice (``maintenance.resolve_impl``; ``None`` is
    ``"device"``):

    * ``"device"`` — :func:`repro_torch.core.maintenance.delta_merge` on the
      state's device: one host-to-device transfer of the packed touched
      keys, none back.  Its composite ``(src, lane)`` merge keys are int64,
      so it applies at every capacity ``merge_keys_fit`` admits.
    * ``"host"`` — the numpy splice (mask updates and a lexsort over the
      surviving lanes on the host), the oracle the device merge is held to.

    Falls back to :func:`build_csr` when either table capacity changed (a
    growth rehash moved every slot), or when the touched keys exceed
    ``max(32, max_delta_frac * Ce)``.  A read-only batch returns ``csr``
    itself.  The reconciliation is result-blind: it re-probes the touched
    keys against the post state rather than trusting per-op success bits,
    so duplicate ops, failed ops and within-batch remove/re-add churn are
    handled by construction.
    """
    ce = csr.e_capacity
    if state.v_capacity != csr.v_capacity or state.e_capacity != ce:
        obsm.counter("csr.delta.rebuild_capacity_changed")
        return build_csr(state)  # rehash: every slot moved

    v_touch, e_tu, e_tv = touched_keys(ops, us, vs)
    if v_touch.size == 0 and e_tu.size == 0:
        obsm.counter("csr.delta.readonly")
        return csr  # read-only batch: the snapshot is still exact
    if v_touch.size + e_tu.size > max(32, int(max_delta_frac * ce)):
        obsm.counter("csr.delta.rebuild_too_large")
        return build_csr(state)  # delta too large to beat the rebuild
    obsm.counter("csr.delta.folded")
    obsm.hist("csr.delta.touched", int(v_touch.size + e_tu.size))

    v_pad = _pad_pow2(v_touch, EMPTY_KEY)
    eu_pad = _pad_pow2(e_tu, EMPTY_KEY)
    ev_pad = _pad_pow2(e_tv, 0)
    nvp, nep = v_pad.shape[0], eu_pad.shape[0]
    pack = np.concatenate([v_pad, eu_pad, ev_pad])

    from . import maintenance  # deferred: maintenance imports this module

    cv = csr.v_capacity
    if maintenance.resolve_impl(impl) != "host" and maintenance.merge_keys_fit(cv, ce):
        return maintenance.delta_merge(csr, state, pack, nvp, nep)

    packed, n_live = _delta_probe(state, pack, nvp, nep)
    nv, ne = v_touch.size, e_tu.size
    v_found = packed[:nv].astype(bool)
    v_slot = packed[nvp:nvp + nv]
    v_live_now = packed[2 * nvp:2 * nvp + nv].astype(bool)
    v_inc_now = packed[3 * nvp:3 * nvp + nv]
    eoff = 4 * nvp
    e_found = packed[eoff:eoff + ne].astype(bool)
    e_lane = packed[eoff + nep:eoff + nep + ne]
    e_valid = packed[eoff + 2 * nep:eoff + 2 * nep + ne].astype(bool)
    e_su = packed[eoff + 3 * nep:eoff + 3 * nep + ne]
    e_sv = packed[eoff + 4 * nep:eoff + 4 * nep + ne]

    # vertices whose (live, inc) changed invalidate every lane bound to them
    pre_live = csr.v_live.cpu().numpy()
    pre_inc = csr.v_inc.cpu().numpy()
    vsl = v_slot[v_found]
    changed = vsl[(pre_live[vsl] != v_live_now[v_found])
                  | (pre_inc[vsl] != v_inc_now[v_found])]

    n_e = int(csr.n_edges)
    src_v = csr.src[:n_e].cpu().numpy()
    dst_v = csr.dst[:n_e].cpu().numpy()
    lane_v = csr.lane[:n_e].cpu().numpy()

    keep = np.ones(n_e, bool)
    if changed.size:
        hit = np.zeros(cv + 1, bool)
        hit[changed] = True
        keep &= ~(hit[src_v] | hit[dst_v])
    touched_lanes = e_lane[e_found]
    if touched_lanes.size:
        # every touched edge key is re-derived from the post state below;
        # drop its old entry (if any) so the splice is the single source
        lhit = np.zeros(ce, bool)
        lhit[touched_lanes] = True
        keep &= ~lhit[lane_v]

    ins = e_found & e_valid
    src_all = np.concatenate([src_v[keep], e_su[ins]])
    dst_all = np.concatenate([dst_v[keep], e_sv[ins]])
    lane_all = np.concatenate([lane_v[keep], e_lane[ins]])
    order = np.lexsort((lane_all, src_all))  # == build_csr's stable sort by src
    src_all, dst_all, lane_all = src_all[order], dst_all[order], lane_all[order]

    n_valid = src_all.shape[0]
    lane_used = np.zeros(ce, bool)
    lane_used[lane_all] = True
    tail_lane = np.nonzero(~lane_used)[0].astype(np.int32)  # ascending, as argsort leaves it
    invalid = np.full(ce - n_valid, cv, np.int32)
    pack = np.concatenate(
        [src_all, invalid, dst_all, invalid, lane_all, tail_lane,
         np.asarray([n_valid], np.int32)]
    )
    src, dst, lane, row_start, row_end, n_edges = _delta_splice(pack, ce, cv, state.device)

    return TraversalCSR(
        v_key=state.v_key,
        v_live=state.v_live,
        v_inc=state.v_inc,
        n_live=n_live,
        src=src,
        dst=dst,
        lane=lane,
        row_start=row_start,
        row_end=row_end,
        n_edges=n_edges,
    )


# ---------------------------------------------------------------------------
# batched frontier BFS
# ---------------------------------------------------------------------------


def _locate_live_slots(csr: TraversalCSR, keys: torch.Tensor):
    """Map query keys to live slots; returns (slot, is_live) with slot=Cv when
    absent/dead.  EMPTY_KEY query lanes (batch padding) resolve to dead."""
    loc = locate_vertices(csr.v_key, keys, keys != EMPTY_KEY)
    safe = torch.where(loc.found, loc.slot, 0).long()
    live = loc.found & csr.v_live[safe]
    slot = torch.where(live, loc.slot, csr.v_capacity)
    return slot, live


def _bfs_from_slots(
    csr: TraversalCSR, slot: torch.Tensor, live: torch.Tensor, impl: Optional[str] = None
):
    """The frontier loop from already-located source slots.  Returns
    (levels, parents): i32[S, Cv] each, -1 for unreached / no parent.

    One :func:`frontier_expand` per level; the loop stops when every
    frontier is empty or after ``n_live`` levels (no shortest path is
    longer).  An ``n_edges == 0`` snapshot returns the source-only maps."""
    cv = csr.v_capacity
    n_src = slot.shape[0]
    dev = slot.device

    # one extra column absorbs sentinel slot Cv (invalid edges / dead sources)
    frontier = torch.zeros((n_src, cv + 1), dtype=torch.bool, device=dev)
    frontier[torch.arange(n_src, device=dev), slot.long()] = live
    levels = torch.where(frontier, 0, _NO_LEVEL).to(_I32)
    parents = torch.full((n_src, cv + 1), _NO_PARENT, dtype=_I32, device=dev)

    if int(csr.n_edges) > 0:
        n_live = int(csr.n_live)
        depth = 0
        while depth < n_live and bool(frontier[:, :cv].any()):
            nbr = frontier_ops.frontier_expand(frontier, csr.src, csr.dst, impl=impl)
            new = (nbr != INT32_MAX) & (levels == _NO_LEVEL)
            new[:, cv] = False
            levels = torch.where(new, depth + 1, levels)
            parents = torch.where(new, nbr, parents)
            frontier = new
            depth += 1
    return levels[:, :cv], parents[:, :cv]


def bfs_parents(csr: TraversalCSR, src_keys: torch.Tensor, impl: Optional[str] = None):
    """Batched BFS with parent pointers: (levels, parents), i32[S, Cv] each.

    ``levels[s, j]`` is the hop distance from ``src_keys[s]`` to slot ``j``
    (0 for the source, -1 unreachable); ``parents[s, j]`` is the minimum
    frontier source slot among ``j``'s in-edges (-1 for sources and
    unreached slots)."""
    slot, live = _locate_live_slots(csr, src_keys)
    return _bfs_from_slots(csr, slot, live, impl)


def bfs_levels(
    csr: TraversalCSR, src_keys: torch.Tensor, impl: Optional[str] = None
) -> torch.Tensor:
    """Batched BFS level map: i32[S, Cv], -1 = unreachable."""
    return bfs_parents(csr, src_keys, impl)[0]


def reachable(
    csr: TraversalCSR, us: torch.Tensor, vs: torch.Tensor, impl: Optional[str] = None
) -> torch.Tensor:
    """Batched reachability: bool[B], ``us[i] ↝ vs[i]`` by directed paths.
    False when either endpoint is absent/dead; ``u ↝ u`` is True iff u is
    live."""
    uslot, ulive = _locate_live_slots(csr, us)
    vslot, vlive = _locate_live_slots(csr, vs)
    levels, _ = _bfs_from_slots(csr, uslot, ulive, impl)
    safe = torch.where(vlive, vslot, 0).long()
    rows = torch.arange(us.shape[0], device=us.device)
    return vlive & (levels[rows, safe] >= 0)


def _canonical_parents(csr: TraversalCSR, levels: torch.Tensor) -> torch.Tensor:
    """Rewrite BFS parents to the minimum-*key* predecessor on a shortest
    path (one scatter-min over the edge list), so ``GetPath`` does not
    depend on the table layout."""
    cv = csr.v_capacity
    dev = levels.device
    n_src = levels.shape[0]

    # rank slots by key (live keys are unique; dead slots sort to the tail)
    order = torch.argsort(torch.where(csr.v_live, csr.v_key, INT32_MAX), stable=True)
    rank = torch.empty(cv, dtype=_I32, device=dev)
    rank[order] = torch.arange(cv, dtype=_I32, device=dev)

    # sentinel column cv absorbs invalid edge lanes (src == dst == cv)
    lv = torch.cat([levels, torch.full((n_src, 1), _NO_LEVEL, dtype=_I32, device=dev)], 1)
    src_l, dst_l = csr.src.long(), csr.dst.long()
    ls = lv[:, src_l]
    ld = lv[:, dst_l]
    on_path = (ls >= 0) & (ld == ls + 1)
    cand = torch.where(on_path, rank[src_l.clamp(0, cv - 1)][None, :], INT32_MAX)
    best = torch.full((n_src, cv + 1), INT32_MAX, dtype=_I32, device=dev)
    best.scatter_reduce_(1, dst_l[None, :].expand(n_src, -1), cand, "amin")
    best = best[:, :cv]
    parent_slot = order.to(_I32)[best.clamp(0, cv - 1).long()]
    return torch.where((best < INT32_MAX) & (levels > 0), parent_slot, _NO_PARENT)


def path_probe(
    csr: TraversalCSR, us: torch.Tensor, vs: torch.Tensor, impl: Optional[str] = None
):
    """Device half of ``GetPath``: (levels, parents, target_slot,
    target_live), with parents canonicalized to the minimum-key
    shortest-path predecessor."""
    uslot, ulive = _locate_live_slots(csr, us)
    vslot, vlive = _locate_live_slots(csr, vs)
    levels, _ = _bfs_from_slots(csr, uslot, ulive, impl)
    return levels, _canonical_parents(csr, levels), vslot, vlive


def khop_mask(
    csr: TraversalCSR, src_keys: torch.Tensor, k: int, impl: Optional[str] = None
) -> torch.Tensor:
    """bool[S, Cv]: slots within ≤k directed hops of each source (incl. self)."""
    levels = bfs_levels(csr, src_keys, impl)
    return (levels >= 0) & (levels <= k)


def snapshot_live(state: GraphState):
    """Snapshot masks: (v_live_mask, e_valid_mask) — the edge mask is the
    :func:`_edge_validity` predicate the CSR build uses."""
    _, _, e_valid = _edge_validity(state)
    return state.v_live, e_valid

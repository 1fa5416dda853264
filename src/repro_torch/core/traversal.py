"""Batched wait-free reachability + snapshot traversal engine.

Port of ``repro.core.traversal`` (the rebuild path; the incremental
``apply_delta`` fold waits for the delta slice):

1. **Snapshot compaction** (:func:`build_csr`) — compacts the live,
   incarnation-valid edge set of a :class:`GraphState` into CSR form.  Vertex
   identity is the table slot; edges resolve their endpoint slots through the
   same bounded-probe :func:`~repro_torch.core.locate.locate_vertices` the
   engine uses (the ``hash_probe`` kernel on the card), stale bindings are
   masked out, survivors are sorted by source slot, and row offsets come from
   two ``searchsorted`` calls.
2. **Batched frontier BFS** (:func:`bfs_levels` / :func:`bfs_parents`) — all
   S source frontiers expand together, one
   :func:`repro_torch.kernels.frontier.frontier_expand` per level (its
   "no proposer" value ``NBR_INF`` is ``INT32_MAX``).  The scatter-min
   result is both the new frontier and the BFS parent of every newly reached
   slot.  The level loop runs on the host and reads one flag
   per level; it is bounded by the live vertex count, and an edge-free
   snapshot skips it.
3. **Query forms** — :func:`reachable`, :func:`bfs_levels`,
   :func:`bfs_parents`, :func:`path_probe` and :func:`khop_mask`.

**Linearization point:** every query against a ``TraversalCSR`` linearizes
at the boundary of the update batch whose post-state the CSR was built from;
all queries sharing one CSR observe the same abstract graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the family's ops module, not its names: either package may be imported first
from ..kernels.frontier import ops as frontier_ops
from .locate import locate_vertices
from .types import EMPTY_KEY, INT32_MAX, GraphState

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


def _bfs_from_slots(csr: TraversalCSR, slot: torch.Tensor, live: torch.Tensor):
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
            nbr = frontier_ops.frontier_expand(frontier, csr.src, csr.dst)
            new = (nbr != INT32_MAX) & (levels == _NO_LEVEL)
            new[:, cv] = False
            levels = torch.where(new, depth + 1, levels)
            parents = torch.where(new, nbr, parents)
            frontier = new
            depth += 1
    return levels[:, :cv], parents[:, :cv]


def bfs_parents(csr: TraversalCSR, src_keys: torch.Tensor):
    """Batched BFS with parent pointers: (levels, parents), i32[S, Cv] each.

    ``levels[s, j]`` is the hop distance from ``src_keys[s]`` to slot ``j``
    (0 for the source, -1 unreachable); ``parents[s, j]`` is the minimum
    frontier source slot among ``j``'s in-edges (-1 for sources and
    unreached slots)."""
    slot, live = _locate_live_slots(csr, src_keys)
    return _bfs_from_slots(csr, slot, live)


def bfs_levels(csr: TraversalCSR, src_keys: torch.Tensor) -> torch.Tensor:
    """Batched BFS level map: i32[S, Cv], -1 = unreachable."""
    return bfs_parents(csr, src_keys)[0]


def reachable(csr: TraversalCSR, us: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Batched reachability: bool[B], ``us[i] ↝ vs[i]`` by directed paths.
    False when either endpoint is absent/dead; ``u ↝ u`` is True iff u is
    live."""
    uslot, ulive = _locate_live_slots(csr, us)
    vslot, vlive = _locate_live_slots(csr, vs)
    levels, _ = _bfs_from_slots(csr, uslot, ulive)
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


def path_probe(csr: TraversalCSR, us: torch.Tensor, vs: torch.Tensor):
    """Device half of ``GetPath``: (levels, parents, target_slot,
    target_live), with parents canonicalized to the minimum-key
    shortest-path predecessor."""
    uslot, ulive = _locate_live_slots(csr, us)
    vslot, vlive = _locate_live_slots(csr, vs)
    levels, _ = _bfs_from_slots(csr, uslot, ulive)
    return levels, _canonical_parents(csr, levels), vslot, vlive


def khop_mask(csr: TraversalCSR, src_keys: torch.Tensor, k: int) -> torch.Tensor:
    """bool[S, Cv]: slots within ≤k directed hops of each source (incl. self)."""
    levels = bfs_levels(csr, src_keys)
    return (levels >= 0) & (levels <= k)


def snapshot_live(state: GraphState):
    """Snapshot masks: (v_live_mask, e_valid_mask) — the edge mask is the
    :func:`_edge_validity` predicate the CSR build uses."""
    _, _, e_valid = _edge_validity(state)
    return state.v_live, e_valid

"""Host-side wrapper: the *unbounded* wait-free graph, on one device.

Port of ``repro.core.graph.WaitFreeGraph`` for one shard, with the
wait-free engine or its fast-path-slow-path twin (``mode="fpsp"``).
``WaitFreeGraph`` owns the :class:`GraphState` plus the global phase counter
(the paper's ``maxPhase`` fetch-and-add — a host-side monotone counter; each
batch gets ``counter + iota`` stamps).  "Unbounded" is
amortized growth: every engine pass is *transactional* — if a bounded probe
chain or insert round tripped its cap (``ok == False``), the post-state is
discarded, the tables are grown (rehash = Harris physical deletion), and the
same batch is re-applied against the grown pre-state.

The graph lives on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and raises where no card is present.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import engine, fastpath, maintenance, traversal
from .types import (
    EMPTY_KEY,
    GROW_LOAD_FACTOR,
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    GraphState,
    is_pow2,
    make_batch,
    make_state,
)

_MAX_GROW_ATTEMPTS = 12

_MUTATING_OPS = (OP_ADD_VERTEX, OP_REMOVE_VERTEX, OP_ADD_EDGE, OP_REMOVE_EDGE)


def _bucket_size(n: int) -> int:
    """Power-of-two batch bucket (floor 64), as in ``repro``: the padding
    and phase stamps must match it for the states to stay identical."""
    return max(64, 1 << max(n - 1, 1).bit_length())


def _used_slots(state: GraphState) -> Tuple[int, int]:
    """(used vertex slots, used edge slots), tombstones included — one read
    back to the host."""
    counts = torch.stack([(state.v_key != EMPTY_KEY).sum(), (state.e_key_u != EMPTY_KEY).sum()])
    v_used, e_used = counts.tolist()
    return v_used, e_used


def _rehash_escalating(
    state: GraphState,
    new_vcap: int,
    new_ecap: int,
    impl: Optional[str] = None,
    with_csr: bool = False,
) -> Tuple[GraphState, Optional[traversal.TraversalCSR]]:
    """Rehash into ``(new_vcap, new_ecap)``; should placement overflow
    ``MAX_PROBES``, double both capacities and retry.  Returns
    ``(new_state, csr_or_None)``."""
    for _ in range(_MAX_GROW_ATTEMPTS):
        new_state, csr, ok = maintenance.rehash(
            state, new_vcap, new_ecap, impl=impl, with_csr=with_csr
        )
        if ok:
            return new_state, csr
        new_vcap *= 2
        new_ecap *= 2
    raise RuntimeError("rehash placement did not converge")


class WaitFreeGraph:
    """The unbounded concurrent graph: the paper's public API, batched.

    ``mode`` selects the engine: ``"waitfree"`` (``engine.apply_batch``) or
    ``"fpsp"`` (``fastpath.apply_batch_fpsp``); both give identical results.

    ``traversal_impl`` selects every query's frontier step: ``None``
    dispatches on the graph's device (the ``frontier_expand`` kernel on the
    card, its plain version on the CPU), ``"reference"`` forces the plain
    version, ``"kernel"`` the kernel (the graph must be on the card).

    ``csr_maintenance`` picks what happens to a cached traversal snapshot
    when an update batch lands: ``"delta"`` (the default) queues the batch,
    and the next query folds the whole queue into the snapshot with one
    :func:`repro_torch.core.traversal.apply_delta` (bit-identical to a
    rebuild, O(batch) probes); ``"rebuild"`` drops the snapshot and
    recompacts it on the next query.

    ``maintenance_impl`` selects where table maintenance (the growth rehash
    and the delta fold's splice) runs: ``"device"`` (the ``compact`` kernels
    on the graph's device; a growth then also hands over the grown state's
    snapshot, the rehash's snapshot-compact) or ``"host"`` (the numpy
    reference); ``None`` means ``"device"``.  Both give identical tables and
    snapshots.

    Not ported yet, and refused with ``NotImplementedError``:
    ``n_shards > 1`` and ``obs`` (ROADMAP.md, "Queue 1").
    """

    def __init__(
        self,
        v_capacity: int = 1024,
        e_capacity: int = 4096,
        mode: str = "waitfree",
        traversal_impl: Optional[str] = None,
        csr_maintenance: str = "delta",
        maintenance_impl: Optional[str] = None,
        n_shards: int = 1,
        obs=None,
        device=None,
    ):
        if mode not in ("waitfree", "fpsp"):
            raise ValueError(f"unknown mode {mode!r}")
        if csr_maintenance not in ("delta", "rebuild"):
            raise ValueError(f"unknown csr_maintenance {csr_maintenance!r}")
        if traversal_impl not in (None, "reference", "kernel"):
            raise ValueError(f"unknown traversal_impl {traversal_impl!r}")
        if not is_pow2(n_shards):
            raise ValueError("n_shards must be a power of two")
        if n_shards > 1:
            raise NotImplementedError("n_shards > 1: ROADMAP.md queue 1, next slice 'Sharding'")
        if obs:
            raise NotImplementedError("obs: ROADMAP.md queue 1, next slice 'Telemetry'")
        maintenance.resolve_impl(maintenance_impl)
        self.device = resolve_device(device, "WaitFreeGraph")
        if traversal_impl == "kernel" and self.device.type != "cuda":
            raise ValueError("traversal_impl='kernel' needs the graph on the card")
        self.mode = mode
        self._apply_fn = engine.apply_batch if mode == "waitfree" else fastpath.apply_batch_fpsp
        self.traversal_impl = traversal_impl
        self.csr_maintenance = csr_maintenance
        self.maintenance_impl = maintenance_impl
        self._grow_csr: Optional[traversal.TraversalCSR] = None
        self.state = make_state(v_capacity, e_capacity, device=self.device)
        self._phase = 0  # the paper's maxPhase counter

    @property
    def state(self) -> GraphState:
        return self._state

    @state.setter
    def state(self, value: GraphState) -> None:
        # any state swap (apply, growth, or a caller installing a state)
        # invalidates the cached snapshot AND the pending delta queue, whose
        # base snapshot no longer matches the state
        self._state = value
        self._csr: Optional[traversal.TraversalCSR] = None
        self._delta_base: Optional[traversal.TraversalCSR] = None
        self._delta_batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    # -- batched API ------------------------------------------------------
    def apply(self, ops, us, vs=None) -> np.ndarray:
        """Apply a batch; returns bool[n] success per op (phase order = batch
        order).  Batches are padded to power-of-two buckets with NOP lanes,
        exactly as in ``repro``."""
        ops0 = np.asarray(ops, np.int32)
        n = ops0.shape[0]
        if n == 0:
            return np.zeros(0, bool)
        us0 = np.asarray(us, np.int32)
        vs0 = np.zeros_like(us0) if vs is None else np.asarray(vs, np.int32)
        # read-only batches leave the abstract graph unchanged, so the cached
        # traversal snapshot stays valid across the state swap below
        mutating = bool(np.isin(ops0, _MUTATING_OPS).any())
        saved_csr = None if mutating else self._csr
        # the pending delta queue (base snapshot + unpadded batches since the
        # last query) survives the state swap below: read-only batches carry
        # it, mutating batches append to it, and the next query folds the
        # whole queue in one apply_delta
        delta_base, delta_batches = self._delta_base, self._delta_batches
        if mutating and self.csr_maintenance == "delta" and self._csr is not None:
            delta_base, delta_batches = self._csr, []
        bucket = _bucket_size(n)
        pad = np.zeros(bucket - n, np.int32)  # OP_NOP = 0
        batch = make_batch(
            np.concatenate([ops0, pad]),
            np.concatenate([us0, pad]),
            np.concatenate([vs0, pad]),
            phase_base=self._phase,
            device=self.device,
        )
        self._phase += batch.size

        self._grow_csr = None
        for attempt in range(_MAX_GROW_ATTEMPTS):
            pre = self.state  # kept alive for transactional retry
            res = self._apply_fn(pre, batch)
            if bool(res.ok) and not self._needs_growth(res.state):
                grow_csr = self._grow_csr
                self.state = res.state
                if attempt > 0:
                    # growth moved every slot, so the saved snapshot and the
                    # queue's base are void (the setter dropped them); the
                    # rehash's snapshot-compact made the grown state's
                    # snapshot: queue this batch against it
                    if mutating and grow_csr is not None and self.csr_maintenance == "delta":
                        self._delta_base = grow_csr
                        self._delta_batches = [(ops0, us0, vs0)]
                elif not mutating:
                    # abstractly identical pre and post state: the snapshot
                    # and the queue stay as valid as they were
                    self._csr = saved_csr
                    self._delta_base, self._delta_batches = delta_base, delta_batches
                elif delta_base is not None and self.csr_maintenance == "delta":
                    # a queue past the fold's own fallback threshold would
                    # rebuild anyway: drop it and stop accumulating
                    delta_batches = delta_batches + [(ops0, us0, vs0)]
                    if sum(b[0].size for b in delta_batches) > delta_base.e_capacity // 4:
                        delta_base, delta_batches = None, []
                    self._delta_base, self._delta_batches = delta_base, delta_batches
                return res.success[:n].cpu().numpy()
            # discard post-state; grow from pre-state; retry the same batch
            self.state = self._grow(pre)
        raise RuntimeError("graph growth did not converge")

    def _needs_growth(self, state: GraphState) -> bool:
        v_used, e_used = _used_slots(state)
        return (v_used > GROW_LOAD_FACTOR * state.v_capacity) or (
            e_used > GROW_LOAD_FACTOR * state.e_capacity
        )

    def _grow(self, state: GraphState) -> GraphState:
        v_used, e_used = _used_slots(state)
        new_vcap = state.v_capacity
        new_ecap = state.e_capacity
        # grow whichever table is crowded (or both, when neither is)
        if v_used > GROW_LOAD_FACTOR * state.v_capacity / 2:
            new_vcap *= 2
        if e_used > GROW_LOAD_FACTOR * state.e_capacity / 2:
            new_ecap *= 2
        if new_vcap == state.v_capacity and new_ecap == state.e_capacity:
            new_vcap *= 2
            new_ecap *= 2
        # the snapshot-compact rides the device rehash; on the host it would
        # be an eager build_csr a grow attempt, so it stays lazy there
        impl = maintenance.resolve_impl(self.maintenance_impl)
        with_csr = impl != "host" and self.csr_maintenance == "delta"
        new_state, csr = _rehash_escalating(state, new_vcap, new_ecap, impl, with_csr)
        # becomes the delta base of the retried batch in apply() (the state
        # setter, which installs the grown state next, leaves it alone)
        self._grow_csr = csr
        return new_state

    # -- the paper's six-operation convenience API -------------------------
    def add_vertex(self, u: int) -> bool:
        return bool(self.apply([OP_ADD_VERTEX], [u])[0])

    def remove_vertex(self, u: int) -> bool:
        return bool(self.apply([OP_REMOVE_VERTEX], [u])[0])

    def contains_vertex(self, u: int) -> bool:
        return bool(self.apply([OP_CONTAINS_VERTEX], [u])[0])

    def add_edge(self, u: int, v: int) -> bool:
        return bool(self.apply([OP_ADD_EDGE], [u], [v])[0])

    def remove_edge(self, u: int, v: int) -> bool:
        return bool(self.apply([OP_REMOVE_EDGE], [u], [v])[0])

    def contains_edge(self, u: int, v: int) -> bool:
        return bool(self.apply([OP_CONTAINS_EDGE], [u], [v])[0])

    # -- traversal queries (batched wait-free reachability) -----------------
    #
    # Every query runs against one cached TraversalCSR snapshot of the
    # post-batch state, made lazily on the first query after a mutating batch.

    def traversal_csr(self) -> traversal.TraversalCSR:
        """The cached consistent snapshot all queries linearize against.

        With ``csr_maintenance="delta"``, the update batches queued since the
        last query are folded into the previous snapshot in one
        :func:`repro_torch.core.traversal.apply_delta` (it re-probes the
        union of the touched keys against the current state, so one fold over
        many batches is exact); otherwise the snapshot is rebuilt."""
        if self._csr is None:
            if self._delta_base is not None and self._delta_batches:
                batches = self._delta_batches
                self._csr = traversal.apply_delta(
                    self._delta_base,
                    self.state,
                    np.concatenate([b[0] for b in batches]),
                    np.concatenate([b[1] for b in batches]),
                    np.concatenate([b[2] for b in batches]),
                    impl=self.maintenance_impl,
                )
            else:
                self._csr = traversal.build_csr(self.state)
            self._delta_base = None
            self._delta_batches = []
        return self._csr

    def _pad_keys(self, keys: Sequence[int]) -> Tuple[torch.Tensor, int]:
        """Pad a query key batch to a power-of-two bucket with EMPTY_KEY lanes."""
        arr = np.asarray(keys, np.int32)
        padded = traversal._pad_pow2(arr, EMPTY_KEY)
        return torch.as_tensor(padded, device=self.device), arr.shape[0]

    def reachable(self, us, vs):
        """Batched directed reachability: bool[n], ``us[i] ↝ vs[i]``.
        False when either endpoint is absent; ``u ↝ u`` is True iff u exists.
        Scalars are accepted and return a plain bool."""
        scalar = np.isscalar(us)
        if scalar:
            us, vs = [us], [vs]
        if len(us) != len(vs):
            raise ValueError(f"reachable: {len(us)} sources vs {len(vs)} targets")
        pu, n = self._pad_keys(us)
        pv, _ = self._pad_keys(vs)
        out = traversal.reachable(self.traversal_csr(), pu, pv, self.traversal_impl)
        out = out[:n].cpu().numpy()
        return bool(out[0]) if scalar else out

    def bfs(self, u: int) -> Dict[int, int]:
        """BFS level map from ``u``: {vertex_key: hop_distance}, ``u`` at 0.
        Empty when ``u`` is absent."""
        return self.bfs_batch([u])[0]

    def bfs_batch(self, sources: Sequence[int]) -> List[Dict[int, int]]:
        """Batched BFS: one level map per source, all against one snapshot."""
        pk, n = self._pad_keys(sources)
        csr = self.traversal_csr()
        levels = traversal.bfs_levels(csr, pk, self.traversal_impl)[:n].cpu().numpy()
        v_key = csr.v_key.cpu().numpy()
        out = []
        for row in levels:
            hit = np.nonzero(row >= 0)[0]
            out.append(dict(zip(v_key[hit].tolist(), row[hit].tolist())))
        return out

    def khop(self, u: int, k: int) -> Set[int]:
        """Vertex keys within ≤k directed hops of ``u`` (including ``u``)."""
        pk, _ = self._pad_keys([u])
        csr = self.traversal_csr()
        mask = traversal.khop_mask(csr, pk, int(k), self.traversal_impl)[0].cpu().numpy()
        return set(csr.v_key.cpu().numpy()[mask].tolist())

    def get_path(self, u: int, v: int) -> Optional[List[int]]:
        """A shortest directed path ``u ↝ v`` as an explicit key list, or
        ``None`` when unreachable or either endpoint is absent."""
        return self.get_path_batch([u], [v])[0]

    def get_path_batch(self, us, vs) -> List[Optional[List[int]]]:
        """Batched ``GetPath``: one shortest path (or None) per (u, v) pair,
        all answered against one snapshot; the host walks the canonical
        parent chain back from each target."""
        if len(us) != len(vs):
            raise ValueError(f"get_path_batch: {len(us)} sources vs {len(vs)} targets")
        pu, n = self._pad_keys(us)
        pv, _ = self._pad_keys(vs)
        csr = self.traversal_csr()
        levels, parents, vslot, vlive = (
            x[:n].cpu().numpy()
            for x in traversal.path_probe(csr, pu, pv, self.traversal_impl)
        )
        v_key = csr.v_key.cpu().numpy()
        out: List[Optional[List[int]]] = []
        for i in range(n):
            if not vlive[i] or levels[i, vslot[i]] < 0:
                out.append(None)
                continue
            chain = [int(vslot[i])]
            while levels[i, chain[-1]] > 0:
                chain.append(int(parents[i, chain[-1]]))
            out.append([int(v_key[s]) for s in reversed(chain)])
        return out

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> Tuple[set, set]:
        """Abstract (V, E): the live vertex keys and the incarnation-valid
        edge keys."""
        v_mask, e_mask = traversal.snapshot_live(self.state)
        v_mask = v_mask.cpu().numpy()
        e_mask = e_mask.cpu().numpy()
        verts = set(self.state.v_key.cpu().numpy()[v_mask].tolist())
        eu = self.state.e_key_u.cpu().numpy()[e_mask].tolist()
        ev = self.state.e_key_v.cpu().numpy()[e_mask].tolist()
        return verts, set(zip(eu, ev))

"""Host-side wrapper: the *unbounded* wait-free graph.

Port of ``repro.core.graph.WaitFreeGraph``, with the wait-free engine or its
fast-path-slow-path twin (``mode="fpsp"``), on one shard or hash-prefix
sharded (``n_shards``).  ``WaitFreeGraph`` owns the :class:`GraphState` (or
the per-shard states) plus the global phase counter (the paper's
``maxPhase`` fetch-and-add — a host-side monotone counter; each batch gets
``counter + iota`` stamps).  "Unbounded" is amortized growth: every engine
pass is *transactional* — if a bounded probe chain or insert round tripped
its cap (``ok == False``), the post-state is discarded, the tables are grown
(rehash = Harris physical deletion), and the same batch is re-applied
against the grown pre-state.

The graph lives on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and raises where no card is present.

Telemetry (``obs=`` / ``REPRO_OBS``) hangs off every public entry point:
spans, fast-path and claim-round counters, growth events — all derived from
stats the passes compute anyway and read only when a registry is enabled,
so enabling it never changes results.  Metric names:
``docs/OBSERVABILITY.md``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
# obs.metrics imports nothing of repro_torch.core: no import cycle
from ..obs import metrics as obsm
from . import engine, fastpath, maintenance, sharding, traversal
from .types import (
    EDGE_OPS,
    EMPTY_KEY,
    GROW_LOAD_FACTOR,
    INT32_MAX,
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
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
    GraphState,
    OpBatch,
    is_pow2,
    make_batch,
    make_state,
)

_MAX_GROW_ATTEMPTS = 12

_MUTATING_OPS = (OP_ADD_VERTEX, OP_REMOVE_VERTEX, OP_ADD_EDGE, OP_REMOVE_EDGE)


def _bucket_size(n: int) -> int:
    """Power-of-two batch bucket (floor 64), as in ``repro``: the padding
    and phase stamps must match it for the states to stay identical (the
    sharded path pads each sub-batch by it too)."""
    return max(64, 1 << max(n - 1, 1).bit_length())


def _used_slots(state: GraphState) -> Tuple[int, int]:
    """(used vertex slots, used edge slots), tombstones included — one read
    back to the host."""
    counts = torch.stack([(state.v_key != EMPTY_KEY).sum(), (state.e_key_u != EMPTY_KEY).sum()])
    v_used, e_used = counts.tolist()
    return v_used, e_used


def _live_counts(states: Sequence[GraphState]) -> List[List[int]]:
    """``[v_live, e_live, v_used, e_used]`` per state, in one read (on the
    first state's device)."""
    dev = states[0].device
    flat = torch.stack([
        x.to(dev) for st in states
        for x in (st.v_live.sum(), st.e_live.sum(), (st.v_key != EMPTY_KEY).sum(),
                  (st.e_key_u != EMPTY_KEY).sum())
    ]).tolist()
    return [flat[4 * i:4 * i + 4] for i in range(len(states))]


def _crowded(v_used: int, e_used: int, state: GraphState) -> bool:
    return v_used > GROW_LOAD_FACTOR * state.v_capacity or (
        e_used > GROW_LOAD_FACTOR * state.e_capacity
    )


def _upload(arrays: Sequence[np.ndarray], devices) -> List[torch.Tensor]:
    """The int32 ``arrays`` on their ``devices`` (one a array) in one
    transfer a device, as views of one buffer, each of its array's shape."""
    out: List[Optional[torch.Tensor]] = [None] * len(arrays)
    for dev in dict.fromkeys(devices):
        mine = [i for i, d in enumerate(devices) if d == dev]
        flat = torch.as_tensor(np.concatenate([arrays[i].ravel() for i in mine]), device=dev)
        off = 0
        for i in mine:
            out[i] = flat[off:off + arrays[i].size].view(arrays[i].shape)
            off += arrays[i].size
    return out


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
    for attempt in range(_MAX_GROW_ATTEMPTS):
        new_state, csr, ok = maintenance.rehash(
            state, new_vcap, new_ecap, impl=impl, with_csr=with_csr
        )
        if ok:
            return new_state, csr
        # placement overflowed even at the doubled capacity: rare enough to
        # log as an event, not only a counter
        obsm.counter("growth.escalations")
        obsm.event("growth.escalation", attempt=attempt, v_capacity=new_vcap,
                   e_capacity=new_ecap)
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
    recompacts it on the next query.  The fold is one-shard only: a sharded
    graph rebuilds its fused snapshot.

    ``maintenance_impl`` selects where table maintenance (the growth rehash,
    the delta fold's splice, and a sharded graph's vertex directory and
    snapshot fusion) runs: ``"device"`` (the ``compact`` kernels on the
    graph's device; a one-shard growth then also hands over the grown
    state's snapshot, the rehash's snapshot-compact) or ``"host"`` (the
    numpy reference); ``None`` means ``"device"``.  Both give identical
    tables and snapshots.

    ``n_shards`` hash-prefix-partitions both tables into that many
    per-shard states (:mod:`repro_torch.core.sharding`): each shard owns
    ``1/n_shards`` of the vertex and of the edge key space, ops are routed
    by the prefix of the hash the probe sequence uses, and a cross-shard
    stabbing wave answers endpoint liveness between the vertex and edge
    settlement phases.  ``mesh`` is a sequence of devices (default
    ``[device]``: every shard a logical shard on the graph's device): shard
    ``i`` lives on ``mesh[i % len(mesh)]`` and runs its waves there, and the
    cross-shard steps (the route's upload of the gather plan, the gathered
    stab answers, the attempt's one read, the directory, the fused snapshot
    and every query) run on ``mesh[0]``, the graph's ``device``.  Any shard
    count and any placement give identical answers.

    ``obs`` enables telemetry (:mod:`repro_torch.obs`): ``None`` defers to
    the ``REPRO_OBS`` environment variable, ``True`` attaches a fresh
    registry, ``False`` the no-op, and a registry instance is shared as is.
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
        mesh=None,
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
        maintenance.resolve_impl(maintenance_impl)
        if mesh is not None:
            mesh = sharding.check_mesh(mesh)
            if device is not None and torch.device(device) != mesh[0]:
                raise ValueError("the graph's device must be its mesh's first device")
            device = mesh[0]
        self.device = resolve_device(device, "WaitFreeGraph")
        if traversal_impl == "kernel" and self.device.type != "cuda":
            raise ValueError("traversal_impl='kernel' needs the graph on the card")
        self.mode = mode
        self._apply_fn = engine.apply_batch if mode == "waitfree" else fastpath.apply_batch_fpsp
        self.traversal_impl = traversal_impl
        self.csr_maintenance = csr_maintenance
        self.maintenance_impl = maintenance_impl
        self.obs = obsm.resolve(obs)
        self._grow_csr: Optional[traversal.TraversalCSR] = None
        self.n_shards = n_shards
        self._mesh = None
        if n_shards == 1:
            self.state = make_state(v_capacity, e_capacity, device=self.device)
        else:
            for cap, name in ((v_capacity, "v_capacity"), (e_capacity, "e_capacity")):
                if cap % n_shards or not is_pow2(cap // n_shards):
                    raise ValueError(
                        f"{name} must split into power-of-two per-shard capacities")
            self._mesh = mesh if mesh is not None else [self.device]
            self.shards = sharding.place_shards(
                sharding.make_shard_states(v_capacity // n_shards, e_capacity // n_shards,
                                           n_shards, device=self.device),
                self._mesh,
            )
        self._phase = 0  # the paper's maxPhase counter

    @property
    def state(self) -> GraphState:
        if self.n_shards > 1:
            raise AttributeError(
                "sharded graph: per-shard states live on .shards "
                "(both tables are hash-prefix partitions)"
            )
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

    @property
    def shards(self) -> List[GraphState]:
        return self._shards

    @shards.setter
    def shards(self, value) -> None:
        # the state setter's contract; the fused snapshot is rebuilt from
        # scratch (the delta fold is one-shard only)
        self._shards = list(value)
        self._csr = None
        self._delta_base = None
        self._delta_batches = []

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
        reg = self.obs
        with obsm.use(reg):
            reg.counter("apply.batches")
            reg.counter("apply.ops", n)
            reg.hist("apply.batch_size", n)
            if self.n_shards > 1:
                with reg.span("graph.apply_sharded"):
                    return self._apply_sharded(ops0, us0, vs0)
            with reg.span("graph.apply"):
                return self._apply_dense(ops0, us0, vs0)

    def _apply_dense(self, ops0, us0, vs0) -> np.ndarray:
        """The one-shard engine dispatch behind :meth:`apply`."""
        n = ops0.shape[0]
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
                # the successful attempt alone feeds the counters: discarded
                # attempts re-run the same lanes
                if self.obs.enabled:
                    self._record_engine_stats(self.obs, res.stats)
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

    def _record_engine_stats(self, reg, stats) -> None:
        """Fold one successful engine pass's stats vector (types.STAT_*)
        into the registry: the one read obs adds, only when enabled."""
        s = stats.tolist()
        reg.counter("engine.inserted", s[STAT_INSERTED])
        reg.counter("engine.vops", s[STAT_VOPS])
        reg.counter("engine.eops", s[STAT_EOPS])
        reg.hist("engine.claim_rounds", s[STAT_CLAIM_ROUNDS])
        if self.mode == "fpsp":
            reg.counter("fastpath.ops", s[STAT_VOPS] + s[STAT_EOPS])
            reg.counter("fastpath.vops", s[STAT_VOPS])
            reg.counter("fastpath.eops", s[STAT_EOPS])
            reg.counter("fastpath.conflicted", s[STAT_CONFLICTED])
            reg.counter("fastpath.vertex_conflicts", s[STAT_V_CONFLICTS])
            reg.counter("fastpath.edge_conflicts", s[STAT_E_CONFLICTS])
            reg.counter("fastpath.edge_dup", s[STAT_EDGE_DUP])
            reg.counter(
                "fastpath.slow_batches" if s[STAT_CONFLICTED] else "fastpath.fast_batches"
            )

    def _record_sharded_stats(self, reg, v_stats, e_stats) -> None:
        """Per-shard twin of :meth:`_record_engine_stats`: the
        ``settle_vertices``/``settle_edges`` stats of one successful sharded
        attempt (lists of ints).  The edge-lane fastpath counters sum to the
        same totals for any shard count (duplicate ``(u, v)`` lanes
        co-locate on one shard)."""
        for (v_ins, v_rounds, n_vops), (e_dup, e_ins, e_rounds, n_eops) in zip(v_stats, e_stats):
            reg.counter("engine.inserted", v_ins + e_ins)
            reg.counter("engine.vops", n_vops)
            reg.counter("engine.eops", n_eops)
            reg.hist("engine.claim_rounds", v_rounds + e_rounds)
            if self.mode == "fpsp":
                reg.counter("fastpath.eops", n_eops)
                reg.counter("fastpath.edge_dup", e_dup)
                reg.counter("fastpath.slow_batches" if e_dup else "fastpath.fast_batches")

    def _needs_growth(self, state: GraphState) -> bool:
        return _crowded(*_used_slots(state), state)

    def _grow(self, state: GraphState) -> GraphState:
        v, e, v_used, e_used = _live_counts([state])[0]
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
        impl = maintenance.resolve_impl(self.maintenance_impl)
        if self.obs.enabled:
            self.obs.counter("growth.events")
            self.obs.event("growth.grow", v_before=state.v_capacity, v_after=new_vcap,
                           e_before=state.e_capacity, e_after=new_ecap, v_live=v, e_live=e)
        # the snapshot-compact rides the device rehash; on the host it would
        # be an eager build_csr a grow attempt, so it stays lazy there
        with_csr = impl != "host" and self.csr_maintenance == "delta"
        new_state, csr = _rehash_escalating(state, new_vcap, new_ecap, impl, with_csr)
        # becomes the delta base of the retried batch in apply() (the state
        # setter, which installs the grown state next, leaves it alone)
        self._grow_csr = csr
        return new_state

    # -- hash-prefix sharded apply (see repro_torch.core.sharding) ----------

    @staticmethod
    def _sub_batch(ops0, us0, vs0, phases0, idx) -> np.ndarray:
        """One shard's owned lanes as the (op, u, v, phase) rows of a
        pow2-bucketed sub-batch (floor 64).  Lanes keep their global phase
        stamps; padding lanes are NOPs with phase 0, inert in every wave."""
        m = idx.size
        cols = np.zeros((4, _bucket_size(m)), np.int32)
        cols[0, :m] = ops0[idx]
        cols[1, :m] = us0[idx]
        cols[2, :m] = vs0[idx]
        cols[3, :m] = phases0[idx]
        return cols

    def _apply_sharded(self, ops0, us0, vs0) -> np.ndarray:
        """The ``n_shards > 1`` twin of ``apply``: route → vertex settle →
        stab → gather → edge settle, and per-shard growth.

          A. ``settle_vertices`` per shard over its owned vertex ops,
             returning per-lane transition payloads;
          B. ``answer_stabs`` per endpoint-owner shard: every edge lane's two
             (endpoint, phase) queries go to the endpoint's owner and are
             answered against its transitions and pre-batch table;
          C. the answers are gathered on the device for each edge owner, and
             ``settle_edges`` (or its FPSP twin) runs per shard.

        Lanes carry globally unique phase stamps and every vertex op on a
        key lives on one shard, so the stab answers are exactly what the
        one-shard engine computes in-batch.  Everything the host needs to
        route (sub-batches, stab queries, gather indices) goes to the device
        in one transfer a batch; the overflow flags, the used slots, the
        stats (with obs) and the results come back in one read an attempt.
        Growth is transactional, as in ``apply``."""
        n = ops0.shape[0]
        S = self.n_shards
        reg = self.obs
        dev = self.device
        mutating = bool(np.isin(ops0, _MUTATING_OPS).any())
        saved_csr = None if mutating else self._csr
        with reg.span("phase.route"):
            shard_idx, _ = sharding.route_ops(ops0, us0, vs0, S)
            phases0 = (self._phase + np.arange(n)).astype(np.int32)
            self._phase += n
            sub = [self._sub_batch(ops0, us0, vs0, phases0, idx) for idx in shard_idx]
        if reg.enabled:
            sizes = [int(idx.size) for idx in shard_idx]
            reg.hist("shard.subbatch_size", sizes)
            if sum(sizes):
                # max-over-mean routed load: 1.0 = perfectly balanced
                reg.gauge("shard.balance", max(sizes) * S / sum(sizes))

        # stab queries: two (endpoint, phase) probes an edge lane, routed to
        # the endpoint's owner (fixed across growth attempts: growth keeps
        # the abstract graph, so the answers are too)
        eidx = np.flatnonzero(np.isin(ops0, EDGE_OPS))
        ne = eidx.size
        q_keys = np.concatenate([us0[eidx], vs0[eidx]]).astype(np.int32)
        q_phases = np.concatenate([phases0[eidx], phases0[eidx]])
        q_owner = sharding.shard_of_vertices(q_keys, S)
        q_sel = [np.flatnonzero(q_owner == t) for t in range(S)]
        if reg.enabled:
            reg.counter("stab.queries", 2 * ne)
            reg.hist("shard.stab_fanout", [int(sel.size) for sel in q_sel])
        askers = [t for t in range(S) if q_sel[t].size]
        q_pads = [a for t in askers for a in (traversal._pad_pow2(q_keys[q_sel[t]], INT32_MAX),
                                              traversal._pad_pow2(q_phases[q_sel[t]], 0))]
        # the gather plan: the answers of the askers, concatenated, then one
        # (False, 0) sentinel that non-edge and padding lanes read
        pos = np.empty(2 * ne, np.int64)
        off = 0
        for t in askers:
            pos[q_sel[t]] = off + np.arange(q_sel[t].size)
            off += q_sel[t].size
        lane_q = np.full(n, -1, np.int64)
        lane_q[eidx] = np.arange(ne)
        plans = []
        for idx, cols in zip(shard_idx, sub):
            k = lane_q[idx]
            e = k >= 0
            plan = np.full((2, cols.shape[1]), off, np.int32)
            plan[0, :idx.size][e] = pos[k[e]]
            plan[1, :idx.size][e] = pos[ne + k[e]]
            plans.append(plan)
        # each shard's sub-batch and queries to its device, the gather plan
        # to the graph's
        sdev = [st.v_key.device for st in self._shards]
        dev_arrays = _upload(sub + q_pads + plans,
                             sdev + [sdev[t] for t in askers for _ in (0, 1)] + [dev] * S)
        batches = [OpBatch(*t) for t in dev_arrays[:S]]
        queries = {t: (dev_arrays[S + 2 * i], dev_arrays[S + 2 * i + 1])
                   for i, t in enumerate(askers)}
        gathers = dev_arrays[S + 2 * len(askers):]
        sentinel = (torch.zeros(1, dtype=torch.bool, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
        settle_edges_fn = (
            engine.settle_edges if self.mode == "waitfree" else fastpath.settle_edges_fpsp
        )
        lanes = np.concatenate(shard_idx)

        for _attempt in range(_MAX_GROW_ATTEMPTS):
            pre = self._shards  # kept alive for transactional retry
            overs = []

            # A. vertex settlement per shard
            with reg.span("phase.settle_vertices"):
                states_a, v_res, evs, v_stats = [], [], [], []
                for s in range(S):
                    st, res, ev_l, ev_i, over, v_st = engine.settle_vertices(pre[s], batches[s])
                    overs.append(over)
                    states_a.append(st)
                    v_res.append(res)
                    evs.append((ev_l, ev_i))
                    v_stats.append(v_st)

            # B. stabbing wave: each owner answers against its pre-wave table
            with reg.span("phase.answer_stabs"):
                ans_live, ans_inc = [], []
                for t in askers:
                    qk, qp = queries[t]
                    live, inc, over = engine.answer_stabs(pre[t], batches[t], *evs[t], qk, qp)
                    overs.append(over)
                    ans_live.append(live[:q_sel[t].size].to(dev))
                    ans_inc.append(inc[:q_sel[t].size].to(dev))
            with reg.span("phase.gather"):
                a_live = torch.cat(ans_live + [sentinel[0]])
                a_inc = torch.cat(ans_inc + [sentinel[1]])
                ends = [tuple(a.to(sdev[s]) for a in (a_live[g[0]], a_inc[g[0]],
                                                       a_live[g[1]], a_inc[g[1]]))
                        for s, g in enumerate(gathers)]

            # C. edge settlement per shard, fed the gathered answers
            with reg.span("phase.settle_edges"):
                states_c, e_stats, outs = [], [], []
                for s in range(S):
                    st, e_res, over, e_st = settle_edges_fn(states_a[s], batches[s], *ends[s])
                    overs.append(over)
                    states_c.append(st)
                    e_stats.append(e_st)
                    m = shard_idx[s].size
                    outs.append((v_res[s][:m] | e_res[:m]).to(torch.int32))

            # one read: overflow, used slots a shard, stats (obs), results
            status = [torch.stack([o.to(dev) for o in overs]).any().to(torch.int32)]
            status += [c.to(dev, torch.int32) for st in states_c
                       for c in ((st.v_key != EMPTY_KEY).sum(), (st.e_key_u != EMPTY_KEY).sum())]
            head = 1 + 2 * S
            if reg.enabled:
                status += [x.to(dev) for st in v_stats + e_stats for x in st]
            read = torch.cat([torch.stack(status)] + [o.to(dev) for o in outs]).cpu().numpy()
            used = read[1:head].reshape(S, 2)
            if not read[0] and not self._needs_growth_sharded(states_c, used):
                self.shards = states_c
                # the successful attempt alone feeds the counters
                if reg.enabled:
                    flat = read[head:head + 7 * S].tolist()
                    self._record_sharded_stats(
                        reg, [flat[3 * s:3 * s + 3] for s in range(S)],
                        [flat[3 * S + 4 * s:3 * S + 4 * s + 4] for s in range(S)])
                if not mutating:
                    # abstractly identical pre and post state: the cached
                    # fused snapshot stays as valid as it was
                    self._csr = saved_csr
                out = np.zeros(n, bool)
                out[lanes] = read[read.size - lanes.size:].astype(bool)
                return out
            with reg.span("phase.compact"):
                self.shards = self._grow_shards(pre)
        raise RuntimeError("graph growth did not converge")

    def _needs_growth_sharded(self, states: List[GraphState], used) -> bool:
        """Whether any shard is past the load factor; ``used`` holds each
        shard's (used vertex slots, used edge slots)."""
        return any(_crowded(int(v), int(e), st) for (v, e), st in zip(used, states))

    def _grow_shards(self, states: List[GraphState]) -> List[GraphState]:
        """Per-shard capacity policy: each shard doubles whichever of its
        tables is crowded (both key spaces are partitioned, so the decisions
        are independent).  Edge validity in each rehash is judged against
        the *global* endpoint index, computed once from the pre-states; the
        escalation loop re-doubles only the shards whose placement
        overflowed."""
        counts = _live_counts(states)
        new_vcaps, new_ecaps = [], []
        for st, (_, _, v_used, e_used) in zip(states, counts):
            v_crowd = v_used > GROW_LOAD_FACTOR * st.v_capacity / 2
            e_crowd = e_used > GROW_LOAD_FACTOR * st.e_capacity / 2
            new_vcaps.append(2 * st.v_capacity if v_crowd else st.v_capacity)
            new_ecaps.append(2 * st.e_capacity if e_crowd else st.e_capacity)
        if all(vc == st.v_capacity and ec == st.e_capacity
               for vc, ec, st in zip(new_vcaps, new_ecaps, states)):
            # an engine-pass overflow with no crowded table: a pathological
            # probe chain somewhere — double everything, as with one shard
            new_vcaps = [2 * vc for vc in new_vcaps]
            new_ecaps = [2 * ec for ec in new_ecaps]
        impl = maintenance.resolve_impl(self.maintenance_impl)
        if self.obs.enabled:
            self.obs.counter("growth.events")
            self.obs.event(
                "growth.grow_shards",
                v_before=[st.v_capacity for st in states],
                v_after=list(new_vcaps),
                e_before=[st.e_capacity for st in states],
                e_after=list(new_ecaps),
            )
        endpoints = sharding.gather_live_vertices(states, impl)
        for _ in range(_MAX_GROW_ATTEMPTS):
            outs = [
                maintenance.rehash(st, vc, ec, impl=impl, with_csr=False, endpoints=endpoints)
                for st, vc, ec in zip(states, new_vcaps, new_ecaps)
            ]
            oks = [bool(ok) for _, _, ok in outs]
            if all(oks):
                return sharding.place_shards([st for st, _, _ in outs], self._mesh)
            self.obs.counter("growth.escalations")
            new_vcaps = [vc if ok else 2 * vc for vc, ok in zip(new_vcaps, oks)]
            new_ecaps = [ec if ok else 2 * ec for ec, ok in zip(new_ecaps, oks)]
        raise RuntimeError("rehash placement did not converge")

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
        many batches is exact); otherwise the snapshot is rebuilt.  A sharded
        graph fuses its shards
        (:func:`repro_torch.core.sharding.fuse_partitioned`, on the shards'
        device unless ``maintenance_impl="host"``)."""
        reg = self.obs
        if self.n_shards > 1:
            if self._csr is None:
                with obsm.use(reg), reg.span("csr.fuse"):
                    reg.counter("csr.fuse")
                    self._csr = sharding.fuse_partitioned(self._shards,
                                                          impl=self.maintenance_impl)
            return self._csr
        if self._csr is None:
            with obsm.use(reg):
                if self._delta_base is not None and self._delta_batches:
                    batches = self._delta_batches
                    with reg.span("csr.delta_fold"):
                        reg.counter("csr.delta_fold")
                        self._csr = traversal.apply_delta(
                            self._delta_base,
                            self.state,
                            np.concatenate([b[0] for b in batches]),
                            np.concatenate([b[1] for b in batches]),
                            np.concatenate([b[2] for b in batches]),
                            impl=self.maintenance_impl,
                        )
                else:
                    with reg.span("csr.build"):
                        reg.counter("csr.build")
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
        self.obs.counter("query.reachable", n)
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
        if self.obs.enabled:
            # frontier iterations per source = deepest reached level
            self.obs.counter("query.bfs", n)
            self.obs.hist("bfs.depth", [int(max(row.max(initial=0), 0)) for row in levels])
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
        self.obs.counter("query.khop")
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
        self.obs.counter("query.get_path", n)
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
    def probe_health(self) -> Dict[str, Dict[int, int]]:
        """Physical probe-chain-length histograms over both hash tables (all
        shards), recorded into the graph's registry as ``probe.vertex`` /
        ``probe.edge`` and returned (:mod:`repro_torch.obs.probes`)."""
        from ..obs import probes

        return probes.record(self.obs, self)

    def snapshot(self) -> Tuple[set, set]:
        """Abstract (V, E): the live vertex keys and the incarnation-valid
        edge keys.  A sharded graph unions the shards' live vertices and
        validates every shard's edge lanes against the global endpoint
        index, on the shards' device."""
        if self.n_shards > 1:
            sk, si = sharding.gather_live_vertices(self._shards)
            eu, ev = sharding.live_edges(self._shards, (sk, si))
            return (set(sk.cpu().numpy().tolist()),
                    set(zip(eu.cpu().numpy().tolist(), ev.cpu().numpy().tolist())))
        v_mask, e_mask = traversal.snapshot_live(self.state)
        v_mask = v_mask.cpu().numpy()
        e_mask = e_mask.cpu().numpy()
        verts = set(self.state.v_key.cpu().numpy()[v_mask].tolist())
        eu = self.state.e_key_u.cpu().numpy()[e_mask].tolist()
        ev = self.state.e_key_v.cpu().numpy()[e_mask].tolist()
        return verts, set(zip(eu, ev))

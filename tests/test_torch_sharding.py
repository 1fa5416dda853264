"""``repro_torch``'s hash-prefix sharded graph against ``repro``'s.

Held exactly (int32 and bool bit for bit) against the reference, on shard
states carried across with ``state_from_numpy``:

* the routing functions and the shard histograms at S ∈ {1, 2, 4, 8};
* ``build_vertex_directory`` and ``fuse_partitioned`` by both routes
  (``impl="device"``, the shards' device; ``impl="host"``, numpy);
* ``rehash(endpoints=...)`` by both implementations;
* ``settle_vertices``, ``answer_stabs``, ``settle_edges`` and
  ``settle_edges_fpsp`` on the same shard states and sub-batches;
* a churned corpus in both modes at ``n_shards ∈ {2, 4}``: every batch's
  results, every shard's tables, the fused snapshot and the query answers.

And the port alone, as ``tests/test_sharding.py`` holds the reference:
answers identical across ``n_shards ∈ {1, 2, 4}`` on 25 seeds, growth at
small capacities, a hot vertex that loads one shard, the ``state`` guard and
the refusal of a mesh that names a ``meta`` device; on the card, shards
placed on ``["cuda:0", "cpu"]`` bit for bit as on one device.  JAX is imported inside the fixture
``j``, so the ``cuda`` test at the end runs where there is no JAX.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import assert_states_equal, cuda_device, state_columns, to_np  # noqa: F401
from repro_torch.core import SequentialGraph, WaitFreeGraph, engine, fastpath, maintenance
from repro_torch.core import run_sequential, sharding
from repro_torch.core.hashing import edge_hash32_np, vertex_hash32_np
from repro_torch.core.traversal import _pad_pow2
from repro_torch.core.types import (
    EDGE_OPS,
    EMPTY_KEY,
    INT32_MAX,
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_NOP,
    OP_REMOVE_VERTEX,
    VERTEX_OPS,
    OpBatch,
    state_from_numpy,
)
from repro_torch.core.workloads import (
    initial_vertices,
    sample_batch,
    sample_query_pairs,
    sample_update_batch,
    shard_balance,
    skewed_update_batch,
)

KEY_SPACE = 24
SHARD_COUNTS = (1, 2, 4)
IMPLS = ("device", "host")


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card test at
    the end runs where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import WaitFreeGraph as JGraph
    from repro.core import engine as j_engine
    from repro.core import fastpath as j_fastpath
    from repro.core import maintenance as j_maint
    from repro.core import sharding as j_sharding
    from repro.core import workloads as j_workloads
    from repro.core.types import OpBatch as JOpBatch

    return SimpleNamespace(jnp=jnp, Graph=JGraph, engine=j_engine, fastpath=j_fastpath,
                           maint=j_maint, sharding=j_sharding, workloads=j_workloads,
                           OpBatch=JOpBatch)


def _churn_stream(seed: int):
    """tests/test_sharding.py's churn recipe: bulk traversal traffic, a
    deletion wave, incarnation revivals, fresh edges."""
    rng = np.random.default_rng(seed)
    stream = [sample_batch(rng, 192, "traversal", key_space=KEY_SPACE) for _ in range(2)]
    kill = rng.choice(KEY_SPACE, size=8, replace=False).astype(np.int32)
    stream.append((np.full(8, OP_REMOVE_VERTEX, np.int32), kill, np.zeros(8, np.int32)))
    stream.append((np.full(4, OP_ADD_VERTEX, np.int32), kill[:4], np.zeros(4, np.int32)))
    stream.append(sample_batch(rng, 96, "traversal", key_space=KEY_SPACE))
    return stream, rng


def _assert_same_fields(got, want, ctx=""):
    for name in want._fields:
        a, b = to_np(getattr(got, name)), to_np(getattr(want, name))
        assert a.dtype == b.dtype, (ctx, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {name}")


def _carried(jg):
    """The reference graph's shards as port states on the CPU."""
    return [state_from_numpy(state_columns(st)) for st in jg.shards]


def _shard_states(g):
    return list(g.shards) if g.n_shards > 1 else [g.state]


def _assert_partition_invariants(g, oracle, ctx=""):
    """Every shard holds only owned rows; live vertices are unique and the
    oracle's vertex set."""
    states = _shard_states(g)
    n = len(states)
    all_live = []
    for s, st in enumerate(states):
        vk = to_np(st.v_key)
        present = vk != EMPTY_KEY
        assert (sharding.shard_of_vertices(vk[present], n) == s).all(), (ctx, s)
        eu, ev = to_np(st.e_key_u), to_np(st.e_key_v)
        ep = eu != EMPTY_KEY
        assert (sharding.shard_of_edges(eu[ep], ev[ep], n) == s).all(), (ctx, s)
        all_live.append(vk[present & to_np(st.v_live)])
    live = np.concatenate(all_live)
    assert len(live) == len(set(live.tolist())), (ctx, "replicated live vertex")
    assert set(live.tolist()) == oracle.vertices, (ctx, "live set diverges")


# ---------------------------------------------------------------------------
# routing and histograms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_routing_and_histograms_match_repro(j, n_shards):
    rng = np.random.default_rng(n_shards)
    ops, us, vs = sample_batch(rng, 1024, "traversal", key_space=100_000)
    ops[::17] = OP_NOP
    np.testing.assert_array_equal(sharding.shard_of_edges(us, vs, n_shards),
                                  j.sharding.shard_of_edges(us, vs, n_shards))
    np.testing.assert_array_equal(sharding.shard_of_vertices(us, n_shards),
                                  j.sharding.shard_of_vertices(us, n_shards))
    idx, owner = sharding.route_ops(ops, us, vs, n_shards)
    j_idx, j_owner = j.sharding.route_ops(ops, us, vs, n_shards)
    np.testing.assert_array_equal(owner, j_owner)
    assert len(idx) == len(j_idx) == n_shards
    for a, b in zip(idx, j_idx):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sharding.edge_shard_histogram(ops, us, vs, n_shards),
                                  j.sharding.edge_shard_histogram(ops, us, vs, n_shards))
    np.testing.assert_array_equal(sharding.vertex_shard_histogram(us, n_shards),
                                  j.sharding.vertex_shard_histogram(us, n_shards))
    np.testing.assert_array_equal(shard_balance(ops, us, vs, n_shards),
                                  j.workloads.shard_balance(ops, us, vs, n_shards))
    # a partition: each non-NOP lane on exactly one shard, ascending, owned
    seen = np.concatenate(idx)
    np.testing.assert_array_equal(np.sort(seen), np.flatnonzero(ops != OP_NOP))
    k = n_shards.bit_length() - 1
    if k:
        prefix = (edge_hash32_np(us, vs) >> np.uint32(32 - k)).astype(np.int32)
        is_e = np.isin(ops, EDGE_OPS)
        np.testing.assert_array_equal(owner[is_e], prefix[is_e])
        vprefix = (vertex_hash32_np(us) >> np.uint32(32 - k)).astype(np.int32)
        is_v = np.isin(ops, VERTEX_OPS)
        np.testing.assert_array_equal(owner[is_v], vprefix[is_v])


# ---------------------------------------------------------------------------
# the vertex directory, the fusion and the endpoint rehash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n_shards", [2, 4])
def test_directory_fusion_and_endpoint_rehash_match_repro(j, n_shards, impl):
    """On the reference graph's shards: the directory, the gathered index
    and the fused snapshot; then each shard rehashed against the global
    endpoint index, as a growth does, equal to the reference's host rehash,
    with the endpoints as numpy or as tensors."""
    jg = j.Graph(256, 1024, n_shards=n_shards)
    stream, _ = _churn_stream(7)
    for ops, us, vs in stream:
        jg.apply(ops, us, vs)
    states = _carried(jg)
    d = sharding.build_vertex_directory(states, impl=impl)
    _assert_same_fields(d, j.sharding.build_vertex_directory(jg.shards), "directory")
    assert isinstance(d.n_live, int)
    sk, si = sharding.gather_live_vertices(states, impl=impl)
    j_ep = j.sharding.gather_live_vertices(jg.shards)
    np.testing.assert_array_equal(to_np(sk), j_ep[0])
    np.testing.assert_array_equal(to_np(si), j_ep[1])
    csr = sharding.fuse_partitioned(states, impl=impl)
    _assert_same_fields(csr, j.sharding.fuse_partitioned(jg.shards), "fused")
    assert csr.src.device == states[0].device
    # a directory made beforehand gives the same snapshot
    _assert_same_fields(sharding.fuse_partitioned(states, d, impl=impl), csr, "given directory")

    for s, (st, jst) in enumerate(zip(states, jg.shards)):
        vcap, ecap = 2 * st.v_capacity, 4 * st.e_capacity
        want, want_csr, want_ok = j.maint.rehash(jst, vcap, ecap, impl="host", endpoints=j_ep)
        for ep in ((sk, si), j_ep):
            got, got_csr, ok = maintenance.rehash(st, vcap, ecap, impl=impl, endpoints=ep)
            assert ok == bool(want_ok) and got_csr is None and want_csr is None
            assert_states_equal(got, want, f"shard {s}")
        # the shard's own table as the index drops every cross-shard edge
        local, _, _ = maintenance.rehash(st, vcap, ecap, impl=impl)
        assert int(local.e_live.sum()) <= int(got.e_live.sum())


@pytest.mark.parametrize("impl", IMPLS)
def test_empty_sharded_graph_fuses(j, impl):
    """No live vertex: an empty endpoint index, and no valid edge."""
    jg = j.Graph(64, 256, n_shards=4)
    jg.apply([OP_ADD_VERTEX, OP_ADD_VERTEX, OP_ADD_EDGE, OP_REMOVE_VERTEX, OP_REMOVE_VERTEX],
             [1, 2, 1, 1, 2], [0, 0, 2, 0, 0])
    states = _carried(jg)
    _assert_same_fields(sharding.build_vertex_directory(states, impl=impl),
                        j.sharding.build_vertex_directory(jg.shards), "directory")
    _assert_same_fields(sharding.fuse_partitioned(states, impl=impl),
                        j.sharding.fuse_partitioned(jg.shards), "fused")
    g = WaitFreeGraph(64, 256, n_shards=4, maintenance_impl=impl, device="cpu")
    assert g.snapshot() == (set(), set()) and g.traversal_csr().n_edges == 0
    assert not g.reachable(1, 1) and g.bfs(1) == {} and g.get_path(1, 1) is None


# ---------------------------------------------------------------------------
# the phase entry points
# ---------------------------------------------------------------------------


def _both_batches(j, cols):
    tb = OpBatch(*(torch.as_tensor(c) for c in cols))
    jb = j.OpBatch(*(j.jnp.asarray(c) for c in cols))
    return tb, jb


def _assert_outputs_equal(got, want, ctx):
    for i, (a, b) in enumerate(zip(got, want)):
        if hasattr(b, "_fields"):
            assert_states_equal(a, b, f"{ctx} output {i}")
        else:
            a, b = to_np(a), to_np(b)
            assert a.dtype == b.dtype, (ctx, i, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{ctx} output {i}")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_phase_functions_match_repro(j, n_shards):
    """One batch through the three phases by hand, each phase's outputs
    equal to the reference's on the same shard states and sub-batches; the
    edge phase in both modes on the same gathered answers."""
    jg = j.Graph(256, 1024, n_shards=n_shards)
    stream, rng = _churn_stream(11)
    for ops, us, vs in stream:
        jg.apply(ops, us, vs)
    states = _carried(jg)
    ops, us, vs = sample_batch(rng, 160, "balanced", key_space=KEY_SPACE)
    n = ops.size
    shard_idx, _ = sharding.route_ops(ops, us, vs, n_shards)
    phases = (1000 + np.arange(n)).astype(np.int32)
    cols = [WaitFreeGraph._sub_batch(ops, us, vs, phases, idx) for idx in shard_idx]
    batches = [_both_batches(j, c) for c in cols]

    evs, j_evs, after, j_after = [], [], [], []
    for s in range(n_shards):
        got = engine.settle_vertices(states[s], batches[s][0])
        want = j.engine.settle_vertices(jg.shards[s], batches[s][1])
        _assert_outputs_equal(got, want, f"settle_vertices shard {s}")
        after.append(got[0])
        j_after.append(want[0])
        evs.append(got[2:4])
        j_evs.append(want[2:4])

    eidx = np.flatnonzero(np.isin(ops, EDGE_OPS))
    ne = eidx.size
    q_keys = np.concatenate([us[eidx], vs[eidx]]).astype(np.int32)
    q_phases = np.concatenate([phases[eidx], phases[eidx]])
    q_owner = sharding.shard_of_vertices(q_keys, n_shards)
    q_live = np.zeros(2 * ne, bool)
    q_inc = np.zeros(2 * ne, np.int32)
    for t in range(n_shards):
        sel = np.flatnonzero(q_owner == t)
        qk = _pad_pow2(q_keys[sel], INT32_MAX)
        qp = _pad_pow2(q_phases[sel], 0)
        got = engine.answer_stabs(states[t], batches[t][0], *evs[t], torch.as_tensor(qk),
                                  torch.as_tensor(qp))
        want = j.engine.answer_stabs(jg.shards[t], batches[t][1], *j_evs[t],
                                     j.jnp.asarray(qk), j.jnp.asarray(qp))
        _assert_outputs_equal(got, want, f"answer_stabs shard {t}")
        q_live[sel] = to_np(want[0])[:sel.size]
        q_inc[sel] = to_np(want[1])[:sel.size]

    ends = np.zeros((4, n), np.int32)
    ends[:, eidx] = [q_live[:ne], q_inc[:ne], q_live[ne:], q_inc[ne:]]
    for s, idx in enumerate(shard_idx):
        bucket = cols[s].shape[1]
        e = np.zeros((4, bucket), np.int32)
        e[:, :idx.size] = ends[:, idx]
        t_ends = (torch.as_tensor(e[0].astype(bool)), torch.as_tensor(e[1]),
                  torch.as_tensor(e[2].astype(bool)), torch.as_tensor(e[3]))
        j_ends = (j.jnp.asarray(e[0].astype(bool)), j.jnp.asarray(e[1]),
                  j.jnp.asarray(e[2].astype(bool)), j.jnp.asarray(e[3]))
        for name, fn, j_fn in (("settle_edges", engine.settle_edges, j.engine.settle_edges),
                               ("settle_edges_fpsp", fastpath.settle_edges_fpsp,
                                j.fastpath.settle_edges_fpsp)):
            got = fn(after[s], batches[s][0], *t_ends)
            want = j_fn(j_after[s], batches[s][1], *j_ends)
            _assert_outputs_equal(got, want, f"{name} shard {s}")


def test_fast_apply_edges_with_duplicates_takes_the_slow_wave(j):
    """A sub-batch with duplicate (u, v) lanes: settle_edges_fpsp's slow
    wave runs and its stats count the duplicates, as the reference's do."""
    jg = j.Graph(64, 256, n_shards=2)
    jg.apply(*initial_vertices(8))
    st = _carried(jg)[0]
    cols = np.zeros((4, 64), np.int32)
    cols[0, :6] = OP_ADD_EDGE
    cols[1, :6] = [1, 1, 2, 3, 1, 4]
    cols[2, :6] = [2, 2, 3, 4, 2, 5]
    cols[3] = np.arange(64)
    tb, jb = _both_batches(j, cols)
    ends = np.zeros((4, 64), np.int32)
    ends[0, :6] = ends[2, :6] = 1
    ends[1, :6] = ends[3, :6] = 0
    t_ends = (torch.as_tensor(ends[0] > 0), torch.as_tensor(ends[1]),
              torch.as_tensor(ends[2] > 0), torch.as_tensor(ends[3]))
    j_ends = tuple(j.jnp.asarray(to_np(x)) for x in t_ends)
    got = fastpath.settle_edges_fpsp(st, tb, *t_ends)
    want = j.fastpath.settle_edges_fpsp(jg.shards[0], jb, *j_ends)
    _assert_outputs_equal(got, want, "fpsp with duplicates")
    assert int(got[3][0]) == 3  # the three lanes of (1, 2)


# ---------------------------------------------------------------------------
# the churned corpus against the reference
# ---------------------------------------------------------------------------


# (mode, n_shards, seed); seed 2 starts from small tables, so that the shards
# grow through the endpoint rehash (each growth compiles the reference anew,
# so it runs once, in the mode with more paths: FPSP)
CORPUS = [(mode, 2, 0) for mode in ("waitfree", "fpsp")]
CORPUS += [(mode, 4, seed) for mode in ("waitfree", "fpsp") for seed in (0, 1)]
CORPUS.append(("fpsp", 4, 2))


@pytest.mark.parametrize("mode,n_shards,seed", CORPUS)
def test_churned_corpus_matches_repro(j, mode, n_shards, seed):
    """Every batch's bits and every shard's tables after it, then the fused
    snapshot (both routes) and the query answers."""
    caps = (256, 1024) if seed < 2 else (32, 32 * n_shards)
    jg = j.Graph(*caps, mode=mode, n_shards=n_shards)
    graphs = [WaitFreeGraph(*caps, mode=mode, n_shards=n_shards, maintenance_impl=impl,
                            device="cpu") for impl in IMPLS]
    stream, rng = _churn_stream(seed)
    stream.append(sample_update_batch(rng, 40, key_space=KEY_SPACE))
    for i, (ops, us, vs) in enumerate(stream):
        want = jg.apply(ops, us, vs)
        for g in graphs:
            np.testing.assert_array_equal(g.apply(ops, us, vs), want, err_msg=f"batch {i}")
            assert len(g.shards) == n_shards
            for s, (a, b) in enumerate(zip(g.shards, jg.shards)):
                assert_states_equal(a, b, f"batch {i} shard {s}")
    us_q, vs_q = sample_query_pairs(rng, 16, KEY_SPACE)
    j_csr = jg.traversal_csr()
    for g in graphs:
        _assert_same_fields(g.traversal_csr(), j_csr, g.maintenance_impl)
        assert g.snapshot() == jg.snapshot()
        np.testing.assert_array_equal(g.reachable(us_q, vs_q), jg.reachable(us_q, vs_q))
        assert g.bfs_batch(us_q[:4].tolist()) == jg.bfs_batch(us_q[:4].tolist())
        assert g.get_path_batch(us_q[:8], vs_q[:8]) == jg.get_path_batch(us_q[:8], vs_q[:8])
        assert g.khop(int(us_q[0]), 2) == jg.khop(int(us_q[0]), 2)
    if seed == 2:
        assert all(st.v_capacity > caps[0] // n_shards for st in graphs[0].shards)


# ---------------------------------------------------------------------------
# the port alone: tests/test_sharding.py's checks
# ---------------------------------------------------------------------------


def _build_corpus_case(seed, mode, caps=(64, 256)):
    """The churn stream through every shard count (from tables small enough
    to grow once or twice), bits checked against the oracle."""
    graphs = {n: WaitFreeGraph(*caps, mode=mode, n_shards=n, device="cpu")
              for n in SHARD_COUNTS}
    oracle = SequentialGraph()
    stream, rng = _churn_stream(seed)
    for ops, us, vs in stream:
        exp, _ = run_sequential(ops, us, vs, graph=oracle)
        for n, g in graphs.items():
            assert g.apply(ops, us, vs).tolist() == exp, f"n_shards={n}"
    return graphs, oracle, rng


@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
@pytest.mark.parametrize("seed", range(25))
def test_corpus_answers_identical_across_shard_counts(mode, seed):
    graphs, oracle, rng = _build_corpus_case(seed, mode)
    g1 = graphs[1]
    for n in SHARD_COUNTS[1:]:
        _assert_partition_invariants(graphs[n], oracle, f"n_shards={n}")
        assert graphs[n].snapshot() == g1.snapshot() == (oracle.vertices, oracle.edges)
    us_q, vs_q = sample_query_pairs(rng, 16, KEY_SPACE)
    r1 = g1.reachable(us_q, vs_q)
    assert r1.tolist() == [oracle.reachable(int(a), int(b)) for a, b in zip(us_q, vs_q)]
    src = us_q[:4].tolist()
    b1 = g1.bfs_batch(src)
    p1 = g1.get_path_batch(us_q[:8], vs_q[:8])
    for n in SHARD_COUNTS[1:]:
        g = graphs[n]
        np.testing.assert_array_equal(g.reachable(us_q, vs_q), r1)
        assert g.bfs_batch(src) == b1
        # parents ride the shared directory's slots: the same shortest path
        assert g.get_path_batch(us_q[:8], vs_q[:8]) == p1


def test_vertex_directory_is_canonical_across_shard_counts():
    graphs, oracle, _ = _build_corpus_case(7, "waitfree", caps=(256, 1024))
    ref = sharding.build_vertex_directory(_shard_states(graphs[1]))
    assert ref.n_live == len(oracle.vertices)
    np.testing.assert_array_equal(to_np(ref.v_key)[to_np(ref.sorted_slot)], to_np(ref.sorted_key))
    for n in SHARD_COUNTS[1:]:
        for impl in IMPLS:
            d = sharding.build_vertex_directory(_shard_states(graphs[n]), impl=impl)
            _assert_same_fields(d, ref, f"n_shards={n} {impl}")


@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
def test_sharded_rebuild_matches_single_shard_delta(mode):
    """The one-shard graph folds its snapshot, the sharded one fuses it
    anew: the answers agree through a chain of update batches, and a
    read-only batch keeps the fused snapshot."""
    rng = np.random.default_rng(11)
    g1 = WaitFreeGraph(256, 1024, mode=mode, device="cpu")
    g4 = WaitFreeGraph(256, 1024, mode=mode, n_shards=4, device="cpu")
    oracle = SequentialGraph()
    stream = [initial_vertices(KEY_SPACE)]
    stream += [sample_batch(rng, 96, "traversal", key_space=KEY_SPACE) for _ in range(2)]
    stream += [sample_update_batch(rng, 12, key_space=KEY_SPACE) for _ in range(4)]
    for ops, us, vs in stream:
        exp, _ = run_sequential(ops, us, vs, graph=oracle)
        assert g1.apply(ops, us, vs).tolist() == exp
        assert g4.apply(ops, us, vs).tolist() == exp
        us_q, vs_q = sample_query_pairs(rng, 8, KEY_SPACE)
        np.testing.assert_array_equal(g1.reachable(us_q, vs_q), g4.reachable(us_q, vs_q))
        assert g1.snapshot() == g4.snapshot() == (oracle.vertices, oracle.edges)
        assert not g4._delta_batches and g4._delta_base is None
    csr = g4.traversal_csr()
    assert g4.contains_vertex(1) is not None and g4.traversal_csr() is csr
    g4.add_vertex(10_000)
    assert g4.traversal_csr() is not csr


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
def test_growth_stress_partitioned(mode, n_shards):
    """Small tables force repeated per-shard doublings; every shard keeps
    only owned rows, capacities evolve independently, answers stay exact."""
    seed = 1000 + ["waitfree", "fpsp"].index(mode) * 2 + n_shards
    rng = np.random.default_rng(seed)
    g = WaitFreeGraph(32, 32 * n_shards, mode=mode, n_shards=n_shards, device="cpu")
    oracle = SequentialGraph()
    for wave in range(4):
        lo = 60 * wave
        keys = np.arange(lo, lo + 60, dtype=np.int32)
        batches = [
            (np.full(60, OP_ADD_VERTEX, np.int32), keys, np.zeros(60, np.int32)),
            (np.full(20, OP_REMOVE_VERTEX, np.int32), keys[rng.choice(60, 20, replace=False)],
             np.zeros(20, np.int32)),
            (np.full(50, OP_ADD_EDGE, np.int32), rng.integers(lo, lo + 60, 50).astype(np.int32),
             rng.integers(0, lo + 60, 50).astype(np.int32)),
        ]
        for ops, us, vs in batches:
            exp, _ = run_sequential(ops, us, vs, graph=oracle)
            assert g.apply(ops, us, vs).tolist() == exp, wave
        assert g.snapshot() == (oracle.vertices, oracle.edges), wave
        _assert_partition_invariants(g, oracle, f"wave={wave}")
        us_q, vs_q = sample_query_pairs(rng, 8, 60 * (wave + 1))
        assert g.reachable(us_q, vs_q).tolist() == [
            oracle.reachable(int(a), int(b)) for a, b in zip(us_q, vs_q)], wave
    assert all(sh.v_capacity > 32 // n_shards for sh in g.shards)


@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
def test_hot_vertex_shard_imbalance(mode):
    """Zipf endpoints and one pinned hot vertex: its owner shard takes most
    lanes; answers stay exact and the partition intact."""
    hot = 0
    owner = int(sharding.shard_of_vertices(np.array([hot], np.int32), 4)[0])
    rng = np.random.default_rng(21)
    graphs = {n: WaitFreeGraph(256, 1024, mode=mode, n_shards=n, device="cpu")
              for n in SHARD_COUNTS}
    oracle = SequentialGraph()
    seen_imbalance = False
    stream = [initial_vertices(KEY_SPACE)] + [
        skewed_update_batch(rng, 128, key_space=KEY_SPACE, hot_key=hot, hot_frac=0.6)
        for _ in range(4)]
    for ops, us, vs in stream:
        vhist = sharding.vertex_shard_histogram(us, 4)
        seen_imbalance |= bool(vhist[owner] > 2 * vhist.sum() // 4)
        exp, _ = run_sequential(ops, us, vs, graph=oracle)
        for n, g in graphs.items():
            assert g.apply(ops, us, vs).tolist() == exp, n
    assert seen_imbalance
    us_q, vs_q = sample_query_pairs(rng, 16, KEY_SPACE)
    r1 = graphs[1].reachable(us_q, vs_q)
    for n in SHARD_COUNTS[1:]:
        _assert_partition_invariants(graphs[n], oracle, f"skew n_shards={n}")
        assert graphs[n].snapshot() == (oracle.vertices, oracle.edges)
        np.testing.assert_array_equal(graphs[n].reachable(us_q, vs_q), r1)


def test_state_guard_mesh_and_placement():
    g = WaitFreeGraph(64, 256, n_shards=2, device="cpu")
    with pytest.raises(AttributeError):
        g.state
    assert len(g.shards) == 2 and g.shards[0].v_capacity == 32
    csr = g.traversal_csr()
    g.shards = list(g.shards)  # a direct assignment drops the cached snapshot
    assert g.traversal_csr() is not csr
    with pytest.raises(ValueError, match="meta"):
        WaitFreeGraph(64, 256, n_shards=2, mesh=["cpu", "meta"], device="cpu")
    with pytest.raises(ValueError, match="meta"):
        sharding.place_shards(sharding.make_shard_states(8, 8, 2), ["cpu", "meta"])
    with pytest.raises(ValueError):
        WaitFreeGraph(64, 96, n_shards=2, device="cpu")  # 48 is no power of two
    with pytest.raises(ValueError):
        WaitFreeGraph(64, 256, n_shards=3, device="cpu")
    on_mesh = WaitFreeGraph(64, 256, n_shards=4, mesh=sharding.host_local_mesh("cpu"))
    assert on_mesh.device == torch.device("cpu")
    states = sharding.make_shard_states(64, 64, 4)
    for a, b in zip(states, sharding.place_shards(states, sharding.host_local_mesh())):
        assert_states_equal(a, b, "placement")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
def test_cuda_sharded_graph_matches_cpu(cuda_device, mode):
    """The sharded graph on the card (its kernels, the device directory and
    fusion) against the same graph on the CPU: bits, shard tables, the
    fused snapshot by both routes, and the answers, through growth."""
    rng = np.random.default_rng(5)
    stream = [initial_vertices(300)]
    stream += [sample_batch(rng, 512, "traversal", key_space=300) for _ in range(4)]
    stream += [sample_update_batch(rng, 64, key_space=300) for _ in range(2)]
    g_cpu = WaitFreeGraph(64, 256, mode=mode, n_shards=4, device="cpu")
    g_gpu = WaitFreeGraph(64, 256, mode=mode, n_shards=4, device=cuda_device)
    for i, (ops, us, vs) in enumerate(stream):
        np.testing.assert_array_equal(g_gpu.apply(ops, us, vs), g_cpu.apply(ops, us, vs),
                                      err_msg=f"batch {i}")
        for a, b in zip(g_gpu.shards, g_cpu.shards):
            assert_states_equal(a, b, f"batch {i}")
    want = g_cpu.traversal_csr()
    _assert_same_fields(g_gpu.traversal_csr(), want, "device fuse")
    _assert_same_fields(sharding.fuse_partitioned(g_gpu.shards, impl="host"), want, "host fuse")
    us_q, vs_q = sample_query_pairs(rng, 64, 300)
    np.testing.assert_array_equal(g_gpu.reachable(us_q, vs_q), g_cpu.reachable(us_q, vs_q))
    assert g_gpu.bfs_batch(us_q[:8].tolist()) == g_cpu.bfs_batch(us_q[:8].tolist())
    assert g_gpu.get_path_batch(us_q[:8], vs_q[:8]) == g_cpu.get_path_batch(us_q[:8], vs_q[:8])
    assert g_gpu.snapshot() == g_cpu.snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["waitfree", "fpsp"])
def test_cuda_mixed_mesh_matches_one_device(cuda_device, mode):
    """Four shards round-robined over the mesh ``[cuda:0, cpu]`` (shards 0
    and 2 on the card, 1 and 3 on the host) against the same graph with
    every shard on the CPU, over a mixed stream whose inserts grow the
    tables: each batch's results and every shard's tables bit for bit, then
    the fused snapshot, the queries and the abstract graph."""
    card = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(11)
    stream = [initial_vertices(300)]
    stream += [sample_batch(rng, 512, "traversal", key_space=300) for _ in range(4)]
    stream += [sample_update_batch(rng, 64, key_space=300) for _ in range(2)]
    g_one = WaitFreeGraph(64, 256, mode=mode, n_shards=4, device="cpu")
    g_mesh = WaitFreeGraph(64, 256, mode=mode, n_shards=4, mesh=[card, "cpu"])
    assert g_mesh.device == card
    grew = False
    for i, (ops, us, vs) in enumerate(stream):
        np.testing.assert_array_equal(g_mesh.apply(ops, us, vs), g_one.apply(ops, us, vs),
                                      err_msg=f"batch {i}")
        assert [st.v_key.device.type for st in g_mesh.shards] == ["cuda", "cpu"] * 2
        for a, b in zip(g_mesh.shards, g_one.shards):
            assert_states_equal(a, b, f"batch {i}")
        grew |= g_mesh.shards[0].v_capacity > 16
    assert grew, "the stream never grew a shard"
    csr = g_mesh.traversal_csr()
    assert csr.src.device == card
    _assert_same_fields(csr, g_one.traversal_csr(), "fused snapshot on the mesh")
    us_q, vs_q = sample_query_pairs(rng, 64, 300)
    np.testing.assert_array_equal(g_mesh.reachable(us_q, vs_q), g_one.reachable(us_q, vs_q))
    assert g_mesh.snapshot() == g_one.snapshot()

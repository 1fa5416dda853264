"""The port's delta CSR maintenance against ``repro``'s, field for field.

``apply_delta`` (the device merge, on the compact family's plain versions
here, and the numpy splice), ``delta_merge``, the snapshot-compact
``rehash(with_csr=True)`` and ``WaitFreeGraph``'s lazy delta queue are held
against ``repro``'s ``apply_delta(impl="host")``, ``delta_merge`` in
interpret mode, ``rehash(with_csr=True)`` and its graph, and against
``build_csr`` of both packages.  Every comparison is exact (int32 for int32,
bool for bool).  The card twins at the end hold the fold on the card equal
to the fold on the CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from _torch_parity import assert_states_equal, cuda_device, state_columns, to_np  # noqa: F401
from repro_torch.core import WaitFreeGraph, maintenance, traversal
from repro_torch.core.oracle import SequentialGraph, run_sequential
from repro_torch.core.types import (
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_VERTEX,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    state_from_numpy,
)
from repro_torch.core.workloads import (
    initial_vertices,
    sample_batch,
    sample_update_batch,
)

KEY_SPACE = 64
SPLICES = ["device", "host"]


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card test at
    the end runs where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import WaitFreeGraph as JGraph
    from repro.core import maintenance as j_maint
    from repro.core import traversal as jt
    from repro.core.types import GraphState

    return SimpleNamespace(jnp=jnp, maint=j_maint, t=jt, GraphState=GraphState, Graph=JGraph)


def _jstate(j, state):
    return j.GraphState(**{k: j.jnp.asarray(v) for k, v in state_columns(state).items()})


def _jcsr(j, csr):
    return j.t.TraversalCSR(*(j.jnp.asarray(to_np(x)) for x in csr))


def _assert_csr_equal(got, want, ctx=""):
    for f in traversal.TraversalCSR._fields:
        a, b = to_np(getattr(got, f)), to_np(getattr(want, f))
        assert a.dtype == b.dtype, (ctx, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} field {f}")


def _apply_both(g, oracle, ops, us, vs):
    got = g.apply(ops, us, vs)
    exp, _ = run_sequential(ops, us, vs, graph=oracle)
    assert got.tolist() == exp


def _chain(g, oracle, keys):
    n = len(keys)
    ops = np.concatenate([np.full(n, OP_ADD_VERTEX, np.int32),
                          np.full(n - 1, OP_ADD_EDGE, np.int32)])
    us = np.concatenate([np.asarray(keys, np.int32), np.asarray(keys[:-1], np.int32)])
    vs = np.concatenate([np.zeros(n, np.int32), np.asarray(keys[1:], np.int32)])
    _apply_both(g, oracle, ops, us, vs)


def _fold_both(j, csr, jcsr, state, ops, us, vs, impl):
    """One fold in each package; both must equal both packages' rebuilds.
    Returns (port csr, repro csr) for the next fold."""
    ops, us, vs = (np.asarray(a, np.int32) for a in (ops, us, vs))
    got = traversal.apply_delta(csr, state, ops, us, vs, impl=impl)
    jstate = _jstate(j, state)
    want = j.t.apply_delta(jcsr, jstate, ops, us, vs, impl="host")
    _assert_csr_equal(got, want, f"{impl} vs repro")
    _assert_csr_equal(got, traversal.build_csr(state), f"{impl} vs build_csr")
    _assert_csr_equal(got, j.t.build_csr(jstate), f"{impl} vs repro build_csr")
    return got, want


@pytest.mark.parametrize("impl", SPLICES)
def test_apply_delta_insert_delete_readd_sequence(j, impl):
    """Inserts, deletes, vertex removal (incident-edge invalidation), re-add
    (incarnation bump) and a tombstone revive all fold in exactly."""
    g, o = WaitFreeGraph(64, 128, csr_maintenance="rebuild", device="cpu"), SequentialGraph()
    _chain(g, o, [1, 2, 3, 4])
    csr = traversal.build_csr(g.state)
    jcsr = _jcsr(j, csr)
    batches = [
        ([OP_ADD_EDGE, OP_ADD_EDGE], [1, 4], [3, 1]),
        ([OP_REMOVE_EDGE, OP_ADD_EDGE], [1, 2], [2, 4]),
        ([OP_REMOVE_VERTEX], [3], [0]),
        ([OP_ADD_VERTEX, OP_ADD_EDGE], [3, 3], [0, 4]),
        ([OP_ADD_EDGE], [1], [2]),
    ]
    for ops, us, vs in batches:
        _apply_both(g, o, ops, us, vs)
        csr, jcsr = _fold_both(j, csr, jcsr, g.state, ops, us, vs, impl)
        assert g.snapshot() == (o.vertices, o.edges)


@pytest.mark.parametrize("impl", SPLICES)
def test_apply_delta_readonly_and_nop_batches_are_free(impl):
    g, o = WaitFreeGraph(64, 64, device="cpu"), SequentialGraph()
    _chain(g, o, [1, 2, 3])
    csr = traversal.build_csr(g.state)
    assert traversal.apply_delta(csr, g.state, [0], [0], [0], impl=impl) is csr
    ro = ([OP_CONTAINS_VERTEX, 6], [1, 1], [0, 2])  # contains_vertex, contains_edge
    _apply_both(g, o, *ro)
    assert traversal.apply_delta(csr, g.state, *ro, impl=impl) is csr


@pytest.mark.parametrize("impl", SPLICES)
def test_apply_delta_falls_back_on_large_delta(j, impl, monkeypatch):
    """A delta past ``max_delta_frac`` of the edge capacity rebuilds (no
    merge, no splice) and is still exact."""
    rng = np.random.default_rng(3)
    g, o = WaitFreeGraph(256, 1024, csr_maintenance="rebuild", device="cpu"), SequentialGraph()
    _apply_both(g, o, *sample_batch(rng, 64, "traversal", key_space=KEY_SPACE))
    csr = traversal.build_csr(g.state)
    jcsr = _jcsr(j, csr)
    ops, us, vs = sample_batch(rng, 512, "traversal", key_space=KEY_SPACE)
    _apply_both(g, o, ops, us, vs)
    assert sum(a.size for a in traversal.touched_keys(ops, us, vs)[:2]) > 256
    calls = []
    monkeypatch.setattr(maintenance, "delta_merge", lambda *a: calls.append("merge"))
    monkeypatch.setattr(traversal, "_delta_probe", lambda *a: calls.append("splice"))
    _fold_both(j, csr, jcsr, g.state, ops, us, vs, impl)
    assert calls == []


@pytest.mark.parametrize("impl", SPLICES)
def test_apply_delta_rebuilds_on_capacity_change(j, impl):
    """A growth rehash moved every slot: the fold must rebuild, and the old
    snapshot's capacities no longer match the state's."""
    g, o = WaitFreeGraph(64, 64, csr_maintenance="rebuild", device="cpu"), SequentialGraph()
    _chain(g, o, [1, 2, 3, 4])
    csr = traversal.build_csr(g.state)
    jcsr = _jcsr(j, csr)
    ops, us, vs = initial_vertices(200)
    _apply_both(g, o, ops, us, vs)
    assert g.state.v_capacity > csr.v_capacity
    _fold_both(j, csr, jcsr, g.state, ops, us, vs, impl)


def _churn_batch(rng, step):
    if step % 4 == 3:  # a wave of vertex removals, half re-added in the batch
        kill = rng.choice(KEY_SPACE, 6, replace=False).astype(np.int32)
        ops = np.concatenate([np.full(6, OP_REMOVE_VERTEX), np.full(3, OP_ADD_VERTEX)])
        return ops.astype(np.int32), np.concatenate([kill, kill[:3]]), np.zeros(9, np.int32)
    if step % 2:
        return sample_update_batch(rng, 24, key_space=KEY_SPACE)
    return sample_batch(rng, 48, "traversal", key_space=KEY_SPACE)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_delta_randomized_churn_matches_repro(j, seed):
    """Random inserts, deletes, removals and re-adds: after every batch both
    of the port's splices equal ``repro``'s fold and both rebuilds."""
    rng = np.random.default_rng(1000 + seed)
    g, o = WaitFreeGraph(256, 1024, mode="fpsp", csr_maintenance="rebuild",
                         device="cpu"), SequentialGraph()
    _apply_both(g, o, *sample_batch(rng, 128, "traversal", key_space=KEY_SPACE))
    csr = traversal.build_csr(g.state)
    csrs = {impl: csr for impl in SPLICES}
    jcsr = _jcsr(j, csr)
    for step in range(10):
        ops, us, vs = _churn_batch(rng, step)
        _apply_both(g, o, ops, us, vs)
        for impl in SPLICES:
            csrs[impl], want = _fold_both(j, csrs[impl], jcsr, g.state, ops, us, vs, impl)
        jcsr = want
    assert g.snapshot() == (o.vertices, o.edges)


def _touched_pack(ops, us, vs):
    v_touch, e_tu, e_tv = traversal.touched_keys(ops, us, vs)
    v_pad = traversal._pad_pow2(v_touch, -1)
    eu_pad = traversal._pad_pow2(e_tu, -1)
    ev_pad = traversal._pad_pow2(e_tv, 0)
    return np.concatenate([v_pad, eu_pad, ev_pad]), v_pad.size, eu_pad.size


def test_delta_merge_matches_repro_interpret_kernels(j):
    """The device merge itself, against ``repro``'s ``delta_merge`` with its
    Pallas compaction in interpret mode."""
    rng = np.random.default_rng(5)
    g, o = WaitFreeGraph(128, 256, csr_maintenance="rebuild", device="cpu"), SequentialGraph()
    _apply_both(g, o, *sample_batch(rng, 96, "traversal", key_space=KEY_SPACE))
    csr = traversal.build_csr(g.state)
    ops, us, vs = sample_update_batch(rng, 24, key_space=KEY_SPACE)
    _apply_both(g, o, ops, us, vs)
    pack, nv, ne = _touched_pack(ops, us, vs)
    got = maintenance.delta_merge(csr, g.state, pack, nv, ne)
    want = j.maint.delta_merge(_jcsr(j, csr), _jstate(j, g.state), pack, nv, ne,
                               impl="device_interpret")
    _assert_csr_equal(got, want)
    _assert_csr_equal(got, traversal.build_csr(g.state))


def test_fold_where_int32_merge_keys_overflow(j, monkeypatch):
    """At Cv = Ce = 2^16, cv * ce = 2^32: ``repro`` can only splice on the
    host there, the port's int64 keys keep the device merge, and the two
    agree."""
    cap = 1 << 16
    assert not j.maint.merge_keys_fit(cap, cap) and maintenance.merge_keys_fit(cap, cap)
    rng = np.random.default_rng(11)
    g, o = WaitFreeGraph(cap, cap, csr_maintenance="rebuild", device="cpu"), SequentialGraph()
    _apply_both(g, o, *sample_batch(rng, 256, "traversal", key_space=KEY_SPACE))
    csr = traversal.build_csr(g.state)
    ops, us, vs = sample_update_batch(rng, 48, key_space=KEY_SPACE)
    _apply_both(g, o, ops, us, vs)
    probe = traversal._delta_probe
    spliced = []
    monkeypatch.setattr(traversal, "_delta_probe", lambda *a: spliced.append(1) or probe(*a))
    got = traversal.apply_delta(csr, g.state, ops, us, vs)
    assert spliced == []  # the device merge, not the host splice
    jstate = _jstate(j, g.state)
    _assert_csr_equal(got, j.t.apply_delta(_jcsr(j, csr), jstate, ops, us, vs, impl="device"))
    _assert_csr_equal(got, j.t.build_csr(jstate))


def test_merge_keys_fit_at_its_edge(j, monkeypatch):
    """The guard's edge in int64, and the host splice it falls back to."""
    assert maintenance.merge_keys_fit(1 << 31, 1 << 31)
    assert not maintenance.merge_keys_fit(1 << 31, 1 << 32)
    assert maintenance.merge_keys_fit((1 << 31) - 1, 1 << 32)
    g, o = WaitFreeGraph(64, 128, csr_maintenance="rebuild", device="cpu"), SequentialGraph()
    _chain(g, o, [1, 2, 3, 4])
    csr = traversal.build_csr(g.state)
    monkeypatch.setattr(maintenance, "_MERGE_KEY_LIMIT", 64 * 128)
    assert not maintenance.merge_keys_fit(64, 128)
    merged = []
    monkeypatch.setattr(maintenance, "delta_merge", lambda *a: merged.append(1))
    ops, us, vs = [OP_ADD_EDGE, OP_REMOVE_EDGE], [4, 1], [1, 2]
    _apply_both(g, o, ops, us, vs)
    _fold_both(j, csr, _jcsr(j, csr), g.state, ops, us, vs, "device")
    assert merged == []


def _churned_state(seed):
    rng = np.random.default_rng(seed)
    g = WaitFreeGraph(256, 1024, device="cpu")
    g.apply(*sample_batch(rng, 192, "traversal", key_space=96))
    kill = rng.choice(96, size=8, replace=False).astype(np.int32)
    g.apply(np.full(8, OP_REMOVE_VERTEX, np.int32), kill)
    g.apply(np.full(4, OP_ADD_VERTEX, np.int32), kill[:4])
    g.apply(*sample_batch(rng, 96, "traversal", key_space=96))
    return g.state


@pytest.mark.parametrize("impl", SPLICES)
@pytest.mark.parametrize("grow", [1, 2])
def test_rehash_with_csr_matches_build_csr_and_repro(j, impl, grow):
    """``with_csr=True`` hands back ``build_csr`` of the new state, equal to
    ``repro``'s snapshot-compact, and the tables stay as they were."""
    state = _churned_state(grow)
    vcap, ecap = grow * state.v_capacity, grow * state.e_capacity
    new_state, csr, ok = maintenance.rehash(state, vcap, ecap, impl=impl, with_csr=True)
    plain, none, ok2 = maintenance.rehash(state, vcap, ecap, impl=impl)
    assert ok and ok2 and none is None
    assert_states_equal(new_state, plain)
    _assert_csr_equal(csr, traversal.build_csr(new_state))
    j_state, j_csr, j_ok = j.maint.rehash(_jstate(j, state), vcap, ecap, impl="host",
                                          with_csr=True)
    assert bool(j_ok)
    assert_states_equal(new_state, j_state)
    _assert_csr_equal(csr, j_csr)


def test_rehash_refuses_endpoints():
    """The shards' global endpoint index excludes the snapshot-compact,
    whose slot map is local (``endpoints`` alone is held in
    tests/test_torch_sharding.py)."""
    state = _churned_state(0)
    keys = np.arange(4, dtype=np.int32)
    for impl in SPLICES:
        with pytest.raises(ValueError, match="local endpoints"):
            maintenance.rehash(state, 512, 2048, impl=impl, with_csr=True,
                               endpoints=(keys, keys))


@pytest.mark.parametrize("impl", SPLICES)
def test_growth_seeds_delta_queue_with_snapshot_compact(impl):
    """After a growth retry the device rehash's snapshot is the queue's base
    and the retried batch its queue; the host rehash leaves the snapshot to
    the next query's rebuild.  Either way the next snapshot is exact."""
    g = WaitFreeGraph(64, 64, maintenance_impl=impl, device="cpu")
    g.traversal_csr()  # prime the cache
    ops, us, vs = initial_vertices(300)  # grows mid-apply
    g.apply(ops, us, vs)
    assert g.state.v_capacity > 64 and g._csr is None
    if impl == "device":
        assert g._delta_base is not None and len(g._delta_batches) == 1
        assert g._delta_base.v_capacity == g.state.v_capacity
    else:
        assert g._delta_base is None and g._delta_batches == []
    _assert_csr_equal(g.traversal_csr(), traversal.build_csr(g.state))


def test_delta_queue_folds_lazily_at_query_time(monkeypatch):
    """Update batches between queries are queued, read-only batches leave the
    queue alone, and the next query folds the whole queue in one
    ``apply_delta``, with no rebuild."""
    rng = np.random.default_rng(7)
    g, o = WaitFreeGraph(256, 1024, device="cpu"), SequentialGraph()
    _apply_both(g, o, *sample_batch(rng, 128, "traversal", key_space=KEY_SPACE))
    g.traversal_csr()  # prime the cache
    calls = {"apply_delta": 0, "build_csr": 0}
    for name in calls:
        fn = getattr(traversal, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(traversal, name, counted)
    for i in range(4):
        ops, us, vs = sample_update_batch(rng, 12, key_space=KEY_SPACE)
        _apply_both(g, o, ops, us, vs)
        assert g._csr is None and len(g._delta_batches) == i + 1
        assert g.contains_vertex(int(us[0])) in (True, False)  # read-only
        assert len(g._delta_batches) == i + 1
    assert calls == {"apply_delta": 0, "build_csr": 0}
    csr = g.traversal_csr()
    assert calls == {"apply_delta": 1, "build_csr": 0}
    assert g._delta_batches == [] and g._delta_base is None
    monkeypatch.undo()
    _assert_csr_equal(csr, traversal.build_csr(g.state))
    assert g.snapshot() == (o.vertices, o.edges)


def test_delta_queue_dropped_past_a_quarter_of_the_edges():
    g = WaitFreeGraph(64, 64, device="cpu")
    g.apply(*initial_vertices(10))
    g.traversal_csr()
    keys = np.arange(20, dtype=np.int32)
    g.apply(np.full(20, OP_ADD_EDGE, np.int32), keys % 10, (keys + 1) % 10)
    assert g._delta_base is None and g._delta_batches == []  # 20 > 64 // 4
    _assert_csr_equal(g.traversal_csr(), traversal.build_csr(g.state))


def test_graph_snapshots_match_repro_through_growth(j):
    """The default graph (delta maintenance) against ``repro``'s, with
    queries between batches: state, snapshot and answers equal after every
    epoch, through several growths."""
    rng = np.random.default_rng(2)
    jg = j.Graph(64, 64)
    tgs = [WaitFreeGraph(64, 64, maintenance_impl=impl, device="cpu") for impl in SPLICES]
    oracle = SequentialGraph()
    caps = set()
    ops, us, vs = initial_vertices(200)
    epochs = [(ops[i:i + 50], us[i:i + 50], vs[i:i + 50]) for i in range(0, 200, 50)]
    epochs += [sample_batch(rng, 96, mix, key_space=200)
               for mix in ("traversal", "update", "traversal", "balanced", "update")]
    src = rng.integers(0, 205, 8).astype(np.int32)
    dst = rng.integers(0, 205, 8).astype(np.int32)
    for i, (ops, us, vs) in enumerate(epochs):
        want = jg.apply(ops, us, vs)
        exp, _ = run_sequential(ops, us, vs, graph=oracle)
        assert want.tolist() == exp
        jcsr = jg.traversal_csr()
        for tg in tgs:
            np.testing.assert_array_equal(tg.apply(ops, us, vs), want, err_msg=f"epoch {i}")
            assert_states_equal(tg.state, jg.state, f"epoch {i}")
            _assert_csr_equal(tg.traversal_csr(), jcsr, f"epoch {i}")
            np.testing.assert_array_equal(tg.reachable(src, dst), jg.reachable(src, dst))
        caps.add(jg.state.v_capacity)
    assert len(caps) >= 3, caps
    for tg in tgs:
        assert tg.snapshot() == (oracle.vertices, oracle.edges)
        assert tg.bfs_batch(src.tolist()) == jg.bfs_batch(src.tolist())


# ---------------------------------------------------------------------------
# on the card: the fold (hash_probe, masked_compact) equal to the CPU's
# ---------------------------------------------------------------------------


def _same_graph_on(device, stream):
    g = WaitFreeGraph(256, 1024, device=device)
    out = []
    for ops, us, vs in stream:
        out.append(g.apply(ops, us, vs))
        out.append(g.traversal_csr())
    return g, out


@pytest.mark.cuda
def test_cuda_fold_matches_cpu(cuda_device):
    rng = np.random.default_rng(9)
    stream = [sample_batch(rng, 128, "traversal", key_space=KEY_SPACE)]
    stream += [_churn_batch(rng, step) for step in range(8)]
    stream += [initial_vertices(600)]  # grows: the snapshot-compact
    g_cpu, cpu = _same_graph_on("cpu", stream)
    g_gpu, gpu = _same_graph_on(cuda_device, stream)
    for i, (a, b) in enumerate(zip(cpu, gpu)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
        else:
            _assert_csr_equal(a, b, f"step {i}")
    assert_states_equal(g_cpu.state, g_gpu.state)
    state = state_from_numpy(state_columns(g_cpu.state), device=cuda_device)
    for impl in SPLICES:
        got = maintenance.rehash(state, 2048, 4096, impl=impl, with_csr=True)
        want = maintenance.rehash(g_cpu.state, 2048, 4096, impl=impl, with_csr=True)
        assert_states_equal(got[0], want[0])
        _assert_csr_equal(got[1], want[1], impl)

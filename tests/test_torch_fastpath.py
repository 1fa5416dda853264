"""The port's fast-path-slow-path engine against ``repro``'s, bit for bit.

``apply_batch_fpsp`` must give the same post-state, ``success``, ``ok`` and
``stats`` vector as ``repro.core.fastpath.apply_batch_fpsp`` for the same
batch: a conflict-free batch (the slow pass skipped on the host), the
hot-key batch of ``tests/test_graph_engine.py``, the ``workloads`` mixes
carried across a populated state (overflowing at 64 slots), and
``WaitFreeGraph(mode="fpsp")`` through several growths.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_parity import assert_states_equal, state_columns, to_np  # noqa: E402
from repro.core import WaitFreeGraph as JGraph  # noqa: E402
from repro.core import fastpath as j_fastpath  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro_torch.core import WaitFreeGraph, engine, fastpath, types  # noqa: E402
from repro_torch.core.oracle import SequentialGraph, run_sequential  # noqa: E402
from repro_torch.core.workloads import MIXES, initial_vertices, sample_batch  # noqa: E402

N = 128


def _both(jstate, tstate, ops, us, vs, phase=0, ctx=""):
    jb = j_types.make_batch(ops, us, vs, phase_base=phase)
    tb = types.make_batch(ops, us, vs, phase_base=phase)
    jr = j_fastpath.apply_batch_fpsp(jstate, jb)
    tr = fastpath.apply_batch_fpsp(tstate, tb)
    assert_states_equal(tr.state, jr.state, ctx)
    np.testing.assert_array_equal(to_np(tr.success), to_np(jr.success), err_msg=ctx)
    np.testing.assert_array_equal(to_np(tr.stats), to_np(jr.stats), err_msg=ctx)
    assert bool(tr.ok) == bool(jr.ok), ctx
    return jr.state, tr.state, to_np(tr.success), bool(tr.ok), to_np(tr.stats)


def test_conflict_free_batch_skips_the_slow_pass(monkeypatch):
    ops = np.full(N, types.OP_ADD_VERTEX, np.int32)
    us = np.arange(N, dtype=np.int32)

    def no_slow_pass(*args):
        raise AssertionError("the slow pass ran on a conflict-free batch")

    monkeypatch.setattr(engine, "apply_batch", no_slow_pass)
    _, tstate, got, ok, stats = _both(j_types.make_state(256, 64), types.make_state(256, 64),
                                      ops, us, us)
    assert ok and got.all()
    assert stats[types.STAT_CONFLICTED] == 0 and stats[types.STAT_INSERTED] == N
    # distinct edges between the new vertices are conflict-free too
    eops = np.full(N, types.OP_ADD_EDGE, np.int32)
    jstate = j_fastpath.apply_batch_fpsp(
        j_types.make_state(256, 64), j_types.make_batch(ops, us, us)).state
    _, _, got, ok, stats = _both(jstate, tstate, eops, us, np.roll(us, 1), phase=N)
    assert stats[types.STAT_CONFLICTED] == 0 and got.all()


def test_hot_key_batch_goes_slow():
    """All lanes add vertex 0: every op conflicts, the slow engine resolves
    them in phase order (one success)."""
    n = 32
    ops = np.full(n, types.OP_ADD_VERTEX, np.int32)
    keys = np.zeros(n, np.int32)
    _, _, got, ok, stats = _both(j_types.make_state(256, 64), types.make_state(256, 64),
                                 ops, keys, keys)
    assert ok and stats[types.STAT_CONFLICTED] == n and got.tolist() == [True] + [False] * (n - 1)


def test_conflict_masks_match():
    rng = np.random.default_rng(0)
    ops = rng.integers(0, 7, 256).astype(np.int32)
    us = rng.integers(0, 40, 256).astype(np.int32)
    vs = rng.integers(0, 40, 256).astype(np.int32)
    want = j_fastpath._conflict_mask(j_types.make_batch(ops, us, vs))
    got = fastpath._conflict_mask(types.make_batch(ops, us, vs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), to_np(w))
    act = rng.random(256) < 0.7
    np.testing.assert_array_equal(
        to_np(fastpath._membership_count(torch.as_tensor(us), torch.as_tensor(vs),
                                         torch.as_tensor(act))),
        to_np(j_fastpath._membership_count(us, vs, act)))


@pytest.mark.parametrize("cap", [64, 256])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mix_streams(cap, mix):
    """Random streams from a carried-across populated state; at 64 slots the
    tables overflow and ``ok=False`` must agree too."""
    rng = np.random.default_rng(cap + len(mix))
    key_space = cap // 2
    ops, us, vs = initial_vertices(key_space)
    jstate = j_fastpath.apply_batch_fpsp(j_types.make_state(cap, cap),
                                         j_types.make_batch(ops, us, vs)).state
    tstate = types.state_from_numpy(state_columns(jstate))
    phase = len(ops)
    for step in range(4):
        ops, us, vs = sample_batch(rng, N, mix, key_space=key_space)
        jstate, tstate, got, ok, _ = _both(jstate, tstate, ops, us, vs, phase, f"{mix}/{step}")
        phase += N


def test_fpsp_graph_matches_repro_through_growth():
    jg = JGraph(64, 64, mode="fpsp", maintenance_impl="host")
    tg = WaitFreeGraph(64, 64, mode="fpsp", device="cpu")
    oracle = SequentialGraph()
    rng = np.random.default_rng(5)
    ops, us, vs = initial_vertices(300)
    batches = [(ops[i:i + 100], us[i:i + 100], vs[i:i + 100]) for i in range(0, 300, 100)]
    batches += [sample_batch(rng, 200, mix, key_space=300)
                for mix in ("traversal", "update", "balanced", "traversal")]
    caps = set()
    for i, (o, u, v) in enumerate(batches):
        want = jg.apply(o, u, v)
        got = tg.apply(o, u, v)
        exp, _ = run_sequential(o, u, v, graph=oracle)
        np.testing.assert_array_equal(got, want, err_msg=f"batch {i}")
        assert got.tolist() == exp
        assert_states_equal(tg.state, jg.state, f"batch {i}")
        caps.add((tg.state.v_capacity, tg.state.e_capacity))
    assert len(caps) >= 3, caps
    assert tg.snapshot() == jg.snapshot() == (oracle.vertices, oracle.edges)
    src = rng.integers(0, 305, 8).tolist()
    dst = rng.integers(0, 305, 8).tolist()
    np.testing.assert_array_equal(tg.reachable(src, dst), jg.reachable(src, dst))

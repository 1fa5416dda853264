"""The port's baseline engines against ``repro.core.baselines``, exactly.

Each engine (lock-free rounds, the serial scan, the coarse host loop) takes
the same numpy-seeded batches in both packages from the same state; the
post-state (field for field), ``success``, ``ok`` and ``stats`` must be
identical, and the success bits equal to the sequential oracle.  The cases
are those of ``tests/test_graph_engine.py``: the Fig. 3 interleaving, edges
needing both vertices, self-loops, NOPs, stress mixes at key space 8, and
lock-free rounds growing with contention.  The card twin holds each engine
on the card equal to the CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from _torch_parity import assert_states_equal, cuda_device, state_columns, to_np  # noqa: F401
from repro_torch.core import baselines, engine, fastpath
from repro_torch.core.oracle import SequentialGraph, run_sequential
from repro_torch.core.traversal import snapshot_live
from repro_torch.core.types import (
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_NOP,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    make_batch,
    make_state,
    state_from_numpy,
)
from repro_torch.core.workloads import MIXES, sample_batch

NAMES = list(baselines.ENGINES)
FIG4_MIXES = ["lookup", "balanced", "update"]


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card test at
    the end runs where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import baselines as j_baselines
    from repro.core.types import GraphState, make_batch

    def state(s):
        return GraphState(**{k: jnp.asarray(v) for k, v in state_columns(s).items()})

    return SimpleNamespace(engines=j_baselines.ENGINES, state=state, make_batch=make_batch)


def _apply_both(j, name, state, ops, us, vs, phase_base=0):
    """One batch through the port's and ``repro``'s engine ``name`` from the
    same state; everything the engine returns must agree.  Returns the
    port's result."""
    got = baselines.ENGINES[name](state, make_batch(ops, us, vs, phase_base=phase_base))
    want = j.engines[name](j.state(state), j.make_batch(ops, us, vs, phase_base))
    assert_states_equal(got.state, want.state, name)
    np.testing.assert_array_equal(to_np(got.success), to_np(want.success), err_msg=name)
    assert bool(got.ok) == bool(want.ok)
    np.testing.assert_array_equal(to_np(got.stats), to_np(want.stats), err_msg=name)
    return got


def _check(j, name, seq, state=None):
    ops, us, vs = (np.asarray(c, np.int32) for c in zip(*seq))
    res = _apply_both(j, name, state if state is not None else make_state(128, 128), ops, us, vs)
    assert bool(res.ok)
    exp, _ = run_sequential(ops, us, vs)
    assert to_np(res.success).tolist() == exp
    return res


@pytest.mark.parametrize("name", NAMES)
def test_figure3_interleaving(j, name):
    """Edge ops observe endpoint liveness at their own linearization point,
    and stale edges never resurrect."""
    _check(j, name, [
        (OP_ADD_VERTEX, 5, 0),
        (OP_ADD_VERTEX, 7, 0),
        (OP_ADD_EDGE, 5, 7),
        (OP_CONTAINS_EDGE, 5, 7),
        (OP_REMOVE_VERTEX, 5, 0),
        (OP_CONTAINS_EDGE, 5, 7),
        (OP_ADD_VERTEX, 5, 0),
        (OP_CONTAINS_EDGE, 5, 7),   # must fail: stale binding
        (OP_ADD_EDGE, 5, 7),
        (OP_CONTAINS_EDGE, 5, 7),
    ])


@pytest.mark.parametrize("name", NAMES)
def test_edge_requires_both_vertices(j, name):
    _check(j, name, [
        (OP_ADD_EDGE, 1, 2),
        (OP_ADD_VERTEX, 1, 0),
        (OP_ADD_EDGE, 1, 2),
        (OP_ADD_VERTEX, 2, 0),
        (OP_ADD_EDGE, 1, 2),
        (OP_ADD_EDGE, 1, 2),
        (OP_REMOVE_EDGE, 1, 2),
        (OP_REMOVE_EDGE, 1, 2),
        (OP_CONTAINS_EDGE, 1, 2),
    ])


@pytest.mark.parametrize("name", NAMES)
def test_self_loops(j, name):
    _check(j, name, [
        (OP_ADD_VERTEX, 3, 0),
        (OP_ADD_EDGE, 3, 3),
        (OP_CONTAINS_EDGE, 3, 3),
        (OP_REMOVE_VERTEX, 3, 0),
        (OP_ADD_VERTEX, 3, 0),
        (OP_CONTAINS_EDGE, 3, 3),  # the stale self-loop is gone
    ])


@pytest.mark.parametrize("name", NAMES)
def test_nop_ops(j, name):
    res = _check(j, name, [(OP_NOP, 0, 0), (OP_ADD_VERTEX, 1, 0), (OP_NOP, 9, 9)],
                 make_state(64, 64))
    assert to_np(res.success).tolist() == [False, True, False]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mix", list(MIXES))
def test_random_stress_matches_repro(j, name, mix):
    """Cross-batch stress at brutal contention (key space 8)."""
    rng = np.random.default_rng(sorted(MIXES).index(mix) * 3 + NAMES.index(name))
    state = make_state(256, 1024)
    oracle = SequentialGraph()
    phase = 0
    for _ in range(2 if name == "coarse" else 4):
        ops, us, vs = sample_batch(rng, 96, mix, key_space=8)
        res = _apply_both(j, name, state, ops, us, vs, phase)
        phase += len(ops)
        assert bool(res.ok)
        exp, oracle = run_sequential(ops, us, vs, graph=oracle)
        assert to_np(res.success).tolist() == exp
        state = res.state


def test_lockfree_rounds_grow_with_contention(j):
    """Lock-freedom has no per-op bound: retry rounds scale with the longest
    per-key conflict chain; with distinct keys they stay near one."""
    n = 64
    ops = np.full(n, OP_CONTAINS_VERTEX, np.int32)
    hot = _apply_both(j, "lockfree", make_state(64, 64), ops, np.zeros(n, np.int32),
                      np.zeros(n, np.int32))
    cold = _apply_both(j, "lockfree", make_state(256, 64), ops, np.arange(n, dtype=np.int32),
                       np.zeros(n, np.int32))
    hot_rounds, cold_rounds = int(hot.stats[0]), int(cold.stats[0])
    assert cold_rounds <= 8
    assert hot_rounds >= n // 2
    assert hot_rounds > 4 * cold_rounds


@pytest.mark.parametrize("mix", FIG4_MIXES)
def test_engines_agree_from_one_pre_state(mix):
    """The five engines from one pre-state on one Fig. 4 batch: the same
    success bits (the oracle's) and the same abstract graph."""
    rng = np.random.default_rng(FIG4_MIXES.index(mix))
    oracle = SequentialGraph()
    ops, us, vs = sample_batch(rng, 64, "traversal", key_space=48)
    pre = engine.apply_batch(make_state(128, 256), make_batch(ops, us, vs)).state
    run_sequential(ops, us, vs, graph=oracle)
    ops, us, vs = sample_batch(rng, 48, mix, key_space=48)
    exp, _ = run_sequential(ops, us, vs, graph=oracle)
    fns = dict(baselines.ENGINES, waitfree=engine.apply_batch, fpsp=fastpath.apply_batch_fpsp)
    for name, fn in fns.items():
        res = fn(pre, make_batch(ops, us, vs, phase_base=64))
        assert bool(res.ok) and to_np(res.success).tolist() == exp, name
        v_mask, e_mask = (to_np(m) for m in snapshot_live(res.state))
        cols = state_columns(res.state)
        assert set(cols["v_key"][v_mask].tolist()) == oracle.vertices, name
        assert set(zip(cols["e_key_u"][e_mask].tolist(),
                       cols["e_key_v"][e_mask].tolist())) == oracle.edges, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_cuda_baselines_match_cpu(cuda_device, name):
    rng = np.random.default_rng(NAMES.index(name))
    state = make_state(256, 1024)
    phase = 0
    for mix in FIG4_MIXES:
        ops, us, vs = sample_batch(rng, 64, mix, key_space=16)
        want = baselines.ENGINES[name](state, make_batch(ops, us, vs, phase_base=phase))
        got = baselines.ENGINES[name](
            state_from_numpy(state_columns(state), device=cuda_device),
            make_batch(ops, us, vs, phase_base=phase, device=cuda_device))
        phase += len(ops)
        assert_states_equal(got.state, want.state, f"{name} {mix}")
        np.testing.assert_array_equal(to_np(got.success), to_np(want.success))
        assert bool(got.ok) == bool(want.ok)
        np.testing.assert_array_equal(to_np(got.stats), to_np(want.stats))
        state = want.state

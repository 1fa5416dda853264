"""``repro_torch.core.engine.apply_batch`` against ``repro``'s, bit for bit.

Every case starts from one state carried across with ``state_from_numpy``
and compares all eight columns, the success bits, ``ok`` and the stats
vector after each batch.  Batches are 64 lanes and tables 64 or 256 slots,
so ``repro`` compiles few shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_parity import assert_states_equal, state_columns, to_np  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro_torch.core import engine, types  # noqa: E402
from repro_torch.core.oracle import run_sequential  # noqa: E402
from repro_torch.core.workloads import MIXES, initial_vertices, sample_batch  # noqa: E402

N = 64


def _pad(ops, us, vs):
    k = N - len(ops)
    z = np.zeros(k, np.int32)
    return (np.concatenate([np.asarray(ops, np.int32), z]),
            np.concatenate([np.asarray(us, np.int32), z]),
            np.concatenate([np.asarray(vs, np.int32), z]))


def _both(jstate, tstate, ops, us, vs, phase_base=0, ctx=""):
    """Apply one batch in both packages; compare everything; return both
    post-states and the success bits."""
    jres = j_engine.apply_batch(jstate, j_types.make_batch(ops, us, vs, phase_base))
    tres = engine.apply_batch(tstate, types.make_batch(ops, us, vs, phase_base))
    assert_states_equal(jres.state, tres.state, ctx)
    np.testing.assert_array_equal(to_np(jres.success), tres.success.numpy(), err_msg=ctx)
    assert bool(jres.ok) == bool(tres.ok), ctx
    np.testing.assert_array_equal(to_np(jres.stats), tres.stats.numpy(), err_msg=ctx)
    assert tres.stats.dtype == torch.int32 and tres.success.dtype == torch.bool
    return jres.state, tres.state, tres.success.numpy(), bool(tres.ok)


def _fresh(cap):
    jstate = j_types.make_state(cap, cap)
    return jstate, types.state_from_numpy(state_columns(jstate))


FIG3 = [
    (types.OP_ADD_VERTEX, 5, 0),
    (types.OP_ADD_VERTEX, 7, 0),
    (types.OP_ADD_EDGE, 5, 7),
    (types.OP_CONTAINS_EDGE, 5, 7),
    (types.OP_REMOVE_VERTEX, 5, 0),
    (types.OP_CONTAINS_EDGE, 5, 7),
    (types.OP_ADD_VERTEX, 5, 0),
    (types.OP_CONTAINS_EDGE, 5, 7),   # must FAIL: stale binding
    (types.OP_ADD_EDGE, 5, 7),
    (types.OP_CONTAINS_EDGE, 5, 7),
]


def test_figure3_interleaving_with_nop_padding():
    """The paper's Fig. 3 case in one batch padded with NOP lanes: results,
    tables and stats identical, and equal to the oracle."""
    jstate, tstate = _fresh(64)
    o, u, v = _pad(*zip(*FIG3))
    _, _, got, ok = _both(jstate, tstate, o, u, v, ctx="fig3")
    assert ok
    exp, _ = run_sequential(*zip(*FIG3))
    assert got[: len(FIG3)].tolist() == exp
    assert not got[len(FIG3):].any()  # NOP lanes never succeed


def test_single_key_extreme_contention():
    """Every lane hits vertex 7 or edge (7, 7): one segment carries the whole
    batch through both scans."""
    rng = np.random.default_rng(3)
    jstate, tstate = _fresh(256)
    ops = rng.integers(1, 7, N).astype(np.int32)
    keys = np.full(N, 7, np.int32)
    jstate, tstate, got, ok = _both(jstate, tstate, ops, keys, keys, ctx="hot")
    assert ok
    exp, _ = run_sequential(ops, keys, keys)
    assert got.tolist() == exp


@pytest.mark.parametrize("cap", [64, 256])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_sample_batch_streams(cap, mix):
    """Random streams from a carried-across populated state; at 64 slots the
    tables overflow and ``ok=False`` must agree too."""
    rng = np.random.default_rng(cap + len(mix))
    key_space = cap // 2
    jstate = j_types.make_state(cap, cap)
    ops, us, vs = _pad(*(a[: N] for a in initial_vertices(min(key_space, N))))
    jstate = j_engine.apply_batch(jstate, j_types.make_batch(ops, us, vs)).state
    tstate = types.state_from_numpy(state_columns(jstate))
    phase = N
    for step in range(4):
        ops, us, vs = sample_batch(rng, N, mix, key_space=key_space)
        jstate, tstate, _, _ = _both(jstate, tstate, ops, us, vs, phase, f"{mix}/{step}")
        phase += N


def test_state_round_trip_keeps_dtypes():
    jstate, tstate = _fresh(64)
    cols = types.state_to_numpy(tstate)
    assert cols["v_live"].dtype == np.bool_ and cols["v_key"].dtype == np.int32
    assert_states_equal(types.state_from_numpy(cols), jstate)

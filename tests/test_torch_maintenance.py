"""The port's growth rehash against ``repro.core.maintenance.rehash_host``.

Churned graphs (tombstones, stale edges from removed-and-re-added vertices)
are rehashed by the port's ``"device"`` path (the ``compact`` family; its
plain versions on the CPU) and its ``"host"`` path, and both must equal
``repro``'s numpy reference column for column — including the ``ok=False``
verdict when the new tables are too small for ``MAX_PROBES`` placement.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from _torch_parity import assert_states_equal, state_columns  # noqa: E402
from repro.core import maintenance as j_maint  # noqa: E402
from repro.core.types import GraphState as JGraphState  # noqa: E402
from repro_torch.core import WaitFreeGraph, maintenance  # noqa: E402
from repro_torch.core.types import OP_ADD_VERTEX, OP_REMOVE_VERTEX  # noqa: E402
from repro_torch.core.workloads import sample_batch  # noqa: E402

KEY_SPACE = 96


def _churned_state(seed):
    """The churn recipe of ``tests/test_sharding.py`` through the port's
    graph: traversal batches, a wave of vertex removals, half re-added."""
    rng = np.random.default_rng(seed)
    g = WaitFreeGraph(256, 1024, device="cpu")
    for _ in range(2):
        g.apply(*sample_batch(rng, 192, "traversal", key_space=KEY_SPACE))
    kill = rng.choice(KEY_SPACE, size=8, replace=False).astype(np.int32)
    g.apply(np.full(8, OP_REMOVE_VERTEX, np.int32), kill)
    g.apply(np.full(4, OP_ADD_VERTEX, np.int32), kill[:4])
    g.apply(*sample_batch(rng, 96, "traversal", key_space=KEY_SPACE))
    return g.state


def _reference(state, vcap, ecap):
    jstate = JGraphState(**state_columns(state))
    return j_maint.rehash_host(jstate, vcap, ecap)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("grow", [1, 2])
@pytest.mark.parametrize("impl", ["device", "host"])
def test_rehash_matches_host_reference(seed, grow, impl):
    state = _churned_state(seed)
    vcap, ecap = grow * state.v_capacity, grow * state.e_capacity
    want, want_ok = _reference(state, vcap, ecap)
    got, csr, ok = maintenance.rehash(state, vcap, ecap, impl=impl)
    assert ok and want_ok and csr is None
    assert_states_equal(got, want, f"seed={seed} grow={grow} impl={impl}")


@pytest.mark.parametrize("impl", ["device", "host"])
def test_rehash_overflow_verdict_matches(impl):
    """Tables far too small for the live keys: placement overflows, ``ok``
    is False in both packages, and the partial tables agree too."""
    state = _churned_state(3)
    want, want_ok = _reference(state, 16, 16)
    got, csr, ok = maintenance.rehash(state, 16, 16, impl=impl)
    assert not ok and not want_ok and csr is None
    assert_states_equal(got, want, impl)


def test_rehash_default_is_device_and_matches_repro_device_path():
    state = _churned_state(4)
    jstate = JGraphState(**{k: jax.numpy.asarray(v) for k, v in state_columns(state).items()})
    want, _, want_ok = j_maint.rehash(jstate, 512, 2048, impl="device")
    got, _, ok = maintenance.rehash(state, 512, 2048)
    assert maintenance.resolve_impl(None) == "device"
    assert ok and bool(want_ok)
    assert_states_equal(got, want)


def test_grow_escalates_on_overflow():
    """``_rehash_escalating`` doubles past an overflowing capacity, landing
    on the same tables as ``repro``'s host reference at the final size."""
    from repro_torch.core.graph import _rehash_escalating

    state = _churned_state(5)
    got, csr = _rehash_escalating(state, 16, 16)
    assert csr is None
    vcap = got.v_capacity
    assert vcap > 16 and got.e_capacity == got.v_capacity
    want, want_ok = _reference(state, vcap, got.e_capacity)
    assert want_ok
    assert_states_equal(got, want)
    half, half_ok = _reference(state, vcap // 2, got.e_capacity // 2)
    assert not half_ok  # the step below the landing size did overflow


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        maintenance.resolve_impl("device_interpret")

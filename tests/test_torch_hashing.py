"""The port's hash and probe-slot functions against ``repro.core.hashing``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jh  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402

_INT32 = np.iinfo(np.int32)
_SPECIAL = np.array([0, -1, _INT32.min, _INT32.max, 1, -2, 0x7FFF, 0x10000], np.int32)


def _keys(seed, n=4096):
    rng = np.random.default_rng(seed)
    rand = rng.integers(_INT32.min, _INT32.max, size=n, dtype=np.int64, endpoint=True)
    return np.concatenate([_SPECIAL, rand.astype(np.int32)])


@pytest.mark.parametrize("seed", [0, 1])
def test_mix32_matches_numpy_twin(seed):
    keys = _keys(seed)
    got = th._mix32(torch.as_tensor(keys)).numpy()
    want = jh._mix32_np(keys).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    np.testing.assert_array_equal(
        got, np.asarray(jh._mix32(jnp.asarray(keys))).astype(np.int64)
    )


def test_numpy_twins_are_copies():
    us, vs = _keys(2), _keys(3)
    np.testing.assert_array_equal(th._mix32_np(us), jh._mix32_np(us))
    np.testing.assert_array_equal(th.vertex_hash32_np(us), jh.vertex_hash32_np(us))
    np.testing.assert_array_equal(th.edge_hash32_np(us, vs), jh.edge_hash32_np(us, vs))


@pytest.mark.parametrize("seed", [4, 5])
def test_edge_hash32_matches_reference(seed):
    us, vs = _keys(seed), _keys(seed + 100)
    got = th.edge_hash32(torch.as_tensor(us), torch.as_tensor(vs)).numpy()
    np.testing.assert_array_equal(got, jh.edge_hash32_np(us, vs).astype(np.int64))
    np.testing.assert_array_equal(
        got, np.asarray(jh.edge_hash32(jnp.asarray(us), jnp.asarray(vs))).astype(np.int64)
    )


@pytest.mark.parametrize("cap", [1, 64, 1024, 2**22])
def test_home_slots_match_reference(cap):
    us, vs = _keys(6), _keys(7)
    tu, tv = torch.as_tensor(us), torch.as_tensor(vs)
    hv = th.hash_vertex(tu, cap)
    he = th.hash_edge(tu, tv, cap)
    assert hv.dtype == torch.int32 and he.dtype == torch.int32
    np.testing.assert_array_equal(hv.numpy(), np.asarray(jh.hash_vertex(jnp.asarray(us), cap)))
    np.testing.assert_array_equal(
        he.numpy(), np.asarray(jh.hash_edge(jnp.asarray(us), jnp.asarray(vs), cap))
    )


def test_probe_slot_matches_reference():
    home = (np.arange(0, 2048, 7, dtype=np.int32) % 1024).astype(np.int32)
    for step in (0, 1, 5, 31):
        np.testing.assert_array_equal(
            th.probe_slot(torch.as_tensor(home), step, 1024).numpy(),
            np.asarray(jh.probe_slot(jnp.asarray(home), jnp.int32(step), 1024)),
        )

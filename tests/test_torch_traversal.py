"""The port's snapshot queries against ``repro.core.traversal``, bit for bit.

Churned graphs are built by the port's graph on the CPU and carried into
``repro`` as the same eight columns; ``build_csr`` (every field), the BFS
level and parent maps, ``reachable``, ``path_probe`` and ``khop_mask`` must
agree exactly, including the stale-edge hazard and the edge-free snapshot.
``repro`` runs its jnp frontier reference, and its Pallas kernel in
interpret mode on one case.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import state_columns, to_np  # noqa: E402
from repro.core import traversal as jt  # noqa: E402
from repro.core.types import GraphState as JGraphState  # noqa: E402
from repro_torch.core import WaitFreeGraph, traversal  # noqa: E402
from repro_torch.core.types import OP_ADD_VERTEX, OP_REMOVE_VERTEX  # noqa: E402
from repro_torch.core.workloads import sample_batch  # noqa: E402

KEY_SPACE = 96
NQ = 16


def _churned_graph(seed):
    rng = np.random.default_rng(seed)
    g = WaitFreeGraph(256, 1024, device="cpu")
    g.apply(np.full(KEY_SPACE, OP_ADD_VERTEX, np.int32), np.arange(KEY_SPACE, dtype=np.int32))
    for _ in range(2):
        g.apply(*sample_batch(rng, 192, "traversal", key_space=KEY_SPACE))
    kill = rng.choice(KEY_SPACE, size=8, replace=False).astype(np.int32)
    g.apply(np.full(8, OP_REMOVE_VERTEX, np.int32), kill)
    g.apply(np.full(4, OP_ADD_VERTEX, np.int32), kill[:4])
    g.apply(*sample_batch(rng, 96, "traversal", key_space=KEY_SPACE))
    return g, rng


def _jstate(state):
    return JGraphState(**{k: jnp.asarray(v) for k, v in state_columns(state).items()})


def _queries(rng):
    keys = rng.integers(0, KEY_SPACE + 8, NQ).astype(np.int32)  # some absent
    keys[-1] = -1  # EMPTY_KEY padding lane
    return keys


def _assert_csr_equal(tcsr, jcsr):
    for f in traversal.TraversalCSR._fields:
        np.testing.assert_array_equal(to_np(getattr(tcsr, f)), to_np(getattr(jcsr, f)),
                                      err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queries_match_repro_on_churned_graphs(seed):
    g, rng = _churned_graph(seed)
    tcsr = traversal.build_csr(g.state)
    jcsr = jt.build_csr(_jstate(g.state))
    _assert_csr_equal(tcsr, jcsr)
    assert int(tcsr.n_edges) > 0

    src, dst = _queries(rng), _queries(rng)
    ts, td = torch.as_tensor(src), torch.as_tensor(dst)
    js, jd = jnp.asarray(src), jnp.asarray(dst)

    tl, tp = traversal.bfs_parents(tcsr, ts)
    jl, jp = jt.bfs_parents(jcsr, js, impl="reference")
    np.testing.assert_array_equal(tl.numpy(), to_np(jl))
    np.testing.assert_array_equal(tp.numpy(), to_np(jp))
    np.testing.assert_array_equal(traversal.bfs_levels(tcsr, ts).numpy(), to_np(jl))

    np.testing.assert_array_equal(
        traversal.reachable(tcsr, ts, td).numpy(),
        to_np(jt.reachable(jcsr, js, jd, impl="reference")),
    )
    for t, j in zip(traversal.path_probe(tcsr, ts, td),
                    jt.path_probe(jcsr, js, jd, impl="reference")):
        np.testing.assert_array_equal(t.numpy(), to_np(j))
    for k in (0, 2):
        np.testing.assert_array_equal(
            traversal.khop_mask(tcsr, ts, k).numpy(),
            to_np(jt.khop_mask(jcsr, js, jnp.int32(k), impl="reference")),
        )
    for t, j in zip(traversal.snapshot_live(g.state), jt.snapshot_live(_jstate(g.state))):
        np.testing.assert_array_equal(t.numpy(), to_np(j))


def test_bfs_matches_repro_interpret_kernel():
    g, rng = _churned_graph(7)
    tcsr = traversal.build_csr(g.state)
    jcsr = jt.build_csr(_jstate(g.state))
    src = _queries(rng)
    tl, tp = traversal.bfs_parents(tcsr, torch.as_tensor(src))
    jl, jp = jt.bfs_parents(jcsr, jnp.asarray(src), impl="kernel_interpret")
    np.testing.assert_array_equal(tl.numpy(), to_np(jl))
    np.testing.assert_array_equal(tp.numpy(), to_np(jp))


def _tiny_graph(ops, us, vs):
    g = WaitFreeGraph(64, 64, device="cpu")
    g.apply(ops, us, vs)
    return g


def test_stale_edge_hazard():
    """Remove and re-add an endpoint: the old edge lane stays in the table
    but is invalid, in the CSR and in every query, in both packages."""
    g = _tiny_graph([1, 1, 4, 2, 1], [5, 7, 5, 5, 5], [0, 0, 7, 0, 0])
    tcsr = traversal.build_csr(g.state)
    jcsr = jt.build_csr(_jstate(g.state))
    _assert_csr_equal(tcsr, jcsr)
    assert int(tcsr.n_edges) == 0 and bool((g.state.e_key_u == 5).any())
    q = np.array([5, 7] + [-1] * 14, np.int32)
    t = traversal.reachable(tcsr, torch.as_tensor(q), torch.as_tensor(q[::-1].copy()))
    j = jt.reachable(jcsr, jnp.asarray(q), jnp.asarray(q[::-1].copy()), impl="reference")
    np.testing.assert_array_equal(t.numpy(), to_np(j))
    assert g.reachable(5, 7) is False and g.get_path(5, 7) is None


def test_edge_free_snapshot():
    """Vertices only: the BFS loop is skipped and sources are the answer."""
    g = _tiny_graph([1, 1, 1], [1, 2, 3], [0, 0, 0])
    tcsr = traversal.build_csr(g.state)
    jcsr = jt.build_csr(_jstate(g.state))
    _assert_csr_equal(tcsr, jcsr)
    q = np.array([1, 2, 9] + [-1] * 13, np.int32)
    tl, tp = traversal.bfs_parents(tcsr, torch.as_tensor(q))
    jl, jp = jt.bfs_parents(jcsr, jnp.asarray(q), impl="reference")
    np.testing.assert_array_equal(tl.numpy(), to_np(jl))
    np.testing.assert_array_equal(tp.numpy(), to_np(jp))
    assert g.bfs(1) == {1: 0} and g.bfs(9) == {} and g.khop(2, 3) == {2}

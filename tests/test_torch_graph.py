"""``repro_torch``'s ``WaitFreeGraph`` against ``repro``'s, end to end.

One op stream that forces several growths goes through both graphs: the
success bits, the full state after every batch, the snapshot and the
traversal answers must be identical, and agree with the port's oracle copy.
Also: the graph refuses to run quietly on the CPU, the settings of later
slices are refused, and the package imports neither JAX nor ``repro``.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from _torch_parity import assert_states_equal
from repro_torch.configs import get_smoke_config
from repro_torch.core import WaitFreeGraph
from repro_torch.core.oracle import SequentialGraph, run_sequential
from repro_torch.core.workloads import initial_vertices, sample_batch
from repro_torch.models import LM

KEY_SPACE = 300


def _stream(seed):
    rng = np.random.default_rng(seed)
    ops, us, vs = initial_vertices(KEY_SPACE)
    for lo in range(0, KEY_SPACE, 100):  # each chunk outgrows the tables
        yield ops[lo:lo + 100], us[lo:lo + 100], vs[lo:lo + 100]
    for mix in ("traversal", "traversal", "update", "traversal", "balanced"):
        yield sample_batch(rng, 200, mix, key_space=KEY_SPACE)


def test_graph_matches_repro_through_growth():
    pytest.importorskip("jax")
    from repro.core import WaitFreeGraph as JGraph

    jg = JGraph(64, 64, maintenance_impl="host")
    tgs = [WaitFreeGraph(64, 64, maintenance_impl=impl, device="cpu")
           for impl in ("device", "host")]
    caps = set()
    oracle = SequentialGraph()
    for i, (ops, us, vs) in enumerate(_stream(0)):
        want = jg.apply(ops, us, vs)
        exp, _ = run_sequential(ops, us, vs, graph=oracle)
        assert want.tolist() == exp
        for tg in tgs:
            got = tg.apply(ops, us, vs)
            np.testing.assert_array_equal(got, want, err_msg=f"batch {i}")
            assert_states_equal(tg.state, jg.state, f"batch {i}")
        caps.add((jg.state.v_capacity, jg.state.e_capacity))
    assert len(caps) >= 3, caps  # the stream grew the tables several times

    rng = np.random.default_rng(1)
    src = rng.integers(0, KEY_SPACE + 5, 12).tolist()
    dst = rng.integers(0, KEY_SPACE + 5, 12).tolist()
    for tg in tgs:
        assert tg.snapshot() == jg.snapshot() == (oracle.vertices, oracle.edges)
        np.testing.assert_array_equal(tg.reachable(src, dst), jg.reachable(src, dst))
        assert tg.bfs_batch(src) == jg.bfs_batch(src)
        assert tg.get_path_batch(src, dst) == jg.get_path_batch(src, dst)
        assert tg.khop(src[0], 2) == jg.khop(src[0], 2)
    tg = tgs[0]
    for u, v in zip(src, dst):
        assert tg.reachable(u, v) == oracle.reachable(u, v)
        assert tg.bfs(u) == oracle.bfs(u)
        path, ref = tg.get_path(u, v), oracle.path(u, v)
        assert (path is None) == (ref is None)
        if path is not None:
            assert len(path) == len(ref) and path[0] == u and path[-1] == v
            assert all(e in oracle.edges for e in zip(path, path[1:]))


def test_single_op_methods_and_read_only_batches_keep_the_snapshot():
    g = WaitFreeGraph(64, 64, device="cpu")
    assert g.add_vertex(1) and g.add_vertex(2) and not g.add_vertex(1)
    assert g.add_edge(1, 2) and not g.add_edge(1, 3)
    assert g.contains_edge(1, 2) and g.contains_vertex(2)
    csr = g.traversal_csr()
    assert g.contains_vertex(1)  # read-only: the cached snapshot survives
    assert g.traversal_csr() is csr
    assert g.remove_edge(1, 2) and not g.contains_edge(1, 2)
    assert g.traversal_csr() is not csr
    assert g.remove_vertex(2) and not g.remove_vertex(2)
    assert g.snapshot() == ({1}, set())
    assert g.apply([], []).shape == (0,)


def test_default_device_is_the_card(monkeypatch):
    """No quiet CPU fallback: without a card the default graph raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WaitFreeGraph()


# keyword arguments of WaitFreeGraph, or {"family": arch, "run": run} for
# an LM prefill (or, with "decode_moe_shardmap", decode step) whose run picks
# the MoE engine over a mesh without giving one: what the port still refuses
@pytest.mark.parametrize("kwargs", [{"family": "mixtral-8x7b", "run": {"sp": True}},
                                    {"n_shards": 2, "mesh": ["cpu", "meta"]},
                                    {"family": "granite-moe-3b-a800m", "run": {"sp": True}},
                                    {"family": "mixtral-8x7b",
                                     "run": {"decode_moe_shardmap": True}}])
def test_later_slices_are_refused(kwargs):
    with pytest.raises(ValueError, match="meta|mesh"):
        if "family" in kwargs:
            model = LM(get_smoke_config(kwargs["family"]), device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            toks = torch.zeros((1, 1), dtype=torch.int32)
            if "decode_moe_shardmap" in kwargs["run"]:
                model.decode_step(params, toks, model.decode_init(1, 4), run=kwargs["run"])
            else:
                model.hidden_states(params, toks, run=kwargs["run"])
        else:
            WaitFreeGraph(device="cpu", **kwargs)


def test_delta_maintenance_is_the_default():
    g = WaitFreeGraph(device="cpu")
    assert g.csr_maintenance == "delta" and g.traversal_impl is None
    assert WaitFreeGraph(csr_maintenance="rebuild", device="cpu").csr_maintenance == "rebuild"


# "kernel_interpret" is repro's Pallas interpreter, which the port has not;
# "kernel" needs the graph on the card
@pytest.mark.parametrize("kwargs", [{"traversal_impl": "kernel_interpret"},
                                    {"traversal_impl": "pallas"}, {"traversal_impl": "kernel"},
                                    {"csr_maintenance": "eager"}])
def test_unknown_traversal_impl_raises(kwargs):
    with pytest.raises(ValueError):
        WaitFreeGraph(device="cpu", **kwargs)


def test_reference_traversal_impl_gives_the_same_answers():
    g = WaitFreeGraph(64, 64, traversal_impl="reference", device="cpu")
    g.apply([1, 1, 1, 4, 4], [1, 2, 3, 1, 2], [0, 0, 0, 2, 3])
    assert g.reachable(1, 3) and not g.reachable(3, 1)
    assert g.bfs(1) == {1: 0, 2: 1, 3: 2} and g.get_path(1, 3) == [1, 2, 3]


_PKG = Path(repro_torch.__file__).parent


def test_package_imports_without_jax_or_repro():
    mods = [m.name for m in pkgutil.walk_packages([str(_PKG)], "repro_torch.")]
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    src_dir = str(_PKG.parent)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": src_dir, "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20
    assert {"repro_torch.core.sharding", "repro_torch.obs", "repro_torch.obs.metrics",
            "repro_torch.obs.probes", "repro_torch.launch.opcost",
            "repro_torch.launch.dryrun", "repro_torch.parallel.mesh",
            "repro_torch.parallel.spec", "repro_torch.launch.shardings",
            "repro_torch.parallel.collectives",
            "repro_torch.optim.compress"} <= set(mods)


def test_no_source_file_names_jax_or_repro():
    bad = re.compile(r"^\s*(import jax|from jax|from repro[ .]|import repro\b)", re.M)
    files = sorted(_PKG.rglob("*.py"))
    assert files
    for f in files:
        assert not bad.search(f.read_text()), f


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Where there is no card the smoke script exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    script = _PKG.parents[1] / "chip_smoke.py"
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

"""The dry run (``repro_torch.launch.dryrun``) and its inputs against
``repro``'s, on the CPU.

* ``SHAPES`` and ``cell_is_runnable`` equal to ``repro``'s for all 10 x 4
  cells (34 runnable);
* every leaf of ``LM.shapes()`` equal, path by path, in shape and dtype to
  ``repro``'s ``LM(cfg).shapes()`` for all 10 archs at full width, on the
  ``meta`` device;
* ``input_specs`` equal in shape and dtype to ``repro``'s ``input_specs(cfg,
  shape, make_host_mesh(), multi_pod=False)`` for every runnable cell, and
  its bytes to the sum of ``repro``'s sizes;
* the train cell's count (one microbatch weighted by the accumulation, the
  rest once) against the whole step counted as it runs, on smoke configs;
* ``run_cell`` at full width: qwen2-7b ``decode_32k`` is ``ok`` and does
  not fit one card, its argument bytes the parameters, the tokens, the
  length and the KV cache by the arithmetic; qwen2-7b ``long_500k`` is
  skipped with the reference's reason, rwkv6-3b ``long_500k`` is ``ok``;
  nothing touches CUDA;
* the CLI writes one JSON a cell, and exits 1 on a cell that raises.

JAX is imported in a fixture.
"""

import json
import sys

import pytest
import torch

from _torch_parity import one_thread  # noqa: F401
from repro_torch.configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config, \
    get_smoke_config
from repro_torch.launch import dryrun, opcost
from repro_torch.launch import steps as S
from repro_torch.models import LM
from repro_torch.models.module import param_bytes


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one torch thread (``_torch_parity.one_thread``)."""


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Drops JAX's compiled executables when the module ends, those of the
    tests that ran before it in this process too: each keeps its code
    mapped, and a test worker that gathers enough of them reaches the
    kernel's limit on memory maps (``vm.max_map_count``) inside an XLA
    compile, which then crashes the worker."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture."""
    jax = pytest.importorskip("jax")
    from repro import configs
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_host_mesh
    from repro.models import LM as RefLM

    return {"jax": jax, "configs": configs, "steps": ref_steps, "mesh": make_host_mesh,
            "LM": RefLM}


def _torch_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: t for k in tree for p, t in _torch_leaves(tree[k], prefix + (k,)).items()}
    return {prefix: tree}


def _ref_leaves(jax, tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(p.key for p in path): leaf for path, leaf in leaves}


def _assert_same_tree(j, ours, theirs):
    a, b = _torch_leaves(ours), _ref_leaves(j["jax"], theirs)
    assert sorted(a) == sorted(b)
    for path, t in a.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(b[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == b[path].dtype.name, path
    return sum(t.numel() * t.element_size() for t in a.values()), \
        sum(x.size * x.dtype.itemsize for x in b.values())


def test_shapes_and_runnable_cells_equal_the_reference(j):
    assert SHAPES == j["configs"].SHAPES
    runnable = 0
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            want = j["configs"].cell_is_runnable(j["configs"].get_config(arch), shape)
            assert cell_is_runnable(get_config(arch), shape) == want, (arch, shape)
            runnable += want
    assert runnable == 34


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shapes_equal_the_reference(j, arch):
    ours = LM(get_config(arch), "meta").shapes()
    theirs = j["LM"](j["configs"].get_config(arch)).shapes()
    nbytes, ref_bytes = _assert_same_tree(j, ours, theirs)
    assert nbytes == ref_bytes == param_bytes(LM(get_config(arch), "meta").meta())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(j, arch):
    cfg, ref_cfg = get_config(arch), j["configs"].get_config(arch)
    mesh = j["mesh"]()
    for shape in SHAPES:
        if not cell_is_runnable(cfg, shape):
            continue
        ours = S.input_specs(cfg, shape)
        theirs = j["steps"].input_specs(ref_cfg, shape, mesh, multi_pod=False)
        nbytes, ref_bytes = _assert_same_tree(j, ours, theirs)
        assert nbytes == ref_bytes, (arch, shape)


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b", "granite-moe-3b-a800m"])
def test_weighted_train_count_equals_the_whole_step(arch):
    """The parts miss only the loss sum's two scalar adds (4 bytes alive)."""
    cfg = get_smoke_config(arch)
    specs = S.input_specs(cfg, {"seq_len": 64, "global_batch": 4, "kind": "train"})
    step, _, _ = S.build_train_step(cfg, accum=2, device=S.META)
    whole = opcost.count(step, **specs)
    parts = dryrun._train_costs(step, **specs)
    for key in ("flops", "bytes", "transcendentals"):
        assert getattr(parts, key) == pytest.approx(getattr(whole, key), rel=1e-6), key
    assert whole.ops - parts.ops == 2
    assert (parts.argument_bytes, parts.output_bytes) == (whole.argument_bytes,
                                                          whole.output_bytes)
    assert 0 <= whole.peak_bytes - parts.peak_bytes <= 8


def test_decode_cell_counts_its_cache():
    cfg = get_config("qwen2-7b")
    r = dryrun.run_cell("qwen2-7b", "decode_32k", verbose=False)
    assert r["status"] == "ok" and r["n_devices"] == 1 and r["fits"] is False
    B, T = SHAPES["decode_32k"]["global_batch"], SHAPES["decode_32k"]["seq_len"]
    kv = 2 * cfg.n_layers * B * cfg.n_kv_heads * T * cfg.head_dim * 2  # bf16 K and V
    params = param_bytes(LM(cfg, "meta").meta())
    mem = r["memory"]
    assert mem["argument_bytes"] - params - B * 4 - 4 == kv  # tokens (B, 1) and the length
    assert mem["alias_bytes"] >= kv  # the cache written in place and returned
    assert mem["argument_bytes"] + mem["temp_bytes"] > dryrun.H100_BYTES
    assert r["flops"] > 2 * (params // 2) * B and r["collective_counts"] == {}
    assert r["exec"]["ops"] > 0 and r["exec"]["top"]["flops"]
    assert not torch.cuda.is_initialized()


def test_long_context_cells():
    r = dryrun.run_cell("qwen2-7b", "long_500k", verbose=False)
    assert r["status"] == "skipped"
    assert r["reason"] == "long_500k requires sub-quadratic attention (DESIGN.md §5)"
    r = dryrun.run_cell("rwkv6-3b", "long_500k", verbose=False)
    assert r["status"] == "ok" and r["fits"] is True and r["memory"]["argument_bytes"] > 0
    assert not torch.cuda.is_initialized()


def test_cli_writes_json_and_exits_one_on_error(tmp_path, monkeypatch):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert json.loads((tmp_path / "qwen2-7b__long_500k.json").read_text())["status"] == "skipped"

    def broken(arch, shape, **_):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out", str(tmp_path)])
    assert e.value.code == 0  # cached: the cell is not run again
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k", "--out", str(tmp_path),
                     "--force"])
    assert e.value.code == 1
    r = json.loads((tmp_path / "qwen2-7b__long_500k.json").read_text())
    assert r["status"] == "error" and r["error"] == "RuntimeError: no such step"

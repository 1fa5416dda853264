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

Per device of a mesh (``--mesh production``):

* for every runnable ``train_4k`` and ``prefill_32k`` cell of every arch on
  both production meshes, (16, 16) and (2, 16, 16), the bytes of the
  counted device's inputs that the step reads equal, exactly, what
  ``repro``'s specs give (``NamedSharding(AbstractMesh(...),
  spec).shard_shape`` of each leaf of its ``input_specs``);
* on a (2, 4) description, the qwen2 smoke config's four model ranks'
  summed flops (the prefill, and one microbatch's loss and gradients)
  equal the one-device count of the same rows within 2%, the counted
  argument bytes equal the specs' on every rank, and the collectives are
  counted by kind; zamba2 (hybrid) is counted in the d-sharded layout,
  and with ``sp`` off in the gathered-whole one;
* a decode cell in the striped-cache layout: qwen2-7b ``decode_32k`` on
  the production mesh is ``ok``, its argument bytes its specs', its K/V
  blocks the whole cache's over 256; on a (2, 4) description each smoke
  config's decode cell counts, rank by rank, what the rank holds: its
  parameter blocks, its token rows and the cache ``shardings.decode_cache``
  allocates for it (the same allocation as the ranks of
  ``test_torch_mesh_decode.py``).

JAX is imported in a fixture.
"""

import json
import math
import sys

import pytest
import torch

from _torch_parity import one_thread  # noqa: F401
from repro_torch.configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config, \
    get_smoke_config
from repro_torch.launch import dryrun, opcost
from repro_torch.launch import steps as S
from repro_torch.launch.shardings import decode_cache
from repro_torch.models import LM
from repro_torch.models.module import param_bytes, tree_leaves
from repro_torch.parallel.mesh import MeshDescription, make_production_mesh
from repro_torch.parallel.spec import local_shape

MESH_SHAPES = ("train_4k", "prefill_32k")


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


# ---------------------------------------------------------------------------
# per device of a mesh
# ---------------------------------------------------------------------------

def _reference_read_bytes(j, ref_cfg, shape, multi_pod):
    """The bytes of one device's blocks of the inputs ``shape``'s step
    reads, by ``repro``'s specs on an abstract production mesh."""
    import math

    from jax.sharding import AbstractMesh, NamedSharding

    jax = j["jax"]
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    mesh = AbstractMesh(sizes, axes)
    specs = j["steps"].input_specs(ref_cfg, shape, mesh, multi_pod=multi_pod)
    if SHAPES[shape]["kind"] == "prefill":
        specs = {"params": specs["params"], "tokens": specs["batch"]["tokens"],
                 "memory": specs["batch"].get("memory")}
    total = 0
    for leaf in jax.tree.leaves(specs):
        block = NamedSharding(mesh, leaf.sharding.spec).shard_shape(leaf.shape)
        total += math.prod(block) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_per_device_argument_bytes_equal_the_reference(j, arch, multi_pod):
    cfg, ref_cfg = get_config(arch), j["configs"].get_config(arch)
    device = dryrun.counted_device(make_production_mesh(multi_pod=multi_pod))
    assert device.coordinate == ((0, 0, 15) if multi_pod else (0, 15))
    for shape in MESH_SHAPES:
        if not cell_is_runnable(cfg, shape):
            continue
        ours = dryrun._read_input_bytes(SHAPES[shape]["kind"], S.input_specs(cfg, shape, device))
        assert ours == _reference_read_bytes(j, ref_cfg, shape, multi_pod), (arch, shape)


def test_model_ranks_sum_to_the_one_device_count():
    """Data index 0 of a (2, 4) description, each of its four model ranks
    counted alone, against one device on the data shard's rows."""
    cfg = get_smoke_config("qwen2-7b")
    desc = MeshDescription((2, 4), ("data", "model"))
    for kind in ("prefill", "train"):
        ranks = [dryrun.run_cell("qwen2-7b", dict(seq_len=64, global_batch=8, kind=kind),
                                 mesh=desc.at(model=m), cfg=cfg, verbose=False)
                 for m in range(4)]
        for r in ranks:
            assert r["status"] == "ok" and r["layout"] == "sequence-parallel"
            assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"]
            assert r["n_devices"] == 8 and r["collective_counts"]["all-gather"] > 0
            # a reduce-scatter runs as an all-reduce of the whole and one's own block
            assert r["collective_bytes"]["all-reduce"] > 0
            assert "reduce-scatter" not in r["collective_bytes"]
        if kind == "prefill":
            one = dryrun.run_cell("qwen2-7b", dict(seq_len=64, global_batch=4, kind=kind),
                                  cfg=cfg, verbose=False)
            assert sum(r["flops"] for r in ranks) == pytest.approx(one["flops"], rel=0.02)
    # one microbatch's loss and gradients, without the update (each rank
    # updates its block only)
    flops = []
    for m in range(4):
        step, _, _ = S.build_train_step(cfg, accum=1, device=S.META, mesh=desc.at(model=m))
        specs = S.input_specs(cfg, dict(seq_len=64, global_batch=8, kind="train"),
                              desc.at(model=m))
        gsum = step.begin(specs["params"])
        flops.append(opcost.count(step.microbatch, specs["params"], specs["batch"], gsum).flops)
    step, _, _ = S.build_train_step(cfg, accum=1, device=S.META)
    specs = S.input_specs(cfg, dict(seq_len=64, global_batch=4, kind="train"))
    one = opcost.count(step.microbatch, specs["params"], specs["batch"],
                       step.begin(specs["params"])).flops
    assert sum(flops) == pytest.approx(one, rel=0.02)


def test_mesh_cells_name_their_layout_and_skip_decode():
    desc = MeshDescription((2, 4), ("data", "model"))
    cfg = get_smoke_config("zamba2-1.2b")
    cell = dict(seq_len=64, global_batch=8, kind="prefill")
    r = dryrun.run_cell("zamba2-1.2b", cell, mesh=desc, cfg=cfg, verbose=False)
    assert r["status"] == "ok" and r["layout"] == "d-sharded"
    assert r["device"] == {"data": 0, "model": 3}
    assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"]
    # with sp off, every dense weight gathered whole for the step
    w = dryrun.run_cell("zamba2-1.2b", cell, mesh=desc, cfg=cfg, verbose=False,
                        run_overrides={"sp": False})
    assert w["status"] == "ok" and w["layout"] == "gathered-whole"
    assert w["memory"]["argument_bytes"] == w["spec_argument_bytes"] == r["spec_argument_bytes"]
    assert r["collective_counts"]["all-gather"] > w["collective_counts"]["all-gather"]
    # a decode cell runs in the striped-cache layout
    mesh = make_production_mesh()
    r = dryrun.run_cell("qwen2-7b", "decode_32k", mesh=mesh, verbose=False)
    assert r["status"] == "ok" and r["layout"] == "striped-cache"
    assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"]
    cfg, device = get_config("qwen2-7b"), dryrun.counted_device(mesh)
    assert r["spec_argument_bytes"] == _bytes(S.input_specs(cfg, "decode_32k", device))
    whole, block = S.cache_specs(cfg, "decode_32k"), S.cache_specs(cfg, "decode_32k", device)
    assert _bytes(block["kv"]) * 256 == _bytes(whole["kv"])
    assert r["collective_counts"]["all-gather"] > 0 and r["collective_bytes"]["all-reduce"] > 0
    assert not torch.cuda.is_initialized()


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b", "granite-moe-3b-a800m",
                                  "llama-3.2-vision-11b", "musicgen-medium", "rwkv6-3b",
                                  "zamba2-1.2b"])
def test_decode_cell_counts_what_a_rank_holds(arch):
    """Each model rank of data index 1 of a (2, 4) description: the count's
    argument bytes are the rank's parameter blocks (``LM.pspecs``; a vlm's
    cross blocks do not run without the cross K/V), its token rows and the
    cache ``decode_cache`` allocates for it."""
    cfg = get_smoke_config(arch)
    desc = MeshDescription((2, 4), ("data", "model"))
    B, T = 8, 64
    model = LM(cfg, device="meta")
    for m in range(4):
        at = desc.at(data=1, model=m)
        r = dryrun.run_cell(arch, dict(seq_len=T, global_batch=B, kind="decode"), mesh=at,
                            cfg=cfg, verbose=False)
        assert r["status"] == "ok" and r["layout"] == "striped-cache"
        params = {k: v for k, v in model.shapes().items() if k != "xattn"}
        specs = model.pspecs(multi_pod=False)
        held = sum(math.prod(local_shape(t.shape, s, at)) * t.element_size()
                   for t, s in zip(tree_leaves(params), tree_leaves(
                       {k: specs[k] for k in params})))
        held += _bytes(decode_cache(model, B, T, at)) + (B // 2) * cfg.n_codebooks * 4
        assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"] == held, m


def test_cli_counts_a_device_of_the_production_mesh(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--mesh", "production",
                     "--multi-pod", "--out", str(tmp_path)])
    assert e.value.code == 0
    r = json.loads((tmp_path / "qwen2-7b__decode_32k__2x16x16.json").read_text())
    assert r["status"] == "ok" and r["layout"] == "striped-cache"
    assert r["mesh"]["shape"] == [2, 16, 16]
    assert r["memory"]["argument_bytes"] == r["spec_argument_bytes"]
    assert r["device"] == {"pod": 0, "data": 0, "model": 15} and r["n_devices"] == 512
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-7b", "--shape", "train_4k", "--multi-pod"])
    assert e.value.code == 2

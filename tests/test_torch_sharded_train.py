"""FSDP/ZeRO training on a (data, model) mesh, against one device.

A gloo world of 4 CPU ranks, a (2, 2) mesh, f32, the smoke configs of
granite-moe-3b-a800m (its MoE FFN as ``moe_apply_shardmap``) and
zamba2-1.2b, at accum 1 and 2, over two steps (the first through the
step's parts, so that its gradients are seen; the second a whole call):

* the loss, and every gradient leaf gathered whole, within 2e-5 (relative
  L2 a leaf, as ``test_torch_train.py`` compares leaves) of the one-device
  oracle, and each update the same way: the state after step 1 against one
  device's, and the state after step 2 against one device's step 2 from the
  mesh's own state after step 1 (Adam's first step divides a gradient by
  its own size, so an element whose gradient is near its eps moves by a
  good part of the learning rate on a rounding of it, and step 2's
  gradients are taken at those parameters).  A leaf that starts at zero
  (zamba2's ``A_log``, ``conv_b``, ``dt_bias``) is after step 1 that update
  alone, -lr · g / (|g| + eps) an element with g clipped: each of its
  elements, and of its f32 master copy, is held to twice the bound
  lr · |a - b| / (min(|a|, |b|) + eps) from the two clipped gradients a and
  b, the rule of ``test_torch_tp.py``.  zamba2 runs in the default layout on
  a mesh, d-sharded (``models/lm.py``), and once more in the gathered-whole
  one (``sp`` off; the case ``zamba2-1.2b|1|gathered-whole``);
* each rank holds only its blocks (``local_shape`` of each leaf's spec);
* a checkpoint of the parameters and the optimizer state saved on (2, 2)
  gathers its leaves one at a time, a stacked leaf one layer at a time, no
  gathered slice alive when the next is gathered (the bytes of each gather
  counted), and restores bit for bit on a (4, 1) mesh of the same world and
  on one device;
* ``TrainRunner(mesh=...)`` draws its data coordinate's rows of the
  reference's token stream (``repro.data``), trains, saves, and resumes on
  (4, 1).

zamba2, which has no MoE, is held to ``repro``'s one-device
``build_train_step`` on the global batches (run once in a subprocess, from
the same parameters): the loss and grad_norm, every gradient leaf, the
parameters after step 1 and the state after step 2 within 2e-4 relative L2
a leaf (1e-6 absolute where a leaf's norm is below 1e-3), the tolerance of
``test_torch_train.py``'s one-device comparison with ``repro`` (the two
packages' one-device steps differ by up to 1.4e-5 in the state after step
2, v squaring the gradients' differences, so 2e-5 cannot hold against
``repro``).  The port's one-device oracle is the tighter one, within 2e-5,
for both archs: for zamba2 the one-device step on the global batch; for
granite, whose dispatch is token-local, the one-device model on each
data shard's rows of each microbatch (capacity from their token count):
the cross-entropy sums over the microbatch's global token count plus 0.01
times the data-mean of the balancing losses, differentiated and updated on
one device.  The masks hold zeros, so the shards' counts differ.
"""

import textwrap
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dist import reference_once, spawn_once
from _torch_parity import one_thread  # noqa: F401
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_smoke_config
from repro_torch.launch.shardings import data_rows
from repro_torch.launch.steps import build_train_step
from repro_torch.models import LM, params_to_numpy
from repro_torch.models.lm import _xent_sums
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, opt_pspecs
from repro_torch.parallel.mesh import MeshDescription
from repro_torch.parallel.spec import local_shape, local_shard

ARCHS = ["granite-moe-3b-a800m", "zamba2-1.2b"]
ACCUMS = [1, 2]
CASES = [(a, n) for a in ARCHS for n in ACCUMS]
# the steps: each case in the default layout, and zamba2 gathered whole
STEP_CASES = [(a, n, True) for a, n in CASES] + [("zamba2-1.2b", 1, False)]
STEP_IDS = [f"{a}|{n}" + ("" if sp else "|gathered-whole") for a, n, sp in STEP_CASES]
STEP_OPT = dict(warmup_steps=1, lr=1e-3, grad_dtype=None)
B, SEQ, TOL = 4, 16, 2e-5
REPRO_TOL, REPRO_SMALL = 2e-4, 1e-6  # test_torch_train.py's against repro
MESH22 = MeshDescription((2, 2), ("data", "model"))
MESH41 = MeshDescription((4, 1), ("data", "model"))
RUNNER = dict(batch=8, seq=16, accum=2, seed=3)


def _params(cfg):
    return LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, SEQ)).astype(np.int32),
         "mask": np.ones((B, SEQ), np.float32)}
    b["mask"][1, ::3] = 0.0
    b["mask"][2, :5] = 0.0
    return b


def _counting(real, log):
    """``real`` (``collectives.whole``) logging, for each call, the bytes it
    gathered and the bytes of the earlier calls' results still alive."""
    alive = []

    def counted(t, mesh, spec):
        held = sum(x.numel() * x.element_size() for x in (r() for r in alive) if x is not None)
        out = real(t, mesh, spec)
        log.append((out.numel() * out.element_size(), held))
        alive.append(weakref.ref(out))
        return out

    return counted


def _specs(cfg):
    ps = LM(cfg, device="meta").pspecs(multi_pod=False)
    return {"params": ps, "opt": opt_pspecs(ps)}


def _rank(rank, world, tmp):
    from repro_torch.launch.train import TrainRunner
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.mesh import make_host_mesh

    mesh = make_host_mesh((2, 2), device_type="cpu")
    mesh41 = make_host_mesh((4, 1), device_type="cpu")
    d = mesh.get_local_rank("data")
    out = {}
    for (arch, accum, sp), key in zip(STEP_CASES, STEP_IDS):
        cfg = get_smoke_config(arch)
        specs = _specs(cfg)
        params = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg), specs["params"])
        opt = adamw_init(params)
        step, _, _ = build_train_step(cfg, accum=accum, opt_cfg=AdamWConfig(**STEP_OPT),
                                      device="cpu", mesh=mesh, run_overrides={"sp": sp})
        rows = data_rows(B, accum, 2, d)
        b1 = {k: v[rows] for k, v in _batch(cfg, 1).items()}
        b2 = {k: v[rows] for k, v in _batch(cfg, 2).items()}
        # step 1 through its parts, to see the gradients
        per = len(rows) // accum
        gsum, loss = step.begin(params), 0.0
        for i in range(accum):
            loss = loss + step.microbatch(
                params, {k: torch.as_tensor(v[i * per:(i + 1) * per]) for k, v in b1.items()},
                gsum)
        grads = [(g / accum).numpy() for g in gsum]
        params, opt, m1 = step.finish(params, opt, gsum, loss)
        p1 = [t.numpy() for t in tree_leaves(params)]
        s1 = [t.numpy() for t in tree_leaves({"params": params, "opt": opt})]
        params, opt, m2 = step(params, opt, b2)
        tree = {"params": params, "opt": opt}
        # this rank's blocks (the test puts them together by coordinate)
        out[key] = {
            "loss": [float(m1["loss"]), float(m2["loss"])],
            "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
            "grads": grads,
            "params1": p1,
            "state1": s1,
            "state2": [t.numpy() for t in tree_leaves(tree)],
        }
        if accum == 2 and sp:
            import repro_torch.checkpoint.store as ST

            store = CheckpointStore(f"{tmp}/{arch}")
            real, gathers = ST.whole, []
            ST.whole = _counting(real, gathers)
            try:
                store.save(2, tree, extra={"arch": arch}, mesh=mesh, specs=specs)
            finally:
                ST.whole = real
            out[key]["save_gathers"] = gathers
            whole = tree_map(lambda t, s: C.whole(t, mesh, s), tree, specs)
            like = {"params": LM(cfg, device="meta").shapes()}
            like["opt"] = adamw_init(like["params"])
            back = store.restore(2, like, device="cpu", mesh=mesh41, specs=specs)
            out[key]["restored41"] = [t.numpy() for t in tree_leaves(back)]
            if rank == 0:
                one = store.restore(2, like, device="cpu")
                out[key]["whole2"] = [t.numpy() for t in tree_leaves(whole)]
                out[key]["restored1"] = [t.numpy() for t in tree_leaves(one)]
    # the runner: a (2, 2) run of 2 steps with checkpoints, resumed on (4, 1)
    cfg = get_smoke_config("zamba2-1.2b")
    opt_cfg = AdamWConfig(**STEP_OPT)
    runner = TrainRunner(cfg, mesh, ckpt_dir=f"{tmp}/runner", opt_cfg=opt_cfg, device="cpu",
                         **RUNNER)
    out["runner_rows"] = runner.data.rows
    out["runner_batch"] = runner.data._rows(0, runner.data.rows)
    losses = runner.train(2, log_every=1, save_every=1, log=lambda *a: None)
    out["runner_losses"] = [loss for _, loss in losses]
    out["runner_params"] = [t.numpy() for t in tree_leaves(runner.params)]
    resumed = TrainRunner(cfg, mesh41, ckpt_dir=f"{tmp}/runner", opt_cfg=opt_cfg, device="cpu",
                          **RUNNER)
    out["resumed_state"] = resumed.init_or_restore()
    out["resumed_step"] = resumed.step
    out["resumed_params"] = [t.numpy() for t in tree_leaves(resumed.params)]
    out["resumed_rows"] = resumed.data.rows
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    return spawn_once("sharded_train", _rank, 4, tmp_path_factory, str(tmp))


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

_REF_SCRIPT = textwrap.dedent(f"""
    import json, os, sys
    sys.path.insert(0, {str(Path(__file__).parent)!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.steps import build_train_step as j_build
    from repro.optim import AdamWConfig as JCfg, adamw_init as j_init
    from test_torch_sharded_train import ACCUMS, B, STEP_OPT, _batch, _params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params_to_numpy

    arch = "zamba2-1.2b"
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    start = jax.tree.map(jnp.asarray, params_to_numpy(_params(cfg)))
    arrays, info = {{}}, {{}}
    for accum in ACCUMS:
        step, model, run = j_build(jcfg, multi_pod=False, accum=accum,
                                   opt_cfg=JCfg(**STEP_OPT), run_overrides={{"sp": False}})
        step = jax.jit(step)
        params, state = start, j_init(start)
        info[str(accum)] = {{"loss": [], "grad_norm": []}}
        for seed in (1, 2):
            b = {{k: jnp.asarray(v) for k, v in _batch(cfg, seed).items()}}
            if seed == 1:  # the step's gradient, microbatch by microbatch
                per, gsum = B // accum, None
                grad = jax.jit(jax.grad(lambda p, mb: model.loss(p, mb, run=run)))
                for i in range(accum):
                    mb = {{k: v[i * per:(i + 1) * per] for k, v in b.items()}}
                    g = grad(params, mb)
                    gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
                for j, leaf in enumerate(jax.tree.leaves(gsum)):
                    arrays[f"{{accum}}/grads/{{j}}"] = np.asarray(leaf / accum)
            params, state, m = step(params, state, b)
            info[str(accum)]["loss"].append(float(m["loss"]))
            info[str(accum)]["grad_norm"].append(float(m["grad_norm"]))
            if seed == 1:
                for j, leaf in enumerate(jax.tree.leaves(params)):
                    arrays[f"{{accum}}/params1/{{j}}"] = np.asarray(leaf)
        for j, leaf in enumerate(jax.tree.leaves({{"params": params, "opt": state}})):
            arrays[f"{{accum}}/state2/{{j}}"] = np.asarray(leaf)
    np.savez(os.environ["OUT"], **arrays)
    print(json.dumps(info))
""")


@pytest.fixture(scope="module")
def repro_step(tmp_path_factory):
    """{accum: (losses, grad_norms, step-1 gradient leaves, params after
    step 1, the state tree after step 2)} of ``repro``'s one-device step
    for zamba2."""
    pytest.importorskip("jax")
    arrays, info = reference_once("sharded_train_repro", _REF_SCRIPT, tmp_path_factory)
    out = {}
    for accum in ACCUMS:
        out[accum] = dict(info[str(accum)])
        for name in ("grads", "params1", "state2"):
            n = sum(k.startswith(f"{accum}/{name}/") for k in arrays)
            out[accum][name] = [arrays[f"{accum}/{name}/{j}"] for j in range(n)]
    return out


def _one_device_step(arch, accum, params, opt, seed):
    """One device's step from ``params`` and ``opt`` on the global batch of
    ``seed``: (params, opt, loss, the step's gradient leaves)."""
    cfg = get_smoke_config(arch)
    opt_cfg = AdamWConfig(**STEP_OPT)
    b = _batch(cfg, seed)
    if cfg.moe is None:
        step, _, _ = build_train_step(cfg, accum=accum, opt_cfg=opt_cfg, device="cpu")
        rows = B // accum
        gsum, loss = step.begin(params), 0.0
        for i in range(accum):
            mb = {k: torch.as_tensor(v[i * rows:(i + 1) * rows]) for k, v in b.items()}
            loss = loss + step.microbatch(params, mb, gsum)
        grads = [(g / accum).numpy() for g in gsum]
        params, opt, m = step.finish(params, opt, gsum, loss)
        return params, opt, float(m["loss"]), grads
    model = LM(cfg, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    total = 0.0
    per = B // accum
    for i in range(accum):
        tot = cnt = 0.0
        auxes = []
        for dd in range(2):
            r = slice(i * per + dd * per // 2, i * per + (dd + 1) * per // 2)
            hid, aux, _ = model.hidden_states(p, b["tokens"][r], run={"remat": False})
            t, c = _xent_sums(p["embed"], cfg, hid, b["targets"][r], b["mask"][r], chunk=512)
            tot, cnt = tot + t, cnt + c
            auxes.append(aux)
        total = total + tot / cnt + 0.01 * sum(auxes) / 2
    total = total / accum
    grads = torch.autograd.grad(total, leaves)
    it = iter(grads)
    params, opt, _ = adamw_update(opt_cfg, params, tree_map(lambda _: next(it), params), opt)
    return params, opt, float(total.detach()), [g.numpy() for g in grads]


_ORACLE = {}


def _oracle(arch, accum):
    """(losses, step-1 gradient leaves, params and the state tree after
    step 1, the state tree after step 2), on one device."""
    if (arch, accum) in _ORACLE:
        return _ORACLE[(arch, accum)]
    params = _params(get_smoke_config(arch))
    opt = adamw_init(params)
    out = {"loss": []}
    for seed in (1, 2):
        params, opt, loss, grads = _one_device_step(arch, accum, params, opt, seed)
        out["loss"].append(loss)
        if seed == 1:
            out["grads"] = grads
            out["params1"] = [t.numpy() for t in tree_leaves(params)]
            out["state1"] = [t.numpy() for t in tree_leaves({"params": params, "opt": opt})]
    out["state2"] = [t.numpy() for t in tree_leaves({"params": params, "opt": opt})]
    _ORACLE[(arch, accum)] = out
    return out


def _step2_from_the_mesh(arch, accum, key, ranks):
    """One device's step 2 from the mesh's state after step 1 (the ranks'
    blocks put together): the state tree's leaves after it."""
    cfg = get_smoke_config(arch)
    whole = _assemble([ranks[r][key]["state1"] for r in range(4)], tree_leaves(_specs(cfg)))
    shapes = LM(cfg, device="meta").shapes()
    it = iter(whole)
    tree = tree_map(lambda _: torch.from_numpy(np.array(next(it))),
                    {"params": shapes, "opt": adamw_init(shapes)})
    params, opt, _, _ = _one_device_step(arch, accum, tree["params"], tree["opt"], 2)
    return [t.numpy() for t in tree_leaves({"params": params, "opt": opt})]


def _paths(tree, prefix: str = "") -> list:
    """The "/"-joined key paths of a tree, in its leaves' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close_leaves(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        if np.linalg.norm(w) < 1e-6:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"{what} leaf {i}")
        else:
            assert _rel_l2(g, w) <= TOL, (what, i, _rel_l2(g, w))


def _close_to_repro(got, want, what):
    """``test_torch_train.py``'s rule against ``repro``: each leaf within
    REPRO_TOL relative L2, or REPRO_SMALL absolute where ``repro``'s leaf has
    a norm below 1e-3."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        if np.linalg.norm(np.asarray(w, np.float64)) < 1e-3:
            assert np.abs(g.astype(np.float64) - w).max() <= REPRO_SMALL, (what, i)
        else:
            assert _rel_l2(g, w) <= REPRO_TOL, (what, i, _rel_l2(g, w))


def _coord(rank, mesh=MESH22):
    return {"data": rank // mesh.shape[1], "model": rank % mesh.shape[1]}


def _blocks(leaves, specs, rank, mesh=MESH22):
    """Rank ``rank``'s blocks of whole numpy leaves."""
    return [local_shard(torch.from_numpy(np.array(w, order="C")), s, mesh,
                        coord=_coord(rank, mesh)).numpy() for w, s in zip(leaves, specs)]


def _assemble(per_rank, specs, mesh=MESH22):
    """The whole leaves of the ranks' blocks (each rank's list of leaves)."""
    out = []
    for i, spec in enumerate(specs):
        blk = per_rank[0][i]
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        entries = tuple(spec) + (None,) * (blk.ndim - len(spec))
        shape = [n * (sizes[e] if isinstance(e, str) else 1) for n, e in zip(blk.shape, entries)]
        whole = np.empty(shape, blk.dtype)
        for rank, leaves in enumerate(per_rank):
            c = _coord(rank, mesh)
            idx = tuple(slice(c[e] * n, (c[e] + 1) * n) if isinstance(e, str) else slice(None)
                        for n, e in zip(blk.shape, entries))
            whole[idx] = leaves[i]
        out.append(whole)
    return out


def _raw(a):
    """The bytes of an array (a 0-d one too)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """The oracles on one torch thread (``_torch_parity.one_thread``)."""


@pytest.mark.parametrize("case", STEP_CASES, ids=STEP_IDS)
def test_loss_and_gradients_match_one_device(ranks, case):
    """The loss, and each rank's blocks of every gradient leaf (together the
    whole of it) against the oracle's."""
    want = _oracle(*case[:2])
    specs = tree_leaves(_specs(get_smoke_config(case[0]))["params"])
    for rank in range(4):
        got = ranks[rank][STEP_IDS[STEP_CASES.index(case)]]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        _close_leaves(got["grads"], _blocks(want["grads"], specs, rank), f"grads rank {rank}")


@pytest.mark.parametrize("case", STEP_CASES, ids=STEP_IDS)
def test_updates_match_one_device(ranks, case):
    """Each update against one device's (the module docstring): every leaf
    of the state after step 1 against the oracle's, a leaf that starts at
    zero (and its master copy) element by element; the state after step 2
    against one device's step 2 from the mesh's state after step 1."""
    arch, accum, _ = case
    key = STEP_IDS[STEP_CASES.index(case)]
    cfg = get_smoke_config(arch)
    want = _oracle(arch, accum)
    specs = _specs(cfg)
    opt = AdamWConfig(**STEP_OPT)
    start = _params(cfg)
    names = _paths(start)
    zero = {n for n, t in zip(names, tree_leaves(start)) if not t.any()}
    assert zero == ({"blocks/A_log", "blocks/conv_b", "blocks/dt_bias"} if cfg.moe is None
                    else set())
    state_names = _paths({"params": start, "opt": adamw_init(start)})
    after = _step2_from_the_mesh(arch, accum, key, ranks)
    norm_one = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum()) for g in want["grads"]))
    for rank in range(4):
        got = ranks[rank][key]
        wanted = _blocks(want["grads"], tree_leaves(specs["params"]), rank)
        for g, w, n in zip(got["state1"], _blocks(want["state1"], tree_leaves(specs), rank),
                           state_names):
            leaf = n.split("/", 1)[1] if n.startswith("params/") else n[len("opt/master/"):]
            if leaf not in zero:
                _close_leaves([g], [w], f"{n} after step 1, rank {rank}")
                continue
            j = names.index(leaf)
            a = got["grads"][j].astype(np.float64) * min(1.0, opt.clip_norm / got["grad_norm"][0])
            b = wanted[j].astype(np.float64) * min(1.0, opt.clip_norm / norm_one)
            bound = opt.lr * np.abs(a - b) / (np.minimum(np.abs(a), np.abs(b)) + opt.eps)
            err = np.abs(g.astype(np.float64) - w)
            assert (err <= 2 * bound + 1e-6 * opt.lr).all(), (n, rank, float(err.max()))
        _close_leaves(got["state2"], _blocks(after, tree_leaves(specs), rank),
                      f"state after step 2, rank {rank}")
        np.testing.assert_allclose(got["grad_norm"], ranks[0][key]["grad_norm"], rtol=0, atol=0)


@pytest.mark.parametrize("accum", ACCUMS)
def test_zamba2_matches_repro_one_device_step(ranks, repro_step, accum):
    """zamba2 (no MoE) on (2, 2) against ``repro``'s one-device
    ``build_train_step`` on the global batches: the loss and grad_norm of
    both steps, each rank's blocks of the step-1 gradients, of the
    parameters after step 1 and of the state after step 2."""
    want = repro_step[accum]
    specs = _specs(get_smoke_config("zamba2-1.2b"))
    for rank in range(4):
        got = ranks[rank][f"zamba2-1.2b|{accum}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=REPRO_TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=REPRO_TOL)
        _close_to_repro(got["grads"], _blocks(want["grads"], tree_leaves(specs["params"]), rank),
                        f"grads rank {rank}")
        _close_to_repro(got["params1"],
                        _blocks(want["params1"], tree_leaves(specs["params"]), rank),
                        f"params after step 1, rank {rank}")
        _close_to_repro(got["state2"], _blocks(want["state2"], tree_leaves(specs), rank),
                        f"state after step 2, rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=[f"{a}|{n}" for a, n in CASES])
def test_each_rank_holds_only_its_blocks(ranks, case):
    cfg = get_smoke_config(case[0])
    shapes = LM(cfg, device="meta").shapes()
    whole = {"params": shapes, "opt": adamw_init(shapes)}
    want = [local_shape(t.shape, s, MESH22)
            for t, s in zip(tree_leaves(whole), tree_leaves(_specs(cfg)))]
    for rank in range(4):
        assert [a.shape for a in ranks[rank][f"{case[0]}|{case[1]}"]["state2"]] == want
    # the FSDP and TP blocks are a quarter of an expert weight
    if cfg.moe is not None:
        e, d, f = shapes["blocks"]["ffn"]["wi"].shape[1:]
        assert (e, d // 2, f // 2) in [s[1:] for s in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_bit_for_bit_on_another_mesh(ranks, arch):
    """Saved on (2, 2) (the whole tree, gathered), restored on (4, 1) and
    on one device."""
    cfg = get_smoke_config(arch)
    specs = tree_leaves(_specs(cfg))
    saved = ranks[0][f"{arch}|2"]["whole2"]
    for rank in range(4):
        for g, w in zip(ranks[rank][f"{arch}|2"]["state2"], _blocks(saved, specs, rank)):
            np.testing.assert_array_equal(_raw(g), _raw(w))
        got = ranks[rank][f"{arch}|2"]["restored41"]
        for g, w in zip(got, _blocks(saved, specs, rank, MESH41)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(_raw(g), _raw(w))
    for g, w in zip(ranks[0][f"{arch}|2"]["restored1"], saved):
        np.testing.assert_array_equal(_raw(g), _raw(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_save_gathers_one_slice_at_a_time(ranks, arch):
    """Every leaf split on the mesh gathered once, a stacked leaf one slice
    of its first unsplit dim (a layer) at a time, and no gathered slice
    still alive when the next is gathered, on every rank: what a rank holds
    beyond its blocks during a save is at most one slice."""
    cfg = get_smoke_config(arch)
    shapes = LM(cfg, device="meta").shapes()
    whole = {"params": shapes, "opt": adamw_init(shapes)}
    want = []
    for t, spec in zip(tree_leaves(whole), tree_leaves(_specs(cfg))):
        entries = tuple(spec) + (None,) * (t.dim() - len(spec))
        if all(e is None for e in entries):
            continue
        nbytes = t.numel() * t.element_size()
        free = next((d for d, e in enumerate(entries) if e is None and t.shape[d] > 1), None)
        want += [nbytes] if free is None else [nbytes // t.shape[free]] * t.shape[free]
    largest = max(t.numel() * t.element_size() for t in tree_leaves(whole))
    for rank in range(4):
        gathers = ranks[rank][f"{arch}|2"]["save_gathers"]
        assert [n for n, _ in gathers] == want
        assert all(held == 0 for _, held in gathers)
        assert max(n for n, _ in gathers) < largest


def test_runner_takes_the_reference_streams_rows(ranks):
    pytest.importorskip("jax")
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticTokenStream as JStream

    cfg = get_smoke_config("zamba2-1.2b")
    ref = JStream(JDataConfig(vocab=cfg.vocab, seq_len=RUNNER["seq"],
                              global_batch=RUNNER["batch"], seed=RUNNER["seed"]))
    whole = ref.next_batch()["tokens"]
    for rank in range(4):
        rows = data_rows(RUNNER["batch"], RUNNER["accum"], 2, rank // 2)
        assert ranks[rank]["runner_rows"] == rows
        np.testing.assert_array_equal(ranks[rank]["runner_batch"][:, :-1], whole[rows])
        assert ranks[rank]["resumed_rows"] == data_rows(RUNNER["batch"], RUNNER["accum"], 4, rank)


def test_runner_on_a_mesh_trains_as_one_device_and_resumes(ranks, tmp_path):
    from repro_torch.launch.train import TrainRunner

    cfg = get_smoke_config("zamba2-1.2b")
    one = TrainRunner(cfg, ckpt_dir=str(tmp_path / "one"), opt_cfg=AdamWConfig(**STEP_OPT),
                      device="cpu", **RUNNER)
    losses = [loss for _, loss in one.train(2, log_every=1, save_every=0, log=lambda *a: None)]
    specs = tree_leaves(_specs(cfg)["params"])
    want = [t.numpy() for t in tree_leaves(one.params)]
    trained = _assemble([ranks[r]["runner_params"] for r in range(4)], specs)
    _close_leaves(trained, want, "runner params")
    for rank in range(4):
        r = ranks[rank]
        np.testing.assert_allclose(r["runner_losses"], losses, rtol=TOL)
        assert r["resumed_state"] == "restored" and r["resumed_step"] == 2
        for g, w in zip(r["resumed_params"], _blocks(trained, specs, rank, MESH41)):
            np.testing.assert_array_equal(_raw(g), _raw(w))


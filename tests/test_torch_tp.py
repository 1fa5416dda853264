"""Tensor and sequence parallelism over "model" for the attention stacks.

A gloo world of 4 CPU ranks (once a session), f32 smoke configs of
qwen2-7b (dense), granite-moe-3b-a800m and mixtral-8x7b (moe, mixtral with
its sliding window), musicgen-medium (audio) and llama-3.2-vision-11b (vlm,
both tanh gates drawn nonzero), on (2, 2), (1, 4) and (4, 1) ("data",
"model") meshes of that world, in the sequence-parallel layout (``sp``, on
by default on a mesh), each rank holding only its blocks:

* the prefill's last-token logits, the loss and every gradient leaf (each
  rank's blocks, under remat) against the one-device port within 2e-5
  relative L2 a leaf (the MoE's oracle runs each data shard's rows alone,
  as its dispatch is token-local);
* each rank's residual is its (B/D, S/M, d) block of the one-device
  hidden states; S % M != 0 raises;
* the dense train step at accum 2 on (2, 2) against ``repro``'s one-device
  ``build_train_step(run_overrides={"sp": False})`` within 2e-4 (the
  tolerance of ``test_torch_train.py``);
* the gathers: every layer gathers its own weights inside its checkpoint
  (twice a step under remat), and no other layer's gathered weights are
  alive when it does, where ``sp=False`` (the gathered-whole layout) holds
  every layer's at once; the dense FFN's blocks stay the rank's "model"
  blocks;
* the sequence-parallel attention (``layers.attn_apply(layout=
  SeqParallel(...))``) on the (1, 4) mesh against whole attention, output
  and gradients.
"""

import textwrap
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_dist import reference_once, spawn_once
from _torch_parity import one_thread  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.launch.shardings import batch_pspecs, data_rows
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models.lm import _xent_sums
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.mesh import MeshDescription
from repro_torch.parallel.spec import local_shard

ARCHS = ["qwen2-7b", "granite-moe-3b-a800m", "mixtral-8x7b", "musicgen-medium",
         "llama-3.2-vision-11b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
CASES = [(a, m) for m in MESHES for a in ARCHS]
IDS = [f"{a}|{m}" for a, m in CASES]
B, SEQ, TOL = 4, 48, 2e-5   # 48 tokens: mixtral's smoke window (32) masks keys
REPRO_TOL, REPRO_SMALL = 2e-4, 1e-6
STEP_OPT = dict(warmup_steps=1, lr=1e-3, grad_dtype=None)
TRAIN_ARCH, TRAIN_ACCUM = "qwen2-7b", 2


def _cfg(arch):
    return get_smoke_config(arch)


def _params(cfg):
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    if cfg.xattn_every:  # the reference inits both tanh gates to 0
        g = torch.Generator().manual_seed(6)
        for tree, name in ((params["xattn"]["attn"], "gate"), (params["xattn"], "ffn_gate")):
            tree[name] = 0.5 + torch.rand(tree[name].shape, generator=g)
    return params


def _batch(cfg, seq=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    shape = (B, seq) if cfg.n_codebooks == 1 else (B, seq, cfg.n_codebooks)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape).astype(np.int32)),
           "targets": torch.as_tensor(rng.integers(0, cfg.vocab, shape).astype(np.int32))}
    mask = np.ones((B, seq), np.float32)
    mask[1, ::3] = 0.0
    mask[2, :5] = 0.0
    out["mask"] = torch.as_tensor(mask)
    if cfg.xattn_every:
        out["memory"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    return out


def _coord(rank, shape):
    return {"data": rank // shape[1], "model": rank % shape[1]}


def _rows(shape, d):
    per = B // shape[0]
    return slice(d * per, (d + 1) * per)


def _rank_batch(cfg, batch, mesh, shape, d):
    """The rank's rows, and its block of the image memory."""
    out = {k: v[_rows(shape, d)] for k, v in batch.items() if k != "memory"}
    if "memory" in batch:
        out["memory"] = local_shard(batch["memory"], batch_pspecs(cfg, B, mesh)["memory"], mesh)
    return out


def _lm_case(cfg, mesh, shape, d):
    """(logits, hidden, loss, grads) of one rank in the sequence-parallel
    layout."""
    model = LM(cfg, device="cpu")
    specs = model.pspecs(multi_pod=False)
    blocks = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg), specs)
    mine = _rank_batch(cfg, _batch(cfg), mesh, shape, d)
    run = {"mesh": mesh, "sp": True}
    with torch.no_grad():
        logits, aux, _ = model.prefill(blocks, mine["tokens"], memory=mine.get("memory"), run=run)
        hid, _, _ = model.hidden_states(blocks, mine["tokens"], memory=mine.get("memory"),
                                        run=run)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(blocks)]
    it = iter(leaves)
    loss = model.loss(tree_map(lambda _: next(it), blocks), mine, run=run)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {"logits": logits.numpy(), "hidden": hid.numpy(), "loss": float(loss.detach()),
            "aux": float(aux), "grads": [None if g is None else g.numpy() for g in grads]}


def _gathers_case(mesh, sp: bool):
    """The loss and backward of the dense smoke model on ``mesh`` with the
    layer views (``blocks.sp_block_view``) and every parameter view
    (``collectives.param_view``) recorded: for each layer view, the bytes it
    gathered and the bytes of earlier layer views still alive; the most
    gathered parameter bytes alive at once."""
    from repro_torch.models import blocks as TB
    from repro_torch.parallel import collectives as C

    cfg = _cfg(TRAIN_ARCH)
    model = LM(cfg, device="cpu")
    specs = model.pspecs(multi_pod=False)
    blocks = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg), specs)
    mine = _rank_batch(cfg, _batch(cfg), mesh, (2, 2), mesh.get_local_rank("data"))
    layer_views, earlier = [], []
    alive, peak = [], [0]

    def gathered(tree, blocks_):
        """The leaves of a view that a collective made (not views of the
        rank's own blocks)."""
        own = {t.untyped_storage().data_ptr() for t in tree_leaves(blocks_)}
        return [t for t in tree_leaves(tree) if t.untyped_storage().data_ptr() not in own]

    real_view, real_param = TB.sp_block_view, C.param_view

    def param_view(t, spec, mesh_, *, model):
        out = real_param(t, spec, mesh_, model=model)
        if out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
            alive.append((weakref.ref(out), out.numel() * out.element_size()))
            peak[0] = max(peak[0], sum(n for r, n in alive if r() is not None))
        return out

    def sp_block_view(p, meta, mesh_, **kw):
        held = sum(n for r, n in earlier if r() is not None)
        out = real_view(p, meta, mesh_, **kw)
        mine_ = [(t, t.numel() * t.element_size()) for t in gathered(out, p)]
        layer_views.append({"held": held, "bytes": sum(n for _, n in mine_),
                            "shapes": {k: tuple(v.shape) for k, v in out["ffn"].items()}})
        earlier.extend((weakref.ref(t), n) for t, n in mine_)
        return out

    TB.sp_block_view, C.param_view = sp_block_view, param_view
    try:
        leaves = [t.detach().requires_grad_() for t in tree_leaves(blocks)]
        it = iter(leaves)
        loss = model.loss(tree_map(lambda _: next(it), blocks), mine,
                          run={"mesh": mesh, "sp": sp})
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        TB.sp_block_view, C.param_view = real_view, real_param
    return {"layer_views": layer_views, "peak_param_bytes": peak[0], "loss": float(loss),
            "grads": [None if g is None else g.numpy() for g in grads]}


def _attention_case(arch, mesh):
    """``attn_apply`` in the sequence-parallel layout on the rank's tokens:
    its output and the gradients of x and of the whole weights."""
    cfg = _cfg(arch)
    m = mesh.get_local_rank("model")
    p, x = _attn_inputs(cfg)
    n = SEQ // mesh.shape[1]
    xl = x[:, m * n:(m + 1) * n].clone().requires_grad_()
    pl = {k: v.clone().requires_grad_() for k, v in p.items()}
    out, _ = TL.attn_apply(pl, cfg, xl, positions=torch.arange(m * n, (m + 1) * n),
                           layout=TL.SeqParallel(mesh, m * n))
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    gx, *gp = torch.autograd.grad((out * w).sum(), [xl] + [pl[k] for k in sorted(pl)])
    return {"out": out.detach().numpy(), "gx": gx.numpy(),
            "gp": {k: g.numpy() for k, g in zip(sorted(pl), gp)}}


def _attn_inputs(cfg):
    g = torch.Generator().manual_seed(11)
    p = {k: torch.randn(meta.shape, generator=g) * 0.2 for k, meta in
         TL.attn_meta(cfg).items()}
    return p, torch.randn(B, SEQ, cfg.d_model, generator=g)


def _rank(rank, world, tmp):
    from repro_torch.launch.steps import build_train_step
    from repro_torch.parallel.mesh import make_host_mesh

    meshes = {name: make_host_mesh(shape, device_type="cpu") for name, shape in MESHES.items()}
    out = {}
    for arch, name in CASES:
        shape, mesh = MESHES[name], meshes[name]
        out[f"{arch}|{name}"] = _lm_case(_cfg(arch), mesh, shape, mesh.get_local_rank("data"))
    # S % M != 0 in the sequence-parallel layout
    cfg = _cfg(TRAIN_ARCH)
    model = LM(cfg, device="cpu")
    mesh = meshes["1x4"]
    blocks = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg),
                      model.pspecs(multi_pod=False))
    try:
        model.loss(blocks, {k: v[:, :SEQ - 2] for k, v in _batch(cfg).items()},
                   run={"mesh": mesh, "sp": True})
        out["indivisible"] = ""
    except ValueError as e:
        out["indivisible"] = str(e)
    # the gathers, in both layouts
    out["gathers_sp"] = _gathers_case(meshes["2x2"], True)
    out["gathers_whole"] = _gathers_case(meshes["2x2"], False)
    # the sequence-parallel attention on (1, 4)
    out["attention"] = {a: _attention_case(a, meshes["1x4"]) for a in
                        (TRAIN_ARCH, "mixtral-8x7b")}
    # the dense train step at accum 2 on (2, 2): step 1 through its parts
    mesh, shape = meshes["2x2"], MESHES["2x2"]
    cfg = _cfg(TRAIN_ARCH)
    specs = LM(cfg, device="meta").pspecs(multi_pod=False)
    params = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg), specs)
    step, _, run = build_train_step(cfg, accum=TRAIN_ACCUM, opt_cfg=AdamWConfig(**STEP_OPT),
                                    device="cpu", mesh=mesh)
    rows = data_rows(B, TRAIN_ACCUM, shape[0], mesh.get_local_rank("data"))
    b = {k: v[rows] for k, v in _batch(cfg, seq=16, seed=3).items()}
    per = len(rows) // TRAIN_ACCUM
    gsum, loss = step.begin(params), 0.0
    for i in range(TRAIN_ACCUM):
        loss = loss + step.microbatch(params, {k: v[i * per:(i + 1) * per] for k, v in b.items()},
                                      gsum)
    grads = [(g / TRAIN_ACCUM).numpy() for g in gsum]
    new, _, metrics = step.finish(params, adamw_init(params), gsum, loss)
    out["train"] = {"sp": run["sp"], "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]), "grads": grads,
                    "params1": [t.numpy() for t in tree_leaves(new)]}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return spawn_once("tp", _rank, 4, tmp_path_factory, str(tmp))


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """The oracles on one torch thread (``_torch_parity.one_thread``)."""


# ---------------------------------------------------------------------------
# the one-device oracles
# ---------------------------------------------------------------------------

_ORACLE = {}


def _oracle(arch, n_dp):
    """(logits, hidden, loss, grads) on one device.  An MoE model's runs
    each data shard's rows alone (token-local dispatch): the cross-entropy
    sums over the global token count plus 0.01 times the data-mean of the
    balancing losses."""
    key = (arch, n_dp if _cfg(arch).moe is not None else 1)
    if key in _ORACLE:
        return _ORACLE[key]
    cfg = _cfg(arch)
    model = LM(cfg, device="cpu")
    params = _params(cfg)
    batch = _batch(cfg)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    n = key[1]
    shards = [_rows((n, 1), d) for d in range(n)]
    logits, hidden, tot, cnt, auxes = [], [], 0.0, 0.0, []
    for r in shards:
        mem = batch.get("memory")
        mem = None if mem is None else mem[r]
        with torch.no_grad():
            logits.append(model.prefill(params, batch["tokens"][r], memory=mem)[0])
        hid, aux, _ = model.hidden_states(p, batch["tokens"][r], memory=mem)
        hidden.append(hid.detach())
        t, c = _xent_sums(p["embed"], cfg, hid, batch["targets"][r], batch["mask"][r], chunk=512)
        tot, cnt = tot + t, cnt + c
        auxes.append(aux)
    loss = tot / cnt + 0.01 * sum(auxes) / n
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    _ORACLE[key] = {"logits": torch.cat(logits).numpy(), "hidden": torch.cat(hidden).numpy(),
                    "loss": float(loss.detach()),
                    "grads": [np.zeros(t.shape, np.float32) if g is None else g.numpy()
                              for t, g in zip(leaves, grads)]}
    return _ORACLE[key]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close_leaves(got, want, what, tol=TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.zeros(w.shape, np.float32) if g is None else g
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if np.linalg.norm(w) < 1e-6:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{what} leaf {i}")
        else:
            assert _rel_l2(g, w) <= tol, (what, i, _rel_l2(g, w))


def _blocks(leaves, specs, rank, shape):
    desc = MeshDescription(shape, ("data", "model"))
    return [local_shard(torch.from_numpy(np.array(w, order="C")), s, desc,
                        coord=_coord(rank, shape)).numpy() for w, s in zip(leaves, specs)]


# ---------------------------------------------------------------------------
# the mesh path against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_logits_match_one_device(ranks, case):
    arch, name = case
    shape = MESHES[name]
    want = _oracle(arch, shape[0])["logits"]
    for rank in range(4):
        got = ranks[rank][f"{arch}|{name}"]["logits"]
        r = _rows(shape, rank // shape[1])
        assert got.shape == want[r].shape
        assert _rel_l2(got, want[r]) <= TOL, (rank, _rel_l2(got, want[r]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_matches_one_device(ranks, case):
    arch, name = case
    want = _oracle(arch, MESHES[name][0])["loss"]
    for rank in range(4):
        np.testing.assert_allclose(ranks[rank][f"{arch}|{name}"]["loss"], want, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_one_device(ranks, case):
    """Each rank's blocks of every gradient leaf (together the whole of it)
    against the one-device gradient."""
    arch, name = case
    shape = MESHES[name]
    want = _oracle(arch, shape[0])["grads"]
    specs = tree_leaves(LM(_cfg(arch), device="meta").pspecs(multi_pod=False))
    for rank in range(4):
        _close_leaves(ranks[rank][f"{arch}|{name}"]["grads"], _blocks(want, specs, rank, shape),
                      f"{arch} on {name}, rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_residual_is_the_ranks_token_block(ranks, case):
    """``hidden_states`` on a rank: its (B/D, S/M, d) block of the
    one-device hidden states."""
    arch, name = case
    shape = MESHES[name]
    want = _oracle(arch, shape[0])["hidden"]
    n = SEQ // shape[1]
    for rank in range(4):
        got = ranks[rank][f"{arch}|{name}"]["hidden"]
        c = _coord(rank, shape)
        w = want[_rows(shape, c["data"]), c["model"] * n:(c["model"] + 1) * n]
        assert got.shape == (B // shape[0], n, _cfg(arch).d_model)
        assert _rel_l2(got, w) <= TOL


def test_indivisible_sequence_raises(ranks):
    for rank in range(4):
        assert "do not divide" in ranks[rank]["indivisible"]


def _paths(tree, prefix: str = "") -> list:
    """The "/"-joined key paths of a parameter tree, in its leaves' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def test_train_step_matches_repro_one_device(ranks, repro_step):
    """The dense train step at accum 2 on (2, 2) (``sp`` on, as
    ``build_run`` sets it on a mesh) against ``repro``'s one-device step:
    the loss and grad_norm, each rank's blocks of every leaf of the step's
    gradients and of the parameters after it, within 2e-4 relative L2 (1e-6
    absolute where ``repro``'s leaf has a norm below 1e-3).  A leaf that
    starts at zero (qwen2's q, k and v biases) is after the step Adam's first
    update alone, -lr · g / (|g| + eps) an element with g clipped, which two
    gradients a and b that differ by rounding move apart by at most lr · |a -
    b| / (min(|a|, |b|) + eps): a relative L2 over such a leaf says nothing
    where some g is near eps (40 of the k bias's 128 are below 1e-6), so each
    of its elements is held to twice that bound from the two packages' own
    clipped gradients."""
    specs = tree_leaves(LM(_cfg(TRAIN_ARCH), device="meta").pspecs(multi_pod=False))
    opt = AdamWConfig(**STEP_OPT)
    start = [t.numpy() for t in tree_leaves(_params(_cfg(TRAIN_ARCH)))]
    assert [p for p, t in zip(_paths(_params(_cfg(TRAIN_ARCH))), start) if not t.any()] == \
        ["blocks/attn/bk", "blocks/attn/bq", "blocks/attn/bv"]
    for rank in range(4):
        got = ranks[rank]["train"]
        assert got["sp"] is True
        np.testing.assert_allclose(got["loss"], repro_step["loss"], rtol=REPRO_TOL)
        np.testing.assert_allclose(got["grad_norm"], repro_step["grad_norm"], rtol=REPRO_TOL)
        clipped = [[g.astype(np.float64) * min(1.0, opt.clip_norm / norm) for g in gs]
                   for gs, norm in ((got["grads"], got["grad_norm"]),
                                    (_blocks(repro_step["grads"], specs, rank, MESHES["2x2"]),
                                     repro_step["grad_norm"]))]
        for what in ("grads", "params1"):
            want = _blocks(repro_step[what], specs, rank, MESHES["2x2"])
            for i, (g, w) in enumerate(zip(got[what], want)):
                assert g.shape == w.shape
                g, w = g.astype(np.float64), w.astype(np.float64)
                if what == "params1" and not start[i].any():
                    a, b = clipped[0][i], clipped[1][i]
                    bound = opt.lr * np.abs(a - b) / (np.minimum(np.abs(a), np.abs(b)) + opt.eps)
                    assert (np.abs(g - w) <= 2 * bound + 1e-6 * opt.lr).all(), (what, i)
                elif np.linalg.norm(w) < 1e-3:
                    assert np.abs(g - w).max(initial=0.0) <= REPRO_SMALL, (what, i)
                else:
                    assert _rel_l2(g, w) <= REPRO_TOL, (what, i, _rel_l2(g, w))


_REF_SCRIPT = textwrap.dedent(f"""
    import json, os, sys
    sys.path.insert(0, {str(Path(__file__).parent)!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch.steps import build_train_step as j_build
    from repro.optim import AdamWConfig as JCfg, adamw_init as j_init
    from test_torch_tp import B, STEP_OPT, TRAIN_ACCUM, TRAIN_ARCH, _batch, _cfg, _params
    from repro_torch.models import params_to_numpy

    cfg, jcfg = _cfg(TRAIN_ARCH), j_smoke(TRAIN_ARCH)
    params = jax.tree.map(jnp.asarray, params_to_numpy(_params(cfg)))
    step, model, run = j_build(jcfg, multi_pod=False, accum=TRAIN_ACCUM,
                               opt_cfg=JCfg(**STEP_OPT), run_overrides={{"sp": False}})
    b = {{k: jnp.asarray(v.numpy()) for k, v in _batch(cfg, seq=16, seed=3).items()}}
    per, gsum = B // TRAIN_ACCUM, None
    grad = jax.jit(jax.grad(lambda p, mb: model.loss(p, mb, run=run)))
    for i in range(TRAIN_ACCUM):
        g = grad(params, {{k: v[i * per:(i + 1) * per] for k, v in b.items()}})
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    arrays = {{f"grads/{{j}}": np.asarray(x / TRAIN_ACCUM)
               for j, x in enumerate(jax.tree.leaves(gsum))}}
    new, _, m = jax.jit(step)(params, j_init(params), b)
    arrays.update({{f"params1/{{j}}": np.asarray(x) for j, x in enumerate(jax.tree.leaves(new))}})
    np.savez(os.environ["OUT"], **arrays)
    print(json.dumps({{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}}))
""")


@pytest.fixture(scope="module")
def repro_step(tmp_path_factory):
    pytest.importorskip("jax")
    arrays, info = reference_once("tp_repro", _REF_SCRIPT, tmp_path_factory)
    out = dict(info)
    for name in ("grads", "params1"):
        n = sum(k.startswith(f"{name}/") for k in arrays)
        out[name] = [arrays[f"{name}/{j}"] for j in range(n)]
    return out


# ---------------------------------------------------------------------------
# the gathers, a layer at a time
# ---------------------------------------------------------------------------

def test_each_layer_gathers_alone_inside_its_checkpoint(ranks):
    """Under remat each layer's view is taken twice (the forward and the
    backward's recompute), and when a layer gathers, no other layer's
    gathered weights are alive on the rank; the dense FFN's leaves stay the
    rank's "model" blocks (half of d_ff on (2, 2))."""
    cfg = _cfg(TRAIN_ARCH)
    for rank in range(4):
        views = ranks[rank]["gathers_sp"]["layer_views"]
        assert len(views) == 2 * cfg.n_layers
        assert all(v["held"] == 0 for v in views), [v["held"] for v in views]
        for v in views:
            assert v["shapes"]["wi"] == (cfg.d_model, cfg.d_ff // 2)
            assert v["shapes"]["wo"] == (cfg.d_ff // 2, cfg.d_model)


def test_gathered_weights_alive_at_once(ranks):
    """The most gathered parameter bytes alive at once: in the
    sequence-parallel layout at most one layer's gathered weights or the
    whole embedding, where the gathered-whole layout (``sp=False``) holds
    every layer's for the step; both give the same loss and gradients."""
    cfg = _cfg(TRAIN_ARCH)
    layer = max(v["bytes"] for v in ranks[0]["gathers_sp"]["layer_views"])
    shapes = LM(cfg, device="meta").shapes()
    embed = sum(t.numel() * t.element_size() for t in tree_leaves(shapes["embed"]))
    blocks_whole = sum(t.numel() * t.element_size() for t in tree_leaves(shapes["blocks"]))
    for rank in range(4):
        sp, whole = ranks[rank]["gathers_sp"], ranks[rank]["gathers_whole"]
        assert sp["peak_param_bytes"] <= max(layer, embed)
        assert whole["peak_param_bytes"] >= blocks_whole
        assert whole["layer_views"] == []
        np.testing.assert_allclose(sp["loss"], whole["loss"], rtol=TOL)
        _close_leaves(sp["grads"], whole["grads"], f"layouts, rank {rank}")


# ---------------------------------------------------------------------------
# the sequence-parallel attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [TRAIN_ARCH, "mixtral-8x7b"])
def test_sequence_parallel_attention_matches_whole(ranks, arch):
    """Each of the (1, 4) mesh's ranks attends its 12 q positions over the
    48 gathered keys (mixtral with its window of 32): its output is its
    block of whole attention's, the gradient of its x its block, and the
    weights' gradients summed over the ranks equal whole attention's."""
    cfg = _cfg(arch)
    p, x = _attn_inputs(cfg)
    pl = {k: v.clone().requires_grad_() for k, v in p.items()}
    xw = x.clone().requires_grad_()
    out, _ = TL.attn_apply(pl, cfg, xw)
    n = SEQ // 4
    w = torch.cat([torch.linspace(-1, 1, B * n * cfg.d_model).reshape(B, n, cfg.d_model)] * 4, 1)
    gx, *gp = torch.autograd.grad((out * w).sum(), [xw] + [pl[k] for k in sorted(pl)])
    for rank in range(4):
        got = ranks[rank]["attention"][arch]
        blk = slice(rank * n, (rank + 1) * n)
        assert _rel_l2(got["out"], out.detach().numpy()[:, blk]) <= TOL
        assert _rel_l2(got["gx"], gx.numpy()[:, blk]) <= TOL
    for k, g in zip(sorted(pl), gp):
        total = sum(ranks[r]["attention"][arch]["gp"][k] for r in range(4))
        assert _rel_l2(total, g.numpy()) <= TOL, k

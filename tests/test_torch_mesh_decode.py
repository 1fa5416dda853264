"""Decode on a mesh: the striped-cache layout.

A gloo world of 4 CPU ranks (once a session), the f32 smoke configs of
qwen2-7b (dense), mixtral-8x7b (moe, its window cut to 4 rows so that the
ring wraps across stripes), granite-moe-3b-a800m (moe), llama-3.2-vision-11b
(vlm: ``xkv`` striped over "model", both tanh gates drawn nonzero),
musicgen-medium (audio), rwkv6-3b (ssm: ``mu``, ``cmu`` and ``bonus`` drawn
nonzero) and zamba2-1.2b (hybrid), on (2, 2), (1, 4) and (4, 1) ("data",
"model") meshes of that world.  Each rank holds its blocks of the
parameters (``LM.pspecs``) and of the cache (``cache_pspecs``; allocated by
``shardings.decode_cache``, which must give those shapes), and runs
``build_decode_step(mesh=)`` for ``STEPS`` steps from a random cache at
``len`` 2 of T 8: at first rank 0's stripe alone holds rows, the writes
cross a stripe boundary on every mesh that splits T, and one row carries a
``start`` offset of 2.  Against the port's one-device decode of the rank's
rows (the MoE's runs each data shard's rows alone, as its dispatch is
token-local):

* the logits of every step within 2e-5 relative L2, and the greedy tokens
  equal (a near tie, a one-device top-2 margin below 1e-5, is reported and
  allowed);
* each rank's cache blocks after the steps equal to the one-device cache's
  slices within 2e-5;
* every model rank's logits bit-identical;
* no other layer's gathered weights alive when a layer gathers its own
  (weakrefs, on (2, 2)).

Against ``repro``'s one-device ``decode_step`` (jitted; run once a session
in the world's ranks, its runs dealt out over them) of the same rows from the
same parameters, tokens and cache, each data shard's rows alone for the
MoE: the logits of every step within the same 2e-5, and the greedy tokens
equal but at a near tie.  ``repro``'s own ``decode_step`` on a mesh of forced host devices
stops under jax 0.9.0 at a ``ShardingTypeError`` in the embedding's gather
(its mesh has explicit axes), so ``repro`` runs on one device.

On a model axis of more than one rank the step refuses a whole
``decode_init`` cache: it reads a ring as the rank's stripe, and checks it
against the ring's global T the cache records (``cache["ring"]``).
"""

import warnings
import weakref

import numpy as np
import pytest
import torch

from _torch_dist import spawn_once
from _torch_parity import one_thread  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.launch.shardings import batch_pspecs, cache_pspecs
from repro_torch.models import LM
from repro_torch.models.lm import params_to_numpy
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.parallel.mesh import MeshDescription
from repro_torch.parallel.spec import local_shard

ARCHS = ["qwen2-7b", "mixtral-8x7b", "granite-moe-3b-a800m", "llama-3.2-vision-11b",
         "musicgen-medium", "rwkv6-3b", "zamba2-1.2b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
CASES = [(a, m) for m in MESHES for a in ARCHS]
IDS = [f"{a}|{m}" for a, m in CASES]
B, T, LEN0, STEPS = 4, 8, 2, 3
START = (0, 2, 0, 0)        # row 1 masks the slots below 2
MIXTRAL_WINDOW = 4          # a ring of 4 rows: the third step from len 2 wraps it
TOL, TIE = 2e-5, 1e-5
VIEW_MESH = "2x2"           # the mesh whose layer views are watched


def _cfg(arch):
    cfg = get_smoke_config(arch)
    return cfg.scaled(window=MIXTRAL_WINDOW) if arch == "mixtral-8x7b" else cfg


def _params(cfg):
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    if cfg.xattn_every:  # the reference inits both tanh gates to 0
        for tree, name in ((params["xattn"]["attn"], "gate"), (params["xattn"], "ffn_gate")):
            tree[name] = 0.5 + torch.rand(tree[name].shape, generator=g)
    if cfg.family == "ssm":  # and rwkv6's lerps and bonus
        for name in ("mu", "cmu", "bonus"):
            t = params["blocks"][name]
            params["blocks"][name] = 0.5 * torch.rand(t.shape, generator=g)
    return params


def _inputs(cfg):
    """The token of every step (STEPS, B, 1[, n_codebooks]) and the image
    memory, from a seed."""
    rng = np.random.default_rng(2)
    shape = (STEPS, B, 1) if cfg.n_codebooks == 1 else (STEPS, B, 1, cfg.n_codebooks)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, shape).astype(np.int32))
    memory = None
    if cfg.xattn_every:
        memory = torch.as_tensor(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    return tokens, memory


def _whole_cache(cfg, model, params, memory):
    """The one-device cache of all B rows: K/V rings and recurrent states
    drawn from a seed, ``len`` LEN0, row 1's ``start`` offset."""
    cache = model.decode_init(B, T, params=params, memory=memory)
    rng = np.random.default_rng(3)
    for name in ("kv", "shared_kv", "states"):
        for leaf in tree_leaves(cache.get(name, {})):
            leaf.copy_(torch.as_tensor(0.5 * rng.standard_normal(tuple(leaf.shape))))
    cache["len"] = torch.tensor(LEN0, dtype=torch.int32)
    if "kv" in cache or "shared_kv" in cache:
        cache["start"] = torch.tensor(START, dtype=torch.int32)
    return cache


def _cache_specs(cfg, cache, mesh):
    """``cache_pspecs`` of the cache, ``start`` split as the rows are."""
    specs = cache_pspecs(cfg, {k: v for k, v in cache.items() if k != "start"}, B, mesh)
    if "start" in cache:
        specs["start"] = (batch_pspecs(cfg, B, mesh)["tokens"][0],)
    return specs


def _rows(shape, d):
    per = B // shape[0]
    return slice(d * per, (d + 1) * per)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _watch_views(record):
    """Wraps ``blocks``' two layer views: at each, the bytes of earlier
    views' gathered tensors still alive; returns the undo."""
    from repro_torch.models import blocks as TB

    real = {name: getattr(TB, name) for name in ("sp_block_view", "whole_block_view")}
    earlier = []

    def wrap(fn):
        def view(p, *args, **kw):
            record.append(sum(n for r, n in earlier if r() is not None))
            out = fn(p, *args, **kw)
            own = {t.untyped_storage().data_ptr() for t in tree_leaves(p)}
            earlier.extend((weakref.ref(t), t.numel() * t.element_size())
                           for t in tree_leaves(out)
                           if t.untyped_storage().data_ptr() not in own)
            return out
        return view

    for name, fn in real.items():
        setattr(TB, name, wrap(fn))
    return lambda: [setattr(TB, name, fn) for name, fn in real.items()]


def _mesh_case(arch, mesh, shape, watch):
    """One rank's decode: each step's logits, its cache blocks after them,
    and (with ``watch``) the views' record."""
    from repro_torch.launch.shardings import decode_cache
    from repro_torch.launch.steps import build_decode_step

    cfg = _cfg(arch)
    model = LM(cfg, device="cpu")
    params = _params(cfg)
    tokens, memory = _inputs(cfg)
    whole = _whole_cache(cfg, model, params, memory)
    specs = _cache_specs(cfg, whole, mesh)
    blocks = tree_map(lambda t, s: local_shard(t, s, mesh), params,
                      model.pspecs(multi_pod=False))
    rows = _rows(shape, mesh.get_local_rank("data"))
    mem = None
    if memory is not None:
        mem = local_shard(memory, batch_pspecs(cfg, B, mesh)["memory"], mesh)
    with torch.no_grad():
        cache = decode_cache(model, B, T, mesh, params=blocks, memory=mem)
    shapes = {k: tuple(v.shape) for k, v in _flat(cache).items() if k != "ring"}
    out = {"alloc_shapes": shapes, "xkv": None,
           "ring": tuple(cache["ring"].shape) if "ring" in cache else None}
    if "xkv" in cache:
        out["xkv"] = {k: v.numpy().copy() for k, v in cache["xkv"].items()}
    for k, t in _flat({k: v for k, v in whole.items() if k != "xkv"}).items():
        blk = local_shard(t, _flat(specs)[k], mesh)
        if k in _flat(cache):
            _flat(cache)[k].copy_(blk)
        else:
            cache[k] = blk
    step, _, run = build_decode_step(cfg, device="cpu", mesh=mesh)
    views = []
    undo = _watch_views(views) if watch else None
    logits = []
    try:
        for s in range(STEPS):
            lg, cache = step(blocks, tokens[s][rows], cache)
            logits.append(lg.numpy())
    finally:
        if undo is not None:
            undo()
    out.update(logits=np.stack(logits), run_moe=run.get("decode_moe_shardmap"),
               cache={k: v.numpy().copy() for k, v in _flat(cache).items()
                      if k not in ("start", "xkv", "ring")},
               views=views)
    return out


def _repro_decode(arch, n_dp, d):
    """``repro``'s one-device decode (jitted) of data shard ``d``'s rows (of
    ``n_dp``) from the port's parameters, tokens and cache: each step's
    logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM

    cfg = _cfg(arch)
    jcfg = j_smoke(arch)
    if arch == "mixtral-8x7b":
        jcfg = jcfg.scaled(window=MIXTRAL_WINDOW)
    params = _params(cfg)
    tokens, memory = _inputs(cfg)
    rows = _rows((n_dp, 1), d)
    with torch.no_grad():
        whole = _whole_cache(cfg, LM(cfg, device="cpu"), params, memory)
    cache = {k: v if k == "len" else tree_map(lambda t: t[rows] if k == "start" else t[:, rows],
                                              v)
             for k, v in whole.items()}
    cache = jax.tree.map(jnp.asarray, params_to_numpy(cache))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
    step = jax.jit(JLM(jcfg).decode_step)
    logits = []
    for s in range(STEPS):
        lg, cache = step(jp, jnp.asarray(tokens[s][rows].numpy()), cache)
        logits.append(np.asarray(lg))
    return np.stack(logits)


def _repro_groups():
    """The runs of ``repro`` the meshes need, as lists of (arch, n_dp, d)
    of one batch shape (one jit compile): each data shard's rows alone for
    an MoE (its dispatch is token-local), one run of all B otherwise (a
    row's decode does not read the others'); the MoE's first."""
    moe = [[(a, shape[0], d) for d in range(shape[0])] for a in ARCHS if _cfg(a).moe
           for shape in MESHES.values()]
    return moe + [[(a, 1, 0)] for a in ARCHS if _cfg(a).moe is None]


def _rank(rank, world):
    from repro_torch.parallel.mesh import make_host_mesh

    meshes = {name: make_host_mesh(shape, device_type="cpu") for name, shape in MESHES.items()}
    out = {}
    for arch, name in CASES:
        out[f"{arch}|{name}"] = _mesh_case(arch, meshes[name], MESHES[name],
                                           watch=name == VIEW_MESH)
    # repro's oracle once a session, its runs dealt out over the ranks
    try:
        import jax  # noqa: F401
    except ImportError:
        out["repro"] = None
    else:
        out["repro"] = {key: _repro_decode(*key)
                        for group in _repro_groups()[rank::world] for key in group}
    return out


def _repro_oracle(ranks, arch, n_dp, d):
    """``repro``'s logits of data shard ``d``'s rows (of ``n_dp``)."""
    if _cfg(arch).moe is None and n_dp > 1:
        return _repro_oracle(ranks, arch, 1, 0)[:, _rows((n_dp, 1), d)]
    return next(r["repro"][arch, n_dp, d] for r in ranks if (arch, n_dp, d) in r["repro"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_once("mesh_decode", _rank, 4, tmp_path_factory)


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """The oracles on one torch thread (``_torch_parity.one_thread``)."""


# ---------------------------------------------------------------------------
# the one-device oracle
# ---------------------------------------------------------------------------

_ORACLE = {}


def _oracle(arch, n_dp, d):
    """The one-device decode of data shard ``d``'s rows (of ``n_dp``): each
    step's logits and the cache after the steps."""
    key = (arch, n_dp, d)
    if key not in _ORACLE:
        cfg = _cfg(arch)
        model = LM(cfg, device="cpu")
        params = _params(cfg)
        tokens, memory = _inputs(cfg)
        rows = _rows((n_dp, 1), d)
        with torch.no_grad():
            whole = _whole_cache(cfg, model, params, memory)
            cache = {k: v if k == "len" else tree_map(lambda t: t[rows] if k == "start"
                                                      else t[:, rows].clone(), v)
                     for k, v in whole.items()}
            logits = []
            for s in range(STEPS):
                lg, cache = model.decode_step(params, tokens[s][rows], cache)
                logits.append(lg.numpy())
        _ORACLE[key] = {"logits": np.stack(logits), "cache": cache}
    return _ORACLE[key]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _coord(rank, shape):
    return {"data": rank // shape[1], "model": rank % shape[1]}


def _near_ties(got, want, vocab):
    """Greedy tokens of ``got`` against ``want`` (logits (..., Vp)): the
    differing ones, each allowed only where ``want``'s top-2 margin is below
    TIE; returns the margins of those that differ."""
    g = got[..., :vocab].argmax(-1)
    w = want[..., :vocab]
    top2 = np.sort(w, axis=-1)[..., -2:]
    margins = (top2[..., 1] - top2[..., 0])[g != w.argmax(-1)]
    assert (margins < TIE).all(), f"greedy tokens differ at margins {margins}"
    return margins


# ---------------------------------------------------------------------------
# the mesh path against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh_name", CASES, ids=IDS)
def test_decode_matches_one_device(ranks, arch, mesh_name):
    shape = MESHES[mesh_name]
    cfg = _cfg(arch)
    ties = []
    for rank, res in enumerate(ranks):
        r = res[f"{arch}|{mesh_name}"]
        coord = _coord(rank, shape)
        want = _oracle(arch, shape[0], coord["data"])
        assert r["logits"].shape == want["logits"].shape
        for s in range(STEPS):
            assert _rel_l2(r["logits"][s], want["logits"][s]) <= TOL, (rank, s)
        ties.extend(_near_ties(r["logits"], want["logits"], cfg.vocab))
        # the rank's cache blocks against the one-device cache's slices
        whole = {k: v for k, v in want["cache"].items() if k not in ("start", "xkv")}
        stripes = MeshDescription((1, shape[1]), ("data", "model"))
        specs = _flat(cache_pspecs(cfg, whole, B // shape[0], stripes))
        for k, t in _flat(whole).items():
            blk = local_shard(t, specs[k], stripes, coord={"data": 0, "model": coord["model"]})
            got = r["cache"][k]
            assert got.shape == tuple(blk.shape), (rank, k)
            if k == "len":
                assert int(got) == LEN0 + STEPS
            else:
                assert _rel_l2(got, blk.numpy()) <= TOL, (rank, k, _rel_l2(got, blk.numpy()))
    if ties:
        warnings.warn(f"{arch} on {mesh_name}: greedy tokens differ at near ties, one-device "
                      f"top-2 margins {ties}")


@pytest.mark.parametrize("arch,mesh_name", CASES, ids=IDS)
def test_decode_matches_repro_one_device(ranks, arch, mesh_name):
    """Every rank's logits against ``repro``'s one-device decode of its
    rows (its data shard's alone for the MoE), within ``TOL``."""
    if ranks[0]["repro"] is None:
        pytest.skip("repro's side needs JAX")
    shape = MESHES[mesh_name]
    cfg = _cfg(arch)
    ties = []
    for rank, res in enumerate(ranks):
        r = res[f"{arch}|{mesh_name}"]
        want = _repro_oracle(ranks, arch, shape[0], _coord(rank, shape)["data"])
        assert r["logits"].shape == want.shape
        for s in range(STEPS):
            assert _rel_l2(r["logits"][s], want[s]) <= TOL, (rank, s, _rel_l2(r["logits"][s],
                                                                              want[s]))
        ties.extend(_near_ties(r["logits"], want, cfg.vocab))
    if ties:
        warnings.warn(f"{arch} on {mesh_name}: greedy tokens differ from repro's at near ties, "
                      f"top-2 margins {ties}")


@pytest.mark.parametrize("arch,mesh_name", CASES, ids=IDS)
def test_allocated_blocks_and_model_ranks_agree(ranks, arch, mesh_name):
    """``decode_cache`` gives each rank its ``cache_pspecs`` blocks (the
    vlm's ``xkv`` the projection of its block of the memory), and every
    model rank of a data index ends each step with the same bits."""
    shape = MESHES[mesh_name]
    cfg = _cfg(arch)
    desc = MeshDescription(shape, ("data", "model"))
    model = LM(cfg, device="cpu")
    params = _params(cfg)
    tokens, memory = _inputs(cfg)
    with torch.no_grad():
        whole = _whole_cache(cfg, model, params, memory)
    specs = _flat(_cache_specs(cfg, whole, desc))
    for rank, res in enumerate(ranks):
        r = res[f"{arch}|{mesh_name}"]
        coord = _coord(rank, shape)
        for k, got in r["alloc_shapes"].items():
            assert got == tuple(local_shard(_flat(whole)[k], specs[k], desc, coord).shape), k
        rings = [t.shape[3] for k, t in _flat(whole).items() if k in ("kv/k", "shared_kv/k")]
        assert r["ring"] == ((0, rings[0]) if rings else None)
        assert r["run_moe"] == (cfg.moe is not None)
        if cfg.xattn_every:
            for k in ("k", "v"):
                want = local_shard(whole["xkv"][k], specs[f"xkv/{k}"], desc, coord).numpy()
                assert _rel_l2(r["xkv"][k], want) <= TOL
        first = ranks[coord["data"] * shape[1]][f"{arch}|{mesh_name}"]
        assert r["logits"].tobytes() == first["logits"].tobytes(), rank


@pytest.mark.parametrize("arch", ARCHS)
def test_one_layer_gathered_at_a_time(ranks, arch):
    """Every layer view (attention, cross, recurrent, the shared block)
    finds no earlier view's gathered weights alive."""
    cfg = _cfg(arch)
    n_views = cfg.n_layers
    if cfg.xattn_every:
        n_views += cfg.n_layers // cfg.xattn_every
    if cfg.shared_attn_every:
        n_views += cfg.n_layers // cfg.shared_attn_every
    for res in ranks:
        views = res[f"{arch}|{VIEW_MESH}"]["views"]
        assert len(views) == STEPS * n_views
        assert max(views) == 0


def test_a_whole_ring_is_refused():
    """``decode_cache`` refuses a ring whose T does not split over "model"
    (the step could not tell it from a stripe)."""
    from repro_torch.launch.shardings import decode_cache

    model = LM(_cfg("qwen2-7b"), device="meta")
    with pytest.raises(ValueError, match="do not split"):
        decode_cache(model, B, 6, MeshDescription((1, 4), ("data", "model")).at(model=1))
    cache = decode_cache(model, B, 8, MeshDescription((1, 4), ("data", "model")).at(model=1))
    assert tuple(cache["kv"]["k"].shape[3:]) == (2, _cfg("qwen2-7b").head_dim)


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b", "llama-3.2-vision-11b"])
def test_a_whole_decode_init_cache_is_refused(arch):
    """On (1, 4) the decode step refuses ``decode_init``'s whole cache (its
    rings of T rows read as stripes would be written and attended at the
    wrong slots), and a vlm's whole ``xkv`` beside striped rings; it takes
    ``decode_cache``'s."""
    from repro_torch.launch.shardings import decode_cache
    from repro_torch.launch.steps import build_decode_step

    desc = MeshDescription((1, 4), ("data", "model")).at(model=1)
    cfg = _cfg(arch)
    model = LM(cfg, device="meta")
    params = model.shapes()
    memory = None
    if cfg.xattn_every:
        memory = torch.empty((B, cfg.n_img_tokens, cfg.d_model), device="meta")
    step = build_decode_step(cfg, device="meta", mesh=desc)[0]
    tokens = torch.zeros((B, 1), dtype=torch.int32, device="meta")
    whole = model.decode_init(B, T, params=params, memory=memory)
    with pytest.raises(ValueError, match="stripes of T"):
        step(params, tokens, whole)
    cache = decode_cache(model, B, T, desc)
    assert tuple(cache["ring"].shape) == (0, T)
    model._check_stripes(cache, 4)
    if cfg.xattn_every:
        with pytest.raises(ValueError, match="cross K/V"):
            step(params, tokens, {**cache, "xkv": whole["xkv"]})

"""``moe_apply_shardmap`` and the LM's MoE engine on a (data, model) mesh.

On a gloo world of 4 CPU ranks, a (2, 2) mesh, in f32, for the mixtral and
granite smoke configs, with the smoke capacity factor (2) and a tight one
(0.5), at a prefill shape (4 × 16) and a decode shape (4 × 1):

* each rank's output and the balancing loss within 2e-5 of ``repro``'s
  ``moe_apply_shardmap`` on 4 forced host devices (one subprocess);
* each rank's dispatch slots (read through a stand-in for
  ``layers.moe_dispatch``) int for int those of ``moe_apply`` run on its
  data shard's rows, and its output within 2e-5 of that run;
* on a world of one rank, a (1, 1) mesh, bit for bit ``moe_apply``.

And ``LM.hidden_states(run={"sp": True, "mesh": ...})`` (the rank's
token block of its rows, in the sequence-parallel layout), ``LM.loss`` and
three ``decode_step(run={"decode_moe_shardmap": True, ...})`` on (2, 2),
with the parameters and the cache as each rank's blocks (the cache's T
striped over "model", ``shardings.decode_cache``), within 2e-5 of the
one-device port on each data shard's rows.  The expert weights are numpy draws handed
to both packages; the worlds run once a session.
"""

import dataclasses
import textwrap
import zlib

import numpy as np
import pytest
import torch

from _torch_dist import reference_once, spawn_once
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, layers as TL
from repro_torch.models.module import build_pspecs, tree_map

ARCHS = ["mixtral-8x7b", "granite-moe-3b-a800m"]
FACTORS = {"smoke": None, "tight": 0.5}
SHAPES = {"prefill": (4, 16), "decode": (4, 1)}
CASES = [(a, f, s) for a in ARCHS for f in FACTORS for s in SHAPES]
TOL = 2e-5


def _cfg(arch, factor):
    cfg = get_smoke_config(arch)
    if FACTORS[factor] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=FACTORS[factor]))
    return cfg


def _inputs(arch, shape):
    """(expert weights, x) as numpy, drawn from a seed."""
    cfg = get_smoke_config(arch)
    d, e, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_ff
    rng = np.random.default_rng(zlib.crc32(f"{arch}|{shape}".encode()))
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "wo": rng.standard_normal((e, ff, d)) / np.sqrt(ff)}
    B, S = SHAPES[shape]
    x = rng.standard_normal((B, S, d))
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


def _recording(slots):
    """A stand-in for ``layers.moe_dispatch`` that keeps the slots."""
    real = TL.moe_dispatch

    def dispatch(*args, **kw):
        out = real(*args, **kw)
        slots.append(out[-1].numpy().copy())
        return out

    return dispatch


def _rank(rank, world):
    from repro_torch.parallel.mesh import make_host_mesh
    from repro_torch.parallel.spec import local_shard

    shape = (2, 2) if world == 4 else (1, 1)
    mesh = make_host_mesh(shape, device_type="cpu")
    d = mesh.get_local_rank("data")
    out = {}
    real = TL.moe_dispatch
    for arch, factor, shp in CASES:
        cfg = _cfg(arch, factor)
        p, x = _inputs(arch, shp)
        specs = build_pspecs(TL.moe_meta(cfg), multi_pod=False)
        blocks = tree_map(lambda t, s: local_shard(torch.from_numpy(t), s, mesh), p, specs)
        rows = x.shape[0] // shape[0]
        xl = torch.from_numpy(x[d * rows:(d + 1) * rows])
        slots = []
        TL.moe_dispatch = _recording(slots)
        try:
            y, aux = TL.moe_apply_shardmap(blocks, cfg, xl, mesh=mesh)
        finally:
            TL.moe_dispatch = real
        key = f"{arch}|{factor}|{shp}"
        out[key] = {"out": y.numpy(), "aux": float(aux), "slots": slots[0]}
    if world == 4:
        out["lm"] = _lm_on_mesh(mesh, d)
    return out


def _lm_setup(arch):
    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    toks = torch.randint(0, cfg.vocab, (4, 16), generator=g, dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab, (3, 4, 1), generator=g, dtype=torch.int32)
    return cfg, model, params, toks, steps


def _lm_on_mesh(mesh, d):
    from repro_torch.launch.shardings import decode_cache
    from repro_torch.parallel.spec import local_shard

    out = {}
    for arch in ARCHS:
        cfg, model, params, toks, steps = _lm_setup(arch)
        blocks = tree_map(lambda t, s: local_shard(t, s, mesh), params,
                          model.pspecs(multi_pod=False))
        rows = slice(2 * d, 2 * d + 2)
        run = {"sp": True, "mesh": mesh}
        with torch.no_grad():
            hid, aux, _ = model.hidden_states(blocks, toks[rows], run=run)
            loss = model.loss(blocks, {"tokens": toks[rows], "targets": toks[rows]}, run=run)
            cache = decode_cache(model, 4, 8, mesh)
            logits = []
            for t in steps:
                lg, cache = model.decode_step(blocks, t[rows], cache,
                                              run={"decode_moe_shardmap": True, "mesh": mesh})
                logits.append(lg.numpy())
        out[arch] = {"hid": hid.numpy(), "aux": float(aux), "loss": float(loss),
                     "logits": np.stack(logits)}
    return out


_REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, os.environ["TESTS"])
    from repro.configs import get_smoke_config
    from repro.models.layers import moe_apply_shardmap
    import test_torch_sharded_moe as T

    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    out, aux = {}, {}
    for arch, factor, shp in T.CASES:
        cfg = get_smoke_config(arch)
        if T.FACTORS[factor] is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=T.FACTORS[factor]))
        p, x = T._inputs(arch, shp)
        with jax.set_mesh(mesh):  # jitted: shard_map run eagerly is ~10x slower here
            y, a = jax.jit(lambda pp, xx: moe_apply_shardmap(pp, cfg, xx))(
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        key = f"{arch}|{factor}|{shp}"
        out[key] = np.asarray(y)
        aux[key] = float(a)
    np.savez(os.environ["OUT"], **out)
    print(json.dumps(aux))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_once("sharded_moe", _rank, 4, tmp_path_factory)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return spawn_once("sharded_moe_1", _rank, 1, tmp_path_factory)[0]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    from pathlib import Path

    return reference_once("sharded_moe_ref", _REFERENCE, tmp_path_factory,
                          env={"TESTS": str(Path(__file__).parent)})


def _one_device(arch, factor, shp, rows):
    """``moe_apply`` on those rows, with its dispatch slots."""
    cfg = _cfg(arch, factor)
    p, x = _inputs(arch, shp)
    slots = []
    real = TL.moe_dispatch
    TL.moe_dispatch = _recording(slots)
    try:
        y, aux = TL.moe_apply({k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                              torch.from_numpy(x[rows]))
    finally:
        TL.moe_dispatch = real
    return y.numpy(), float(aux), slots[0]


@pytest.mark.parametrize("case", CASES, ids=["|".join(c) for c in CASES])
def test_matches_repro_shardmap(ranks, reference, case):
    ref_out, ref_aux = reference
    key = "|".join(case)
    for rank in range(4):
        d = rank // 2
        rows = ref_out[key].shape[0] // 2
        np.testing.assert_allclose(ranks[rank][key]["out"], ref_out[key][d * rows:(d + 1) * rows],
                                   atol=TOL, rtol=0, err_msg=f"rank {rank}")
        assert abs(ranks[rank][key]["aux"] - ref_aux[key]) <= TOL


@pytest.mark.parametrize("case", CASES, ids=["|".join(c) for c in CASES])
def test_slots_are_moe_apply_on_the_shards_rows(ranks, case):
    """Token-local dispatch: each rank's slots are ``moe_apply``'s on its
    data shard's rows (capacity from the shard's token count), and its
    output that run's; the aux is the data-mean of theirs."""
    key = "|".join(case)
    B = SHAPES[case[2]][0]
    auxes = []
    for d in range(2):
        y, aux, slots = _one_device(*case, slice(d * B // 2, (d + 1) * B // 2))
        auxes.append(aux)
        for m in range(2):
            r = ranks[2 * d + m][key]
            np.testing.assert_array_equal(r["slots"], slots)
            np.testing.assert_allclose(r["out"], y, atol=TOL, rtol=0)
    if case[1] == "tight" and case[2] == "prefill":
        assert (slots == _cfg(*case[:2]).moe.n_experts * TL.moe_capacity(
            _cfg(*case[:2]), B // 2 * SHAPES[case[2]][1])).any(), "no pair was dropped"
    assert abs(ranks[0][key]["aux"] - np.mean(auxes)) <= TOL


@pytest.mark.parametrize("case", CASES, ids=["|".join(c) for c in CASES])
def test_one_rank_is_moe_apply_bit_for_bit(one_rank, case):
    key = "|".join(case)
    y, aux, slots = _one_device(*case, slice(None))
    np.testing.assert_array_equal(one_rank[key]["out"].view(np.uint32), y.view(np.uint32))
    assert one_rank[key]["aux"] == aux
    np.testing.assert_array_equal(one_rank[key]["slots"], slots)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_on_a_mesh_is_the_one_device_lm_on_each_shards_rows(ranks, arch):
    cfg, model, params, toks, steps = _lm_setup(arch)
    auxes, xent = [], []
    for d in range(2):
        rows = slice(2 * d, 2 * d + 2)
        with torch.no_grad():
            hid, aux, _ = model.hidden_states(params, toks[rows])
            loss = model.loss(params, {"tokens": toks[rows], "targets": toks[rows]})
            cache = model.decode_init(2, 8)
            logits = []
            for t in steps:
                lg, cache = model.decode_step(params, t[rows], cache)
                logits.append(lg.numpy())
        auxes.append(float(aux))
        xent.append(float(loss) - 0.01 * float(aux))
        n = toks.shape[1] // 2
        for m in range(2):
            r = ranks[2 * d + m]["lm"][arch]
            np.testing.assert_allclose(r["hid"], hid.numpy()[:, m * n:(m + 1) * n], atol=TOL,
                                       rtol=0)
            np.testing.assert_allclose(r["logits"], np.stack(logits), atol=TOL, rtol=0)
    for rank in range(4):
        r = ranks[rank]["lm"][arch]
        assert abs(r["aux"] - np.mean(auxes)) <= TOL
        # equal token counts: the global mean is the mean of the shards' means
        assert abs(r["loss"] - (np.mean(xent) + 0.01 * np.mean(auxes))) <= TOL

"""The mesh, the partition specs and the collectives of the port.

Against ``repro`` (its functions run in one subprocess on 8 forced host
devices, once a session):

* ``resolve_spec``, ``build_pspecs``, ``LM.pspecs`` and ``opt_pspecs`` for
  all ten configs, with and without multi-pod;
* for every arch × ``SHAPES`` cell on a (2, 2) ("data", "model") mesh and a
  (2, 2, 2) ("pod", "data", "model") mesh, every leaf of
  ``input_specs`` (the parameters, the optimizer state, the batch, the
  decode tokens and cache, the image memory): its spec and its block's
  shape equal the reference's ``spec`` and ``shard_shape``, and the
  ``batch_pspecs``/``cache_pspecs`` they come from.

The port alone, in a gloo world of 4 CPU ranks (once a session):
``make_host_mesh`` and each rank's coordinate, its refusal of a shape that
is not the world's, ``local_shard`` and ``collectives.whole`` (a round trip
bit for bit, bf16 too), ``all_reduce`` over one and two axes (bf16 summed in
f32), and the
gradients of ``gather`` (``"sum"``, ``"slice"``), ``reduce_forward`` and
``reduce_backward`` against their closed forms.
"""

import json
import math
import textwrap

import numpy as np
import pytest
import torch

from _torch_dist import reference_once, spawn_once
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.launch import steps as S
from repro_torch.launch.shardings import batch_pspecs, cache_pspecs, data_rows
from repro_torch.models import LM
from repro_torch.models.module import resolve_spec
from repro_torch.optim import opt_pspecs
from repro_torch.parallel import collectives as C
from repro_torch.parallel.mesh import (
    MeshDescription,
    axis_sizes,
    data_axes,
    is_multi_pod,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.parallel.spec import local_shape, local_shard

MESHES = {"2x2": MeshDescription((2, 2), ("data", "model")),
          "2x2x2": MeshDescription((2, 2, 2), ("pod", "data", "model"))}
LOGICAL = [(None,), ("fsdp", "tp"), ("tp", "fsdp"), (None, "fsdp", "tp"), ("dp", None),
           ("tp",), ()]


def _norm(spec):
    """A spec as JSON holds it: entries None, a name, or a list of names."""
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


_REFERENCE = textwrap.dedent("""
    import json, os
    import jax
    from repro.configs import ARCH_NAMES, SHAPES, get_config
    from repro.launch import steps
    from repro.launch.shardings import batch_pspecs, cache_pspecs
    from repro.models import LM
    from repro.models.module import resolve_spec
    from repro.optim.adamw import opt_pspecs

    def norm(spec):
        return [e if e is None or isinstance(e, str) else list(e) for e in tuple(spec)]

    def flat(tree, f):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): f(leaf)
                for path, leaf in leaves}

    def leaf_info(leaf):
        try:
            local = list(leaf.sharding.shard_shape(leaf.shape))
        except Exception as e:
            local = "error"
        return {"spec": norm(leaf.sharding.spec), "shape": list(leaf.shape), "local": local}

    out = {"resolve": {}, "pspecs": {}, "opt": {}, "cells": {}, "batch": {}, "cache": {}}
    logical = json.loads(os.environ["LOGICAL"])
    for mp in (False, True):
        out["resolve"][str(mp)] = [norm(resolve_spec(tuple(l), multi_pod=mp)) for l in logical]
    meshes = {"2x2": jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4]),
              "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"))}
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for mp in (False, True):
            ps = LM(cfg).pspecs(multi_pod=mp)
            out["pspecs"][f"{arch}|{mp}"] = flat(ps, norm)
            out["opt"][f"{arch}|{mp}"] = flat(opt_pspecs(ps), norm)
        for name, mesh in meshes.items():
            mp = name == "2x2x2"
            for shape, sh in SHAPES.items():
                key = f"{arch}|{name}|{shape}"
                out["cells"][key] = flat(steps.input_specs(cfg, shape, mesh, multi_pod=mp),
                                         leaf_info)
                B = sh["global_batch"]
                out["batch"][key] = {k: norm(v) for k, v in
                                     batch_pspecs(cfg, B, mesh, multi_pod=mp).items()}
                if sh["kind"] == "decode":
                    shapes = jax.eval_shape(lambda: LM(cfg).decode_init(B, sh["seq_len"]))
                    out["cache"][key] = flat(cache_pspecs(cfg, shapes, B, mesh, multi_pod=mp),
                                             norm)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    return reference_once("mesh_ref", _REFERENCE, tmp_path_factory,
                          env={"LOGICAL": json.dumps([list(x) for x in LOGICAL])})[1]


# ---------------------------------------------------------------------------
# specs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_resolve_spec_matches_repro(ref, multi_pod):
    ours = [_norm(resolve_spec(x, multi_pod=multi_pod)) for x in LOGICAL]
    assert ours == ref["resolve"][str(multi_pod)]
    with pytest.raises(ValueError):
        resolve_spec(("seq",), multi_pod=multi_pod)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pspecs_match_repro(ref, arch, multi_pod):
    """``LM.pspecs`` (``build_pspecs`` over the meta tree) and
    ``opt_pspecs``, leaf for leaf."""
    ps = LM(get_config(arch), device="meta").pspecs(multi_pod=multi_pod)
    key = f"{arch}|{multi_pod}"
    assert {k: _norm(v) for k, v in _flat(ps)} == ref["pspecs"][key]
    assert {k: _norm(v) for k, v in _flat(opt_pspecs(ps))} == ref["opt"][key]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_repro_on_a_mesh(ref, arch, mesh_name):
    """Every leaf of every cell's ``input_specs``: the global shape, the
    spec, and the block's shape (``shard_shape``)."""
    cfg, mesh = get_config(arch), MESHES[mesh_name]
    for shape, sh in SHAPES.items():
        key = f"{arch}|{mesh_name}|{shape}"
        whole = dict(_flat(S.input_specs(cfg, shape)))
        ours = {}
        for k, leaf in _flat(S.input_specs(cfg, shape, mesh)):
            assert leaf.device.type == "meta"
            ours[k] = {"spec": _norm(leaf.spec), "shape": list(whole[k].shape),
                       "local": list(leaf.shape)}
        assert ours == ref["cells"][key], key
        B = sh["global_batch"]
        assert {k: _norm(v) for k, v in batch_pspecs(cfg, B, mesh).items()} \
            == ref["batch"][key]
        if sh["kind"] == "decode":
            cache = LM(cfg, device="meta").decode_init(B, sh["seq_len"])
            assert {k: _norm(v) for k, v in
                    _flat(cache_pspecs(cfg, cache, B, mesh))} == ref["cache"][key]


def test_production_mesh_and_axes():
    assert make_production_mesh() == MeshDescription((16, 16), ("data", "model"))
    pod = make_production_mesh(multi_pod=True)
    assert axis_sizes(pod) == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(pod) == ("pod", "data") and data_axes(MESHES["2x2"]) == ("data",)
    assert is_multi_pod(pod) and not is_multi_pod(MESHES["2x2"])
    assert local_shape((4096, 512), ("data", "model"), pod) == (256, 32)
    assert local_shape((4096, 512), (("pod", "data"), None), pod) == (128, 512)
    with pytest.raises(ValueError, match="does not split"):
        local_shape((30, 8), ("data",), pod)


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh((1, 1), device_type="cpu")


def test_data_rows():
    # microbatch i is rows [8 i, 8 i + 8); data index 1 of 2 holds 4..7 of each
    assert data_rows(16, 2, 2, 1) == [4, 5, 6, 7, 12, 13, 14, 15]
    assert data_rows(8, 1, 4, 3) == [6, 7]
    with pytest.raises(ValueError):
        data_rows(6, 2, 2, 0)


# ---------------------------------------------------------------------------
# a world of 4 ranks
# ---------------------------------------------------------------------------

X = np.arange(4 * 6 * 4, dtype=np.float32).reshape(4, 6, 4) - 40.0
SPECS = {"rows": ("data", None, None), "grid": ("data", "model", None),
         "both": (("data", "model"), None, None), "cols": (None, None, "model")}


def _weights(rank):
    return np.random.default_rng(100 + rank).standard_normal((4, 6, 4)).astype(np.float32)


def _rank(rank, world):
    mesh = make_host_mesh((2, 2), device_type="cpu")
    out = {"coord": tuple(mesh.get_coordinate())}
    try:
        make_host_mesh((2, 4), device_type="cpu")
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    x = torch.from_numpy(X)
    for name, spec in SPECS.items():
        blk = local_shard(x, spec, mesh)
        out[f"block_{name}"] = blk.numpy()
        out[f"whole_{name}"] = C.whole(blk, mesh, spec).numpy()
    bf = x.to(torch.bfloat16)
    out["whole_bf16"] = C.whole(local_shard(bf, SPECS["grid"], mesh), mesh,
                                SPECS["grid"]).float().numpy()
    v = torch.full((3,), float(rank + 1))
    out["sum_model"] = C.all_reduce(v, mesh, "model").numpy()
    out["sum_both"] = C.all_reduce(v, mesh, ("data", "model")).numpy()
    out["sum_data_bf16"] = C.all_reduce(v.to(torch.bfloat16), mesh, "data")
    w = torch.from_numpy(_weights(rank))
    for grad in ("sum", "slice"):
        blk = local_shard(x, SPECS["rows"], mesh).requires_grad_()
        y = C.gather(blk, mesh, "data", 0, grad=grad)
        out[f"gathered_{grad}"] = y.detach().numpy()
        (y * w).sum().backward()
        out[f"grad_gather_{grad}"] = blk.grad.numpy()
    v = torch.full((4,), float(rank + 1), requires_grad=True)
    z = C.reduce_forward(v, mesh, "model")
    out["reduce_forward"] = z.detach().numpy()
    (z * w[0, 0]).sum().backward()
    out["grad_reduce_forward"] = v.grad.numpy()
    v = torch.full((4,), float(rank + 1), requires_grad=True)
    z = C.reduce_backward(v, mesh, "data")
    out["reduce_backward"] = z.detach().numpy()
    (z * w[0, 0]).sum().backward()
    out["grad_reduce_backward"] = v.grad.numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_once("mesh", _rank, 4, tmp_path_factory)


def _coord(rank):
    return {"data": rank // 2, "model": rank % 2}


def _group(rank, axis):
    """The ranks of ``rank``'s group along ``axis`` of the (2, 2) mesh."""
    d, m = rank // 2, rank % 2
    return [2 * i + m for i in range(2)] if axis == "data" else [2 * d + i for i in range(2)]


@pytest.mark.parametrize("rank", range(4))
def test_host_mesh_coordinates(ranks, rank):
    assert ranks[rank]["coord"] == (rank // 2, rank % 2)
    assert "needs 8 ranks" in ranks[rank]["refused"]


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("rank", range(4))
def test_local_shard_and_whole(ranks, rank, name):
    desc = MESHES["2x2"]
    want = local_shard(torch.from_numpy(X), SPECS[name], desc, coord=_coord(rank)).numpy()
    np.testing.assert_array_equal(ranks[rank][f"block_{name}"], want)
    assert want.shape == local_shape(X.shape, SPECS[name], desc)
    np.testing.assert_array_equal(ranks[rank][f"whole_{name}"], X)
    np.testing.assert_array_equal(ranks[rank]["whole_bf16"], X)


@pytest.mark.parametrize("rank", range(4))
def test_all_reduce_over_axes(ranks, rank):
    r = ranks[rank]
    assert r["sum_model"].tolist() == [float(sum(i + 1 for i in _group(rank, "model")))] * 3
    assert r["sum_both"].tolist() == [10.0] * 3
    # a bf16 sum runs in f32 and comes back in bf16
    assert r["sum_data_bf16"].dtype == torch.bfloat16
    assert r["sum_data_bf16"].tolist() == [float(sum(i + 1 for i in _group(rank, "data")))] * 3


@pytest.mark.parametrize("rank", range(4))
def test_autograd_collectives(ranks, rank):
    """The backward of each against its closed form."""
    r = ranks[rank]
    d = rank // 2
    rows = slice(2 * d, 2 * d + 2)
    for grad in ("sum", "slice"):
        np.testing.assert_array_equal(r[f"gathered_{grad}"], X)
    group_w = sum(_weights(i) for i in _group(rank, "data"))
    np.testing.assert_allclose(r["grad_gather_sum"], group_w[rows], rtol=1e-6)
    np.testing.assert_array_equal(r["grad_gather_slice"], _weights(rank)[rows])
    assert r["reduce_forward"].tolist() == [float(sum(i + 1 for i in _group(rank, "model")))] * 4
    np.testing.assert_array_equal(r["grad_reduce_forward"], _weights(rank)[0, 0])
    assert r["reduce_backward"].tolist() == [float(rank + 1)] * 4
    np.testing.assert_allclose(r["grad_reduce_backward"],
                               sum(_weights(i)[0, 0] for i in _group(rank, "data")), rtol=1e-6)
    assert math.prod(r["block_both"].shape) == X.size // 4

"""``repro_torch.optim.compress`` against ``repro.optim.compress``.

* ``quantize``, ``dequantize``, ``ef_init`` and ``compression_ratio`` bit
  for bit (ties at half a step included: both round half to even);
* ``compressed_psum`` over a gloo world of 4 CPU ranks, three rounds of
  error feedback on an f32 and a bf16 leaf: each rank's outputs and
  residuals bit for bit those of the reference's ``compressed_psum`` under
  ``shard_map`` on 4 forced host devices;
* ``tests/test_compress.py``'s properties, on the port: every rank gets the
  same mean, one round is within the scale of the true mean, and 64 rounds
  of error feedback average to within 1e-3 of it.

The ranks run once a session (``_torch_dist.spawn_once``), the reference in
one subprocess; JAX is imported only there and in the fixture ``j``.
"""

import textwrap

import numpy as np
import pytest
import torch

from _torch_dist import reference_once, spawn_once
from repro_torch.optim import compress as TC

WORLD, N, ROUNDS = 4, 256, 3


def _grads(seed=1):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((WORLD, N)).astype(np.float32),
            "b": (rng.standard_normal((WORLD, 8, 16)) * 3).astype(np.float32)}


def _rank(rank, world):
    """Rounds of ``compressed_psum`` on this rank's gradients (w f32, b
    bf16), then 64 rounds of error feedback on w alone."""
    g = _grads()
    grads = {"w": torch.from_numpy(g["w"][rank]),
             "b": torch.from_numpy(g["b"][rank]).to(torch.bfloat16)}
    ef = TC.ef_init(grads)
    out = {}
    for r in range(ROUNDS):
        mean, ef = TC.compressed_psum(grads, ef)
        for k in grads:
            out[f"out_{k}_{r}"] = mean[k].float().numpy()
            out[f"ef_{k}_{r}"] = ef[k].numpy()
    e = TC.ef_init({"w": grads["w"]})
    acc = np.zeros(N, np.float64)
    for _ in range(64):
        mean, e = TC.compressed_psum({"w": grads["w"]}, e)
        acc += mean["w"].numpy()
    out["ef64_mean"] = (acc / 64).astype(np.float32)
    return out


_REFERENCE = textwrap.dedent(f"""
    import json, os
    import jax, jax.numpy as jnp, numpy as np
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from repro.optim.compress import compressed_psum, ef_init

    mesh = jax.make_mesh(({WORLD},), ("pod",), devices=jax.devices()[:{WORLD}])
    rng = np.random.default_rng(1)
    g = {{"w": rng.standard_normal(({WORLD}, {N})).astype(np.float32),
          "b": (rng.standard_normal(({WORLD}, 8, 16)) * 3).astype(np.float32)}}

    # run as tests/test_compress.py runs it, eagerly: under jax.jit XLA
    # rewrites the division by the scale and differs from both in the last bit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P("pod"), P("pod")),
             out_specs=(P("pod"), P("pod")))
    def step(gi, ei):
        out, new_e = compressed_psum({{k: v[0] for k, v in gi.items()}},
                                     {{k: v[0] for k, v in ei.items()}}, axis="pod")
        return ({{k: v[None] for k, v in out.items()}}, {{k: v[None] for k, v in new_e.items()}})

    grads = {{"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}}
    out = {{}}
    with jax.set_mesh(mesh):
        ef = {{k: jnp.zeros(v.shape, jnp.float32) for k, v in grads.items()}}
        for r in range({ROUNDS}):
            mean, ef = step(grads, ef)
            for k in grads:
                out[f"out_{{k}}_{{r}}"] = np.asarray(mean[k].astype(jnp.float32))
                out[f"ef_{{k}}_{{r}}"] = np.asarray(ef[k])
    np.savez(os.environ["OUT"], **out)
    print(json.dumps({{"ok": True}}))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_once("compress", _rank, WORLD, tmp_path_factory)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    return reference_once("compress_ref", _REFERENCE, tmp_path_factory)[0]


@pytest.fixture
def j():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.optim import compress as JC

    return jnp, JC


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("scale_of", ["max", "ties", "tiny"])
def test_quantize_dequantize_match_repro(j, scale_of):
    jnp, JC = j
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * 5
    if scale_of == "ties":
        # x / scale lands on k + 0.5: both round half to even
        scale = np.float32(0.25)
        x = ((np.arange(-600, 600) + 0.5) * scale).astype(np.float32)
    elif scale_of == "tiny":
        scale = np.float32(1e-12 / 127.0)
    else:
        scale = np.float32(np.abs(x).max() / 127.0)
    q = TC.quantize(torch.from_numpy(x), torch.tensor(scale))
    jq = JC.quantize(jnp.asarray(x), jnp.float32(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_bits(TC.dequantize(q, torch.tensor(scale)).numpy()),
                                  _bits(JC.dequantize(jq, jnp.float32(scale))))


def test_ef_init_and_ratio_match_repro(j):
    jnp, JC = j
    tree = {"a": torch.ones(1024, 1024), "b": {"c": torch.ones(4096, dtype=torch.bfloat16)}}
    jtree = {"a": jnp.ones((1024, 1024)), "b": {"c": jnp.ones((4096,), jnp.bfloat16)}}
    assert TC.compression_ratio(tree) == JC.compression_ratio(jtree)
    ef = TC.ef_init(tree)
    assert ef["b"]["c"].dtype == torch.float32 and not ef["b"]["c"].any()
    assert ef["a"].shape == tuple(JC.ef_init(jtree)["a"].shape)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("what", ["out", "ef"])
@pytest.mark.parametrize("leaf", ["w", "b"])
def test_compressed_psum_matches_repro(ranks, reference, rank, what, leaf):
    for r in range(ROUNDS):
        key = f"{what}_{leaf}_{r}"
        np.testing.assert_array_equal(_bits(ranks[rank][key]), _bits(reference[key][rank]),
                                      err_msg=f"{key} rank {rank}")


def test_compressed_psum_identical_on_every_rank(ranks):
    for r in range(ROUNDS):
        for leaf in ("w", "b"):
            key = f"out_{leaf}_{r}"
            for rank in range(1, WORLD):
                np.testing.assert_array_equal(_bits(ranks[rank][key]), _bits(ranks[0][key]))


def test_one_round_within_the_scale(ranks):
    g = _grads()["w"]
    scale = np.abs(g).max() / 127.0
    assert np.abs(ranks[0]["out_w_0"] - g.mean(axis=0)).max() < scale


def test_error_feedback_converges(ranks):
    """64 rounds on the same gradients: the residuals re-enter, so the
    average of the means converges to the true mean."""
    target = _grads()["w"].mean(axis=0)
    for rank in range(WORLD):
        assert np.abs(ranks[rank]["ef64_mean"] - target).max() < 1e-3

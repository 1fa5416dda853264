"""``repro_torch.launch.opcost`` against exactly known programs and against
``repro.launch.hloparse``.

The counterparts of ``tests/test_hloparse.py``'s programs (8 looped
matmuls, nested loops, looped equal to unrolled), the bytes of one matmul,
free views, ``weight``, the convolution rule, the memory fields, and one
collective on a one-process gloo group.  Then the port's total flops on the
smoke prefill of qwen2-7b and rwkv6-3b (B 2, S 64) against ``hloparse`` of
``repro``'s compiled step (``run_overrides={"sp": False}``): measured
0.26% and 0.48% apart on this CPU (the port counts a few elementwise ops
that XLA folds or fuses away), held to ``HLO_RTOL``; and the port's matmul
flops on qwen2-7b's equal to an analytic count of the same step.  JAX is
imported in a fixture.
"""

import sys
import tempfile

import pytest
import torch
import torch.nn.functional as F

from _torch_parity import one_thread  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.launch import opcost
from repro_torch.launch import steps as S
from repro_torch.models.layers import padded_vocab

HLO_RTOL = 1e-2
MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm")


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


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _looped(x, w):
    for wi in w.unbind(0):
        x = x @ wi
    return x


def _unrolled(x, w):
    return x @ w[0] @ w[1] @ w[2] @ w[3] @ w[4] @ w[5] @ w[6] @ w[7]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_looped_matmuls_count_every_iteration(device):
    x = torch.ones(128, 256, device=device)
    w = torch.ones(8, 256, 256, device=device)
    s = opcost.summarize(opcost.count(_looped, x, w))
    assert s["flops"] == 8 * 2 * 128 * 256 * 256
    assert s["ops"] == 8 and s["transcendentals"] == 0
    assert s["top"]["flops"][0]["op"] == "mm" and s["top"]["flops"][0]["count"] == 8


def test_nested_loops_multiply():
    def f(x, w):
        for wi in w.unbind(0):
            for _ in range(4):
                x = torch.tanh(x @ wi)
        return x

    c = opcost.count(f, _meta(64, 64), _meta(3, 64, 64))
    assert c.flops == 12 * 2 * 64 * 64 * 64 + 12 * 64 * 64  # 12 matmuls and 12 tanh
    assert c.transcendentals == 12 * 64 * 64
    assert c.by_op["mm"][0] == 12 and c.by_op["tanh"][0] == 12


def test_unrolled_matches_looped():
    a = opcost.count(_looped, _meta(64, 128), _meta(8, 128, 128))
    b = opcost.count(_unrolled, _meta(64, 128), _meta(8, 128, 128))
    assert (a.flops, a.bytes, a.ops) == (b.flops, b.bytes, b.ops)


def test_bytes_of_one_matmul():
    c = opcost.count(torch.matmul, _meta(64, 128), _meta(128, 32))
    assert c.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert c.flops == 2 * 64 * 32 * 128


def test_views_are_free():
    def views(x):
        y = x.view(4, 8, 16).transpose(1, 2).unsqueeze(0)[..., 1:3]
        return y.expand(3, 4, 16, 2).permute(3, 2, 1, 0).detach()

    c = opcost.count(views, _meta(32, 16))
    assert (c.flops, c.bytes, c.ops) == (0, 0, 0)
    assert c.temp_bytes == 0 and c.alias_bytes == c.argument_bytes == 32 * 16 * 4


def test_broadcast_operand_read_once():
    c = opcost.count(lambda x, b: x * b.expand(64, 32), _meta(64, 32), _meta(1, 32))
    assert c.bytes == (64 * 32 + 32 + 64 * 32) * 4
    assert c.flops == 64 * 32


def test_weight_multiplies():
    def f(x, w):
        return torch.exp(x @ w).sum()

    one = opcost.count(f, _meta(16, 32), _meta(32, 8))
    three = opcost.count(f, _meta(16, 32), _meta(32, 8), weight=3)
    for key in ("flops", "bytes", "transcendentals", "ops"):
        assert getattr(three, key) == 3 * getattr(one, key)
    assert three.peak_bytes == one.peak_bytes and three.by_op["mm"][0] == 3


def test_convolution():
    # a depthwise causal conv of width 4 over 64 channels, and a dense one
    x, w = _meta(2, 64, 100), _meta(64, 1, 4)
    c = opcost.count(lambda x, w: F.conv1d(x, w, groups=64), x, w)
    assert c.flops == 2 * (2 * 64 * 97) * 1 * 4
    c = opcost.count(lambda x, w: F.conv1d(x, w), x, _meta(32, 64, 3))
    assert c.flops == 2 * (2 * 32 * 98) * 64 * 3


def test_memory_by_storage():
    def f(x):
        y = x * 2.0
        z = y + 1.0
        del y
        t = z.exp()
        return t.sum(), x[:10]

    c = opcost.count(f, _meta(1000))
    assert c.argument_bytes == 4000
    assert c.peak_bytes == 4000 + 8000 + 4  # x, z, t and the sum (y was freed)
    assert c.temp_bytes == 8004
    assert c.output_bytes == 4 + 4000 and c.alias_bytes == 4000


def test_unread_arguments_are_dropped():
    c = opcost.count(lambda x, unused: x + 1, _meta(100), _meta(1000))
    assert c.argument_bytes == 400 and c.peak_bytes == 800


def test_one_collective_on_a_gloo_group():
    dist = pytest.importorskip("torch.distributed")
    if not dist.is_available():
        pytest.skip("torch.distributed is not built in")
    with tempfile.NamedTemporaryFile() as f:
        dist.init_process_group("gloo", init_method=f"file://{f.name}", rank=0, world_size=1)
        try:
            t = torch.ones(1000)
            s = opcost.summarize(opcost.count(lambda x: dist.all_reduce(x), t))
        finally:
            dist.destroy_process_group()
    assert s["collective_counts"] == {"all-reduce": 1}
    assert s["collective_bytes"] == {"all-reduce": 4000}
    site, = s["collective_sites"]
    assert (site["kind"], site["bytes"], site["group"], site["mult"]) == ("all-reduce", 4000, 1, 1)


def test_a_step_without_collectives_has_none():
    s = opcost.summarize(opcost.count(_looped, _meta(8, 8), _meta(2, 8, 8)))
    assert s["collective_bytes"] == {} and s["collective_counts"] == {}
    assert s["collective_sites"] == []


# ---------------------------------------------------------------------------
# against the reference's hloparse, and an analytic count
# ---------------------------------------------------------------------------

@pytest.fixture
def j():
    """``repro``'s side: its smoke prefill compiled on this CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as ref_config
    from repro.launch import hloparse
    from repro.launch import steps as ref_steps

    def summary(arch, batch, seq):
        fn, model, _ = ref_steps.build_prefill_step(ref_config(arch), multi_pod=False,
                                                    run_overrides={"sp": False})
        tokens = {"tokens": jax.ShapeDtypeStruct((batch, seq), jnp.int32)}
        return hloparse.summarize(jax.jit(fn).lower(model.shapes(), tokens).compile().as_text())

    return summary


def _port_prefill(arch, batch, seq):
    cfg = get_smoke_config(arch)
    step, _, _ = S.build_prefill_step(cfg, device=S.META)
    return cfg, opcost.count(step, S.param_specs(cfg),
                             {"tokens": _meta(batch, seq, dtype=torch.int32)})


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b"])
def test_prefill_flops_match_hloparse(j, arch):
    ref = j(arch, 2, 64)
    _, c = _port_prefill(arch, 2, 64)
    assert abs(c.flops - ref["flops"]) <= HLO_RTOL * ref["flops"]
    assert ref["collective_counts"] == {} and c.collective_counts == {}


def test_dense_prefill_matmuls_match_the_arithmetic():
    """qwen2-7b's smoke prefill (S 64 within one 512-block of the plain
    attention, which computes the block's masked pairs too): the
    projections, the SwiGLU MLP, QK^T and PV, and the last token's logits."""
    b, s = 2, 64
    cfg, c = _port_prefill("qwen2-7b", b, s)
    t, d, dh = b * s, cfg.d_model, cfg.head_dim
    proj = 2 * t * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh + 2 * t * cfg.n_heads * dh * d
    mlp = 3 * 2 * t * d * cfg.d_ff
    attn = 2 * 2 * b * cfg.n_heads * s * s * dh
    head = 2 * b * d * padded_vocab(cfg)
    want = cfg.n_layers * (proj + mlp + attn) + head
    assert sum(c.by_op[k][1] for k in MATMUL_OPS if k in c.by_op) == want

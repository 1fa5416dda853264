"""The port's dense LM against ``repro``'s, at f32 on the smoke configs.

Parameters are drawn once by ``repro`` and carried into the port with
``params_from_numpy``; token ids and activations are made with numpy and
handed to both.  Each layer function, the prefill logits
(``hidden_states`` + ``_logits``) and five decode steps must agree within
2e-4, the tolerance ``tests/test_system.py`` uses for the reference's own
forward checks.  The configs cover RoPE + GQA + QKV bias (qwen2-7b), the
sliding window (h2o-danube-3-4b), layernorm + GeLU + biases
(starcoder2-15b) and tied embeddings (command-r-plus-104b).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import to_np  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.blocks import attn_cache_init as j_cache_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.steps import build_decode_step, build_prefill_step  # noqa: E402
from repro_torch.models import LM, layers as L, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.blocks import attn_cache_init  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["qwen2-7b", "h2o-danube-3-4b", "starcoder2-15b", "command-r-plus-104b"]

_CACHE = {}


def _setup(arch):
    """(reference cfg, port cfg, reference params, port params), once."""
    if arch not in _CACHE:
        jcfg = j_smoke(arch)
        jp = JLM(jcfg).init(jax.random.key(0))
        tree = jax.tree.map(np.asarray, jp)
        cfg = get_smoke_config(arch)
        _CACHE[arch] = (jcfg, cfg, jp, params_from_numpy(cfg, tree, device="cpu"))
    return _CACHE[arch]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, what=""):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), err_msg=what, **TOL)


def test_configs_match_the_reference():
    from repro.configs import ARCH_NAMES as J_NAMES
    from repro.configs import get_config as j_get
    from repro_torch.configs import ARCH_NAMES, get_config

    assert ARCH_NAMES == J_NAMES
    for name in ARCH_NAMES:
        for port, ref in ((get_config(name), j_get(name)), (get_smoke_config(name), j_smoke(name))):
            fields = {f: getattr(port, f) for f in port.__dataclass_fields__}
            want = {f: getattr(ref, f) for f in ref.__dataclass_fields__}
            for f in ("moe", "ssm"):
                fields[f] = fields[f] and vars(fields[f])
                want[f] = want[f] and vars(want[f])
            assert fields == want, name
            assert port.head_dim == ref.head_dim
            assert L.padded_vocab(port) == JL.padded_vocab(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_meta(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    back = params_to_numpy(tp)
    want = jax.tree.map(np.asarray, jp)
    flat_b, _ = jax.tree.flatten(back)
    flat_w, _ = jax.tree.flatten(want)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for b, w in zip(flat_b, flat_w):
        assert b.dtype == w.dtype and b.shape == w.shape
        np.testing.assert_array_equal(b, w)
    # the port's own init draws the same shapes and dtypes as the meta says
    own = LM(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    for a, w in zip(jax.tree.leaves(params_to_numpy(own)), flat_w):
        assert a.shape == w.shape and a.dtype == w.dtype


def test_params_from_numpy_checks_shapes():
    jcfg, cfg, jp, _ = _setup("qwen2-7b")
    tree = jax.tree.map(np.asarray, jp)
    tree["ln_f"]["scale"] = tree["ln_f"]["scale"][:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, tree, device="cpu")


def test_bf16_params_round_trip():
    cfg = get_smoke_config("qwen2-7b").scaled(dtype="bfloat16", n_layers=1)
    p = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tree = params_to_numpy(p)
    assert tree["embed"]["tok"].dtype.name == "bfloat16"
    back = params_from_numpy(cfg, tree, device="cpu")
    assert torch.equal(back["embed"]["tok"].view(torch.int16), p["embed"]["tok"].view(torch.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_functions(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(0)
    B, S, d = 2, 12, cfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["blocks"])
    tlp = {k: {n: t[0] for n, t in v.items()} for k, v in tp["blocks"].items()}

    _close(L.norm_apply(tlp["ln1"], cfg, _t(x)), JL.norm_apply(lp["ln1"], jcfg, x), "norm")
    heads = rng.standard_normal((B, cfg.n_heads, S, cfg.head_dim)).astype(np.float32)
    pos1 = np.arange(3, 3 + S)
    pos2 = rng.integers(0, 50, (B, S))
    for pos in (pos1, pos2):
        _close(L.rope_apply(_t(heads), _t(pos), cfg.rope_theta),
               JL.rope_apply(heads, jnp.asarray(pos), jcfg.rope_theta), "rope")
    _close(L.sinusoid_embed(_t(pos1), d), JL.sinusoid_embed(jnp.asarray(pos1), d), "sinusoid")
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    _close(L.embed_apply(tp["embed"], cfg, _t(toks)),
           JL.embed_apply(jp["embed"], jcfg, jnp.asarray(toks)), "embed")
    _close(L.logits_apply(tp["embed"], cfg, _t(x)), JL.logits_apply(jp["embed"], jcfg, x),
           "logits")
    _close(L._split_heads(_t(x), cfg.n_heads, d // cfg.n_heads),
           JL._split_heads(x, jcfg.n_heads, d // jcfg.n_heads), "split_heads")
    _close(L.mlp_apply(tlp["ffn"], cfg, _t(x)), JL.mlp_apply(lp["ffn"], jcfg, x), "mlp")

    # full-sequence attention, through the plain chunked route on the CPU
    got, cache = L.attn_apply(tlp["attn"], cfg, _t(x), block_q=4, block_k=4)
    want, _ = JL.attn_apply(lp["attn"], jcfg, x, block_q=4, block_k=4)
    assert cache is None
    _close(got, want, "attn")
    got, _ = L.attn_apply(tlp["attn"], cfg, _t(x), attn_impl="reference")
    _close(got, want, "attn reference")

    # one decode step against a partly filled ring with per-row start offsets
    T = 8
    ck = rng.standard_normal((B, cfg.n_kv_heads, T, cfg.head_dim)).astype(np.float32)
    cv = rng.standard_normal((B, cfg.n_kv_heads, T, cfg.head_dim)).astype(np.float32)
    start = np.array([0, 2], np.int32)
    for n in (5, 11):  # before and after the ring wraps
        jc = {"k": ck, "v": cv, "len": jnp.int32(n), "start": jnp.asarray(start)}
        tc = {"k": _t(ck).clone(), "v": _t(cv).clone(), "len": torch.tensor(n, dtype=torch.int32),
              "start": _t(start)}
        want, jnew = JL.attn_apply(lp["attn"], jcfg, x[:, :1], positions=jnp.arange(n, n + 1),
                                   kv_cache=jc)
        got, tnew = L.attn_apply(tlp["attn"], cfg, _t(x[:, :1]),
                                 positions=torch.arange(n, n + 1), kv_cache=tc)
        _close(got, want, f"decode attn at {n}")
        _close(tnew["k"], jnew["k"], "decode k cache")
        _close(tnew["v"], jnew["v"], "decode v cache")
        assert int(tnew["len"]) == int(jnew["len"]) == n + 1

    want = j_cache_init(jcfg, B, T, jnp.float32)
    got = attn_cache_init(cfg, B, T, torch.float32, "cpu")
    for name in ("k", "v", "len"):
        _close(got[name], want[name], f"cache init {name}")
        assert got[name].shape == want[name].shape

    q = rng.standard_normal((B, cfg.n_heads, 1, cfg.head_dim)).astype(np.float32)
    _close(L._decode_attention(_t(q), _t(ck), _t(cv), torch.tensor(6), _t(start)),
           JL._decode_attention(q, ck, cv, jnp.int32(6), jnp.asarray(start)), "decode attention")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    rng = np.random.default_rng(1)
    B, S = 2, 40  # longer than the smoke window of h2o-danube-3-4b (32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)

    jm = JLM(jcfg)
    hid, _, _ = jm.hidden_states(jp, jnp.asarray(toks), run={"sp": False})
    want = jm._logits(jp, hid)
    tm = LM(cfg, device="cpu")
    thid, aux, states = tm.hidden_states(tp, _t(toks))
    assert aux == 0.0 and states is None
    _close(tm._logits(tp, thid), want, "prefill logits")

    prefill, _, _ = build_prefill_step(cfg, device="cpu", run_overrides={"attn_impl": "kernel"})
    _close(prefill(tp, {"tokens": _t(toks)}), want[:, -1:], "prefill step")

    jc = jm.decode_init(B, 16)
    step, _, _ = build_decode_step(cfg, device="cpu")
    tc = tm.decode_init(B, 16)
    for t in range(5):
        tok = toks[:, t:t + 1]
        want, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        got, tc = step(tp, _t(tok), tc)
        _close(got, want, f"decode step {t}")
    assert int(tc["len"]) == 5


def test_other_families_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(get_smoke_config("mixtral-8x7b"), device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(get_smoke_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_prefill_step(get_smoke_config("qwen2-7b"))

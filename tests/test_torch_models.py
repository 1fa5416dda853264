"""The port's dense LM against ``repro``'s, at f32 on the smoke configs.

Parameters are drawn once by ``repro`` and carried into the port with
``params_from_numpy``; token ids and activations are made with numpy and
handed to both.  Each layer function, the prefill logits
(``hidden_states`` + ``_logits``) and five decode steps must agree within
2e-4, the tolerance ``tests/test_system.py`` uses for the reference's own
forward checks.  The configs cover RoPE + GQA + QKV bias (qwen2-7b), the
sliding window (h2o-danube-3-4b), layernorm + GeLU + biases
(starcoder2-15b) and tied embeddings (command-r-plus-104b).

The recurrent families, rwkv6-3b (ssm) and zamba2-1.2b (hybrid: mamba2 and
a shared attention block), are held to the same 2e-4 on their hidden
states, recurrent states, decode logits and prefill step.  The reference
initialises some of their leaves to constants (rwkv6's token-shift lerps
``mu``/``cmu``, ``bonus`` and decay base ``w0``; mamba2's ``A_log``,
``dt_bias``, ``conv_b`` and ``D``), which would leave the token shift and
the bonus unexercised; the tests add numpy noise to those leaves and hand
the same arrays to both packages.
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
from repro.launch.steps import build_prefill_step as j_prefill_step  # noqa: E402
from repro.models.blocks import attn_cache_init as j_cache_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.steps import build_decode_step, build_prefill_step  # noqa: E402
from repro_torch.models import LM, layers as L, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.blocks import attn_cache_init  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["qwen2-7b", "h2o-danube-3-4b", "starcoder2-15b", "command-r-plus-104b"]
REC_ARCHS = ["rwkv6-3b", "zamba2-1.2b"]
# leaves the reference initialises to constants, re-drawn with numpy noise
NOISY = {"rwkv6-3b": {"mu": 0.5, "cmu": 0.5, "bonus": 0.5, "w0": 0.5},
         "zamba2-1.2b": {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.1, "D": 0.5}}

_CACHE = {}


def _setup(arch, n_layers=None):
    """(reference cfg, port cfg, reference params, port params), once."""
    if (arch, n_layers) not in _CACHE:
        jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
        if n_layers is not None:
            jcfg, cfg = jcfg.scaled(n_layers=n_layers), cfg.scaled(n_layers=n_layers)
        tree = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(0)))
        rng = np.random.default_rng(100)
        for name, scale in NOISY.get(arch, {}).items():
            leaf = tree["blocks"][name]
            noise = scale * rng.standard_normal(leaf.shape)
            tree["blocks"][name] = (leaf + noise).astype(leaf.dtype)
        jp = jax.tree.map(jnp.asarray, tree)
        _CACHE[arch, n_layers] = (jcfg, cfg, jp, params_from_numpy(cfg, tree, device="cpu"))
    return _CACHE[arch, n_layers]


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


NEW_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b", "llama-3.2-vision-11b", "musicgen-medium"]


@pytest.mark.parametrize("arch", ARCHS + REC_ARCHS + NEW_ARCHS)
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


def _close_tree(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), f"{what} {name}"
        _close(got[name], want[name], f"{what} {name}")


@pytest.mark.parametrize("arch,n_layers", [("rwkv6-3b", None), ("zamba2-1.2b", None),
                                           ("zamba2-1.2b", 7)])
def test_recurrent_hidden_states_and_states(arch, n_layers):
    """The prefill forward and its recurrent states, from zero states and
    continued from a first segment's states (odd lengths run chunk 1).
    zamba2 at 7 layers has a mamba2 tail after its two shared-block groups,
    as the full config's 38 layers in groups of 6 do."""
    jcfg, cfg, jp, tp = _setup(arch, n_layers)
    rng = np.random.default_rng(2)
    B, S1, S2 = 2, 40, 13
    toks = rng.integers(0, cfg.vocab, (B, S1 + S2)).astype(np.int32)
    jm, tm = JLM(jcfg), LM(cfg, device="cpu")
    run = {"sp": False, "remat": False}

    js = jm.init_recurrent_states(B, jnp.float32)
    ts = tm.init_recurrent_states(B, torch.float32)
    _close_tree(ts, js, "initial states")
    jh, _, js = jm.hidden_states(jp, jnp.asarray(toks[:, :S1]), run=run, states=js)
    th, aux, ts = tm.hidden_states(tp, _t(toks[:, :S1]), states=ts)
    assert aux == 0.0
    _close(th, jh, "hidden")
    _close_tree(ts, js, "states after the first segment")
    _close(tm._logits(tp, th), jm._logits(jp, jh), "logits")
    jh, _, js = jm.hidden_states(jp, jnp.asarray(toks[:, S1:]), run=run, states=js)
    th, _, ts = tm.hidden_states(tp, _t(toks[:, S1:]), states=ts)
    _close(th, jh, "hidden, continued")
    _close_tree(ts, js, "states after the second segment")
    # no states means zero states
    th0, _, ts0 = tm.hidden_states(tp, _t(toks[:, :S1]))
    th1, _, ts1 = tm.hidden_states(tp, _t(toks[:, :S1]),
                                   states=tm.init_recurrent_states(B, torch.float32))
    assert torch.equal(th0, th1) and all(torch.equal(ts0[n], ts1[n]) for n in ts0)
    # the plain scan forced gives the same (on the CPU both are the plain one)
    thr, _, _ = tm.hidden_states(tp, _t(toks[:, :S1]), run={"scan_impl": "reference"})
    assert torch.equal(thr, th0)


@pytest.mark.parametrize("arch,n_layers", [("rwkv6-3b", None), ("zamba2-1.2b", None),
                                           ("zamba2-1.2b", 7)])
def test_recurrent_prefill_and_decode(arch, n_layers):
    """The prefill step's last-token logits and five decode steps (cache
    states and the hybrid's shared-block KV) against the reference."""
    jcfg, cfg, jp, tp = _setup(arch, n_layers)
    rng = np.random.default_rng(3)
    B, S = 2, 24
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jm = JLM(jcfg)
    jstep, _, _ = j_prefill_step(jcfg, multi_pod=False, run_overrides={"sp": False})
    want = jstep(jp, {"tokens": jnp.asarray(toks)})
    prefill, _, _ = build_prefill_step(cfg, device="cpu")
    _close(prefill(tp, {"tokens": _t(toks)}), want, "prefill step")

    jc = jm.decode_init(B, 16)
    step, tm, _ = build_decode_step(cfg, device="cpu")
    tc = tm.decode_init(B, 16)
    assert sorted(tc) == sorted(jc)
    for t in range(5):
        tok = toks[:, t:t + 1]
        want, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        got, tc = step(tp, _t(tok), tc)
        _close(got, want, f"decode step {t}")
        _close_tree(tc["states"], jc["states"], f"states after step {t}")
        if "shared_kv" in jc:
            _close_tree(tc["shared_kv"], jc["shared_kv"], f"shared KV after step {t}")
    assert int(tc["len"]) == 5


def test_recurrent_block_helpers():
    from repro.models import blocks as JB

    from repro_torch.models import blocks as TB

    for S in (1, 2, 7, 24, 40, 64, 100, 4096, 4097):
        assert TB._pick_chunk(S) == JB._pick_chunk(S)
    jcfg, cfg, jp, tp = _setup("zamba2-1.2b")
    rng = np.random.default_rng(4)
    C = 2 * cfg.d_model + 2 * cfg.ssm.state
    x = rng.standard_normal((2, 5, C)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.ssm.conv - 1, C)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jp["blocks"])
    want, wstate = JB._causal_conv(x, lp["conv_w"], lp["conv_b"], prev)
    got, gstate = TB._causal_conv(_t(x), _t(np.array(lp["conv_w"])),
                                  _t(np.array(lp["conv_b"])), _t(prev))
    _close(got, want, "causal conv")
    _close(gstate, wstate, "causal conv state")
    for name, jinit, tinit, jc in (("rwkv6", JB.rwkv6_state_init, TB.rwkv6_state_init,
                                    j_smoke("rwkv6-3b")),
                                   ("mamba2", JB.mamba2_state_init, TB.mamba2_state_init,
                                    j_smoke("zamba2-1.2b"))):
        pc = get_smoke_config(jc.name)
        _close_tree(tinit(pc, 3, torch.float32, "cpu"), jinit(jc, 3, jnp.float32), name)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "granite-moe-3b-a800m"])
def test_sharded_moe_is_refused(arch):
    """Every family runs; the MoE FFN over a mesh (``moe_apply_shardmap``,
    which the ``sp`` prefill and the ``decode_moe_shardmap`` decode pick, as
    in the reference) needs the mesh: without one each raises
    ``ValueError``, as the reference's shard_map does."""
    from repro_torch.models import blocks as TB

    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int32)
    model.hidden_states(params, toks)
    with pytest.raises(ValueError, match="mesh"):
        model.hidden_states(params, toks, run={"sp": True})
    with pytest.raises(ValueError, match="mesh"):
        model.loss(params, {"tokens": toks, "targets": toks}, run={"sp": True})
    with pytest.raises(ValueError, match="mesh"):
        model.decode_step(params, toks[:, :1], model.decode_init(1, 8),
                          run={"decode_moe_shardmap": True})
    with pytest.raises(ValueError, match="mesh"):
        TB.attn_block_apply(_layer_of(params["blocks"], 0), cfg,
                            torch.zeros(1, 4, cfg.d_model), moe=True, shard=True)


def _layer_of(tree, i):
    return {k: _layer_of(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(get_smoke_config("qwen2-7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_prefill_step(get_smoke_config("qwen2-7b"))

"""The port's moe, vlm and audio LMs against ``repro``'s, at f32 on the smoke
configs.

Parameters are drawn once by ``repro`` and carried into the port with
``params_from_numpy``; token ids, image tokens and activations are made with
numpy and handed to both.  granite-moe-3b-a800m and mixtral-8x7b (MoE FFN,
mixtral with its sliding window), llama-3.2-vision-11b (gated cross
attention after every 3rd layer of the smoke stack) and musicgen-medium (4
codebooks, sinusoid positions, layernorm, GeLU) must give the reference's
prefill logits, balancing loss and decode logits within 2e-4, and the
serving engine the reference's tokens, ticks and page tables exactly.  The
smoke MoE's capacity factor of 2 never drops a pair, so mixtral also runs
with a factor of 0.5 ("tight"), which drops pairs at prefill and at every
decode step.

The reference initialises the cross-attention block's two tanh gates to
zero, which makes the block add nothing; the tests give them numpy noise
(the same arrays to both packages), so that the cross path counts.

The card tests at the end run the cross attention's one-token decode
through the CUDA kernel.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_states_equal, cuda_device, to_np  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import LM, blocks as TB, layers as L, params_from_numpy
from repro_torch.models.config import MoEConfig
from repro_torch.models.lm import _layer
from repro_torch.serving import Request, ServingEngine

TOL = dict(rtol=2e-4, atol=2e-4)
VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
TIGHT = 0.5  # the "tight" MoE capacity factor

_CACHE = {}


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card tests
    at the end run where there is no JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM
    from repro.models import blocks as JB
    from repro.models import layers as JL
    from repro.models.config import MoEConfig as JMoE

    return jax, jnp, j_smoke, JLM, JB, JL, JMoE


def _setup(j, arch, variant=None):
    """(reference cfg, port cfg, reference params, port params), once; the
    cross-attention gates drawn nonzero."""
    if (arch, variant) not in _CACHE:
        jax, jnp, j_smoke, JLM, _, _, JMoE = j
        jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
        if variant == "tight":
            m = cfg.moe
            jcfg = jcfg.scaled(moe=JMoE(m.n_experts, m.top_k, m.expert_ff, TIGHT))
            cfg = cfg.scaled(moe=MoEConfig(m.n_experts, m.top_k, m.expert_ff, TIGHT))
        tree = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(0)))
        if "xattn" in tree:
            rng = np.random.default_rng(200)
            for leaves, name in ((tree["xattn"]["attn"], "gate"), (tree["xattn"], "ffn_gate")):
                leaves[name] = rng.uniform(0.3, 1.0, leaves[name].shape).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, tree)
        _CACHE[arch, variant] = (jcfg, cfg, jp, params_from_numpy(cfg, tree, device="cpu"))
    return _CACHE[arch, variant]


def _t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def _close(got, want, what=""):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), err_msg=what, **TOL)


def _tokens(cfg, rng, B, S):
    shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _memory(cfg, rng, B):
    if not cfg.xattn_every:
        return None
    return rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches_repro(j, qkv_bias):
    """``attn_apply`` with ``memory`` and with ``kv_override`` (full
    sequence and Sq 1): no RoPE, no bias on a given K/V, non-causal, the
    output scaled by tanh(gate)."""
    _, jnp, j_smoke, _, _, JL, _ = j
    jcfg, cfg = j_smoke(VLM).scaled(qkv_bias=qkv_bias), get_smoke_config(VLM).scaled(
        qkv_bias=qkv_bias)
    rng = np.random.default_rng(5)
    p = {name: (rng.standard_normal(m.shape) / np.sqrt(m.shape[0] if len(m.shape) > 1 else 8))
         .astype(np.float32) for name, m in L.attn_meta(cfg, cross=True).items()}
    p["gate"] = np.array([0.8], np.float32)
    tp = {name: _t(a) for name, a in p.items()}
    B, S, M = 2, 9, cfg.n_img_tokens
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, M, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, cfg.n_kv_heads, M, cfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    for xs in (x, x[:, :1]):
        want, _ = JL.attn_apply(p, jcfg, xs, memory=mem)
        for impl in ("chunked", "reference"):
            got, cache = L.attn_apply(tp, cfg, _t(xs), memory=_t(mem), attn_impl=impl,
                                      block_q=4, block_k=4)
            assert cache is None
            _close(got, want, f"memory, {impl}")
        want, _ = JL.attn_apply(p, jcfg, xs, kv_override=tuple(map(jnp.asarray, kv)))
        got, _ = L.attn_apply(tp, cfg, _t(xs), kv_override=tuple(map(_t, kv)))
        _close(got, want, "kv_override")


def test_xattn_block_matches_repro(j):
    _, _, _, _, JB, _, _ = j
    jcfg, cfg, jp, tp = _setup(j, VLM)
    rng = np.random.default_rng(6)
    B, S = 2, 7
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = _memory(cfg, rng, B)
    for i in range(cfg.n_layers // cfg.xattn_every):
        jx = {k: v for k, v in _tree_layer(jp["xattn"], i).items()}
        tx = _layer(tp["xattn"], i)
        assert float(tx["ffn_gate"][0]) != 0.0 and float(tx["attn"]["gate"][0]) != 0.0
        _close(TB.xattn_block_apply(tx, cfg, _t(x), _t(mem)),
               JB.xattn_block_apply(jx, jcfg, x, mem), f"block {i}, memory")
        jk, jv = JB.xattn_precompute_kv(jx, jcfg, mem)
        tk, tv = TB.xattn_precompute_kv(tx, cfg, _t(mem))
        _close(tk, jk, "precomputed k")
        _close(tv, jv, "precomputed v")
        _close(TB.xattn_block_apply(tx, cfg, _t(x[:, :1]), kv_override=(tk, tv)),
               JB.xattn_block_apply(jx, jcfg, x[:, :1], kv_override=(jk, jv)), "kv_override")
        # no memory: the reference's self-attention path with the block's weights
        _close(TB.xattn_block_apply(tx, cfg, _t(x)), JB.xattn_block_apply(jx, jcfg, x),
               "no memory")


def _tree_layer(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_layer(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.mark.parametrize("tied", [False, True])
def test_codebook_embed_and_logits_match_repro(j, tied):
    _, jnp, _, _, _, JL, _ = j
    jcfg, cfg, jp, tp = _setup(j, AUDIO)
    rng = np.random.default_rng(8)
    emb = {k: np.asarray(v) for k, v in jp["embed"].items()}
    if tied:
        jcfg, cfg = jcfg.scaled(tie_embeddings=True), cfg.scaled(tie_embeddings=True)
        emb = {"tok": emb["tok"]}
    assert emb["tok"].shape == (cfg.n_codebooks, L.padded_vocab(cfg), cfg.d_model)
    assert [tuple(m.shape) for m in L.embed_meta(cfg).values()] == \
        [tuple(m.shape) for m in JL.embed_meta(jcfg).values()]
    temb = {k: _t(v) for k, v in emb.items()}
    toks = _tokens(cfg, rng, 2, 11)
    _close(L.embed_apply(temb, cfg, _t(toks)), JL.embed_apply(emb, jcfg, jnp.asarray(toks)),
           "embed")
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    for c in range(cfg.n_codebooks):
        _close(L.logits_apply(temb, cfg, _t(x), codebook=c),
               JL.logits_apply(emb, jcfg, x, codebook=c), f"logits of codebook {c}")


CASES = [("granite-moe-3b-a800m", None), ("mixtral-8x7b", None), ("mixtral-8x7b", "tight"),
         (VLM, None), (AUDIO, None)]


@pytest.mark.parametrize("arch,variant", CASES)
def test_prefill_and_decode_logits(j, arch, variant):
    """The prefill forward's logits and balancing loss, the prefill step
    (with the image tokens for vlm) and five decode steps (vlm: over the
    precomputed cross K/V) against the reference."""
    _, jnp, _, JLM, _, _, _ = j
    from repro.launch.steps import build_prefill_step as j_prefill_step

    jcfg, cfg, jp, tp = _setup(j, arch, variant)
    rng = np.random.default_rng(1)
    B, S = 2, 40  # longer than mixtral's smoke window (32)
    toks, mem = _tokens(cfg, rng, B, S), _memory(cfg, rng, B)
    jm, tm = JLM(jcfg), LM(cfg, device="cpu")
    hid, jaux, _ = jm.hidden_states(jp, jnp.asarray(toks), memory=mem, run={"sp": False})
    want = jm._logits(jp, hid)
    thid, aux, states = tm.hidden_states(tp, _t(toks), memory=_t(mem))
    assert states is None
    _close(tm._logits(tp, thid), want, "prefill logits")
    _close(torch.as_tensor(aux), jaux, "aux")
    if cfg.moe is None:
        assert aux == 0.0

    jstep, _, _ = j_prefill_step(jcfg, multi_pod=False, run_overrides={"sp": False})
    batch = {"tokens": toks} if mem is None else {"tokens": toks, "memory": mem}
    prefill, _, _ = build_prefill_step(cfg, device="cpu", run_overrides={"attn_impl": "kernel"})
    got = prefill(tp, {k: _t(v) for k, v in batch.items()})
    _close(got, jstep(jp, {k: jnp.asarray(v) for k, v in batch.items()}), "prefill step")
    _close(got, want[:, -1:], "prefill step against the forward")

    jc = jm.decode_init(B, 16, params=jp, memory=mem)
    step, _, _ = build_decode_step(cfg, device="cpu")
    tc = tm.decode_init(B, 16, params=tp, memory=_t(mem))
    assert sorted(tc) == sorted(jc)
    if "xkv" in jc:
        for name in ("k", "v"):
            _close(tc["xkv"][name], jc["xkv"][name], f"cross {name}")
    for t in range(5):
        tok = toks[:, t:t + 1]
        want, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        got, tc = step(tp, _t(tok), tc)
        _close(got, want, f"decode step {t}")
    for name in ("k", "v"):
        _close(tc["kv"][name], jc["kv"][name], f"KV cache {name}")
    assert int(tc["len"]) == 5


def test_vlm_decode_matches_its_prefill(j):
    """Decoding over the precomputed cross K/V, one token at a time, gives
    the prefill's logits at every position; without the cross K/V the
    decode runs the text layers alone, as the reference's."""
    _, jnp, _, JLM, _, _, _ = j
    jcfg, cfg, jp, tp = _setup(j, VLM)
    rng = np.random.default_rng(2)
    B, S = 2, 10
    toks, mem = _tokens(cfg, rng, B, S), _memory(cfg, rng, B)
    tm = LM(cfg, device="cpu")
    thid, _, _ = tm.hidden_states(tp, _t(toks), memory=_t(mem))
    want = tm._logits(tp, thid)
    cache = tm.decode_init(B, S, params=tp, memory=_t(mem))
    got = []
    for t in range(S):
        lg, cache = tm.decode_step(tp, _t(toks[:, t:t + 1]), cache)
        got.append(lg)
    _close(torch.cat(got, 1), to_np(want), "decode against prefill")

    jm = JLM(jcfg)
    jc, tc = jm.decode_init(B, S, params=jp), tm.decode_init(B, S, params=tp)
    assert "xkv" not in tc and "xkv" not in jc
    for t in range(3):
        want, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        got, tc = tm.decode_step(tp, _t(toks[:, t:t + 1]), tc)
        _close(got, want, f"text-only decode step {t}")


def _requests(cfg, seed, n, max_new):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(3, 10))
        shape = (plen,) if cfg.n_codebooks == 1 else (plen, cfg.n_codebooks)
        out.append(dict(id=i, prompt=rng.integers(0, cfg.vocab, shape).astype(np.int32),
                        max_new_tokens=max_new, temperature=0.8 if i % 2 else 0.0))
    return out


@pytest.mark.parametrize("arch,variant", [("granite-moe-3b-a800m", None),
                                          ("mixtral-8x7b", "tight"), (VLM, None), (AUDIO, None)])
def test_engine_matches_repro(j, arch, variant):
    """The same requests (greedy and sampled, more than the slots) give the
    reference's tokens, ticks, page tables and page-table graph state; the
    tight MoE drops pairs at every tick, idle slots competing with the
    token 0 both engines feed them."""
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JEngine

    jcfg, cfg, jp, tp = _setup(j, arch, variant)
    reqs = _requests(cfg, 9, 5, 4)
    jeng = JEngine(jcfg, jp, max_batch=3, max_len=48, page_size=8, seed=3)
    teng = ServingEngine(cfg, tp, max_batch=3, max_len=48, page_size=8, seed=3, device="cpu")
    for r in reqs:
        jeng.submit(JRequest(**r))
        teng.submit(Request(**r))
    while jeng.queue or any(s is not None for s in jeng.slots):
        jeng.tick()
        teng.tick()
        assert teng.pages.seq_pages == jeng.pages.seq_pages
        assert [r and r.id for r in teng.slots] == [r and r.id for r in jeng.slots]
    assert sorted(teng.finished) == sorted(jeng.finished) == list(range(len(reqs)))
    for i in jeng.finished:
        assert teng.finished[i].generated == jeng.finished[i].generated, f"request {i}"
    assert teng.ticks == jeng.ticks
    assert teng.pages.op_log == jeng.pages.op_log
    assert_states_equal(teng.pages.graph.state, jeng.pages.graph.state)


@pytest.mark.parametrize("arch,shape", [(AUDIO, (5,)), (AUDIO, (5, 3)), (AUDIO, (0, 4)),
                                        ("mixtral-8x7b", (5, 4))])
def test_engine_refuses_a_prompt_of_the_wrong_shape(arch, shape):
    cfg = get_smoke_config(arch)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="prompt of shape"):
        eng.submit(Request(id=0, prompt=np.zeros(shape, np.int32), max_new_tokens=2))


@pytest.mark.cuda
def test_cuda_cross_decode_on_the_kernel(cuda_device):
    """The cross attention at Sq 1 against 4,096 image tokens launches the
    CUDA kernel (bf16, within 2e-2 of the plain version), and the smoke vlm
    decoding over its cross K/V on the card gives its own prefill's logits
    (f32, within 2e-4)."""
    cfg = get_smoke_config(VLM).scaled(n_img_tokens=4096)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype, tol in (("bfloat16", 2e-2), ("float32", 2e-5)):
        c = cfg.scaled(dtype=dtype)
        xp = _layer(LM(c, cuda_device).init(gen)["xattn"], 0)
        xp["attn"]["gate"].fill_(0.7)
        mem = torch.randn(2, 4096, c.d_model, generator=gen, device=cuda_device).to(c.param_dtype)
        x = torch.randn(2, 1, c.d_model, generator=gen, device=cuda_device).to(c.param_dtype)
        kv = TB.xattn_precompute_kv(xp, c, mem)
        before = fak.flash_attention.launches
        got, _ = L.attn_apply(xp["attn"], c, x, kv_override=kv)
        assert fak.flash_attention.launches == before + 1
        want, _ = L.attn_apply(xp["attn"], c, x, kv_override=kv, attn_impl="reference")
        assert got.shape == want.shape == (2, 1, c.d_model)
        assert (got.float() - want.float()).abs().max().item() <= tol

    model = LM(cfg.scaled(n_img_tokens=64), cuda_device)
    tp = model.init(gen)
    for leaf in (tp["xattn"]["attn"]["gate"], tp["xattn"]["ffn_gate"]):
        leaf.fill_(0.6)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen, device=cuda_device)
    mem = torch.randn(2, 64, cfg.d_model, generator=gen, device=cuda_device)
    with torch.no_grad():
        hid, _, _ = model.hidden_states(tp, toks, memory=mem)
        want = model._logits(tp, hid)
        cache = model.decode_init(2, 12, params=tp, memory=mem)
        got = []
        for t in range(12):
            lg, cache = model.decode_step(tp, toks[:, t:t + 1], cache)
            got.append(lg)
    _close(torch.cat(got, 1), to_np(want), "decode against prefill on the card")

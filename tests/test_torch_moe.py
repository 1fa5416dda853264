"""The port's MoE FFN against ``repro``'s, its dispatch int for int.

``moe_dispatch`` (top-k with ties to the lower expert index, slots granted
in (expert, phase) order, drops past the capacity) must give the expert
choices (``gate_idx``), the kept pairs and every pair's slot of the
reference's ``_moe_local``; its output, routing probabilities and the
Switch loss must agree within 2e-4 at f32.  The reference does not return
its slots: they are read from the one ``jnp.where`` of its dispatch
(``tgt``, with ``e * capacity`` for a dropped pair) through a stand-in for
its module's ``jnp``.  Cases: random routing with and without drops, a zero
router (every expert ties), capacity 1, every token's first choice on one
expert, and a token count that is not a multiple of the expert count.  The
dispatch and combine are shape-static (index writes, no boolean-mask
gather), so both MoE LMs' smoke prefill and train step run on the ``meta``
device, as the dry run needs.  The card twins at the end hold the dispatch
on the card equal to the CPU's, and the bf16 combine the same bit for bit
across runs.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, to_np  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card tests
    at the end run where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import layers as JL
    from repro.models.config import MoEConfig as JMoE

    return SimpleNamespace(jnp=jnp, smoke=j_smoke, L=JL, MoE=JMoE)


def _cfgs(j, arch="mixtral-8x7b", moe=None):
    """The smoke configs of both packages, with ``moe`` = (e, k, ff, factor)
    in place of the smoke MoE where given."""
    jcfg, cfg = j.smoke(arch), get_smoke_config(arch)
    if moe is not None:
        jcfg, cfg = jcfg.scaled(moe=j.MoE(*moe)), cfg.scaled(moe=MoEConfig(*moe))
    return jcfg, cfg


def _weights(cfg, rng, router="random"):
    d, e, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_ff
    w = {name: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
         for name, shape in (("router", (d, e)), ("wi", (e, d, ff)), ("wg", (e, d, ff)),
                             ("wo", (e, ff, d)))}
    if router == "zeros":
        w["router"][:] = 0.0
    elif router == "one_expert":  # with x > 0, expert 2 is every token's first choice
        w["router"][:] = 0.0
        w["router"][:, 2] = 1.0
    return w


def _j_local(j, monkeypatch, w, jcfg, xt, capacity):
    """The reference's ``_moe_local`` and the slots of its dispatch."""
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(j.jnp, name)

        def where(self, *args):
            seen.append(j.jnp.where(*args))
            return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(j.L, "jnp", Spy())
        out, probs, gate_idx = j.L._moe_local(w["router"], w["wi"], w["wg"], w["wo"], jcfg,
                                              xt, capacity)
    slot = np.asarray(seen[0]).reshape(gate_idx.shape)
    return out, probs, gate_idx, slot


# (name, moe override, T, capacity or None for the reference's, router)
CASES = [
    ("random", None, 24, None, "random"),
    ("random, drops", None, 24, 5, "random"),
    ("zero router", None, 16, 3, "zeros"),
    ("capacity 1", None, 20, 1, "random"),
    ("one expert", None, 16, 6, "one_expert"),
    ("T 13 over e 4", None, 13, 4, "random"),
    ("e 5, k 3, T 17", (5, 3, 32, 1.25), 17, None, "random"),
]


@pytest.mark.parametrize("name,moe,T,capacity,router", CASES, ids=[c[0] for c in CASES])
def test_dispatch_and_local_match_repro(j, monkeypatch, name, moe, T, capacity, router):
    jcfg, cfg = _cfgs(j, moe=moe)
    rng = np.random.default_rng(len(name) + T)
    w = _weights(cfg, rng, router)
    xt = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    if router == "one_expert":
        xt = np.abs(xt) + 0.5
    if capacity is None:
        capacity = L.moe_capacity(cfg, T)
    e, k = cfg.moe.n_experts, cfg.moe.top_k

    want_out, want_probs, want_idx, want_slot = _j_local(j, monkeypatch, w, jcfg, xt, capacity)
    tw = {n: torch.as_tensor(a) for n, a in w.items()}
    probs, gate_vals, gate_idx, keep, slot = L.moe_dispatch(tw["router"], cfg,
                                                            torch.as_tensor(xt), capacity)
    np.testing.assert_array_equal(to_np(gate_idx), np.asarray(want_idx), err_msg="gate_idx")
    np.testing.assert_array_equal(to_np(slot), want_slot, err_msg="slots")
    np.testing.assert_array_equal(to_np(keep), want_slot < e * capacity, err_msg="keep")
    np.testing.assert_allclose(to_np(probs), np.asarray(want_probs), **TOL)
    np.testing.assert_allclose(to_np(gate_vals.sum(-1)), np.ones(T), **TOL)

    out, probs2, gate_idx2 = L._moe_local(tw["router"], tw["wi"], tw["wg"], tw["wo"], cfg,
                                          torch.as_tensor(xt), capacity)
    assert torch.equal(gate_idx2, gate_idx) and torch.equal(probs2, probs)
    np.testing.assert_allclose(to_np(out), np.asarray(want_out), **TOL)
    kept = to_np(keep)
    if router == "zeros":  # every expert ties: the lowest k indices, as jax.lax.top_k
        np.testing.assert_array_equal(to_np(gate_idx), np.tile(np.arange(k), (T, 1)))
    if router == "one_expert":
        assert (to_np(gate_idx)[:, 0] == 2).all()
        assert kept[:, 0].sum() == capacity and kept[:capacity, 0].all()
    if name == "capacity 1":
        assert kept.sum() == len(np.unique(to_np(gate_idx)))
    # every kept slot is used once, each expert's in phase order from 0
    s = to_np(slot)[kept]
    assert len(np.unique(s)) == len(s) and (s < e * capacity).all()
    for x in range(e):
        pos = s[s // capacity == x] % capacity
        np.testing.assert_array_equal(pos, np.arange(len(pos)))


@pytest.mark.parametrize("arch,B,S", [("mixtral-8x7b", 2, 12), ("granite-moe-3b-a800m", 3, 7)])
def test_moe_apply_and_aux_match_repro(j, arch, B, S):
    jcfg, cfg = _cfgs(j, arch)
    rng = np.random.default_rng(7)
    w = _weights(cfg, rng)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    tw = {n: torch.as_tensor(a) for n, a in w.items()}
    for capacity in (None, 2):
        want, want_aux = j.L.moe_apply(w, jcfg, x, capacity=capacity)
        got, aux = L.moe_apply(tw, cfg, torch.as_tensor(x), capacity=capacity)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # the Switch loss on given routing stats
    probs = rng.dirichlet(np.ones(cfg.moe.n_experts), 9).astype(np.float32)
    idx = rng.integers(0, cfg.moe.n_experts, (9, cfg.moe.top_k)).astype(np.int32)
    np.testing.assert_allclose(
        float(L._moe_aux(torch.as_tensor(probs), torch.as_tensor(idx).long(),
                         cfg.moe.n_experts)),
        float(j.L._moe_aux(probs, idx, jcfg.moe.n_experts)), **TOL)


def test_capacity_is_the_references():
    from repro_torch.configs import get_config

    for name in ("mixtral-8x7b", "granite-moe-3b-a800m"):
        cfg = get_config(name)
        m = cfg.moe
        for T in (1, 2, 8, 13, 8192, 16384):
            assert L.moe_capacity(cfg, T) == (int(m.capacity_factor * m.top_k * T / m.n_experts)
                                              or 1)
    # a decode step of 8 serving slots: 2 slots an expert for both
    assert L.moe_capacity(get_config("granite-moe-3b-a800m"), 8) == 2
    assert L.moe_capacity(get_config("mixtral-8x7b"), 8) == 2


def _cpu_and_card(dev, cfg, w, xt, capacity):
    got = {}
    for where in ("cpu", dev):
        out = L.moe_dispatch(torch.as_tensor(w["router"], device=where), cfg,
                             torch.as_tensor(xt, device=where), capacity)
        got[str(where)] = [to_np(t) for t in out]
    return got.values()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_moe_steps_run_on_meta(arch):
    from repro_torch.launch import steps as S

    cfg = get_smoke_config(arch)
    specs = S.input_specs(cfg, {"seq_len": 16, "global_batch": 4, "kind": "train"})
    prefill, _, _ = S.build_prefill_step(cfg, device="meta")
    logits = prefill(specs["params"], specs["batch"])
    assert logits.device.type == "meta" and logits.shape == (4, 1, L.padded_vocab(cfg))
    train, _, _ = S.build_train_step(cfg, device="meta")
    new_params, new_opt, metrics = train(**specs)
    assert train.accum == 2 and metrics["loss"].device.type == "meta"
    assert new_params["blocks"]["ffn"]["wi"].shape == specs["params"]["blocks"]["ffn"]["wi"].shape


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["random", "zeros", "one_expert"])
def test_cuda_dispatch_matches_cpu(cuda_device, router):
    cfg = get_smoke_config("granite-moe-3b-a800m").scaled(moe=MoEConfig(40, 8, 64))
    rng = np.random.default_rng(11)
    w = _weights(cfg, rng, router)
    xt = rng.standard_normal((4096, cfg.d_model)).astype(np.float32)
    if router == "one_expert":
        xt = np.abs(xt) + 0.5
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu, card = _cpu_and_card(cuda_device, cfg, w, xt, L.moe_capacity(cfg, len(xt)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, a, b in zip(("probs", "gate_vals", "gate_idx", "keep", "slot"), cpu, card):
        if name in ("probs", "gate_vals"):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.cuda
def test_cuda_combine_is_bit_identical(cuda_device):
    """granite's decode shape and a prefill-sized token set, bf16: two runs
    give the same bits (the combine adds without atomics)."""
    cfg = get_smoke_config("granite-moe-3b-a800m").scaled(
        d_model=1536, moe=MoEConfig(40, 8, 512), dtype="bfloat16")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    d, e, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.expert_ff
    p = {"router": torch.randn(d, e, generator=gen, device=cuda_device) / d ** 0.5}
    for name, shape, fan in (("wi", (e, d, ff), d), ("wg", (e, d, ff), d), ("wo", (e, ff, d), ff)):
        p[name] = (torch.randn(shape, generator=gen, device=cuda_device) / fan ** 0.5).bfloat16()
    for T in (8, 4096):
        x = torch.randn(1, T, d, generator=gen, device=cuda_device).bfloat16()
        a, aux_a = L.moe_apply(p, cfg, x)
        b, aux_b = L.moe_apply(p, cfg, x)
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)) and torch.equal(aux_a, aux_b)

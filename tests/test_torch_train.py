"""The port's training against ``repro``'s, at f32 on the smoke configs.

Parameters are drawn once by ``repro`` and carried into the port with
``params_from_numpy``; token ids, targets, masks, image tokens and
gradients are made with numpy and handed to both.  ``repro`` runs its loss
and train step with ``run={"sp": False}`` (sequence-parallel constraints
need a mesh), jitted.

* ``LM.loss`` and its gradients for one model of each family: loss within
  1e-5 relative, each parameter leaf's gradient within 2e-4 relative L2;
* ``_xent_chunked`` with a chunk that does not divide S, zeros in the mask,
  a padded vocab and codebooks;
* ``adamw_update`` over 3 steps on f32 and bf16 trees, the schedule, the
  clip and the master copy;
* the train step at accum 2 against ``repro``'s ``build_train_step`` over
  2 steps, and accum 2 against accum 1;
* ``TrainRunner``'s kill (``--crash-at``, exit 42) and resume, bit for bit;
* the autograd route of the two LM kernels (``KernelAttention``,
  ``KernelScan``) forced on the CPU with plain stand-ins for the kernels:
  a grad-requiring input gives a ``grad_fn`` and the plain version's
  gradients, a lost ``grad_fn`` raises, and ``LM.loss``'s kernel launches
  under remat are the count ``chip_smoke.py`` requires.

The reference initialises some leaves to constants (rwkv6's lerps, bonus
and decay base; mamba2's ``A_log``, ``dt_bias``, ``conv_b``, ``D``; the vlm's
tanh gates to zero); the tests give them numpy noise, the same arrays to
both packages.  JAX is imported in the fixture ``j``, so the card tests at
the end run where there is no JAX.
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, one_thread, to_np  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import kernel as ssk
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.steps import build_train_step
from repro_torch.launch.train import TrainRunner
from repro_torch.models import LM, blocks as TB, layers as TL, params_from_numpy
from repro_torch.models.lm import _xent_chunked
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

FAMILIES = ["qwen2-7b", "granite-moe-3b-a800m", "rwkv6-3b", "zamba2-1.2b",
            "llama-3.2-vision-11b", "musicgen-medium"]
NOISY = {"rwkv6-3b": {"mu": 0.5, "cmu": 0.5, "bonus": 0.5, "w0": 0.5},
         "zamba2-1.2b": {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.1, "D": 0.5}}
LOSS_RTOL, LEAF_REL_L2 = 1e-5, 2e-4
REF_RUN = {"sp": False, "loss_chunk": 16}

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one torch thread (``_torch_parity.one_thread``)."""


@pytest.fixture
def j():
    """``repro``'s side, imported inside the fixture so that the card tests
    at the end run where there is no JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.models import LM as JLM

    return jax, jnp, j_smoke, JLM


def _setup(j, arch):
    """(reference cfg, port cfg, reference params, numpy tree), once."""
    if arch not in _CACHE:
        jax, jnp, j_smoke, JLM = j
        jcfg, cfg = j_smoke(arch), get_smoke_config(arch)
        tree = jax.tree.map(np.asarray, JLM(jcfg).init(jax.random.key(0)))
        rng = np.random.default_rng(100)
        for name, scale in NOISY.get(arch, {}).items():
            leaf = tree["blocks"][name]
            tree["blocks"][name] = (leaf + scale * rng.standard_normal(leaf.shape)) \
                .astype(leaf.dtype)
        if "xattn" in tree:
            for leaves, name in ((tree["xattn"]["attn"], "gate"), (tree["xattn"], "ffn_gate")):
                leaves[name] = rng.uniform(0.3, 1.0, leaves[name].shape).astype(np.float32)
        _CACHE[arch] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree)
    return _CACHE[arch]


def _batch(cfg, rng, B, S, *, mask_zeros=False):
    shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
    b = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, shape).astype(np.int32),
         "mask": np.ones((B, S), np.float32)}
    if mask_zeros:
        b["mask"][:, ::3] = 0.0
    if cfg.xattn_every:
        b["memory"] = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return b


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _rel_l2(got, want) -> float:
    got, want = to_np(got).astype(np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaves_close(got_tree, want_leaves, what, *, small=None):
    """Each leaf within ``LEAF_REL_L2`` relative L2 (or, with ``small``,
    within ``small`` absolute where the reference's leaf has a norm below
    1e-3)."""
    got = tree_leaves(got_tree)
    assert len(got) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        w = np.asarray(w, np.float64)
        assert tuple(g.shape) == w.shape, (what, i)
        if small is not None and np.linalg.norm(w) < 1e-3:
            assert np.abs(to_np(g) - w).max() <= small, (what, i)
        else:
            assert _rel_l2(g, w) <= LEAF_REL_L2, (what, i, _rel_l2(g, w))


# ---------------------------------------------------------------------------
# (a) the loss and its gradients, one model of each family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_repro(j, arch):
    jax, jnp, _, JLM = j
    jcfg, cfg, jp, tree = _setup(j, arch)
    rng = np.random.default_rng(1)
    batch = _batch(cfg, rng, 2, 24, mask_zeros=True)
    jm = JLM(jcfg)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, run=REF_RUN)))(jp, {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_numpy(cfg, tree, device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = LM(cfg, device="cpu").loss(params, _t(batch), run={"loss_chunk": 16})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    it = iter(grads)
    _leaves_close(tree_map(lambda _: next(it), params), jax.tree.leaves(want_g), arch)


# ---------------------------------------------------------------------------
# (b) the chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tied", [("qwen2-7b", False), ("command-r-plus-104b", True),
                                       ("musicgen-medium", False)])
def test_xent_chunked_matches_repro(j, arch, tied):
    """S 20 at chunk 8 (halved to 4), a third of the mask zero, vocab 500
    padded to 512; all three losses' gradients with respect to the hidden
    states and the embedding, and a mask of zeros giving 0."""
    jax, jnp, j_smoke, _ = j
    from repro.models import layers as JL
    from repro.models.lm import _xent_chunked as j_xent

    jcfg = j_smoke(arch).scaled(vocab=500, tie_embeddings=tied)
    cfg = get_smoke_config(arch).scaled(vocab=500, tie_embeddings=tied)
    assert TL.padded_vocab(cfg) == 512
    rng = np.random.default_rng(2)
    emb = {name: (0.3 * rng.standard_normal(m.shape)).astype(np.float32)
           for name, m in JL.embed_meta(jcfg).items()}
    b = _batch(cfg, rng, 2, 20, mask_zeros=True)
    hid = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)

    def ref(e, h, mask):
        return j_xent(e, jcfg, h, jnp.asarray(b["targets"]), mask, chunk=8)

    for mask in (b["mask"], np.zeros_like(b["mask"]), None):
        jm = None if mask is None else jnp.asarray(mask)
        want, (we, wh) = jax.value_and_grad(ref, argnums=(0, 1))(emb, jnp.asarray(hid), jm)
        te = {k: torch.as_tensor(v).requires_grad_() for k, v in emb.items()}
        th = torch.as_tensor(hid).requires_grad_()
        got = _xent_chunked(te, cfg, th, torch.as_tensor(b["targets"]),
                            None if mask is None else torch.as_tensor(mask), chunk=8)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL, atol=1e-7)
        if mask is not None and not mask.any():
            assert float(got.detach()) == 0.0
            continue
        g = torch.autograd.grad(got, [th] + [te[k] for k in sorted(te)], allow_unused=True)
        assert _rel_l2(g[0], wh) <= LEAF_REL_L2
        for gk, k in zip(g[1:], sorted(te)):
            if gk is None:  # the untied table feeds no logits
                assert not np.asarray(we[k]).any(), k
            else:
                assert _rel_l2(gk, we[k]) <= LEAF_REL_L2, k


# ---------------------------------------------------------------------------
# (c) AdamW
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
ADAM_TOL = 1e-5


def _opt_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 3, 2)).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_repro(j, dtype):
    """Three updates with fresh gradients each, the clip active (norms
    about 5 against 0.5), against the reference's: parameters, m, v,
    master, count, grad_norm and lr."""
    jax, jnp, _, _ = j
    from repro.optim import AdamWConfig as JCfg, adamw_init as j_init, adamw_update as j_upd

    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    params = tree_map(lambda a: torch.as_tensor(a).to(tdt), tree)
    assert all(torch.equal(p.float(), torch.as_tensor(np.array(q, np.float32)))
               for p, q in zip(tree_leaves(params), jax.tree.leaves(jparams)))
    jstate, state = j_init(jparams), adamw_init(params)
    jcfg, cfg = JCfg(**OPT), AdamWConfig(**OPT)
    for step in range(3):
        g = jax.tree.map(lambda a: (2.0 * rng.standard_normal(a.shape)).astype(np.float32), tree)
        jparams, jstate, jm = j_upd(jcfg, jparams, jax.tree.map(jnp.asarray, g), jstate)
        params, state, m = adamw_update(cfg, params, tree_map(torch.as_tensor, g), state)
        assert int(state["count"]) == int(jstate["count"]) == step + 1
        assert state["count"].dtype == torch.int32
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=ADAM_TOL)
        assert float(jm["grad_norm"]) > cfg.clip_norm
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=ADAM_TOL)
        for name in ("m", "v", "master"):
            for got, want in zip(tree_leaves(state[name]), jax.tree.leaves(jstate[name])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=ADAM_TOL,
                                           atol=1e-7, err_msg=f"{name} step {step}")
        for got, want in zip(tree_leaves(params), jax.tree.leaves(jparams)):
            assert got.dtype == tdt
            np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                                       rtol=ADAM_TOL if dtype == "float32" else 1e-2,
                                       atol=1e-7)


def test_cosine_schedule_matches_repro(j):
    _, jnp, _, _ = j
    from repro.optim import AdamWConfig as JCfg, cosine_schedule as j_sched

    for kw in (dict(warmup_steps=100, total_steps=10_000), dict(warmup_steps=0, total_steps=1),
               dict(warmup_steps=5, total_steps=5)):
        for step in (0, 1, 2, 4, 5, 50, 100, 101, 5_000, 9_999, 10_000, 20_000):
            got = cosine_schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
            want = j_sched(JCfg(**kw), jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12,
                                       err_msg=f"{kw} step {step}")


def test_adamw_clip_and_master_copy():
    """The norm is reported before the clip; a norm under the limit is
    not scaled; the master is an f32 copy (a new buffer even for f32
    parameters) and the parameters are the master rounded to their dtype;
    the given trees are not changed."""
    p32 = {"w": torch.tensor([1.0, -2.0, 3.0])}
    st = adamw_init(p32)
    assert st["master"]["w"].data_ptr() != p32["w"].data_ptr()
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 0
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, clip_norm=1.0)
    big = {"w": torch.tensor([30.0, 40.0, 0.0])}  # norm 50: scaled by 1/50 (exact in bf16)
    small = {"w": torch.tensor([0.375, 0.5, 0.0])}  # norm 0.625: not scaled
    for g in (big, small):
        new_p, new_st, m = adamw_update(cfg, p32, g, st)
        np.testing.assert_allclose(float(m["grad_norm"]), float(g["w"].norm()), rtol=1e-6)
        # Adam's first step moves every coordinate with a nonzero gradient by lr
        step = p32["w"] - new_p["w"]
        np.testing.assert_allclose(step.numpy(), [0.1, 0.1, 0.0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(new_st["m"]["w"].numpy(),
                                   0.1 * g["w"].numpy() * min(1.0, 1.0 / float(g["w"].norm())),
                                   rtol=1e-5)
    assert torch.equal(p32["w"], torch.tensor([1.0, -2.0, 3.0])) and int(st["count"]) == 0
    pb = {"w": torch.tensor([1.0, -2.0, 3.0]).bfloat16()}
    new_p, new_st, _ = adamw_update(AdamWConfig(lr=1e-3, warmup_steps=0), pb,
                                    {"w": torch.ones(3)}, adamw_init(pb))
    assert new_st["master"]["w"].dtype == torch.float32 and new_p["w"].dtype == torch.bfloat16
    assert torch.equal(new_p["w"], new_st["master"]["w"].bfloat16())
    assert not torch.equal(new_st["master"]["w"], new_p["w"].float())  # the master keeps f32


# ---------------------------------------------------------------------------
# (d) the train step
# ---------------------------------------------------------------------------

# the step comparisons keep the gradients f32 (grad_dtype None): the bf16
# cast would turn the two packages' f32 ulp differences into whole bf16
# steps (0.4% of an element) wherever a gradient lies near a rounding
# boundary, past 2e-4 on leaves of a hundred elements; the cast itself is
# held on identical gradients by test_adamw_matches_repro
STEP_OPT = dict(warmup_steps=1, lr=1e-3, grad_dtype=None)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "granite-moe-3b-a800m"])
def test_train_step_matches_repro(j, arch):
    """Two steps at accum 2 (4 rows, 2 a microbatch) against ``repro``'s
    ``build_train_step(..., accum=2, run_overrides={"sp": False})``:
    parameters, m, v and master within 2e-4 relative L2 a leaf (1e-6
    absolute where the leaf's norm is below 1e-3), loss, grad_norm and lr."""
    jax, jnp, _, _ = j
    from repro.launch.steps import build_train_step as j_build
    from repro.optim import AdamWConfig as JCfg, adamw_init as j_init

    jcfg, cfg, jp, tree = _setup(j, arch)
    jstep, _, _ = j_build(jcfg, multi_pod=False, accum=2, opt_cfg=JCfg(**STEP_OPT),
                          run_overrides={"sp": False})
    jstep = jax.jit(jstep)
    step, _, run = build_train_step(cfg, accum=2, opt_cfg=AdamWConfig(**STEP_OPT), device="cpu")
    assert run["remat"] and run["loss_chunk"] == 512
    params = params_from_numpy(cfg, tree, device="cpu")
    jparams, jstate, state = jp, j_init(jp), adamw_init(params)
    rng = np.random.default_rng(4)
    for i in range(2):
        batch = _batch(cfg, rng, 4, 32)
        jparams, jstate, jm = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=LEAF_REL_L2,
                                       err_msg=f"{key} step {i}")
        _leaves_close(params, jax.tree.leaves(jparams), f"params {i}", small=1e-6)
        for name in ("m", "v", "master"):
            _leaves_close(state[name], jax.tree.leaves(jstate[name]), f"{name} {i}", small=1e-6)
        assert int(state["count"]) == i + 1


def test_accum_two_equals_accum_one():
    cfg = get_smoke_config("zamba2-1.2b")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, np.random.default_rng(5), 4, 32)
    outs = {}
    for accum in (1, 2):
        step, _, _ = build_train_step(cfg, accum=accum, opt_cfg=AdamWConfig(**STEP_OPT),
                                      device="cpu")
        outs[accum] = step(params, adamw_init(params), batch)
    (p1, s1, m1), (p2, s2, m2) = outs[1], outs[2]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5)
    _leaves_close(p2, [to_np(t) for t in tree_leaves(p1)], "params", small=1e-6)
    for name in ("m", "v", "master"):
        _leaves_close(s2[name], [to_np(t) for t in tree_leaves(s1[name])], name, small=1e-6)


def test_train_step_refuses_a_batch_that_does_not_split():
    cfg = get_smoke_config("qwen2-7b")
    step, model, _ = build_train_step(cfg, accum=2, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), _batch(cfg, np.random.default_rng(0), 3, 8))


# ---------------------------------------------------------------------------
# (g) kill and resume
# ---------------------------------------------------------------------------

def _runner(tmp_path, name):
    return TrainRunner(get_smoke_config("zamba2-1.2b"), ckpt_dir=str(tmp_path / name),
                       batch=4, seq=32, accum=2, seed=3, opt_cfg=AdamWConfig(warmup_steps=1),
                       device="cpu")


def _state(runner):
    return tree_leaves({"params": runner.params, "opt": runner.opt_state})


def test_kill_and_resume_is_bit_exact(tmp_path):
    """A run of 4 steps, and a run killed after step 3 (``crash_at``: exit
    42, its step-2 checkpoint written) resumed by a fresh runner: the same
    parameters, m, v, master, count and data step, bit for bit."""
    whole = _runner(tmp_path, "whole")
    assert whole.init_or_restore() == "initialized"
    losses = whole.train(4, log_every=1, save_every=2, log=lambda _: None)
    assert [s for s, _ in losses] == [1, 2, 3, 4]
    assert whole.store.steps() == [2, 4]

    killed = _runner(tmp_path, "killed")
    with pytest.raises(SystemExit) as exc:
        killed.train(4, log_every=1, save_every=2, crash_at=3, log=lambda _: None)
    assert exc.value.code == 42
    killed.store.wait()
    assert killed.store.latest_step() == 2

    resumed = _runner(tmp_path, "killed")
    assert resumed.init_or_restore() == "restored" and resumed.step == 2
    assert resumed.data.step == 2
    more = resumed.train(4, log_every=1, save_every=2, log=lambda _: None)
    assert more == losses[2:]
    assert resumed.data.step == whole.data.step == 4
    for a, b in zip(_state(resumed), _state(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_cli_crashes_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main

    args = ["--arch", "rwkv6-3b", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--save-every", "1", "--log-every", "1"]
    with pytest.raises(SystemExit) as exc:
        main(args + ["--crash-at", "2"])
    assert exc.value.code == 42
    main(args)
    out = capsys.readouterr().out
    # step 1's checkpoint is whole; step 2's async write may or may not have
    # ended when the crash came, and the resume takes the latest valid one
    assert ("restored @ step 1" in out or "restored @ step 2" in out) and "done @ step 3" in out


# ---------------------------------------------------------------------------
# (h) the kernels' autograd route, forced on the CPU
# ---------------------------------------------------------------------------

_ATTENTION, _SCAN = flash_ops.attention, ssd_ops.ssd_scan  # the real entry points


def _plain_flash(q, k, v, *, causal=True, window=None, sm_scale=None, q_offset=0):
    """A stand-in for the CUDA kernel: the plain version, with no graph (as
    the kernel's wrapper hands back), counting launches."""
    with torch.no_grad():
        out = flash_ref.mha_chunked(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                                    block_q=8, block_k=8, q_offset=q_offset)
    _plain_flash.launches += 1
    return out


def _plain_scan(q, k, v, w, *, chunk, scalar_decay, strict, h0=None, return_state=False):
    with torch.no_grad():
        out = _SCAN(q, k, v, w, chunk=chunk, scalar_decay=scalar_decay, strict=strict, h0=h0,
                    return_state=return_state, impl="reference")
    _plain_scan.launches += 1
    return out


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernels replaced by counting plain stand-ins, and the models'
    entry points sent down the kernel route on the CPU."""
    _plain_flash.launches = _plain_scan.launches = 0
    monkeypatch.setattr(fak, "flash_attention", _plain_flash)
    monkeypatch.setattr(ssk, "ssd_scan", _plain_scan)

    def attention(q, k, v, *, impl=None, **kw):
        if impl is None:
            return flash_ops.kernel_route(q, k, v, **kw)
        return _ATTENTION(q, k, v, impl=impl, **kw)

    def scan(q, k, v, w, *, impl=None, h0=None, **kw):
        if impl is None:
            return ssd_ops.kernel_route(q, k, v, w, h0, **kw)
        return _SCAN(q, k, v, w, impl=impl, h0=h0, **kw)

    monkeypatch.setattr(TL.flash_ops, "attention", attention)
    monkeypatch.setattr(TB.ssd_ops, "ssd_scan", scan)


def _grads(fn, inputs):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)).to(o)
           for i, o in enumerate(outs)]
    g = torch.autograd.grad(outs, leaves, cot)
    return outs, g


@pytest.mark.parametrize("window", [None, 5])
def test_attention_kernel_route_has_the_plain_gradient(kernel_route, window):
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(2, 4, 24, 16, generator=gen)
    k, v = (torch.randn(2, 2, 24, 16, generator=gen) for _ in range(2))
    kw = dict(causal=True, window=window, block_q=8, block_k=8)
    out, g = _grads(lambda q, k, v: flash_ops.kernel_route(q, k, v, **kw), (q, k, v))
    assert out[0].grad_fn is not None and _plain_flash.launches == 1
    want, wg = _grads(lambda q, k, v: flash_ops.attention(q, k, v, impl="reference", **kw),
                      (q, k, v))
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=0)
    for a, b in zip(g, wg):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # without grad the raw wrapper runs: no Function, no graph
    with torch.no_grad():
        assert flash_ops.kernel_route(q, k, v, **kw).grad_fn is None


@pytest.mark.parametrize("scalar,strict,h0", [(True, False, True), (False, True, False),
                                              (False, False, True)])
def test_scan_kernel_route_has_the_plain_gradient(kernel_route, scalar, strict, h0):
    gen = torch.Generator().manual_seed(7)
    B, H, S, K, V = 2, 3, 32, 8, 12
    q, k = (torch.randn(B, H, S, K, generator=gen) * 0.5 for _ in range(2))
    v = torch.randn(B, H, S, V, generator=gen) * 0.5
    w = torch.rand(B, H, S, 1 if scalar else K, generator=gen) * 0.5 + 0.45
    hs = torch.randn(B, H, K, V, generator=gen) if h0 else None
    kw = dict(chunk=8, scalar_decay=scalar, strict=strict, return_state=True)
    ins = (q, k, v, w) + ((hs,) if h0 else ())

    def route(fn):
        return lambda q, k, v, w, *h: fn(q, k, v, w, h[0] if h else None)

    out, g = _grads(route(lambda q, k, v, w, h: ssd_ops.kernel_route(q, k, v, w, h, **kw)), ins)
    assert all(o.grad_fn is not None for o in out) and _plain_scan.launches == 1
    want, wg = _grads(route(lambda q, k, v, w, h: ssd_ops.ssd_scan(
        q, k, v, w, h0=h, impl="reference", **kw)), ins)
    for a, b in zip(out + g, want + wg):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # a loss that drops the final state: y's gradient alone
    y, _ = ssd_ops.kernel_route(*(t.detach().requires_grad_() for t in (q, k, v, w)), None, **kw)
    assert y.grad_fn is not None


def test_a_lost_grad_fn_raises(kernel_route, monkeypatch):
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    monkeypatch.setattr(flash_ops.KernelAttention, "apply",
                        lambda q, k, v, *a: fak.flash_attention(q, k, v))
    with pytest.raises(RuntimeError, match="grad_fn"):
        flash_ops.kernel_route(q, q.detach(), q.detach())
    w = torch.full((1, 2, 8, 1), 0.9)
    monkeypatch.setattr(ssd_ops.KernelScan, "apply",
                        lambda q, k, v, w, h0, opts: ssk.ssd_scan(q, k, v, w, h0=h0, **opts))
    with pytest.raises(RuntimeError, match="grad_fn"):
        ssd_ops.kernel_route(q, q.detach(), q.detach(), w, None, chunk=4, scalar_decay=True,
                             strict=False, return_state=False)


@pytest.mark.parametrize("n_layers", [6, 7])
def test_loss_through_the_kernel_route(kernel_route, n_layers):
    """zamba2's loss with both kernels on the autograd route (a mamba2 tail
    at 7 layers, as at full width): the plain route's loss and gradients,
    and the launches chip_smoke.py requires of a loss and its backward
    under remat: each kernel twice a call of its forward."""
    cfg = get_smoke_config("zamba2-1.2b").scaled(n_layers=n_layers)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(8))
    batch = _t(_batch(cfg, np.random.default_rng(9), 2, 32))
    leaves = tree_leaves(params)

    def loss_grads(run):
        wrt = [t.detach().requires_grad_() for t in leaves]
        it = iter(wrt)
        loss = model.loss(tree_map(lambda _: next(it), params), batch, run=run)
        return loss, torch.autograd.grad(loss, wrt)

    loss, g = loss_grads({})
    n_shared = n_layers // cfg.shared_attn_every
    assert _plain_flash.launches == 2 * n_shared
    assert _plain_scan.launches == 2 * n_layers
    want, wg = loss_grads({"attn_impl": "reference", "scan_impl": "reference"})
    assert _plain_flash.launches == 2 * n_shared and _plain_scan.launches == 2 * n_layers
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    for a, b in zip(g, wg):
        assert _rel_l2(a, to_np(b)) <= 1e-5
    loss_grads({"remat": False})
    assert _plain_flash.launches == 3 * n_shared and _plain_scan.launches == 3 * n_layers


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_kernel_routes_have_the_plain_gradient(cuda_device):
    """Both kernels under autograd on the card, f32: outputs and gradients
    against the plain versions'."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q = torch.randn(2, 4, 256, 64, generator=gen, device=cuda_device)
    k, v = (torch.randn(2, 2, 256, 64, generator=gen, device=cuda_device) for _ in range(2))
    out, g = _grads(lambda q, k, v: flash_ops.attention(q, k, v), (q, k, v))
    assert out[0].grad_fn is not None
    want, wg = _grads(lambda q, k, v: flash_ops.attention(q, k, v, impl="reference"), (q, k, v))
    for a, b in zip(out + g, want + wg):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    w = torch.rand(2, 4, 256, 1, generator=gen, device=cuda_device) * 0.5 + 0.45
    h0 = torch.randn(2, 4, 64, 64, generator=gen, device=cuda_device)
    kw = dict(chunk=64, scalar_decay=True, return_state=True)
    ins = (q * 0.3, q.flip(2) * 0.3, q, w, h0)
    out, g = _grads(lambda q, k, v, w, h: ssd_ops.ssd_scan(q, k, v, w, h0=h, **kw), ins)
    want, wg = _grads(lambda q, k, v, w, h: ssd_ops.ssd_scan(q, k, v, w, h0=h, impl="reference",
                                                             **kw), ins)
    for a, b in zip(out + g, want + wg):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One f32 train step of the smoke zamba2 on the card (both kernels on
    the autograd route) against the same step on the CPU (plain)."""
    cfg = get_smoke_config("zamba2-1.2b")
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _batch(cfg, np.random.default_rng(11), 4, 64)
    got = {}
    for dev in ("cpu", cuda_device):
        step, _, _ = build_train_step(cfg, accum=2, opt_cfg=AdamWConfig(**STEP_OPT), device=dev)
        p = tree_map(lambda t: t.to(dev), params)
        got[str(dev)] = step(p, adamw_init(p), batch)
        if dev != "cpu":
            assert fak.flash_attention.launches > 0 and ssk.ssd_scan.launches > 0
    (pc, sc, mc), (pg, sg, mg) = got["cpu"], got[str(cuda_device)]
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]), rtol=1e-5)
    _leaves_close(sg["master"], [to_np(t) for t in tree_leaves(sc["master"])], "master",
                  small=1e-6)

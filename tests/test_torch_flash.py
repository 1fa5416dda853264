"""The port's forward attention against ``repro``'s flash attention.

On the CPU ``attention`` takes the plain chunked version; it is held against
``repro``'s ``mha_reference`` and its Pallas kernel in interpret mode at the
sweep of ``tests/test_kernels.py`` (MHA, GQA, MQA, window, Sq != Sk
non-causal, Sk off the block), in f32 and bf16, at that file's tolerances
(2e-5 and 2e-2).  Inputs are made with numpy and rounded to the working type
by each package.  ``attention(q_offset=...)`` (a q block whose rows sit at
absolute positions from ``q_offset``, the sequence-parallel layout's) is
held against ``repro``'s ``mha_chunked(q_offset=...)`` at offsets that are
and are not multiples of a block, with a window, with GQA, Sq < Sk.  The
``cuda``-marked tests hold the CUDA kernel against the plain version and run
only where there is a card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, to_np  # noqa: F401
from repro_torch.kernels.flash_attention import attention, mha_chunked, mha_reference
from repro_torch.kernels.flash_attention import kernel as flash_kernel

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SWEEP = [
    (1, 2, 2, 32, 32, 16, True, None),     # MHA causal
    (2, 4, 2, 64, 64, 32, True, None),     # GQA
    (1, 8, 1, 32, 32, 64, True, None),     # MQA
    (2, 4, 2, 64, 64, 32, True, 16),       # sliding window
    (1, 2, 2, 16, 48, 32, False, None),    # cross (Sq != Sk, no causal)
    (1, 2, 2, 32, 40, 16, True, None),     # non-multiple Sk (padding)
]
# beyond the sweep: a group of 7 (qwen2-7b's) with D = 128 and Sq off the
# kernel's 64-row tile, and rows whose keys are all masked (window past Sk)
EXTRA = [
    (1, 14, 2, 100, 100, 128, True, None),
    (1, 2, 1, 64, 16, 32, True, 8),
]
# the edges of the bf16 kernel's 128-row tiles and 64-column boxes (card
# only): Sq and Sk of 1, 127, 128, 129 and 4,100; Sq != Sk, causal and not;
# D of 8, 64, 72, 120 and 128; a group of 7; a window whose rows lie wholly
# past Sk; B * Hq * q tiles above 1,000 blocks
CUDA_EDGES = [
    (1, 2, 2, 1, 1, 64, True, None),
    (1, 2, 2, 127, 127, 128, True, None),
    (1, 2, 2, 128, 128, 72, True, None),
    (1, 4, 4, 129, 129, 8, True, None),
    (1, 7, 1, 4100, 4100, 128, True, None),
    (1, 2, 2, 129, 300, 120, False, None),
    (1, 2, 2, 300, 129, 64, True, None),
    (1, 2, 2, 127, 4100, 128, False, None),
    (1, 14, 2, 1, 4100, 128, False, None),
    (1, 2, 2, 4100, 129, 64, True, None),
    (1, 2, 1, 200, 60, 64, True, 16),
    (2, 600, 600, 16, 16, 64, True, None),
]


# q blocks at an offset: (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset),
# blocks of 16 on the CPU; the last q block, offsets off and on a block,
# GQA and MQA, a window, offset 0 with Sq < Sk, non-causal
OFFSETS = [
    (1, 2, 2, 16, 64, 16, True, None, 48),
    (2, 4, 2, 12, 48, 32, True, None, 20),
    (1, 4, 1, 24, 80, 16, True, 16, 37),
    (1, 2, 2, 8, 40, 16, True, 8, 0),
    (1, 2, 2, 10, 40, 16, False, None, 13),
]
# the same on the card, against the kernel's tiles (64 rows f32, 128 bf16):
# offsets off every tile, a window of 4,096 crossing tiles, a window
# narrower than a tile, a group of 7 at the last of 16 blocks of qwen2-7b's
# 4,096 tokens, non-causal
CUDA_OFFSETS = [
    (1, 2, 2, 100, 300, 64, True, None, 200),
    (1, 4, 2, 129, 700, 128, True, None, 517),
    (1, 14, 2, 256, 4096, 128, True, None, 3840),
    (1, 4, 1, 300, 5000, 128, True, 4096, 4700),
    (2, 4, 4, 64, 1000, 72, True, 100, 63),
    (1, 2, 2, 77, 500, 64, False, None, 11),
]


# scales that are not the default 1/sqrt(D): negative, zero and large, on a
# shape with a window (masked keys on both sides) and an edge tile
SCALES = [-0.25, 0.0]
SCALE_SHAPE = (1, 4, 2, 48, 40, 32, True, 12)
CUDA_SCALES = SCALES + [2.0]
CUDA_SCALE_SHAPES = [SCALE_SHAPE, (1, 4, 1, 300, 300, 128, True, 130)]


def _inputs(shape, seed):
    B, Hq, Hkv, Sq, Sk, D = shape[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(to_np(got), np.float32), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", SWEEP)
def test_plain_version_matches_repro(B, Hq, Hkv, Sq, Sk, D, causal, window, dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention import attention as j_attention
    from repro.kernels.flash_attention import mha_reference as j_reference

    q, k, v = _inputs((B, Hq, Hkv, Sq, Sk, D), seed=Sq * 1000 + Sk + D)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(T_DTYPES[dtype]) for a in (q, k, v))
    np.testing.assert_array_equal(to_np(tq.float()), np.asarray(jq.astype(jnp.float32)))

    want = np.asarray(j_reference(jq, jk, jv, causal=causal, window=window).astype(jnp.float32))
    interp = j_attention(jq, jk, jv, causal=causal, window=window, impl="kernel_interpret",
                         block_q=16, block_k=16)
    interp = np.asarray(jax.device_get(interp.astype(jnp.float32)))

    got = attention(tq, tk, tv, causal=causal, window=window, block_q=16, block_k=16)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    _close(got, interp, dtype)
    # the default chunk sizes and the naive version agree too
    _close(attention(tq, tk, tv, causal=causal, window=window), want, dtype)
    _close(mha_reference(tq, tk, tv, causal=causal, window=window), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", EXTRA)
def test_group_seven_and_fully_masked_rows(B, Hq, Hkv, Sq, Sk, D, causal, window, dtype):
    q, k, v = (torch.as_tensor(a).to(T_DTYPES[dtype])
               for a in _inputs((B, Hq, Hkv, Sq, Sk, D), seed=7))
    got = attention(q, k, v, causal=causal, window=window, block_q=32, block_k=16)
    want = mha_reference(q, k, v, causal=causal, window=window)
    assert not torch.isnan(got).any()
    # a row sees no key when its whole window lies past Sk: the port gives 0
    # there (mha_reference averages v over the masked keys instead)
    qpos = torch.arange(Sq)
    dead = (qpos - window + 1 > Sk - 1) if window is not None else torch.zeros(Sq, dtype=bool)
    assert torch.equal(got[:, :, dead], torch.zeros_like(got[:, :, dead]))
    _close(got[:, :, ~dead], to_np(want[:, :, ~dead].float()), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sm_scale", SCALES)
def test_plain_version_takes_any_sm_scale(sm_scale, dtype):
    """A negative or zero scale, as ``repro``'s attention takes it."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention import attention as j_attention
    from repro.kernels.flash_attention import mha_reference as j_reference

    B, Hq, Hkv, Sq, Sk, D, causal, window = SCALE_SHAPE
    q, k, v = _inputs(SCALE_SHAPE, seed=17)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(T_DTYPES[dtype]) for a in (q, k, v))
    kw = dict(causal=causal, window=window, sm_scale=sm_scale)
    want = np.asarray(j_reference(jq, jk, jv, **kw).astype(jnp.float32))
    interp = j_attention(jq, jk, jv, impl="kernel_interpret", block_q=16, block_k=16, **kw)
    interp = np.asarray(jax.device_get(interp.astype(jnp.float32)))
    got = attention(tq, tk, tv, block_q=16, block_k=16, **kw)
    _close(got, want, dtype)
    _close(got, interp, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset", OFFSETS)
def test_plain_version_at_an_offset_matches_repro(B, Hq, Hkv, Sq, Sk, D, causal, window,
                                                  q_offset, dtype):
    """``attention(q_offset=...)`` against ``repro``'s ``mha_chunked`` at the
    same offset, and a causal block against the rows it is of attention
    over a whole sequence (q made of the block and rows before it)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ref import mha_chunked as j_chunked

    q, k, v = _inputs((B, Hq, Hkv, Sq, Sk, D), seed=q_offset * 100 + Sq)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(T_DTYPES[dtype]) for a in (q, k, v))
    kw = dict(causal=causal, window=window)
    want = np.asarray(j_chunked(jq, jk, jv, q_offset=q_offset, block_q=16, block_k=16,
                                **kw).astype(jnp.float32))
    got = attention(tq, tk, tv, q_offset=q_offset, block_q=16, block_k=16, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    _close(attention(tq, tk, tv, q_offset=q_offset, **kw), want, dtype)
    if causal and q_offset + Sq <= Sk:
        full = torch.cat([torch.zeros(B, Hq, q_offset, D, dtype=tq.dtype), tq], dim=2)
        rows = attention(full, tk[:, :, :q_offset + Sq], tv[:, :, :q_offset + Sq], **kw)
        _close(got, to_np(rows[:, :, q_offset:].float()), dtype)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_block_gate_fails_a_stale_tile():
    """``chip_smoke.py``'s per-block limit on the bf16 kernel passes what a
    right kernel gives (P rounded once to bf16, the output rounded once) and
    fails a kernel whose last q tile read one KV tile's K/V from the tile
    before it, as a wrong stage of the ring would."""
    smoke = _chip_smoke()
    S, D, t = 1024, 128, smoke.FLASH_BLOCK_ROWS
    q, k, v = (torch.as_tensor(a).bfloat16() for a in _inputs((1, 4, 4, S, S, D), seed=23))
    want = attention(q, k, v, causal=True, impl="reference")
    causal = torch.ones(S, S, dtype=torch.bool).triu(1)
    s = (q.float() @ k.float().transpose(-1, -2) * D ** -0.5).masked_fill(causal, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    right = (p.bfloat16().float() @ v.float() / p.sum(-1, keepdim=True)).bfloat16()
    assert smoke.require_block_rel_l2("right", right, want) <= smoke.FLASH_BLOCK_REL_TOL
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 5 * t:6 * t], v2[:, :, 5 * t:6 * t] = k[:, :, 4 * t:5 * t], v[:, :, 4 * t:5 * t]
    stale = want.clone()
    stale[:, :, S - t:] = mha_reference(q, k2, v2, causal=True)[:, :, S - t:]
    with pytest.raises(SystemExit, match="relative L2"):
        smoke.require_block_rel_l2("stale", stale, want)


def test_chunked_defaults_to_right_aligned_causal():
    """``mha_chunked`` keeps the reference's ``q_offset = Sk - Sq`` default;
    ``attention`` counts both from 0, as the kernel does."""
    q, k, v = (torch.as_tensor(a) for a in _inputs((1, 2, 2, 8, 24, 16), seed=3))
    tail = mha_chunked(q, k, v, causal=True)
    np.testing.assert_allclose(to_np(tail), to_np(mha_chunked(q, k, v, causal=True, q_offset=16)))
    head = attention(q, k, v, causal=True)
    np.testing.assert_allclose(to_np(head), to_np(mha_reference(q, k, v, causal=True)),
                               atol=2e-5, rtol=2e-5)


def test_kernel_wrapper_checks_its_inputs():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="impl"):
        attention(q, q, q, impl="bogus")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window", SWEEP + EXTRA + CUDA_EDGES)
def test_cuda_kernel_matches_plain(cuda_device, B, Hq, Hkv, Sq, Sk, D, causal, window, dtype):
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(T_DTYPES[dtype])
               for a in _inputs((B, Hq, Hkv, Sq, Sk, D), seed=11))
    before = flash_kernel.flash_attention.launches
    got = attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    want = attention(q, k, v, causal=causal, window=window, impl="reference")
    assert not torch.isnan(got).any()
    _close(got, to_np(want.float()), dtype)
    if dtype == "bfloat16" and Sq >= 1024:  # late rows are small: hold each q tile too
        smoke = _chip_smoke()
        assert smoke.require_block_rel_l2("kernel", got, want) <= smoke.FLASH_BLOCK_REL_TOL
    if window is not None and Sq - window >= Sk:  # rows that see no key give exactly 0
        dead = torch.arange(Sq, device=cuda_device) - window + 1 > Sk - 1
        assert torch.equal(got[:, :, dead], torch.zeros_like(got[:, :, dead]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,q_offset", OFFSETS + CUDA_OFFSETS)
def test_cuda_kernel_at_an_offset_matches_plain(cuda_device, B, Hq, Hkv, Sq, Sk, D, causal,
                                                window, q_offset, dtype):
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(T_DTYPES[dtype])
               for a in _inputs((B, Hq, Hkv, Sq, Sk, D), seed=q_offset + 1))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_kernel.flash_attention.launches
    at_offset = flash_kernel.flash_attention.launches_at_offset
    got = attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + 1
    assert flash_kernel.flash_attention.launches_at_offset == at_offset + bool(q_offset)
    want = attention(q, k, v, impl="reference", **kw)
    assert torch.isfinite(got).all()
    _close(got, to_np(want.float()), dtype)
    if dtype == "bfloat16" and Sq >= 256:
        smoke = _chip_smoke()
        assert smoke.require_block_rel_l2("kernel", got, want) <= smoke.FLASH_BLOCK_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [(2, 28, 4, 1000, 1000, 128), (1, 32, 32, 700, 700, 64)])
def test_cuda_bf16_kernel_is_deterministic(cuda_device, B, Hq, Hkv, Sq, Sk, D):
    """The same inputs twice give the same bytes: no race on the stage ring."""
    q, k, v = (torch.as_tensor(a, device=cuda_device).bfloat16()
               for a in _inputs((B, Hq, Hkv, Sq, Sk, D), seed=13))
    first = flash_kernel.flash_attention(q, k, v, causal=True)
    second = flash_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sm_scale", CUDA_SCALES)
@pytest.mark.parametrize("shape", CUDA_SCALE_SHAPES)
def test_cuda_kernel_takes_any_sm_scale(cuda_device, shape, sm_scale, dtype):
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(T_DTYPES[dtype])
               for a in _inputs(shape, seed=19))
    causal, window = shape[6:]
    got = attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    want = attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale, impl="reference")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, to_np(want.float()), dtype)


@pytest.mark.cuda
def test_cuda_kernel_refuses_bad_inputs(cuda_device):
    q = torch.zeros(1, 4, 8, 16, device=cuda_device)
    k = torch.zeros(1, 3, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="Hkv"):
        flash_kernel.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        flash_kernel.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="multiple of 8"):
        x = torch.zeros(1, 4, 8, 20, device=cuda_device)
        flash_kernel.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros(4 * 8 * 16 + 1, device=cuda_device)[1:].view(1, 4, 8, 16)
        flash_kernel.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="q_offset"):
        flash_kernel.flash_attention(q, q, q, q_offset=1)  # causal: q_offset + Sq > Sk
    with pytest.raises(ValueError, match="q_offset"):
        flash_kernel.flash_attention(q, q, q, q_offset=-1, causal=False)

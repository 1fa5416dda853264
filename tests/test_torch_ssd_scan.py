"""The port's SSD / gated linear-attention scan against ``repro``'s.

On the CPU ``ssd_scan`` takes the plain chunked version; it is held against
``repro``'s Pallas kernel in interpret mode and its sequential
``linear_scan_reference`` at the sweep of ``tests/test_kernels.py``, with
both ``scalar_decay`` modes and ``strict`` both ways, in f32 within 1e-4
and bf16 within 5e-2 (that sweep's tolerances).  The initial state ``h0``
and the final state, the decode step continuing a chunked state, and the
chunk-1 case of odd lengths are held against the reference's functions at
1e-4 in f32.  ``linear_scan_passes``, the plain mirror of the CUDA
kernel's decomposition (chunk states, the state pass, chunk outputs, the
per-channel sub-chunks of 16), is held to ``repro``'s sequential reference
and interpret-mode kernel at 1e-4 in f32.  Inputs are made with numpy and
rounded to the working type by each package.  The ``cuda``-marked tests hold
the CUDA kernel against the plain version and run only where there is a
card.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, to_np  # noqa: F401
from repro_torch.kernels.ssd_scan import (
    linear_scan_chunked, linear_scan_reference, linear_scan_step, ssd_scan,
)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import linear_scan_passes

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SWEEP = [  # tests/test_kernels.py's (B, H, S, K, V, chunk, scalar)
    (1, 2, 64, 8, 8, 16, False),
    (2, 3, 128, 16, 24, 32, False),
    (2, 2, 128, 32, 32, 64, True),
    (1, 1, 256, 64, 64, 64, False),
]
# beyond the sweep: the widest head the kernel takes, S = 100 (chunk 4), an
# odd S (chunk 1), and a scalar decay at V = 24
EXTRA = [
    (1, 2, 128, 128, 128, 64, False),
    (2, 2, 100, 16, 16, 4, False),
    (1, 3, 37, 8, 24, 1, True),
]


# beyond those, for the card: S of one chunk (no state carried between chunks),
# a one-chunk scalar scan, and chunk 32 (two sub-chunks) at V 24
CUDA_EXTRA = [
    (2, 2, 64, 64, 64, 64, False),
    (1, 2, 64, 64, 64, 64, True),
    (1, 2, 96, 16, 24, 32, False),
]


def _inputs(B, H, S, K, V, scalar, seed, edges=False):
    """q, k, v at scale 0.5 and a decay in (0, 1), as the reference sweep
    draws them; ``edges`` sets the decay of some steps to exactly 1, 0
    (clamped to 1e-30) and 1e-30 in every channel."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, K)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, H, S, K)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, H, S, V)) * 0.5).astype(np.float32)
    if scalar:
        w = np.broadcast_to(rng.uniform(0.05, 1.0, (B, H, S, 1)), (B, H, S, K))
    else:
        w = rng.uniform(0.01, 1.0, (B, H, S, K))
    w = np.array(w, np.float32)
    if edges:
        w[..., ::7, :] = 1.0
        w[..., 3::11, :] = 0.0
        w[..., 5::13, :] = 1e-30
    return q, k, v, w


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(to_np(got), np.float32), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("B,H,S,K,V,chunk,scalar", SWEEP)
def test_plain_version_matches_repro(B, H, S, K, V, chunk, scalar, strict, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_reference as j_reference
    from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan

    arrs = _inputs(B, H, S, K, V, scalar, seed=S * 100 + K + V)
    jd = getattr(jnp, dtype)
    jq, jk, jv, jw = (jnp.asarray(a).astype(jd) for a in arrs)
    tq, tk, tv, tw = (torch.as_tensor(a).to(T_DTYPES[dtype]) for a in arrs)
    np.testing.assert_array_equal(to_np(tw.float()), np.asarray(jw.astype(jnp.float32)))

    want, _ = j_reference(jq, jk, jv, jw, strict=strict)
    interp = j_ssd_scan(jq, jk, jv, jw, chunk=chunk, scalar_decay=scalar, strict=strict,
                        impl="kernel_interpret")
    got = ssd_scan(tq, tk, tv, tw, chunk=chunk, scalar_decay=scalar, strict=strict)
    assert got.dtype == tq.dtype and got.shape == tv.shape
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)
    _close(got, np.asarray(interp.astype(jnp.float32)), dtype)
    _close(linear_scan_reference(tq, tk, tv, tw, strict=strict)[0],
           np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("B,H,S,K,V,chunk,scalar", SWEEP[:2] + EXTRA[1:])
def test_states_in_and_out_match_repro(B, H, S, K, V, chunk, scalar, strict):
    """``h0`` in and the final state out, on decays that include 1, 0 and
    1e-30, against ``linear_scan_chunked`` and ``linear_scan_reference``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_chunked as j_chunked
    from repro.kernels.ssd_scan import linear_scan_reference as j_reference

    arrs = _inputs(B, H, S, K, V, scalar, seed=7 + S, edges=True)
    h0 = np.random.default_rng(3).standard_normal((B, H, K, V)).astype(np.float32)
    jy, jh = j_chunked(*(jnp.asarray(a) for a in arrs), h0=jnp.asarray(h0), chunk=chunk,
                       strict=strict)
    ry, rh = j_reference(*(jnp.asarray(a) for a in arrs), h0=jnp.asarray(h0), strict=strict)
    t = [torch.as_tensor(a) for a in arrs]
    y, hT = ssd_scan(*t, chunk=chunk, scalar_decay=scalar, strict=strict,
                     h0=torch.as_tensor(h0), return_state=True)
    assert hT.dtype == torch.float32 and hT.shape == (B, H, K, V)
    for got, want in ((y, jy), (hT, jh), (y, ry), (hT, rh)):
        _close(got, np.asarray(want), "float32")
    y2, h2 = linear_scan_chunked(*t, h0=torch.as_tensor(h0), chunk=chunk, strict=strict)
    assert torch.equal(y2, y) and torch.equal(h2, hT)
    _close(linear_scan_reference(*t, h0=torch.as_tensor(h0), strict=strict)[1], np.asarray(rh),
           "float32")


@pytest.mark.parametrize("strict", [False, True])
def test_chunked_final_state_feeds_decode(strict):
    """As ``test_ssd_chunked_final_state_feeds_decode``: the chunked final
    state continued by one decode step gives the full sequence's last
    output, in both packages alike."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_step as j_step

    B, H, S, K, V = 1, 2, 64, 8, 8
    q, k, v, w = (torch.as_tensor(a) for a in _inputs(B, H, S + 1, K, V, False, seed=5))
    full, _ = linear_scan_reference(q, k, v, w, strict=strict)
    _, h = ssd_scan(q[:, :, :S], k[:, :, :S], v[:, :, :S], w[:, :, :S], chunk=16,
                    strict=strict, return_state=True)
    y, h1 = linear_scan_step(q[:, :, S], k[:, :, S], v[:, :, S], w[:, :, S], h, strict=strict)
    _close(y, to_np(full[:, :, S]), "float32")
    jy, jh1 = j_step(*(jnp.asarray(to_np(a[:, :, S])) for a in (q, k, v, w)),
                     jnp.asarray(to_np(h)), strict=strict)
    _close(y, np.asarray(jy), "float32")
    _close(h1, np.asarray(jh1), "float32")


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("B,H,S,K,V,chunk", [(2, 2, 128, 32, 32, 64), (1, 3, 37, 8, 24, 1)])
def test_one_column_scalar_decay(B, H, S, K, V, chunk, strict):
    """With ``scalar_decay`` a (B, H, S, 1) decay, as the mamba2 block
    passes it, gives exactly the result of that decay broadcast over K (on
    decays that include 1, 0 and 1e-30), and on the sweep's decays that
    result is ``repro``'s ``linear_scan_chunked``'s on the broadcast decay,
    outputs and final state (f32, 1e-4)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_chunked as j_chunked

    q, k, v, w = (torch.as_tensor(a) for a in _inputs(B, H, S, K, V, True, seed=S + K,
                                                       edges=True))
    h0 = torch.as_tensor(np.random.default_rng(4).standard_normal((B, H, K, V)),
                         dtype=torch.float32)
    kw = dict(chunk=chunk, scalar_decay=True, strict=strict, h0=h0, return_state=True)
    y1, h1 = ssd_scan(q, k, v, w[..., :1].contiguous(), **kw)
    y, h = ssd_scan(q, k, v, w, **kw)
    assert torch.equal(y1, y) and torch.equal(h1, h)
    q, k, v, w = (torch.as_tensor(a) for a in _inputs(B, H, S, K, V, True, seed=S + V))
    y1, h1 = ssd_scan(q, k, v, w[..., :1].contiguous(), **kw)
    jy, jh = j_chunked(*(jnp.asarray(to_np(t)) for t in (q, k, v, w)),
                       h0=jnp.asarray(to_np(h0)), chunk=chunk, strict=strict)
    _close(y1, np.asarray(jy), "float32")
    _close(h1, np.asarray(jh), "float32")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("B,H,S,K,V,chunk", [c[:6] for c in SWEEP + EXTRA])
def test_passes_match_repro(B, H, S, K, V, chunk, scalar, strict, with_h0):
    """The kernel's three-pass decomposition, in plain PyTorch, against
    ``repro``'s sequential reference (outputs and final state) and, without
    ``h0`` (which ``repro``'s kernel does not take), its Pallas kernel in
    interpret mode; f32 within 1e-4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_reference as j_reference
    from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan

    arrs = _inputs(B, H, S, K, V, scalar, seed=S * 100 + K + V + scalar)
    h0 = np.random.default_rng(3).standard_normal((B, H, K, V)).astype(np.float32) \
        if with_h0 else None
    y, hT = linear_scan_passes(*(torch.as_tensor(a) for a in arrs),
                               None if h0 is None else torch.as_tensor(h0), chunk=chunk,
                               strict=strict, scalar_decay=scalar)
    jy, jh = j_reference(*(jnp.asarray(a) for a in arrs),
                         h0=None if h0 is None else jnp.asarray(h0), strict=strict)
    _close(y, np.asarray(jy), "float32")
    _close(hT, np.asarray(jh), "float32")
    if h0 is None:
        interp = j_ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk, scalar_decay=scalar,
                            strict=strict, impl="kernel_interpret")
        _close(y, np.asarray(interp), "float32")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("B,H,S,K,V,chunk", [c[:6] for c in SWEEP + EXTRA])
def test_passes_match_repro_on_decay_edges(B, H, S, K, V, chunk, scalar, strict, with_h0):
    """As above on decays that include 1, 0 and 1e-30 in every channel,
    against ``repro``'s sequential reference (f32, 1e-4).  (There the
    chunked forms that sum the log-decays in f32, ``repro``'s chunked
    function and Pallas kernel among them, depart from the recurrence by
    more than 1e-4 once K is 32 or more: L falls to about -650 after ten
    steps of 1e-30, and its rounding moves the exponents.)"""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_reference as j_reference

    arrs = _inputs(B, H, S, K, V, scalar, seed=S * 100 + K + V + scalar, edges=True)
    h0 = np.random.default_rng(3).standard_normal((B, H, K, V)).astype(np.float32) \
        if with_h0 else None
    y, hT = linear_scan_passes(*(torch.as_tensor(a) for a in arrs),
                               None if h0 is None else torch.as_tensor(h0), chunk=chunk,
                               strict=strict, scalar_decay=scalar)
    jy, jh = j_reference(*(jnp.asarray(a) for a in arrs),
                         h0=None if h0 is None else jnp.asarray(h0), strict=strict)
    _close(y, np.asarray(jy), "float32")
    _close(hT, np.asarray(jh), "float32")


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_passes_stay_finite_at_tiny_decays(chunk, strict):
    """64 steps of decay 1e-30 in every channel: L falls to about -4,400
    within a chunk of 64, so a factorisation that divided by e^{L_s} would
    overflow; the decomposition stays finite and equals ``repro``'s
    sequential reference (f32, 1e-4)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.ssd_scan import linear_scan_reference as j_reference

    rng = np.random.default_rng(9)
    q, k, v = ((rng.standard_normal((1, 2, 64, 16)) * 0.5).astype(np.float32) for _ in range(3))
    w = np.full((1, 2, 64, 16), 1e-30, np.float32)
    y, hT = linear_scan_passes(*(torch.as_tensor(a) for a in (q, k, v, w)), chunk=chunk,
                               strict=strict)
    assert torch.isfinite(y).all() and torch.isfinite(hT).all()
    jy, jh = j_reference(*(jnp.asarray(a) for a in (q, k, v, w)), strict=strict)
    _close(y, np.asarray(jy), "float32")
    _close(hT, np.asarray(jh), "float32")


def test_wrapper_checks_its_inputs():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(q, q, q, q)
    with pytest.raises(ValueError, match="impl"):
        ssd_scan(q, q, q, q, impl="bogus")
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(q, q, q, q, chunk=3)


def test_package_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.kernels.ssd_scan as m\n"
        "import repro_torch.kernels.ssd_scan.kernel, repro_torch.kernels.ssd_scan.ref\n"
        "assert callable(m.ssd_scan)\n"
    )
    src_dir = str(Path(__file__).resolve().parents[1] / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": src_dir, "PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("states", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("B,H,S,K,V,chunk,scalar", SWEEP + EXTRA + CUDA_EXTRA)
def test_cuda_kernel_matches_plain(cuda_device, B, H, S, K, V, chunk, scalar, strict, dtype,
                                   states):
    """The kernel against the plain version, with an initial state and the
    final state (``states``), or with neither."""
    arrs = _inputs(B, H, S, K, V, scalar, seed=11 + S, edges=True)
    q, k, v, w = (torch.as_tensor(a, device=cuda_device).to(T_DTYPES[dtype]) for a in arrs)
    h0 = torch.randn(B, H, K, V, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)) if states else None
    before = (ssd_kernel.ssd_scan.launches, ssd_kernel.ssd_scan.calls)
    out = ssd_scan(q, k, v, w, chunk=chunk, scalar_decay=scalar, strict=strict, h0=h0,
                   return_state=states)
    torch.cuda.synchronize()
    assert (ssd_kernel.ssd_scan.launches, ssd_kernel.ssd_scan.calls) == (
        before[0] + len(ssd_kernel.PASSES), before[1] + 1)
    want, want_h = ssd_scan(q, k, v, w, chunk=chunk, strict=strict, h0=h0, return_state=True,
                            impl="reference")
    got, hT = out if states else (out, None)
    assert torch.isfinite(got.float()).all()
    _close(got, to_np(want.float()), dtype)
    if not states:
        return
    assert torch.isfinite(hT).all()
    _close(hT, to_np(want_h), dtype)
    if scalar:  # one decay a step, as the mamba2 block passes it: the same result
        got1, hT1 = ssd_scan(q, k, v, w[..., :1].contiguous(), chunk=chunk, scalar_decay=True,
                             strict=strict, h0=h0, return_state=True)
        assert torch.equal(got1, got) and torch.equal(hT1, hT)


@pytest.mark.cuda
def test_cuda_kernel_refuses_bad_inputs(cuda_device):
    q = torch.zeros(1, 2, 8, 16, device=cuda_device)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(q.half(), q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 2, 16, 8, device=cuda_device).transpose(2, 3)
        ssd_kernel.ssd_scan(x, x, x, x)
    with pytest.raises(ValueError, match="K"):
        x = torch.zeros(1, 2, 8, 129, device=cuda_device)
        ssd_kernel.ssd_scan(x, x, x, x)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.ssd_scan(q, q, q, q, chunk=128)
    with pytest.raises(ValueError, match="scalar_decay"):  # one-column w, per-channel mode
        ssd_kernel.ssd_scan(q, q, q, q[..., :1].contiguous(), chunk=8)
    with pytest.raises(ValueError, match="h0"):
        ssd_kernel.ssd_scan(q, q, q, q, chunk=8,
                            h0=torch.zeros(1, 2, 16, 16, device=cuda_device).half())

"""The port's paged decode attention against ``repro``'s.

* On the CPU ``paged_attention`` takes the plain version; it is held against
  ``repro``'s ``paged_attention_reference`` and its Pallas kernel in
  interpret mode at the sweep of ``tests/test_kernels.py`` plus a GQA group
  of 7 at D 128 (qwen2-7b's) and a group of 1 at D 64 (zamba2-1.2b's shared
  block), in f32 and bf16, at that file's tolerances (2e-5 and 2e-2).
* A sequence of length 0 gives 0, as ``repro``'s kernel does; ``repro``'s
  reference gives a mean of v there (the documented difference).
* On a serving drain of the port's engine (f32 smoke configs, with slot and
  page reuse) the plain paged version, fed the engine's own block tables
  and its cache rows copied into pages, equals the engine's dense decode
  attention, and the block tables equal those of ``repro``'s
  ``PagedKVManager`` on the same request stream.
* Tables given on the host are checked there: every refusal of the card's
  check is made with the same message before anything is uploaded, and the
  two checks count the same (CPU tests).
* The ``cuda``-marked tests hold the CUDA kernel against the plain version
  and run only where there is a card: the bf16 kernel's edges (groups, D,
  pages, lengths) on host and card tables, a call with host tables that
  makes no read from the device, host-table calls queued behind a busy
  card, and repeated calls bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from _torch_parity import cuda_device, to_np  # noqa: F401
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.models import LM
from repro_torch.models.layers import _decode_attention
from repro_torch.serving import Request, ServingEngine

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, Hq, Hkv, D, P, page, pages_per_seq)
SWEEP = [
    (2, 4, 4, 16, 8, 8, 2),      # MHA
    (3, 8, 2, 32, 16, 8, 4),     # GQA
    (1, 12, 1, 64, 8, 16, 3),    # MQA, larger pages
]
EXTRA = [
    (2, 14, 2, 128, 16, 16, 4),  # a group of 7 at D 128 (qwen2-7b)
    (3, 4, 4, 64, 12, 16, 3),    # a group of 1 at D 64 (zamba2-1.2b's shared block)
]


def _inputs(shape, seed):
    """q, k_pages, v_pages (f32), a block table with repeats where the pool
    is small (as the reference sweep draws it) and lengths in
    [1, pages * page]."""
    B, Hq, Hkv, D, P, page, pps = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    bt = rng.choice(P, size=(B, pps), replace=B * pps > P).astype(np.int32)
    sl = rng.integers(1, page * pps + 1, size=(B,)).astype(np.int32)
    return q, kp, vp, bt, sl


def _torch(arrays, dtype, device="cpu"):
    q, kp, vp, bt, sl = arrays
    cast = [torch.as_tensor(a, device=device).to(T_DTYPES[dtype]) for a in (q, kp, vp)]
    return (*cast, torch.as_tensor(bt, device=device), torch.as_tensor(sl, device=device))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(to_np(got), np.float32), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _repro(arrays, dtype, impl):
    import jax
    import jax.numpy as jnp

    from repro.kernels.paged_attention import paged_attention as j_paged

    jd = getattr(jnp, dtype)
    q, kp, vp, bt, sl = arrays
    out = j_paged(jnp.asarray(q).astype(jd), jnp.asarray(kp).astype(jd),
                  jnp.asarray(vp).astype(jd), jnp.asarray(bt), jnp.asarray(sl), impl=impl)
    return np.asarray(jax.device_get(out.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# (a) parity with repro's reference and its interpret-mode kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP + EXTRA)
def test_plain_version_matches_repro(shape, dtype):
    pytest.importorskip("jax")
    arrays = _inputs(shape, seed=sum(shape))
    tq, tk, tv, tbt, tsl = _torch(arrays, dtype)
    got = paged_attention(tq, tk, tv, tbt, tsl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, _repro(arrays, dtype, "reference"), dtype)
    _close(got, _repro(arrays, dtype, "kernel_interpret"), dtype)
    # the explicit plain route is the same function
    assert torch.equal(paged_attention(tq, tk, tv, tbt, tsl, impl="reference"), got)


# ---------------------------------------------------------------------------
# (b) a sequence of length 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_length_zero_gives_zero_as_repro_kernel(dtype):
    pytest.importorskip("jax")
    q, kp, vp, bt, sl = _inputs((3, 8, 2, 32, 16, 8, 4), seed=5)
    sl = np.array([0, 9, 0], np.int32)
    arrays = (q, kp, vp, bt, sl)
    got = paged_attention(*_torch(arrays, dtype))
    interp = _repro(arrays, dtype, "kernel_interpret")
    ref = _repro(arrays, dtype, "reference")
    _close(got, interp, dtype)
    assert np.all(to_np(got)[[0, 2]] == 0) and np.all(interp[[0, 2]] == 0)
    # the documented difference: repro's reference averages v over the
    # whole table on such a row, and agrees everywhere else
    assert np.abs(ref[[0, 2]]).max() > 1e-3
    _close(got[1], ref[1], dtype)


# ---------------------------------------------------------------------------
# (c) on the engine's own block tables, during a real drain
# ---------------------------------------------------------------------------

def _paged_check(eng, layer_kv, rng):
    """The plain paged version on the live slots' block tables, with their
    cache rows copied into pages of a pool of random rows, against the
    engine's dense decode attention; returns (block table, lengths)."""
    cache = eng.cache
    live = [s for s, r in enumerate(eng.slots) if r is not None]
    ids = [eng.slots[s].id for s in live]
    page, pps = eng.page_size, eng.max_len // eng.page_size
    table = eng.pages.block_table(ids, pps)
    start = cache["start"][live]
    lens = (cache["len"] - start).to(torch.int32)
    k_all, v_all = layer_kv
    _, hkv, _, d = k_all.shape
    kp, vp = (torch.as_tensor(rng.standard_normal((eng.pages.num_pages, page, hkv, d)),
                              dtype=k_all.dtype) for _ in range(2))
    for i, slot in enumerate(live):
        n = int(lens[i])
        assert n <= len(eng.pages.seq_pages[ids[i]]) * page  # the table covers the cache
        for j in range(-(-n // page)):
            lo = int(start[i]) + page * j
            rows = min(page, int(start[i]) + n - lo)
            kp[table[i, j], :rows] = k_all[slot, :, lo:lo + rows].transpose(0, 1)
            vp[table[i, j], :rows] = v_all[slot, :, lo:lo + rows].transpose(0, 1)
    q = torch.as_tensor(rng.standard_normal((len(live), eng.cfg.n_heads, d)), dtype=k_all.dtype)
    got = paged_attention(q, kp, vp, torch.as_tensor(table), lens)
    want = _decode_attention(q[:, :, None], k_all[live], v_all[live], cache["len"],
                             start=start)[:, :, 0]
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-5, rtol=2e-5)
    return table, lens


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b"])
def test_paged_decode_on_the_engines_block_tables(arch):
    pytest.importorskip("jax")
    from repro.serving import PagedKVManager as JManager

    cfg = get_smoke_config(arch)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, page_size=8, seed=1, device="cpu")
    jm = JManager(eng.pages.num_pages, eng.page_size)
    real_step = eng.pages.step_ops

    def both(admit, extend, finish):  # repro's manager sees the same stream
        jm.step_ops(admit, extend, finish)
        return real_step(admit, extend, finish)

    eng.pages.step_ops = both
    rng = np.random.default_rng(2)
    for i in range(5):
        eng.submit(Request(id=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(5, 12)))
                           .astype(np.int32), max_new_tokens=6))
    key = "kv" if "kv" in eng.cache else "shared_kv"
    n_attn = eng.cache[key]["k"].shape[0]
    freed, owned, checks, reused = set(), {}, 0, 0
    while eng.queue or any(s is not None for s in eng.slots):
        eng.tick()
        for seq in set(owned) - set(eng.pages.seq_pages):
            freed.update(owned.pop(seq))
        owned.update({s: list(p) for s, p in eng.pages.seq_pages.items()})
        if eng.ticks % 3 or not any(s is not None for s in eng.slots):
            continue
        for layer in (0, n_attn - 1):
            kv = eng.cache[key]
            table, lens = _paged_check(eng, (kv["k"][layer], kv["v"][layer]), rng)
        ids = [r.id for r in eng.slots if r is not None]
        np.testing.assert_array_equal(table, np.asarray(jm.block_table(ids, table.shape[1])))
        live_pages = {int(p) for i in range(len(ids))
                      for p in table[i, : -(-int(lens[i]) // eng.page_size)]}
        reused += len(live_pages & freed)
        checks += 1
    assert checks >= 4 and reused >= 1


# ---------------------------------------------------------------------------
# (d) imports, (e) refusals without a card
# ---------------------------------------------------------------------------

def test_new_modules_and_chip_smoke_import_without_jax_or_repro():
    root = Path(repro_torch.__file__).parents[2]
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path[:0] = [{str(root / 'src')!r}, {str(root)!r}]\n"
        "for m in ('repro_torch.kernels.paged_attention',\n"
        "          'repro_torch.kernels.paged_attention.ref',\n"
        "          'repro_torch.kernels.paged_attention.kernel',\n"
        "          'repro_torch.kernels.paged_attention.ops', 'chip_smoke'):\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'paged_attention' in chip_smoke.WRAPPERS\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"}, timeout=120)
    assert res.returncode == 0, res.stderr


def _small(dtype=torch.float32, B=2, Hq=4, Hkv=2, D=16, P=6, page=4, pps=3):
    q = torch.zeros(B, Hq, D, dtype=dtype)
    kp = torch.zeros(P, page, Hkv, D, dtype=dtype)
    bt = torch.zeros(B, pps, dtype=torch.int32)
    sl = torch.full((B,), page * pps, dtype=torch.int32)
    return q, kp, kp.clone(), bt, sl


def test_kernel_wrapper_refuses_without_a_card():
    q, kp, vp, bt, sl = _small()
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_attention(q, kp, vp, bt, sl)
    with pytest.raises(ValueError, match="head dim"):
        paged_kernel.paged_attention(*_small(D=136))
    with pytest.raises(ValueError, match="group"):
        paged_kernel.paged_attention(*_small(Hq=17, Hkv=1))
    with pytest.raises(TypeError):
        paged_kernel.paged_attention(q.half(), kp.half(), vp.half(), bt, sl)
    with pytest.raises(TypeError):
        paged_kernel.paged_attention(q, kp, vp, bt.long(), sl)
    with pytest.raises(ValueError, match="seq_lens"):
        paged_kernel.paged_attention(q, kp, vp, bt, sl + 1)
    with pytest.raises(ValueError, match="seq_lens"):
        paged_kernel.paged_attention(q, kp, vp, bt, sl - sl - 1)
    bad = bt.clone()
    bad[1, 1] = 6  # past the pool, on a live page
    with pytest.raises(ValueError, match="page ids"):
        paged_kernel.paged_attention(q, kp, vp, bad, sl)
    bad[1, 1] = -1
    with pytest.raises(ValueError, match="page ids"):
        paged_kernel.paged_attention(q, kp, vp, bad, sl)
    # the same id past the live pages is never read: only the card is missing
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_attention(q, kp, vp, bad, torch.tensor([12, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="impl"):
        paged_attention(q, kp, vp, bt, sl, impl="bogus")


def test_plain_version_ignores_dead_table_entries():
    """Entries past a sequence's live pages may hold anything (the kernel
    never reads them); the plain version does not read them either."""
    arrays = _inputs((3, 8, 2, 32, 16, 8, 4), seed=6)
    q, kp, vp, bt, sl = _torch(arrays, "float32")
    sl = torch.tensor([3, 8, 17], dtype=torch.int32)
    dead = bt.clone()
    dead[0, 1:] = -7
    dead[1, 1:] = 10**6
    dead[2, 3] = 16
    np.testing.assert_array_equal(to_np(paged_attention(q, kp, vp, dead, sl)),
                                  to_np(paged_attention(q, kp, vp, bt, sl)))


# the refusals of the wrapper's value check: (what, table and lengths from
# _small's, message); the same for host tables and for tables on the card
def _long(bt, sl):
    return bt, sl + 1


def _negative(bt, sl):
    return bt, sl - sl - 1


def _past_pool(bt, sl):
    bt = bt.clone()
    bt[1, 1] = 6
    return bt, sl


def _negative_id(bt, sl):
    bt = bt.clone()
    bt[0, 2] = -1
    return bt, sl


REFUSALS = [(_long, "seq_lens"), (_negative, "seq_lens"), (_past_pool, "page ids"),
            (_negative_id, "page ids")]


@pytest.mark.parametrize("bad,match", REFUSALS, ids=[f.__name__ for f, _ in REFUSALS])
def test_host_tables_are_refused_before_any_upload(monkeypatch, bad, match):
    """Host tables are refused on the host, with the message that tables on
    the card get, before anything is copied to a device."""
    def no_upload(*args):
        raise AssertionError("host tables were uploaded before the check refused them")

    monkeypatch.setattr(paged_kernel, "_upload", no_upload)
    q, kp, vp, bt, sl = _small()
    bt, sl = bad(bt, sl)
    with pytest.raises(ValueError, match=match):
        paged_kernel.paged_attention(q, kp, vp, bt, sl)
    # the same numbers, so the same refusal and message, by the route of
    # tables on the card (torch ops and one read, here on the CPU)
    assert paged_kernel._table_stats_host(bt, sl, 6, 4) == \
        paged_kernel._table_stats_device(bt, sl, 6, 4)


@pytest.mark.parametrize("seed", range(4))
def test_host_and_device_table_checks_agree(seed):
    """The host check (numpy) and the card's (torch ops) give the same
    lengths and count of bad live page ids on random tables, with ids past
    either end of the pool, live and dead."""
    rng = np.random.default_rng(seed)
    B, pps, page, P = 5, 7, 4, 20
    bt = torch.as_tensor(rng.integers(-3, P + 3, (B, pps)).astype(np.int32))
    sl = torch.as_tensor(rng.integers(0, pps * page + 1, B).astype(np.int32))
    host = paged_kernel._table_stats_host(bt, sl, P, page)
    assert host == paged_kernel._table_stats_device(bt, sl, P, page)
    live = torch.arange(pps)[None, :] * page < sl[:, None].long()
    assert host[3] == int((live & ((bt < 0) | (bt >= P))).sum())
    # a transposed view is read as it stands
    t = bt.t().contiguous().t()
    assert paged_kernel._table_stats_host(t, sl, P, page) == host
    # ids all in the pool (the host check's fast path), with garbage past
    # the longest sequence's pages and, in a shorter row, past its own
    good = torch.as_tensor(rng.integers(0, P, (B, pps)).astype(np.int32))
    cols = -(-int(sl.max()) // page)
    good[:, cols:] = -9
    for dead in (False, True):
        if dead:
            row = int(sl.argmin())
            good[row, -(-int(sl[row]) // page):cols] = P + 5
        stats = paged_kernel._table_stats_host(good, sl, P, page)
        assert stats == paged_kernel._table_stats_device(good, sl, P, page)
        assert stats[3] == 0


def _table_placements(device):
    """The plain version's inputs with the tables on the host and on ``device``."""
    arrays = _inputs((3, 14, 2, 128, 16, 16, 4), seed=8)
    q, kp, vp, bt, sl = _torch(arrays, "bfloat16", device)
    return (q, kp, vp, bt.cpu(), sl.cpu()), (q, kp, vp, bt, sl)


def test_plain_version_takes_host_tables():
    """``paged_attention`` with the tables as host tensors gives what it gives
    with them on q's device (the CPU here; the card in the ``cuda`` test)."""
    host, dev = _table_placements("cpu")
    for impl in (None, "reference"):
        assert torch.equal(paged_attention(*host, impl=impl), paged_attention(*dev, impl=impl))


# ---------------------------------------------------------------------------
# (f) the CUDA kernel, on the card only
# ---------------------------------------------------------------------------

# beyond (a): long sequences over several tiles and splits, pages of 16 as
# the engine uses, groups of 3, 12 and 16
CUDA_EXTRA = [
    (4, 28, 4, 128, 1100, 16, 260),
    (3, 32, 32, 64, 300, 16, 96),
    (2, 6, 2, 8, 40, 5, 30),
    (2, 16, 1, 120, 64, 16, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP + EXTRA + CUDA_EXTRA)
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype):
    arrays = _inputs(shape, seed=sum(shape) + 1)
    tq, tk, tv, tbt, tsl = _torch(arrays, dtype, cuda_device)
    before = paged_kernel.paged_attention.launches
    got = paged_attention(tq, tk, tv, tbt, tsl)
    torch.cuda.synchronize()
    assert paged_kernel.paged_attention.launches == before + 1
    want = paged_attention(tq, tk, tv, tbt, tsl, impl="reference")
    assert got.dtype == tq.dtype and torch.isfinite(got).all()
    _close(got, to_np(want.float()), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_edge_lengths(cuda_device, dtype):
    """Lengths 0, 1, a page boundary and the full table; repeated page ids;
    table tails zero-filled as ``PagedKVManager.block_table`` leaves them."""
    B, page, pps, P = 6, 16, 8, 20
    arrays = _inputs((B, 14, 2, 128, P, page, pps), seed=9)
    q, kp, vp, bt, _ = arrays
    sl = np.array([0, 1, page, 3 * page, page * pps, 2 * page + 5], np.int32)
    bt[1] = 3                       # one page, repeated through the table
    bt[3, 3:] = 0                   # zero-filled tail
    bt[5, :] = [4, 4, 7, 0, 0, 0, 0, 0]
    tq, tk, tv, tbt, tsl = _torch((q, kp, vp, bt, sl), dtype, cuda_device)
    got = paged_attention(tq, tk, tv, tbt, tsl)
    want = paged_attention(tq, tk, tv, tbt, tsl, impl="reference")
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, to_np(want.float()), dtype)


@pytest.mark.cuda
def test_cuda_kernel_refuses_bad_inputs(cuda_device):
    q, kp, vp, bt, sl = (t.to(cuda_device) for t in _small())
    bad = bt.clone()
    bad[0, 2] = kp.shape[0]
    with pytest.raises(ValueError, match="page ids"):
        paged_kernel.paged_attention(q, kp, vp, bad, sl)
    with pytest.raises(ValueError, match="seq_lens"):
        paged_kernel.paged_attention(q, kp, vp, bt, sl + 1)
    with pytest.raises(ValueError, match="head dim"):
        paged_kernel.paged_attention(*(t.to(cuda_device) for t in _small(D=136)))
    with pytest.raises(ValueError, match="group"):
        paged_kernel.paged_attention(*(t.to(cuda_device) for t in _small(Hq=17, Hkv=1)))
    with pytest.raises(ValueError, match="contiguous"):
        paged_kernel.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp, vp, bt, sl)
    with pytest.raises(ValueError, match="16-byte"):
        x = torch.zeros(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
        paged_kernel.paged_attention(x, kp, vp, bt, sl)


# the bf16 kernel (cp.async ring, mma.sync): groups of 1, 7, 8 and 16, D of 64
# and 128, pages of 8, 16 and 32, over scattered tables and the lengths 0, 1,
# a page - 1 and + 1, a block's tile of 64 positions - 1 and + 1, and the
# table's full length
@pytest.mark.cuda
@pytest.mark.parametrize("page", [8, 16, 32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("g", [1, 7, 8, 16])
def test_cuda_bf16_kernel_edges(cuda_device, g, D, page):
    rng = np.random.default_rng(g * 1000 + D * 10 + page)
    hkv, pps = 2, -(-300 // page)
    lens = [0, 1, page - 1, page + 1, 63, 65, pps * page, int(rng.integers(1, pps * page))]
    B = len(lens)
    P = B * pps + 7
    q = rng.standard_normal((B, g * hkv, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, hkv, D)).astype(np.float32)
    bt = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)  # scattered
    sl = np.array(lens, np.int32)
    tq, tk, tv, tbt, tsl = _torch((q, kp, vp, bt, sl), "bfloat16", cuda_device)
    want = paged_attention(tq, tk, tv, tbt, tsl, impl="reference")
    on_card = paged_attention(tq, tk, tv, tbt, tsl)
    on_host = paged_attention(tq, tk, tv, tbt.cpu(), tsl.cpu())
    torch.cuda.synchronize()
    assert torch.equal(on_card, on_host)  # one plan, one kernel
    assert torch.equal(on_card[0], torch.zeros_like(on_card[0]))
    _close(on_card, to_np(want.float()), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_host_tables_make_no_device_read(cuda_device, dtype):
    """A call with host tables neither reads from the device nor waits for
    it: under sync debug mode "error" any such read raises."""
    arrays = _inputs((4, 28, 4, 128, 1100, 16, 260), seed=12)
    q, kp, vp, bt, sl = _torch(arrays, dtype, cuda_device)
    bt, sl = bt.cpu(), sl.cpu()
    want = paged_attention(q, kp, vp, bt, sl)  # builds the library, outside the mode
    torch.cuda.synchronize()
    before = paged_kernel.paged_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = paged_attention(q, kp, vp, bt, sl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert paged_kernel.paged_attention.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_host_tables_queued_behind_work(cuda_device):
    """Host-table calls queued while the card is busy, each on other tables:
    no staging buffer is written while a launch is still to read it, so
    each call gives what its tables give on the card."""
    arrays = _inputs((4, 28, 4, 128, 1100, 16, 260), seed=14)
    q, kp, vp, _, _ = _torch(arrays, "bfloat16", cuda_device)
    rng = np.random.default_rng(14)
    tables = [(torch.as_tensor(rng.choice(1100, size=(4, 260)).astype(np.int32)),
               torch.as_tensor(rng.integers(0, 16 * 260 + 1, 4).astype(np.int32)))
              for _ in range(6)]
    want = [paged_attention(q, kp, vp, bt.to(cuda_device), sl.to(cuda_device))
            for bt, sl in tables]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # about 25 ms of the card's clock
    got = [paged_attention(q, kp, vp, bt, sl) for bt, sl in tables]
    assert len(paged_kernel._STAGING[q.device]) >= 2  # buffers were still to be read
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_bf16_kernel_repeats_exactly(cuda_device):
    """Ten calls on one input, host and card tables in turn, give one output
    bit for bit (no atomics, one plan)."""
    arrays = _inputs((4, 28, 4, 128, 1100, 16, 260), seed=13)
    q, kp, vp, bt, sl = _torch(arrays, "bfloat16", cuda_device)
    first = paged_attention(q, kp, vp, bt, sl)
    for i in range(10):
        tables = (bt, sl) if i % 2 else (bt.cpu(), sl.cpu())
        assert torch.equal(paged_attention(q, kp, vp, *tables), first)


@pytest.mark.cuda
def test_cuda_plain_version_takes_host_tables(cuda_device):
    host, dev = _table_placements(cuda_device)
    assert torch.equal(paged_attention(*host, impl="reference"),
                       paged_attention(*dev, impl="reference"))
    assert torch.equal(paged_attention(*host), paged_attention(*dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bad,match", REFUSALS, ids=[f.__name__ for f, _ in REFUSALS])
def test_cuda_refusals_on_both_routes(cuda_device, bad, match):
    """Each refusal holds for tables on the host and on the card, with one
    message, before any launch."""
    q, kp, vp, bt, sl = (t.to(cuda_device) for t in _small())
    bt, sl = bad(bt, sl)
    before = paged_kernel.paged_attention.launches
    for tables in ((bt, sl), (bt.cpu(), sl.cpu())):
        with pytest.raises(ValueError, match=match):
            paged_kernel.paged_attention(q, kp, vp, *tables)
    assert paged_kernel.paged_attention.launches == before

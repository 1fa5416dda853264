"""The four graph kernel families of the port against ``repro``'s.

On the CPU the port's wrappers take their plain versions; each is held
against ``repro``'s jnp reference and its Pallas kernel in interpret mode at
the sweep shapes of ``tests/test_kernels.py``, plus adversarial cases
(duplicates, contended slots, an all-false mask, N off every block size, the
placement overflow).  The ``cuda``-marked tests hold the CUDA kernels against
the plain versions and run only where there is a card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, to_np  # noqa: F401
from repro_torch.core.hashing import hash_vertex
from repro_torch.core.locate import claim_vertex_slots
from repro_torch.kernels.compact import masked_compact, probe_place
from repro_torch.kernels.compact import kernel as compact_kernel
from repro_torch.kernels.frontier import frontier_expand
from repro_torch.kernels.frontier import kernel as frontier_kernel
from repro_torch.kernels.hash_probe import hash_probe
from repro_torch.kernels.hash_probe import kernel as probe_kernel


@pytest.fixture
def jref():
    """``repro``'s kernel entry points; imported inside the fixture so the
    card tests below run where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.compact import masked_compact as mc
    from repro.kernels.compact import probe_place as pp
    from repro.kernels.frontier import frontier_expand as fe
    from repro.kernels.hash_probe import hash_probe as hp

    return SimpleNamespace(jnp=jnp, hash_probe=hp, masked_compact=mc, probe_place=pp,
                           frontier_expand=fe)


J_IMPLS = ("reference", "kernel_interpret")


# ---------------------------------------------------------------------------
# hash_probe
# ---------------------------------------------------------------------------

def _probe_case(cap, n, seed, dup=False):
    rng = np.random.default_rng(seed)
    present = rng.choice(10_000, size=cap // 4, replace=False).astype(np.int32)
    table, _, over, _ = claim_vertex_slots(
        torch.full((cap,), -1, dtype=torch.int32), torch.as_tensor(present),
        torch.ones(cap // 4, dtype=torch.bool),
    )
    assert not bool(over)
    absent = (10_000 + rng.integers(0, 1000, n // 2)).astype(np.int32)
    queries = np.concatenate([present[: n - n // 2], absent])
    if dup:
        queries = np.concatenate([queries, queries[: n // 3], [-1, -1]]).astype(np.int32)
    return table.numpy(), queries


@pytest.mark.parametrize("cap,n,dup", [(64, 16, False), (256, 64, False),
                                       (1024, 256, False), (256, 100, True)])
def test_hash_probe_matches_repro(jref, cap, n, dup):
    table, queries = _probe_case(cap, n, cap * 31 + n, dup)
    found, empty = hash_probe(torch.as_tensor(table), torch.as_tensor(queries))
    for impl in J_IMPLS:
        jf, je = jref.hash_probe(jref.jnp.asarray(table), jref.jnp.asarray(queries), impl=impl)
        np.testing.assert_array_equal(found.numpy(), to_np(jf), err_msg=impl)
        np.testing.assert_array_equal(empty.numpy(), to_np(je), err_msg=impl)


def test_hash_probe_full_table_has_no_empty_slot(jref):
    table = np.arange(64, dtype=np.int32)  # every slot taken
    queries = np.array([5, 100, 63, -7], np.int32)
    found, empty = hash_probe(torch.as_tensor(table), torch.as_tensor(queries))
    jf, je = jref.hash_probe(jref.jnp.asarray(table), jref.jnp.asarray(queries), impl="reference")
    np.testing.assert_array_equal(found.numpy(), to_np(jf))
    np.testing.assert_array_equal(empty.numpy(), to_np(je))
    assert (empty.numpy() == -1).all()


# ---------------------------------------------------------------------------
# masked_compact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,N,density", [(1, 64, 0.5), (3, 1000, 0.2), (6, 4096, 0.8),
                                         (2, 1000, 0.0), (4, 1537, 1.0)])
def test_masked_compact_matches_repro(jref, R, N, density):
    rng = np.random.default_rng(R * 17 + N)
    vals = rng.integers(-5, 1000, (R, N)).astype(np.int32)
    mask = rng.random(N) < density
    out, count = masked_compact(torch.as_tensor(vals), torch.as_tensor(mask), fill=-1)
    assert out.dtype == torch.int32 and count.dtype == torch.int32
    for impl in J_IMPLS:
        jo, jn = jref.masked_compact(jref.jnp.asarray(vals), jref.jnp.asarray(mask), fill=-1, impl=impl)
        np.testing.assert_array_equal(out.numpy(), to_np(jo), err_msg=impl)
        assert int(count) == int(jn) == int(mask.sum())


# ---------------------------------------------------------------------------
# probe_place
# ---------------------------------------------------------------------------

def _place_case(cap, n, seed, contended=False):
    rng = np.random.default_rng(seed)
    keys = rng.choice(100_000, n, replace=False).astype(np.int32)
    home = hash_vertex(torch.as_tensor(keys), cap).numpy()
    if contended:
        home = (home % 4).astype(np.int32)  # every lane fights over 4 homes
    active = rng.random(n) < 0.9
    return home, active


@pytest.mark.parametrize("cap,n,contended", [(64, 16, False), (256, 100, False),
                                             (1024, 500, False), (256, 60, True)])
def test_probe_place_matches_repro(jref, cap, n, contended):
    home, active = _place_case(cap, n, cap + n, contended)
    slots, over = probe_place(
        torch.as_tensor(home), torch.as_tensor(active), capacity=cap, max_probes=32
    )
    for impl in J_IMPLS:
        js, jo = jref.probe_place(
            jref.jnp.asarray(home), jref.jnp.asarray(active), capacity=cap, max_probes=32, impl=impl
        )
        np.testing.assert_array_equal(slots.numpy(), to_np(js), err_msg=impl)
        assert bool(over) == bool(jo)


def test_probe_place_overflow_is_flagged(jref):
    home = hash_vertex(torch.arange(40, dtype=torch.int32), 32).numpy()
    active = np.ones(40, bool)
    slots, over = probe_place(
        torch.as_tensor(home), torch.as_tensor(active), capacity=32, max_probes=2
    )
    for impl in J_IMPLS:
        js, jo = jref.probe_place(
            jref.jnp.asarray(home), jref.jnp.asarray(active), capacity=32, max_probes=2, impl=impl
        )
        np.testing.assert_array_equal(slots.numpy(), to_np(js), err_msg=impl)
        assert bool(over) and bool(jo)


# ---------------------------------------------------------------------------
# frontier_expand
# ---------------------------------------------------------------------------

def _frontier_case(S, C, Ce, seed):
    rng = np.random.default_rng(seed)
    frontier = rng.random((S, C)) < 0.2
    src = rng.integers(0, C, Ce).astype(np.int32)
    dst = rng.integers(0, C, Ce).astype(np.int32)
    return frontier, src, dst


@pytest.mark.parametrize("S,C,Ce", [(4, 64, 256), (8, 130, 1024), (16, 512, 4096), (3, 65, 1)])
def test_frontier_expand_matches_repro(jref, S, C, Ce):
    frontier, src, dst = _frontier_case(S, C, Ce, S * 131 + C * 7 + Ce)
    out = frontier_expand(torch.as_tensor(frontier), torch.as_tensor(src), torch.as_tensor(dst))
    for impl in J_IMPLS:
        jo = jref.frontier_expand(jref.jnp.asarray(frontier), jref.jnp.asarray(src), jref.jnp.asarray(dst), impl=impl)
        np.testing.assert_array_equal(out.numpy(), to_np(jo), err_msg=impl)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------

def _cuda(*arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n,dup", [(1024, 256, False), (256, 100, True)])
def test_hash_probe_kernel_matches_plain(cuda_device, cap, n, dup):
    table, queries = _cuda(*_probe_case(cap, n, 7, dup), device=cuda_device)
    got = probe_kernel.hash_probe(table, queries)
    want = hash_probe(table, queries, impl="reference")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def _unmix32(x: np.ndarray) -> np.ndarray:
    """The inverse of the MurmurHash3 finalizer (a bijection on uint32)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7ED1B41D)  # 0xC2B2AE35^-1 mod 2^32
    x ^= (x >> np.uint32(13)) ^ (x >> np.uint32(26))
    x *= np.uint32(0xA5CB9243)  # 0x85EBCA6B^-1 mod 2^32
    x ^= x >> np.uint32(16)
    return x


def _keys_at(homes, cap, rng):
    """int32 keys whose home slots in a table of ``cap`` are ``homes`` (the
    high bits of each hash drawn at random; a repeat is harmless)."""
    bits = cap.bit_length() - 1
    high = rng.integers(0, 1 << (32 - bits), len(homes), dtype=np.uint64)
    return _unmix32((high << np.uint64(bits)) | np.asarray(homes, np.uint64)).view(np.int32)


def _chain_case(cap, case, seed):
    """A table of ``cap`` slots and queries whose chains reach the probe
    loop's edges:

    * ``claimed``: half the slots (at most 2^17) taken by the engine's claim
      path; half the queries present;
    * ``tail``: queries whose homes lie in the last 16 slots, over a table
      whose last 16 and first 32 slots are taken, so chains go past step 3
      and wrap to slot 0;
    * ``cluster``: queries homed in 8 slots, under a run of 64 taken slots;
    * ``full``: no empty slot at all.

    A few queries are placed at probe step 7 of their chain; each case adds
    duplicate queries and the key -1 (EMPTY_KEY)."""
    rng = np.random.default_rng(seed)
    table = np.full(cap, -1, np.int32)
    if case == "claimed":
        keys = np.unique(_keys_at(rng.integers(0, cap, min(cap // 2, 1 << 17)), cap, rng))
        keys = rng.permutation(keys[keys != -1])
        table = claim_vertex_slots(torch.as_tensor(table), torch.as_tensor(keys),
                                   torch.ones(keys.size, dtype=torch.bool))[0].numpy()
        queries = np.concatenate([keys[:200], _keys_at(rng.integers(0, cap, 200), cap, rng)])
    elif case == "full":
        table[:] = _keys_at(rng.integers(0, cap, cap), cap, rng)
        queries = np.concatenate([table[rng.permutation(cap)[:50]],
                                  _keys_at(rng.integers(0, cap, 50), cap, rng)])
    else:
        c = cap - 16 if case == "tail" else cap // 2
        taken = (np.arange(-32, 16) + cap) % cap if case == "tail" else c + np.arange(64) % cap
        table[taken] = _keys_at(rng.integers(0, cap, taken.size), cap, rng)
        queries = _keys_at(c + rng.integers(0, min(cap, 16 if case == "tail" else 8), 100), cap,
                           rng)
        homes = hash_vertex(torch.as_tensor(queries[:8]), cap).numpy()
        table[(homes + 28) % cap] = queries[:8]  # present at step 7 (offset 28)
    queries = np.concatenate([queries, queries[: len(queries) // 3], [-1, -1]]).astype(np.int32)
    return table, queries


@pytest.mark.cuda
@pytest.mark.parametrize("cap,case", [(8, "claimed"), (8, "full"), (16, "claimed"), (16, "tail"),
                                      (16, "full"), (1024, "tail"), (1024, "cluster"),
                                      (1 << 23, "claimed"), (1 << 23, "tail"),
                                      (1 << 23, "cluster")])
def test_hash_probe_kernel_chains_match_plain(cuda_device, cap, case):
    """The kernel's probe loop gives the plain version's slots bit for bit on
    chains past step 3, wrapping at the table's end, in full and clustered
    tables, at caps of 8, 16 and 2^23."""
    table, queries = _cuda(*_chain_case(cap, case, cap + len(case)), device=cuda_device)
    before = probe_kernel.hash_probe.launches
    got = probe_kernel.hash_probe(table, queries)
    assert probe_kernel.hash_probe.launches == before + 1
    want = hash_probe(table, queries, impl="reference")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


def test_hash_probe_chain_cases_reach_their_edges():
    """The cases of the test above reach what they are for, on the plain
    version: chains past step 3 (offset 6) and wrapping, a full table with
    no empty slot, present and absent keys."""
    for cap, case in [(16, "tail"), (1024, "tail"), (1024, "cluster"), (1 << 23, "tail"),
                      (1 << 23, "cluster"), (16, "full"), (1 << 23, "claimed")]:
        table, queries = _chain_case(cap, case, cap + len(case))
        found, empty = hash_probe(torch.as_tensor(table), torch.as_tensor(queries))
        home = hash_vertex(torch.as_tensor(queries), cap)
        slot = torch.where(found >= 0, found, empty)
        offset = (slot - home) & (cap - 1)
        assert (found >= 0).any() and (queries == -1).any()
        if case == "full":
            assert (empty < 0).all()
        elif case == "claimed":
            assert (empty >= 0).any()
        else:
            assert ((slot >= 0) & (offset > 6)).any() or ((slot < 0).any() and cap == 16)
            if case == "tail":
                assert ((slot >= 0) & (slot < home)).any() or cap == 16  # wrapped


# beyond the first three: the one-pass kernel's 4,096-lane tiles, N of 1,
# one tile -1 and +1, and 2^23 + 17 (2,049 tiles, so the look-back crosses
# many), at densities 0, 0.01, 0.5 and 1 and R of 1 and 6
COMPACT_TILE_CASES = [(r, n, d) for n in (1, 4095, 4097, (1 << 23) + 17)
                      for d in (0.0, 0.01, 0.5, 1.0) for r in (1, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,density", [(6, 4096, 0.8), (2, 1000, 0.0), (3, 100_003, 0.3)]
                         + COMPACT_TILE_CASES)
def test_masked_compact_kernel_matches_plain(cuda_device, R, N, density):
    rng = np.random.default_rng(N)
    vals, mask = _cuda(rng.integers(-5, 1000, (R, N)).astype(np.int32),
                       rng.random(N) < density, device=cuda_device)
    before = compact_kernel.masked_compact.launches
    out, count = compact_kernel.masked_compact(vals, mask, fill=-1)
    assert compact_kernel.masked_compact.launches == before + 1
    ref, rcount = masked_compact(vals, mask, fill=-1, impl="reference")
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())
    assert int(count) == int(rcount)


@pytest.mark.cuda
def test_masked_compact_kernel_repeats_exactly(cuda_device):
    """20 calls on one input: each equals the plain version (the look-back
    and the tile counter are reset every call), one launch each."""
    rng = np.random.default_rng(5)
    n = (1 << 20) + 3
    vals, mask = _cuda(rng.integers(-5, 1000, (4, n)).astype(np.int32), rng.random(n) < 0.36,
                       device=cuda_device)
    ref, rcount = masked_compact(vals, mask, fill=-1, impl="reference")
    for _ in range(20):
        before = compact_kernel.masked_compact.launches
        out, count = compact_kernel.masked_compact(vals, mask, fill=-1)
        assert compact_kernel.masked_compact.launches == before + 1
        assert torch.equal(out, ref) and int(count) == int(rcount)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n,contended,probes", [(1024, 500, False, 32),
                                                    (256, 60, True, 32), (32, 40, False, 2)])
def test_probe_place_kernel_matches_plain(cuda_device, cap, n, contended, probes):
    home, active = _cuda(*_place_case(cap, n, 3, contended), device=cuda_device)
    got = compact_kernel.probe_place(home, active, capacity=cap, max_probes=probes)
    want = probe_place(home, active, capacity=cap, max_probes=probes, impl="reference")
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())
    assert bool(got[1]) == bool(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,Ce", [(16, 512, 4096), (3, 65, 1)])
def test_frontier_expand_kernel_matches_plain(cuda_device, S, C, Ce):
    frontier, src, dst = _cuda(*_frontier_case(S, C, Ce, 11), device=cuda_device)
    got = frontier_kernel.frontier_expand(frontier, src, dst)
    want = frontier_expand(frontier, src, dst, impl="reference")
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    """No quiet fallback: a kernel wrapper given CPU tensors raises."""
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        probe_kernel.hash_probe(t, t)
    with pytest.raises(ValueError):
        compact_kernel.masked_compact(t[None, :], t.bool(), fill=-1)
    with pytest.raises(ValueError):
        frontier_kernel.frontier_expand(t[None, :].bool(), t, t)

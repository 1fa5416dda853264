"""The redesigned graph kernels' decompositions against ``repro``.

``frontier_expand`` packs the frontier into one bit a source row and expands
every edge once over the set bits of its source column;
``frontier_expand_packed`` is that decomposition in plain PyTorch.
``probe_place`` runs every claim round in one launch, with no reset of the
claim words and a worklist of each round's losers;
``probe_place_device_rounds`` is those rounds in plain PyTorch.  Both are
held against ``repro``'s jnp reference and its Pallas kernel in interpret
mode, the rounds against a numpy copy of ``repro``'s round loop.  The
``cuda``-marked tests hold the CUDA kernels against the plain versions and
run only where there is a card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import cuda_device, to_np  # noqa: F401
from repro_torch.core.hashing import hash_vertex
from repro_torch.core.types import INT32_MAX
from repro_torch.kernels.compact import kernel as compact_kernel
from repro_torch.kernels.compact import probe_place
from repro_torch.kernels.compact.ref import probe_place_device_rounds
from repro_torch.kernels.frontier import frontier_expand
from repro_torch.kernels.frontier import kernel as frontier_kernel
from repro_torch.kernels.frontier.ref import frontier_expand_packed


@pytest.fixture
def jref():
    """``repro``'s entry points; imported inside the fixture so the card
    tests below run where there is no JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.compact import probe_place as pp
    from repro.kernels.compact.ref import probe_place_rounds
    from repro.kernels.frontier import frontier_expand as fe

    return jnp, fe, pp, probe_place_rounds


J_IMPLS = ("reference", "kernel_interpret")


# ---------------------------------------------------------------------------
# frontier_expand: pack to bits, expand over the set bits
# ---------------------------------------------------------------------------

def _frontier_case(S, C, Ce, seed, order):
    """Random frontier and edges; the sentinel column C - 1 is on some
    frontiers and is the source and destination of some edges."""
    rng = np.random.default_rng(seed)
    frontier = rng.random((S, C)) < 0.25
    frontier[::3, C - 1] = True
    src = rng.integers(0, C, Ce).astype(np.int32)
    dst = rng.integers(0, C, Ce).astype(np.int32)
    src[::7] = C - 1
    dst[::5] = C - 1
    if order == "sorted":  # as the CSR hands them over
        keep = np.argsort(src, kind="stable")
        src, dst = src[keep], dst[keep]
    return frontier, src, dst


FRONTIER_CASES = [("sorted", 70, 400), ("unsorted", 70, 400), ("no edges", 33, 0)]


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 256])
@pytest.mark.parametrize("order,C,Ce", FRONTIER_CASES)
def test_frontier_expand_packed_matches_repro(jref, S, order, C, Ce):
    jnp, fe, _, _ = jref
    frontier, src, dst = _frontier_case(S, C, Ce, S * 7 + Ce, order)
    out = frontier_expand_packed(torch.as_tensor(frontier), torch.as_tensor(src),
                                 torch.as_tensor(dst))
    assert out.dtype == torch.int32 and out.shape == (S, C)
    for impl in J_IMPLS:
        want = fe(jnp.asarray(frontier), jnp.asarray(src), jnp.asarray(dst), impl=impl)
        np.testing.assert_array_equal(out.numpy(), to_np(want), err_msg=impl)
    if Ce == 0:
        assert (out.numpy() == INT32_MAX).all()


def test_frontier_expand_packed_all_false_frontier():
    _, src, dst = _frontier_case(40, 50, 300, 3, "unsorted")
    out = frontier_expand_packed(torch.zeros((40, 50), dtype=torch.bool), torch.as_tensor(src),
                                 torch.as_tensor(dst))
    assert (out.numpy() == INT32_MAX).all()


# ---------------------------------------------------------------------------
# probe_place: every round in one launch, no reset, a worklist
# ---------------------------------------------------------------------------

def _rounds_np(home, active, cap, max_probes):
    """``repro``'s round loop (``probe_place_rounds``) in numpy, with its
    per-round claim reset, returning (slots, overflow, rounds, the slots
    claimed in each round)."""
    m = home.shape[0]
    occ = np.zeros(cap, bool)
    slots = np.full(m, -1, np.int32)
    pending = active.copy()
    claimed = []
    rounds = 0
    while rounds < m and pending.any():
        cand = np.full(m, -1, np.int64)
        for step in range(max_probes):
            s = (home.astype(np.int64) + step * (step + 1) // 2) & (cap - 1)
            take = pending & (cand < 0) & ~occ[s]
            cand = np.where(take, s, cand)
        has = pending & (cand >= 0)
        rounds += 1
        if not has.any():
            break
        claim = np.full(cap, INT32_MAX, np.int64)
        np.minimum.at(claim, cand[has], np.flatnonzero(has))
        claimed.append(set(cand[has].tolist()))
        winner = has & (claim[np.where(has, cand, 0)] == np.arange(m))
        occ[cand[winner]] = True
        slots[winner] = cand[winner]
        pending &= ~winner
    return slots, bool(pending.any()), rounds, claimed


def _place_case(cap, m, seed, homes=None, density=0.9):
    rng = np.random.default_rng(seed)
    keys = rng.choice(max(100_000, 4 * m), m, replace=False).astype(np.int32)
    home = hash_vertex(torch.as_tensor(keys), cap).numpy()
    if homes:
        home = (home % homes).astype(np.int32)  # every lane fights over a few homes
    return home, rng.random(m) < density


# (cap, m, max_probes, homes, density): m off every block size, m of 1, no
# lane active, max_probes 2 with overflow, every lane contending for 4 homes
PLACE_CASES = [(64, 16, 32, None, 0.9), (1024, 515, 32, None, 0.9), (64, 1, 32, None, 1.0),
               (128, 40, 32, None, 0.0), (32, 40, 2, None, 1.0), (256, 60, 32, 4, 1.0),
               (64, 64, 32, 4, 1.0), (4096, 1537, 32, None, 0.7)]


@pytest.mark.parametrize("cap,m,probes,homes,density", PLACE_CASES)
def test_probe_place_device_rounds_matches_repro(jref, cap, m, probes, homes, density):
    jnp, _, pp, probe_place_rounds = jref
    home, active = _place_case(cap, m, cap + m, homes, density)
    slots, over, rounds = probe_place_device_rounds(
        torch.as_tensor(home), torch.as_tensor(active), capacity=cap, max_probes=probes)
    js, jo = probe_place_rounds(jnp.asarray(home), jnp.asarray(active), capacity=cap,
                                max_probes=probes)
    np.testing.assert_array_equal(slots.numpy(), to_np(js))
    assert bool(over) == bool(jo)
    for impl in J_IMPLS:
        ks, ko = pp(jnp.asarray(home), jnp.asarray(active), capacity=cap, max_probes=probes,
                    impl=impl)
        np.testing.assert_array_equal(slots.numpy(), to_np(ks), err_msg=impl)
        assert bool(over) == bool(ko)
    n_slots, n_over, n_rounds, _ = _rounds_np(home, active, cap, probes)
    np.testing.assert_array_equal(n_slots, to_np(js))  # the numpy loop is repro's
    assert n_over == bool(jo) and rounds == n_rounds
    if (cap, probes) == (32, 2):
        assert bool(over)


@settings(max_examples=60, deadline=None)
@given(log_cap=st.integers(0, 7), m=st.integers(1, 90), probes=st.integers(1, 12),
       homes=st.sampled_from([None, 1, 2, 4]), density=st.sampled_from([0.3, 1.0]),
       seed=st.integers(0, 2**16))
def test_no_claim_word_is_written_in_two_rounds(log_cap, m, probes, homes, density, seed):
    """Why the kernel resets no claim word: a slot claimed in one round is
    occupied by its lowest claimant, so no later round claims it.  The
    mirror without the reset equals the loop with it, round for round."""
    cap = 1 << log_cap
    rng = np.random.default_rng(seed)
    home = rng.integers(0, cap, m).astype(np.int32) if homes is None else \
        rng.integers(0, homes, m).astype(np.int32)
    active = rng.random(m) < density
    n_slots, n_over, n_rounds, claimed = _rounds_np(home, active, cap, probes)
    for a in range(len(claimed)):
        for b in range(a + 1, len(claimed)):
            assert not claimed[a] & claimed[b]
    slots, over, rounds = probe_place_device_rounds(
        torch.as_tensor(home), torch.as_tensor(active), capacity=cap, max_probes=probes)
    np.testing.assert_array_equal(slots.numpy(), n_slots)
    assert bool(over) == n_over and rounds == n_rounds


def test_probe_place_wrapper_refuses_cpu_tensors():
    """No quiet fallback: the kernel wrapper given CPU tensors raises."""
    with pytest.raises(ValueError):
        compact_kernel.probe_place(torch.zeros(8, dtype=torch.int32),
                                   torch.ones(8, dtype=torch.bool), capacity=16, max_probes=4)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [33, 256])
@pytest.mark.parametrize("order,C,Ce", [("unsorted", 70, 400), ("sorted", 4099, 50_000),
                                        ("unsorted", 4099, 50_000), ("no edges", 33, 0)])
def test_frontier_expand_kernel_two_launches(cuda_device, S, order, C, Ce):
    frontier, src, dst = (torch.as_tensor(a, device=cuda_device)
                          for a in _frontier_case(S, C, Ce, S + C, order))
    before = frontier_kernel.frontier_expand.launches
    got = frontier_kernel.frontier_expand(frontier, src, dst)
    assert frontier_kernel.frontier_expand.launches == before + 2
    want = frontier_expand(frontier, src, dst, impl="reference")
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cap,m,probes,homes,density",
                         PLACE_CASES + [(1 << 21, (1 << 20) + 3, 32, None, 0.9)])
def test_probe_place_kernel_one_launch(cuda_device, cap, m, probes, homes, density):
    home, active = _place_case(cap, m, 5, homes, density)
    want = probe_place_device_rounds(torch.as_tensor(home), torch.as_tensor(active),
                                     capacity=cap, max_probes=probes)
    h, a = torch.as_tensor(home, device=cuda_device), torch.as_tensor(active, device=cuda_device)
    plain = probe_place(h, a, capacity=cap, max_probes=probes, impl="reference")
    np.testing.assert_array_equal(want[0].numpy(), plain[0].cpu().numpy())
    before = compact_kernel.probe_place.launches
    compact_kernel.probe_place(h, a, capacity=cap, max_probes=probes)  # makes the counter
    r0 = int(compact_kernel.probe_place.rounds)
    slots, over = compact_kernel.probe_place(h, a, capacity=cap, max_probes=probes)
    assert compact_kernel.probe_place.launches == before + 2
    assert int(compact_kernel.probe_place.rounds) - r0 == want[2]
    np.testing.assert_array_equal(slots.cpu().numpy(), want[0].numpy())
    assert bool(over) == bool(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [(1 << 20) + 3, 1])
def test_probe_place_kernel_repeats_exactly(cuda_device, m):
    """20 calls on one input: each equals the plain version (the control
    words and the worklists are reset every call), one launch each."""
    cap = 1 << 21
    home, active = _place_case(cap, m, 9, None, 1.0)
    h, a = torch.as_tensor(home, device=cuda_device), torch.as_tensor(active, device=cuda_device)
    want = probe_place(h, a, capacity=cap, max_probes=32, impl="reference")
    for _ in range(20):
        before = compact_kernel.probe_place.launches
        slots, over = compact_kernel.probe_place(h, a, capacity=cap, max_probes=32)
        assert compact_kernel.probe_place.launches == before + 1
        assert torch.equal(slots, want[0]) and bool(over) == bool(want[1])

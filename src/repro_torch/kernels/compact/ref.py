"""Plain PyTorch versions of the state-maintenance compaction primitives.

* :func:`masked_compact_reference` — stable stream compaction: keep the
  columns of ``values`` whose ``mask`` lane is set, in lane order, and fill
  the rest.  One ``cumsum`` turns the mask into scatter positions.

* :func:`probe_place_reference` — claim-round placement of distinct
  pre-hashed keys into an empty power-of-two table: every pending lane probes
  its triangular chain for the first unoccupied slot, contended slots go to
  the lowest lane index (scatter-min), winners occupy, losers re-probe.  The
  lowest pending lane always wins its slot, so every round places at least
  one key.  Stops when nothing is pending, when a round had no candidate at
  all, or after ``m`` rounds — the stop rules of
  ``repro.kernels.compact.ref.probe_place_rounds``.

* :func:`probe_place_device_rounds` — the same placement as the CUDA kernel
  runs it (tagged claim words never reset, no occupancy array, a worklist
  of the losers), with its round count; for the tests, nothing on the main
  path calls it.
"""

from __future__ import annotations

import torch

from ...core.hashing import probe_slot
from ...core.types import INT32_MAX


def masked_compact_reference(
    values: torch.Tensor,  # i32[R, N] — R payload rows sharing one mask
    mask: torch.Tensor,    # bool[N]
    *,
    fill: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out i32[R, N], count i32[]): ``out[:, :count]`` is ``values[:, mask]``
    in lane order; the tail is ``fill``."""
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    out = torch.full(values.shape, fill, dtype=values.dtype, device=values.device)
    out[:, pos[mask].long()] = values[:, mask]
    return out, mask.sum().to(torch.int32)


def probe_place_reference(
    home: torch.Tensor,    # i32[m] — pre-hashed home slots
    active: torch.Tensor,  # bool[m] — lanes that carry a key to place
    *,
    capacity: int,
    max_probes: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots i32[m], overflow bool[]); ``slots[i] == -1`` where inactive or
    unplaced."""
    m = home.shape[0]
    dev = home.device
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    occ = torch.zeros(capacity, dtype=torch.bool, device=dev)
    slots = torch.full((m,), -1, dtype=torch.int32, device=dev)
    pending = active.clone()
    rounds = 0
    while rounds < m and bool(pending.any()):
        cand = torch.full((m,), -1, dtype=torch.int32, device=dev)
        for step in range(max_probes):
            s = probe_slot(home, step, capacity)
            take = pending & (cand < 0) & ~occ[s.long()]
            cand = torch.where(take, s, cand)
        has = pending & (cand >= 0)
        rounds += 1
        if not bool(has.any()):
            break  # no candidate anywhere: no winner can ever appear again
        safe = torch.where(has, cand, 0).long()
        claim = torch.full((capacity,), INT32_MAX, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, safe, torch.where(has, idx, INT32_MAX), "amin")
        winner = has & (claim[safe] == idx)
        occ[cand[winner].long()] = True
        slots = torch.where(winner, cand, slots)
        pending = pending & ~winner
    return slots, pending.any()


def probe_place_device_rounds(
    home: torch.Tensor,    # i32[m] — pre-hashed home slots
    active: torch.Tensor,  # bool[m] — lanes that carry a key to place
    *,
    capacity: int,
    max_probes: int,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The rounds as the CUDA kernel runs them, in plain PyTorch, for the
    tests: (slots i32[m], overflow bool[], rounds).  Each slot has one
    32-bit claim word, filled once a call and never reset: a lane tagged in
    its top two bits with the parity of the round that claimed, or with
    "taken" once its winner has settled.  A slot's lowest claimant always
    wins it, so the word of a slot claimed in an earlier round marks it
    taken and no occupancy array is kept.  A round settles the previous
    round (a lane won iff its slot's word holds its own tag) and its losers
    claim again; the stop rule is the reference's.  Equals
    :func:`probe_place_reference`, with the same number of rounds."""
    m = home.shape[0]
    dev = home.device
    no_claim, taken = 0xFFFFFFFF, 2 << 30  # held as int64
    claim = torch.full((capacity,), no_claim, dtype=torch.int64, device=dev)
    slots = torch.full((m,), -1, dtype=torch.int32, device=dev)

    def claims(lanes, rnd):  # round rnd's candidates, every earlier claim final
        h = home[lanes]
        cand = torch.full_like(lanes, -1)
        for step in range(max_probes):
            s = probe_slot(h, step, capacity)
            word = claim[s.long()]
            free = (word == no_claim) | (word >> 30 == rnd % 2)
            cand = torch.where((cand < 0) & free, s, cand)
        has = cand >= 0
        claim.scatter_reduce_(0, cand[has].long(), (rnd % 2 << 30) | lanes[has].long(), "amin")
        return cand

    work = torch.arange(m, dtype=torch.int32, device=dev)[active]
    if not work.numel():
        return slots, torch.tensor(False, device=dev), 0
    cand, rounds, rnd = claims(work, 0), 1, 0
    while bool((cand >= 0).any()):
        won = (cand >= 0) & (claim[cand.clamp(min=0).long()] == (rnd % 2 << 30) | work.long())
        slots[work[won].long()] = cand[won]
        claim[cand[won].long()] = taken | work[won].long()
        work = work[~won]
        if not work.numel() or rounds >= m:
            break
        rnd += 1
        cand, rounds = claims(work, rnd), rounds + 1
    return slots, torch.tensor(work.numel() > 0, device=dev), rounds

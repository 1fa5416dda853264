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

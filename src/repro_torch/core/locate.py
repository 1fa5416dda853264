"""Bounded-probe locate and scatter-claim insertion for the hash tables.

Port of ``repro.core.locate``.  ``locate_*`` is the engine's analogue of the
paper's ``WFLocateVertex`` / ``WFLocateEdge``: for every query key, the slot
holding the key (live or tombstone) or the first empty slot of its probe
chain.  The chain is capped at MAX_PROBES; a locate that would exceed the cap
sets ``overflow`` and the host grows the table.

:func:`locate_vertices` runs on the ``hash_probe`` kernel family — the CUDA
kernel for tensors on the card — and then applies the ``active`` mask to its
outputs, which is exactly what ``repro``'s jnp ``_locate`` computes.
:func:`locate_edges` and :func:`_claim_slots` are plain tensor code, as they
are jnp (not Pallas) in ``repro``.

``_claim_slots`` is deterministic parallel insertion: every pending key
scatters its priority into its candidate slot, the lowest query index wins,
losers re-probe.  Rounds are bounded by MAX_INSERT_ROUNDS; each round reads
one flag back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# the family's ops module, not its names: either package may be imported first
from ..kernels.hash_probe import ops as hash_probe_ops
from .hashing import hash_edge, hash_vertex, probe_slot
from .types import EMPTY_KEY, INT32_MAX, MAX_INSERT_ROUNDS, MAX_PROBES


class LocateResult(NamedTuple):
    slot: torch.Tensor         # i32[n] slot holding the key, or -1
    found: torch.Tensor        # bool[n]
    insert_slot: torch.Tensor  # i32[n] first empty slot on the chain, or -1
    overflow: torch.Tensor     # bool[] any active probe chain exhausted


def _finish(found_slot, empty_slot, active) -> LocateResult:
    overflow = (active & (found_slot < 0) & (empty_slot < 0)).any()
    return LocateResult(found_slot, found_slot >= 0, empty_slot, overflow)


def locate_vertices(
    v_key: torch.Tensor, keys: torch.Tensor, active: torch.Tensor
) -> LocateResult:
    found, empty = hash_probe_ops.hash_probe(v_key, keys)
    found = torch.where(active, found, -1)
    empty = torch.where(active, empty, -1)
    return _finish(found, empty, active)


def locate_edges(
    e_key_u: torch.Tensor,
    e_key_v: torch.Tensor,
    us: torch.Tensor,
    vs: torch.Tensor,
    active: torch.Tensor,
) -> LocateResult:
    cap = e_key_u.shape[0]
    home = hash_edge(us, vs, cap)
    found = torch.full_like(home, -1)
    empty = torch.full_like(home, -1)
    for step in range(MAX_PROBES):
        pending = (found < 0) & (empty < 0) & active
        s = probe_slot(home, step, cap)
        sl = s.long()
        ku = e_key_u[sl]
        is_match = (ku == us) & (e_key_v[sl] == vs) & active
        found = torch.where(pending & is_match, s, found)
        empty = torch.where(pending & (ku == EMPTY_KEY) & ~is_match, s, empty)
    return _finish(found, empty, active)


def _claim_slots(
    key_cols: Tuple[torch.Tensor, ...],
    query_cols: Tuple[torch.Tensor, ...],
    home: torch.Tensor,
    want: torch.Tensor,
):
    """Insert unique new keys into empty slots, deterministically.

    key_cols:   the table's key column(s) — (v_key,) or (e_key_u, e_key_v).
    query_cols: matching per-query key column(s); ``home`` their home slots.
    want: bool[n] — which queries need insertion (mutually distinct keys,
          absent from the table).

    Returns (key_cols, slots i32[n] (-1 where not wanted/failed), overflow
    bool[], rounds i32[]).  The given columns are never written: the first
    round clones them.
    """
    n = want.shape[0]
    dev = want.device
    cap = key_cols[0].shape[0]
    slots = torch.full((n,), -1, dtype=torch.int32, device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    pending = want
    rounds = 0
    while rounds < MAX_INSERT_ROUNDS and bool(pending.any()):
        if rounds == 0:
            key_cols = tuple(c.clone() for c in key_cols)
        first_col = key_cols[0]
        # bounded probe for the first empty slot on each pending chain
        cand = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for step in range(MAX_PROBES):
            s = probe_slot(home, step, cap)
            take = pending & (cand < 0) & (first_col[s.long()] == EMPTY_KEY)
            cand = torch.where(take, s, cand)
        has_cand = pending & (cand >= 0)
        safe_cand = torch.where(has_cand, cand, 0).long()

        # scatter-claim: lowest query index wins each contended slot
        claim = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, safe_cand, torch.where(has_cand, idx, INT32_MAX), "amin")
        winner = has_cand & (claim[safe_cand] == idx)

        wslot = cand[winner].long()
        for col, qcol in zip(key_cols, query_cols):
            col[wslot] = qcol[winner]
        slots = torch.where(winner, cand, slots)
        pending = pending & ~winner
        rounds += 1
    rounds_t = torch.tensor(rounds, dtype=torch.int32, device=dev)
    return key_cols, slots, pending.any(), rounds_t


def claim_vertex_slots(v_key, query_keys, want):
    home = hash_vertex(query_keys, v_key.shape[0])
    cols, slots, overflow, rounds = _claim_slots((v_key,), (query_keys,), home, want)
    return cols[0], slots, overflow, rounds


def claim_edge_slots(e_key_u, e_key_v, qu, qv, want):
    home = hash_edge(qu, qv, e_key_u.shape[0])
    cols, slots, overflow, rounds = _claim_slots((e_key_u, e_key_v), (qu, qv), home, want)
    return cols[0], cols[1], slots, overflow, rounds

"""State maintenance: the growth rehash (live-compact).

Port of the rehash half of ``repro.core.maintenance``.  A rehash masks the
live vertices and the incarnation-valid live edges, compacts them in
table-slot order (``masked_compact``), and re-inserts them into the grown
tables by claim-round placement (``probe_place``) — Harris physical
deletion, batched.  Placement is bounded by ``MAX_PROBES``, the engine's own
locate bound, so every placed key is locatable by construction; a placement
that would exceed it reports ``ok=False`` and the caller grows further.

Implementations (``impl``):

* ``"host"`` — :func:`rehash_host`, vectorized numpy claim rounds with the
  identical discipline: the reference every device path must match bit for
  bit.
* ``"device"`` — the :mod:`repro_torch.kernels.compact` primitives on the
  state's device: the CUDA kernels on the card, their plain versions on the
  CPU.
* ``None`` — ``"device"``.

A rehash linearizes at the batch boundary that triggered it: the caller
discards the overflowing post-state and re-applies the same batch against
the grown pre-state, so no operation observes a half-compacted table.

The snapshot-compact (``with_csr``) branch, the delta merge and the
sharded ``endpoints`` override wait for the delta and sharding slices; the
compaction therefore carries only the rows the new tables need (no old-slot
rows, which only the snapshot-compact reads).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# the family's ops module, not its names: either package may be imported first
from ..kernels.compact import ops as compact_ops
from .hashing import edge_hash32_np, hash_edge, hash_vertex, vertex_hash32_np
from .traversal import _edge_validity
from .types import ABSENT_INC, EMPTY_KEY, MAX_PROBES, GraphState

MAINTENANCE_IMPLS = (None, "host", "device")

_I32 = torch.int32


def resolve_impl(impl: Optional[str]) -> str:
    """``None`` -> ``"device"``."""
    if impl not in MAINTENANCE_IMPLS:
        raise ValueError(f"unknown maintenance impl {impl!r}")
    return impl or "device"


# ---------------------------------------------------------------------------
# host oracle: vectorized numpy claim rounds (the bit-identity reference)
# ---------------------------------------------------------------------------


def _vhome_np(keys: np.ndarray, capacity: int) -> np.ndarray:
    return (vertex_hash32_np(keys) & np.uint32(capacity - 1)).astype(np.int32)


def _ehome_np(us: np.ndarray, vs: np.ndarray, capacity: int) -> np.ndarray:
    return (edge_hash32_np(us, vs) & np.uint32(capacity - 1)).astype(np.int32)


def _probe_place_host(
    home: np.ndarray, capacity: int, max_probes: int
) -> Tuple[np.ndarray, bool]:
    """numpy claim rounds for all-active lanes: identical rounds, claims and
    tie-breaks to ``probe_place``, so the placement is bit-identical."""
    m = home.shape[0]
    occ = np.zeros(capacity, bool)
    slots = np.full(m, -1, np.int32)
    pending = np.ones(m, bool)
    idx = np.arange(m, dtype=np.int64)
    int_max = np.iinfo(np.int32).max
    rounds = 0
    while pending.any() and rounds < m:
        cand = np.full(m, -1, np.int32)
        for step in range(max_probes):
            s = (home + step * (step + 1) // 2) & (capacity - 1)
            take = pending & (cand < 0) & ~occ[s]
            cand[take] = s[take]
        has = pending & (cand >= 0)
        if not has.any():
            break  # no candidate anywhere: overflow
        claim = np.full(capacity, int_max, np.int64)
        np.minimum.at(claim, cand[has], idx[has])
        safe = np.where(has, cand, 0)
        winner = has & (claim[safe] == idx)
        occ[cand[winner]] = True
        slots[winner] = cand[winner]
        pending &= ~winner
        rounds += 1
    return slots, bool(pending.any())


def rehash_host(state: GraphState, new_vcap: int, new_ecap: int) -> Tuple[GraphState, bool]:
    """Grow + compact on the host (numpy): keep live vertices (with
    incarnations) and incarnation-valid live edges only.  The new state is
    built on ``state``'s device."""
    v_key = state.v_key.cpu().numpy()
    v_live = state.v_live.cpu().numpy()
    v_inc = state.v_inc.cpu().numpy()

    v_sel = np.flatnonzero(v_live)  # compaction order = table-slot order
    keys = v_key[v_sel]
    incs = v_inc[v_sel]
    vslots, v_over = _probe_place_host(_vhome_np(keys, new_vcap), new_vcap, MAX_PROBES)

    n_vkey = np.full(new_vcap, EMPTY_KEY, np.int32)
    n_vlive = np.zeros(new_vcap, bool)
    n_vinc = np.full(new_vcap, ABSENT_INC, np.int32)
    placed = vslots >= 0
    n_vkey[vslots[placed]] = keys[placed]
    n_vinc[vslots[placed]] = incs[placed]
    n_vlive[vslots[placed]] = True

    # edge validity: live lane AND both endpoints live at the bound
    # incarnation (binary search over the sorted live keys)
    e_ku = state.e_key_u.cpu().numpy()
    e_kv = state.e_key_v.cpu().numpy()
    e_live = state.e_live.cpu().numpy()
    e_bu = state.e_inc_u.cpu().numpy()
    e_bv = state.e_inc_v.cpu().numpy()

    order = np.argsort(keys, kind="stable")
    sk, si = keys[order], incs[order]

    def inc_now(qs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if sk.size == 0:
            return np.zeros(qs.shape, bool), np.zeros(qs.shape, np.int32)
        pos = np.searchsorted(sk, qs)
        pos_c = np.minimum(pos, sk.size - 1)
        found = (pos < sk.size) & (sk[pos_c] == qs)
        return found, si[pos_c]

    e_sel = np.flatnonzero(e_live)
    fu, iu = inc_now(e_ku[e_sel])
    fv, iv = inc_now(e_kv[e_sel])
    valid = fu & fv & (iu == e_bu[e_sel]) & (iv == e_bv[e_sel])
    e_sel = e_sel[valid]  # stale edges: physical deletion

    eslots, e_over = _probe_place_host(
        _ehome_np(e_ku[e_sel], e_kv[e_sel], new_ecap), new_ecap, MAX_PROBES
    )
    n_eku = np.full(new_ecap, EMPTY_KEY, np.int32)
    n_ekv = np.full(new_ecap, EMPTY_KEY, np.int32)
    n_elive = np.zeros(new_ecap, bool)
    n_ebu = np.full(new_ecap, ABSENT_INC, np.int32)
    n_ebv = np.full(new_ecap, ABSENT_INC, np.int32)
    eplaced = eslots >= 0
    n_eku[eslots[eplaced]] = e_ku[e_sel][eplaced]
    n_ekv[eslots[eplaced]] = e_kv[e_sel][eplaced]
    n_ebu[eslots[eplaced]] = e_bu[e_sel][eplaced]
    n_ebv[eslots[eplaced]] = e_bv[e_sel][eplaced]
    n_elive[eslots[eplaced]] = True

    dev = state.device
    new_state = GraphState(
        *(torch.as_tensor(a, device=dev)
          for a in (n_vkey, n_vlive, n_vinc, n_eku, n_ekv, n_elive, n_ebu, n_ebv))
    )
    return new_state, not (v_over or e_over)


# ---------------------------------------------------------------------------
# device live-compact
# ---------------------------------------------------------------------------


def _place_rows(rows, count, capacity: int, home_fn, fills):
    """Place the first ``count`` compacted lanes of ``rows`` (key rows first)
    into fresh ``capacity``-slot columns.  Returns (columns, live, overflow)."""
    dev = rows.device
    active = torch.arange(rows.shape[1], dtype=_I32, device=dev) < count
    home = torch.where(active, home_fn(rows), 0)
    slots, overflow = compact_ops.probe_place(
        home, active, capacity=capacity, max_probes=MAX_PROBES
    )
    placed = active & (slots >= 0)
    where = slots[placed].long()
    cols = []
    for row, fill in zip(rows, fills):
        col = torch.full((capacity,), fill, dtype=_I32, device=dev)
        col[where] = row[placed]
        cols.append(col)
    live = torch.zeros(capacity, dtype=torch.bool, device=dev)
    live[where] = True
    return cols, live, overflow


def _rehash_device(state: GraphState, new_vcap: int, new_ecap: int):
    # vertices: compact live lanes in slot order, place into the new table
    vcomp, n_v = compact_ops.masked_compact(
        torch.stack([state.v_key, state.v_inc]), state.v_live, fill=-1
    )
    (n_vkey, n_vinc), n_vlive, v_over = _place_rows(
        vcomp, n_v, new_vcap, lambda r: hash_vertex(r[0], new_vcap),
        (EMPTY_KEY, ABSENT_INC),
    )

    # edges: mask stale bindings, compact, place
    _, _, valid = _edge_validity(state)
    ecomp, n_e = compact_ops.masked_compact(
        torch.stack([state.e_key_u, state.e_key_v, state.e_inc_u, state.e_inc_v]),
        valid,
        fill=-1,
    )
    (n_eku, n_ekv, n_ebu, n_ebv), n_elive, e_over = _place_rows(
        ecomp, n_e, new_ecap, lambda r: hash_edge(r[0], r[1], new_ecap),
        (EMPTY_KEY, EMPTY_KEY, ABSENT_INC, ABSENT_INC),
    )

    new_state = GraphState(
        v_key=n_vkey, v_live=n_vlive, v_inc=n_vinc,
        e_key_u=n_eku, e_key_v=n_ekv, e_live=n_elive, e_inc_u=n_ebu, e_inc_v=n_ebv,
    )
    return new_state, not bool(v_over | e_over)


def rehash(
    state: GraphState, new_vcap: int, new_ecap: int, *, impl: Optional[str] = None
) -> Tuple[GraphState, bool]:
    """Grow + compact into fresh ``(new_vcap, new_ecap)`` tables.

    Returns ``(new_state, ok)``; ``ok=False`` means a probe chain would have
    exceeded ``MAX_PROBES`` — discard the new state and grow further.  Both
    impls are bit-identical."""
    if resolve_impl(impl) == "host":
        return rehash_host(state, new_vcap, new_ecap)
    return _rehash_device(state, new_vcap, new_ecap)

"""State maintenance: the growth rehash, the snapshot-compact and the CSR
delta merge.

Port of ``repro.core.maintenance``, three operations on the
:mod:`repro_torch.kernels.compact` primitives:

1. **live-compact** (:func:`rehash`) — mask the live vertices and the
   incarnation-valid live edges, compact them in table-slot order
   (``masked_compact``), and re-insert them into the grown tables by
   claim-round placement (``probe_place``) — Harris physical deletion,
   batched.  Placement is bounded by ``MAX_PROBES``, the engine's own locate
   bound, so every placed key is locatable by construction; a placement
   that would exceed it reports ``ok=False`` and the caller grows further.
2. **snapshot-compact** (``rehash(..., with_csr=True)``) — the compaction
   carries every vertex's old slot and every surviving edge's old endpoint
   slots, so an old-slot → new-slot map gives the new state's
   :class:`TraversalCSR` with one stable argsort and no locate: a growth
   hands the delta queue its snapshot.  Bit-identical to ``build_csr`` of
   the new state.
3. **delta merge** (:func:`delta_merge`) — the device half of
   :func:`repro_torch.core.traversal.apply_delta`: compact the surviving
   lanes, sort the O(batch) delta, and merge it into the surviving runs with
   ``searchsorted``.  Its composite ``(src, lane)`` keys are int64, so
   unlike the reference (int32 keys, x64 off) it applies at every capacity
   below ``2**63`` slots squared (:func:`merge_keys_fit`).

Implementations (``impl``):

* ``"host"`` — :func:`rehash_host`, vectorized numpy claim rounds with the
  identical discipline, and the numpy splice of ``apply_delta``: the
  reference every device path must match bit for bit.
* ``"device"`` — the compact primitives on the state's device: the CUDA
  kernels on the card, their plain versions on the CPU.
* ``None`` — ``"device"``.

A rehash linearizes at the batch boundary that triggered it: the caller
discards the overflowing post-state and re-applies the same batch against
the grown pre-state, so no operation observes a half-compacted table.  A
``delta_merge`` inherits the linearization point of the CSR it folds into.
Under hash-prefix sharding (:mod:`repro_torch.core.sharding`) each shard
rehashes its own tables with this code, except that edge validity is judged
against the *global* sorted endpoint index (``rehash(..., endpoints=...)``):
an edge's endpoints generally live on other shards.

Telemetry: :func:`rehash` records a ``maintenance.rehash`` counter and a
``maintenance.rehash.<impl>`` span, and the host placement a
``maintenance.claim_rounds`` histogram, into the active registry
(:mod:`repro_torch.obs`); none of it alters the tables.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# ambient telemetry: a no-op unless a registry is active (obs.metrics imports
# nothing of repro_torch.core)
from ..obs import metrics as obsm
# the family's ops module, not its names: either package may be imported first
from ..kernels.compact import ops as compact_ops
from .hashing import edge_hash32_np, hash_edge, hash_vertex, vertex_hash32_np
from .traversal import TraversalCSR, _delta_probe_parts, _edge_validity, build_csr
from .types import ABSENT_INC, EMPTY_KEY, MAX_PROBES, GraphState

MAINTENANCE_IMPLS = (None, "host", "device")

# Composite (src, lane) merge keys are int64 below this bound; past it the
# delta fold takes the host splice (as the reference does past 2**31).
_MERGE_KEY_LIMIT = 2**63
_INT64_MAX = 2**63 - 1

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
    obsm.hist("maintenance.claim_rounds", rounds)
    return slots, bool(pending.any())


def rehash_host(
    state: GraphState, new_vcap: int, new_ecap: int, endpoints=None
) -> Tuple[GraphState, bool]:
    """Grow + compact on the host (numpy): keep live vertices (with
    incarnations) and incarnation-valid live edges only.  The new state is
    built on ``state``'s device.

    ``endpoints``, when given, is the sorted global ``(keys, incs)`` live
    vertex index (numpy or tensors) that edge validity is judged against
    instead of this state's own vertex table: the partitioned-shard case
    (:func:`repro_torch.core.sharding.gather_live_vertices`)."""
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

    if endpoints is None:
        order = np.argsort(keys, kind="stable")
        sk, si = keys[order], incs[order]
    else:
        sk, si = (e.cpu().numpy() if isinstance(e, torch.Tensor) else np.asarray(e)
                  for e in endpoints)

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
    into fresh ``capacity``-slot columns, one column a fill.  Returns
    (columns, live, overflow, slots, active), ``slots`` -1 where unplaced."""
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
    return cols, live, overflow, slots, active


def _edge_validity_sorted(state: GraphState, sorted_key: torch.Tensor,
                          sorted_inc: torch.Tensor) -> torch.Tensor:
    """Edge validity against an external sorted ``(key, inc)`` endpoint
    index: the device twin of ``rehash_host``'s lookup under ``endpoints``.
    (The reference pads the index to a power of two so that ``jit``
    compiles once; its INT32_MAX padding keys can never validate an edge, so
    the unpadded index gives the same mask.)"""
    n = sorted_key.shape[0]
    if n == 0:
        return torch.zeros(state.e_capacity, dtype=torch.bool, device=state.device)

    def look(q):
        pos = torch.searchsorted(sorted_key, q)
        pc = pos.clamp(max=n - 1)
        return (pos < n) & (sorted_key[pc] == q), sorted_inc[pc]

    fu, iu = look(state.e_key_u)
    fv, iv = look(state.e_key_v)
    return state.e_live & fu & fv & (iu == state.e_inc_u) & (iv == state.e_inc_v)


def _rehash_device(state: GraphState, new_vcap: int, new_ecap: int, with_csr: bool,
                   endpoints=None):
    cv_old = state.v_capacity
    dev = state.device

    # vertices: compact live lanes (with their old slots) in slot order, place
    vcomp, n_v = compact_ops.masked_compact(
        torch.stack([state.v_key, state.v_inc, torch.arange(cv_old, dtype=_I32, device=dev)]),
        state.v_live,
        fill=-1,
    )
    (n_vkey, n_vinc), n_vlive, v_over, vslots, v_active = _place_rows(
        vcomp, n_v, new_vcap, lambda r: hash_vertex(r[0], new_vcap),
        (EMPTY_KEY, ABSENT_INC),
    )

    # edges: mask stale bindings, compact (with the old endpoint slots, which
    # only the snapshot-compact reads), place
    rows = [state.e_key_u, state.e_key_v, state.e_inc_u, state.e_inc_v]
    if endpoints is None:
        su_old, sv_old, valid = _edge_validity(state)
        rows += [su_old, sv_old]
    else:
        # partitioned shard: endpoints judged against the global index
        sk, si = (torch.as_tensor(e, device=dev) for e in endpoints)
        valid = _edge_validity_sorted(state, sk, si)
    ecomp, n_e = compact_ops.masked_compact(torch.stack(rows), valid, fill=-1)
    (n_eku, n_ekv, n_ebu, n_ebv), n_elive, e_over, eslots, e_active = _place_rows(
        ecomp, n_e, new_ecap, lambda r: hash_edge(r[0], r[1], new_ecap),
        (EMPTY_KEY, EMPTY_KEY, ABSENT_INC, ABSENT_INC),
    )

    new_state = GraphState(
        v_key=n_vkey, v_live=n_vlive, v_inc=n_vinc,
        e_key_u=n_eku, e_key_v=n_ekv, e_live=n_elive, e_inc_u=n_ebu, e_inc_v=n_ebv,
    )
    ok = not bool(v_over | e_over)
    if not with_csr:
        return new_state, None, ok

    # snapshot-compact: every compacted edge knows its endpoints' old slots,
    # and old2new turns them into new ones, so only build_csr's argsort
    # remains
    old2new = torch.full((cv_old + 1,), new_vcap, dtype=_I32, device=dev)
    old2new[vcomp[2][v_active].long()] = vslots[v_active]
    e_placed = e_active & (eslots >= 0)
    where = eslots[e_placed].long()
    src_lane = torch.full((new_ecap,), new_vcap, dtype=_I32, device=dev)
    dst_lane = torch.full((new_ecap,), new_vcap, dtype=_I32, device=dev)
    src_lane[where] = old2new[ecomp[4][e_placed].long()]
    dst_lane[where] = old2new[ecomp[5][e_placed].long()]
    order = torch.argsort(src_lane, stable=True)
    src = src_lane[order]
    rows = torch.arange(new_vcap, dtype=_I32, device=dev)
    csr = TraversalCSR(
        v_key=n_vkey,
        v_live=n_vlive,
        v_inc=n_vinc,
        n_live=n_v,
        src=src,
        dst=dst_lane[order],
        lane=order.to(_I32),
        row_start=torch.searchsorted(src, rows, right=False).to(_I32),
        row_end=torch.searchsorted(src, rows, right=True).to(_I32),
        n_edges=n_e,
    )
    return new_state, csr, ok


def rehash(
    state: GraphState,
    new_vcap: int,
    new_ecap: int,
    *,
    impl: Optional[str] = None,
    with_csr: bool = False,
    endpoints=None,
) -> Tuple[GraphState, Optional[TraversalCSR], bool]:
    """Grow + compact into fresh ``(new_vcap, new_ecap)`` tables.

    Returns ``(new_state, csr, ok)``.  ``csr`` is the new state's
    :class:`TraversalCSR` when ``with_csr`` (bit-identical to
    ``build_csr(new_state)``; the host impl builds it, and only when ``ok``),
    else ``None``.  ``ok=False`` means a probe chain would have exceeded
    ``MAX_PROBES`` — discard the new state and grow further.  Both impls are
    bit-identical.

    ``endpoints`` — the sorted global ``(keys, incs)`` live vertex index,
    numpy or tensors — replaces the state's own vertex table as the edge
    validity reference: the partitioned-shard case.  It excludes
    ``with_csr`` (the snapshot-compact's slot map is local; a sharded
    graph's snapshot is rebuilt by
    :func:`repro_torch.core.sharding.fuse_partitioned`)."""
    impl = resolve_impl(impl)
    if endpoints is not None and with_csr:
        raise ValueError("rehash: the snapshot-compact needs local endpoints")
    with obsm.span(f"maintenance.rehash.{impl}"):
        obsm.counter("maintenance.rehash")
        if impl == "host":
            new_state, ok = rehash_host(state, new_vcap, new_ecap, endpoints)
            csr = build_csr(new_state) if (with_csr and ok) else None
            return new_state, csr, ok
        return _rehash_device(state, new_vcap, new_ecap, with_csr, endpoints)


# ---------------------------------------------------------------------------
# device delta merge (the searchsorted splice of apply_delta)
# ---------------------------------------------------------------------------


def merge_keys_fit(cv: int, ce: int) -> bool:
    """Whether the composite ``src * ce + lane`` merge keys (at most
    ``cv * ce - 1``) stay below the int64 sentinel: the device merge's
    applicability guard."""
    return cv * ce < _MERGE_KEY_LIMIT


def _drop_set(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, write: torch.Tensor):
    """``buf[idx[i]] = vals[i]`` where ``write[i]``, for a ``buf`` with one
    spare slot at its end that takes every unwritten lane (the reference's
    ``mode="drop"`` scatter, with no read back to the host)."""
    spare = buf.shape[0] - 1
    buf[torch.where(write, idx, spare).long()] = vals


def _delta_merge_device(csr: TraversalCSR, state: GraphState, keys: torch.Tensor,
                        nv: int, ne: int) -> TraversalCSR:
    cv, ce = csr.v_capacity, csr.e_capacity
    dev = keys.device
    p = _delta_probe_parts(state, keys[:nv], keys[nv:nv + ne], keys[nv + ne:])

    # vertices whose (live, inc) changed invalidate every lane bound to them
    v_l = p.v_slot.long()
    changed = p.v_found & ((csr.v_live[v_l] != p.v_live_now) | (csr.v_inc[v_l] != p.v_inc_now))
    hit = torch.zeros(cv + 2, dtype=torch.bool, device=dev)
    _drop_set(hit, p.v_slot, torch.ones_like(changed), changed)

    # every touched edge key is re-derived from the post state: drop its old
    # entry (if any) so the merge below is the single source
    ltouch = torch.zeros(ce + 1, dtype=torch.bool, device=dev)
    _drop_set(ltouch, p.e_lane, torch.ones_like(p.e_found), p.e_found)

    lanes = torch.arange(ce, dtype=_I32, device=dev)
    src_l = csr.src.long()
    keep = ((lanes < csr.n_edges) & ~(hit[src_l] | hit[csr.dst.long()])
            & ~ltouch[csr.lane.long()])
    scomp, n_keep = compact_ops.masked_compact(
        torch.stack([csr.src, csr.dst, csr.lane]), keep, fill=0
    )
    s_src, s_dst, s_lane = scomp
    s_active = lanes < n_keep
    s_key = torch.where(s_active, s_src.long() * ce + s_lane, _INT64_MAX)

    # the O(batch) delta, sorted by the (src, lane) order of the rebuild's
    # stable argsort
    ins = p.e_found & p.e_valid
    d_key0 = torch.where(ins, p.e_su.long() * ce + p.e_lane, _INT64_MAX)
    d_key, dorder = torch.sort(d_key0, stable=True)
    d_src, d_dst, d_lane, d_ins = p.e_su[dorder], p.e_sv[dorder], p.e_lane[dorder], ins[dorder]
    n_ins = ins.sum().to(_I32)

    # searchsorted merge: keys are distinct (lanes are), so each side's final
    # position is its own rank plus the other side's count of smaller keys
    pos_s = lanes + torch.searchsorted(d_key, s_key).to(_I32)
    d_rank = torch.arange(d_key.shape[0], dtype=_I32, device=dev)
    pos_d = d_rank + torch.searchsorted(s_key, d_key).to(_I32)

    out_src = torch.full((ce + 1,), cv, dtype=_I32, device=dev)
    out_dst = torch.full((ce + 1,), cv, dtype=_I32, device=dev)
    out_lane = torch.zeros(ce + 1, dtype=_I32, device=dev)
    for out, s_vals, d_vals in ((out_src, s_src, d_src), (out_dst, s_dst, d_dst),
                                (out_lane, s_lane, d_lane)):
        _drop_set(out, pos_s, s_vals, s_active)
        _drop_set(out, pos_d, d_vals, d_ins)

    # tail: the unused lanes in ascending order, exactly where the rebuild's
    # stable argsort leaves the invalid lanes
    n_valid = n_keep + n_ins
    lane_used = torch.zeros(ce + 1, dtype=torch.bool, device=dev)
    _drop_set(lane_used, s_lane, torch.ones_like(s_active), s_active)
    _drop_set(lane_used, d_lane, torch.ones_like(d_ins), d_ins)
    ucomp, n_unused = compact_ops.masked_compact(lanes[None, :], ~lane_used[:ce], fill=0)
    _drop_set(out_lane, n_valid + lanes, ucomp[0], lanes < n_unused)

    out_src = out_src[:ce]
    rows = torch.arange(cv, dtype=_I32, device=dev)
    return TraversalCSR(
        v_key=state.v_key,
        v_live=state.v_live,
        v_inc=state.v_inc,
        n_live=p.n_live,
        src=out_src,
        dst=out_dst[:ce],
        lane=out_lane[:ce],
        row_start=torch.searchsorted(out_src, rows, right=False).to(_I32),
        row_end=torch.searchsorted(out_src, rows, right=True).to(_I32),
        n_edges=n_valid,
    )


def delta_merge(
    csr: TraversalCSR, state: GraphState, pack: np.ndarray, nv: int, ne: int
) -> TraversalCSR:
    """Fold the (deduplicated, bucket-padded, packed ``vkeys | e_us | e_vs``)
    touched keys into ``csr`` on the state's device — the searchsorted splice
    of :func:`repro_torch.core.traversal.apply_delta`, with one host-to-device
    transfer and none back.  Callers own the fallback guards (capacity
    change, delta footprint, :func:`merge_keys_fit`); bit-identity to
    ``build_csr(state)`` holds by construction."""
    keys = torch.as_tensor(pack, device=state.device)
    return _delta_merge_device(csr, state, keys, nv, ne)

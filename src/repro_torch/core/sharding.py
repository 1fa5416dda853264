"""Hash-prefix sharding of the graph tables.

Port of ``repro.core.sharding``.  ``S`` unmodified per-shard
:class:`~repro_torch.core.types.GraphState` instances make one graph:

**Partition rule.**  Both tables partition by the *prefix* of the same
32-bit hash whose *suffix* the probe sequence uses as the home slot
(:mod:`repro_torch.core.hashing`):

* an edge key ``(u, v)`` lives in shard ``edge_hash32(u, v) >> (32 - log2 S)``;
* a vertex key ``u`` lives in shard ``vertex_hash32(u) >> (32 - log2 S)``.

Prefix and suffix are disjoint bit fields for any per-shard capacity
≤ ``2**(32 - log2 S)``, so every shard runs the unchanged locate
(``hash_probe``), placement (``probe_place``) and rehash
(``masked_compact``): no kernel knows sharding exists.  No vertex is
replicated.

**Batch routing** (:func:`route_ops`, numpy on the host through the numpy
hash twins).  Each lane has one *owner* shard — the vertex owner for vertex
ops, the edge owner for edge ops — and each shard receives its owned lanes,
compacted, with their global phase stamps.

**Stabbing wave.**  Edge ops must observe endpoint liveness at their own
phase, and an edge's endpoints generally live on other shards: every edge
lane emits two ``(endpoint, phase)`` queries, each owner answers from its
own vertex transitions (:func:`repro_torch.core.engine.answer_stabs`), and
the gathered answers feed the edge owner's edge wave.

**Fusion** (:func:`fuse_partitioned`).  Per-shard vertex tables have
private slot spaces, so a cross-shard snapshot needs one canonical global
vertex directory: the union of live ``(key, inc)`` pairs placed into a
fresh table by priority-ordered claim rounds (priority = key order).  It
depends only on the live vertex set, so ``n_shards ∈ {1, 2, 4}`` give
snapshots over the identical slot space and identical answers.  Edge lanes
from all shards are validated against the directory and sorted into one
CSR.

The directory and the fusion run on the shards' device: a masked select, a
concatenation and a stable argsort gather the live vertices, ``probe_place``
(the CUDA kernel on the card) places them, ``searchsorted`` validates the
edges against the sorted keys, and one stable argsort of the source slots
orders them, as :func:`~repro_torch.core.traversal.build_csr` does.
``impl="host"`` (the graph's ``maintenance_impl``) takes the reference's
numpy route instead; both give the same directory and snapshot field for
field.

**Linearization:** a cross-shard snapshot is the fusion of the S shard
states after every shard installed its post-batch tables; shards partition
both key spaces, so the fused CSR is a consistent cut at that batch
boundary.

**Placement.**  A mesh is a list of devices; :func:`place_shards` puts
shard ``i`` on ``mesh[i % len(mesh)]`` (round-robin), and each shard's waves
run on its device.  The cross-shard steps run on the first shard's device
(``mesh[0]``), with explicit copies: the stabbing wave's answers are
gathered there, and so are the live vertices (:func:`gather_live_vertices`)
and the edge columns (:func:`_edge_columns`) that the directory and the
fused snapshot are made of.  Placement never changes a value.
:func:`host_local_mesh` lists every local device of a type, as
``jax.devices()`` does; a mesh naming a ``meta`` device, or a card that is
not there, raises.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.compact import ops as compact_ops
from . import maintenance
from .hashing import edge_hash32_np, hash_vertex, vertex_hash32_np
from .traversal import TraversalCSR
from .types import (
    ABSENT_INC,
    EDGE_OPS,
    EMPTY_KEY,
    GROW_LOAD_FACTOR,
    MAX_PROBES,
    OP_NOP,
    VERTEX_OPS,
    GraphState,
    is_pow2,
    make_state,
)

_I32 = torch.int32
Array = Union[np.ndarray, torch.Tensor]


def _check_shards(n_shards: int) -> None:
    if not is_pow2(n_shards):
        raise ValueError("n_shards must be a power of two")


def shard_of_edges(us: np.ndarray, vs: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard per edge key: the top ``log2 n_shards`` bits (prefix) of
    the same 32-bit hash whose suffix is the probe home slot."""
    _check_shards(n_shards)
    us = np.asarray(us, np.int32)
    if n_shards == 1:
        return np.zeros(us.shape, np.int32)
    k = n_shards.bit_length() - 1
    return (edge_hash32_np(us, np.asarray(vs, np.int32)) >> np.uint32(32 - k)).astype(
        np.int32
    )


def shard_of_vertices(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Owner shard per vertex key: the top ``log2 n_shards`` bits of
    ``vertex_hash32``."""
    _check_shards(n_shards)
    keys = np.asarray(keys, np.int32)
    if n_shards == 1:
        return np.zeros(keys.shape, np.int32)
    k = n_shards.bit_length() - 1
    return (vertex_hash32_np(keys) >> np.uint32(32 - k)).astype(np.int32)


def route_ops(
    ops: np.ndarray, us: np.ndarray, vs: np.ndarray, n_shards: int
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Partition a batch's lanes by owner shard.

    Returns ``(shard_idx, owner)``: ``owner[i]`` is the shard that owns lane
    ``i`` (vertex owner for vertex ops, edge owner for edge ops, 0 for
    NOPs), and ``shard_idx[s]`` the ascending lane indices (int64) of shard
    ``s``'s owned non-NOP lanes.  Each lane appears in exactly one list."""
    ops = np.asarray(ops, np.int32)
    us = np.asarray(us, np.int32)
    vs = np.asarray(vs, np.int32)
    owner = np.zeros(ops.shape, np.int32)
    is_vop = np.isin(ops, VERTEX_OPS)
    is_eop = np.isin(ops, EDGE_OPS)
    owner[is_vop] = shard_of_vertices(us[is_vop], n_shards)
    owner[is_eop] = shard_of_edges(us[is_eop], vs[is_eop], n_shards)
    active = ops != OP_NOP
    shard_idx = [
        np.flatnonzero(active & (owner == s)).astype(np.int64)
        for s in range(n_shards)
    ]
    return shard_idx, owner


def make_shard_states(
    v_shard_capacity: int, e_shard_capacity: int, n_shards: int, device="cpu"
) -> List[GraphState]:
    """Fresh empty shards, each holding a ``1/n_shards`` partition of both
    key spaces."""
    return [make_state(v_shard_capacity, e_shard_capacity, device=device)
            for _ in range(n_shards)]


# ---------------------------------------------------------------------------
# canonical global vertex directory + cross-shard snapshot fusion
# ---------------------------------------------------------------------------


class VertexDirectory(NamedTuple):
    """A canonical global vertex table over the union of the shards' live
    vertices — the slot space cross-shard snapshots traverse in.

    Placement depends on the live key *set* alone (keys ascending,
    priority-ordered claim rounds, capacity the smallest power of two ≥ 64
    within ``GROW_LOAD_FACTOR``).  ``sorted_*`` hold the same content as a
    binary-searchable index.  The arrays are tensors on the shards' device,
    or numpy arrays on the host route (``impl="host"``), as in ``repro``."""

    v_key: Array        # i32[C] — EMPTY_KEY where unused
    v_live: Array       # bool[C]
    v_inc: Array        # i32[C]
    n_live: int
    sorted_key: Array   # i32[n_live] — live keys, ascending
    sorted_inc: Array   # i32[n_live]
    sorted_slot: Array  # i32[n_live] — directory slot per sorted key


def _on_host(impl: Optional[str]) -> bool:
    return maintenance.resolve_impl(impl) == "host"


def gather_live_vertices(
    states: Sequence[GraphState], impl: Optional[str] = None
) -> Tuple[Array, Array]:
    """The union of live ``(key, inc)`` pairs across shards, sorted by key
    (shards partition the key space, so keys are unique): the endpoint index
    the sharded rehash and snapshot validate edges against.  Tensors on the
    shards' device (one read of the live count), or numpy on the host
    route."""
    if _on_host(impl):
        live = [st.v_live.cpu().numpy() for st in states]
        k = np.concatenate([st.v_key.cpu().numpy()[m] for st, m in zip(states, live)])
        i = np.concatenate([st.v_inc.cpu().numpy()[m] for st, m in zip(states, live)])
        order = np.argsort(k, kind="stable")
        return k[order].astype(np.int32), i[order].astype(np.int32)
    dev = states[0].device
    live = torch.cat([st.v_live.to(dev) for st in states])
    k = torch.cat([st.v_key.to(dev) for st in states])[live]
    i = torch.cat([st.v_inc.to(dev) for st in states])[live]
    k, order = torch.sort(k, stable=True)
    return k, i[order]


def _directory_capacity(n_live: int) -> int:
    cap = 64
    while n_live > GROW_LOAD_FACTOR * cap:
        cap *= 2
    return cap


def _directory_host(sorted_key: np.ndarray, sorted_inc: np.ndarray) -> VertexDirectory:
    n_live = sorted_key.shape[0]
    cap = _directory_capacity(n_live)
    for _ in range(24):
        home = (vertex_hash32_np(sorted_key) & np.uint32(cap - 1)).astype(np.int32)
        slots, overflow = maintenance._probe_place_host(home, cap, MAX_PROBES)
        if not overflow:
            v_key = np.full(cap, EMPTY_KEY, np.int32)
            v_live = np.zeros(cap, bool)
            v_inc = np.full(cap, ABSENT_INC, np.int32)
            v_key[slots] = sorted_key
            v_inc[slots] = sorted_inc
            v_live[slots] = True
            return VertexDirectory(v_key, v_live, v_inc, int(n_live), sorted_key,
                                   sorted_inc, slots.astype(np.int32))
        cap *= 2
    raise RuntimeError("vertex directory placement did not converge")


def _directory_device(sorted_key: torch.Tensor, sorted_inc: torch.Tensor) -> VertexDirectory:
    n_live = sorted_key.shape[0]
    dev = sorted_key.device
    cap = _directory_capacity(n_live)
    active = torch.ones(n_live, dtype=torch.bool, device=dev)
    for _ in range(24):
        # lane order is key order: probe_place's priority is the reference's
        slots, overflow = compact_ops.probe_place(
            hash_vertex(sorted_key, cap), active, capacity=cap, max_probes=MAX_PROBES
        )
        if not bool(overflow):
            where = slots.long()
            v_key = torch.full((cap,), EMPTY_KEY, dtype=_I32, device=dev)
            v_live = torch.zeros(cap, dtype=torch.bool, device=dev)
            v_inc = torch.full((cap,), ABSENT_INC, dtype=_I32, device=dev)
            v_key[where] = sorted_key
            v_inc[where] = sorted_inc
            v_live[where] = True
            return VertexDirectory(v_key, v_live, v_inc, int(n_live), sorted_key,
                                   sorted_inc, slots)
        cap *= 2
    raise RuntimeError("vertex directory placement did not converge")


def build_vertex_directory(
    states: Sequence[GraphState], impl: Optional[str] = None
) -> VertexDirectory:
    """Place the global live vertex set into one canonical open-addressing
    table (same hash, same triangular probing, same ``MAX_PROBES`` bound as
    the engines' locate, so ``locate_vertices`` works on the directory
    columns unchanged).  Capacity doubles on placement overflow, as in a
    rehash.  ``impl`` as in :func:`gather_live_vertices`."""
    sorted_key, sorted_inc = gather_live_vertices(states, impl)
    if _on_host(impl):
        return _directory_host(sorted_key, sorted_inc)
    return _directory_device(sorted_key, sorted_inc)


def _lookup_sorted(sorted_key: torch.Tensor, queries: torch.Tensor):
    """(found, position) of each query key in the ascending key index."""
    n = sorted_key.shape[0]
    if n == 0:
        return (torch.zeros(queries.shape, dtype=torch.bool, device=queries.device),
                torch.zeros(queries.shape, dtype=torch.int64, device=queries.device))
    pos = torch.searchsorted(sorted_key, queries)
    pos_c = pos.clamp(max=n - 1)
    return (pos < n) & (sorted_key[pos_c] == queries), pos_c


def _lookup_sorted_np(sorted_key: np.ndarray, queries: np.ndarray):
    """numpy twin of :func:`_lookup_sorted` (the host route)."""
    if sorted_key.size == 0:
        return np.zeros(queries.shape, bool), np.zeros(queries.shape, np.int64)
    pos = np.searchsorted(sorted_key, queries)
    pos_c = np.minimum(pos, sorted_key.size - 1)
    return (pos < sorted_key.size) & (sorted_key[pos_c] == queries), pos_c


def _edge_columns(states: Sequence[GraphState]):
    """(e_key_u, e_key_v, e_live, e_inc_u, e_inc_v) concatenated across
    shards: global lane = shard offset + local lane; on the first shard's
    device."""
    dev = states[0].device
    return tuple(torch.cat([getattr(st, f).to(dev) for st in states])
                 for f in ("e_key_u", "e_key_v", "e_live", "e_inc_u", "e_inc_v"))


def _fuse_host(states, d: VertexDirectory, dev) -> TraversalCSR:
    e_ku, e_kv, e_live, e_bu, e_bv = (c.cpu().numpy() for c in _edge_columns(states))
    ce = e_ku.shape[0]
    cv = d.v_key.shape[0]
    if d.n_live == 0:
        # no live vertices, so no valid edges; the index arrays are empty
        valid = np.zeros(ce, bool)
        src = np.full(ce, cv, np.int32)
        dst = np.full(ce, cv, np.int32)
    else:
        fu, pu = _lookup_sorted_np(d.sorted_key, e_ku)
        fv, pv = _lookup_sorted_np(d.sorted_key, e_kv)
        valid = (e_live & fu & fv & (d.sorted_inc[pu] == e_bu)
                 & (d.sorted_inc[pv] == e_bv))
        src = np.where(valid, d.sorted_slot[pu], cv).astype(np.int32)
        dst = np.where(valid, d.sorted_slot[pv], cv).astype(np.int32)
    lane = np.arange(ce, dtype=np.int32)
    order = np.argsort(src, kind="stable")
    src, dst, lane = src[order], dst[order], lane[order]
    rows = np.arange(cv, dtype=np.int32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    return TraversalCSR(
        v_key=torch.as_tensor(d.v_key, device=dev),
        v_live=torch.as_tensor(d.v_live, device=dev),
        v_inc=torch.as_tensor(d.v_inc, device=dev),
        n_live=t(d.n_live),
        src=t(src),
        dst=t(dst),
        lane=t(lane),
        row_start=t(np.searchsorted(src, rows, side="left")),
        row_end=t(np.searchsorted(src, rows, side="right")),
        n_edges=t(valid.sum()),
    )


def _fuse_device(states, d: VertexDirectory) -> TraversalCSR:
    e_ku, e_kv, e_live, e_bu, e_bv = _edge_columns(states)
    dev = e_ku.device
    ce = e_ku.shape[0]
    cv = d.v_key.shape[0]
    if d.n_live == 0:
        valid = torch.zeros(ce, dtype=torch.bool, device=dev)
        src = torch.full((ce,), cv, dtype=_I32, device=dev)
        dst = src.clone()
    else:
        fu, pu = _lookup_sorted(d.sorted_key, e_ku)
        fv, pv = _lookup_sorted(d.sorted_key, e_kv)
        valid = (e_live & fu & fv & (d.sorted_inc[pu] == e_bu)
                 & (d.sorted_inc[pv] == e_bv))
        src = torch.where(valid, d.sorted_slot[pu], cv)
        dst = torch.where(valid, d.sorted_slot[pv], cv)
    order = torch.argsort(src, stable=True)
    src = src[order]
    rows = torch.arange(cv, dtype=_I32, device=dev)
    return TraversalCSR(
        v_key=d.v_key,
        v_live=d.v_live,
        v_inc=d.v_inc,
        n_live=torch.tensor(d.n_live, dtype=_I32, device=dev),
        src=src,
        dst=dst[order],
        lane=order.to(_I32),
        row_start=torch.searchsorted(src, rows, right=False).to(_I32),
        row_end=torch.searchsorted(src, rows, right=True).to(_I32),
        n_edges=valid.sum().to(_I32),
    )


def fuse_partitioned(
    states: Sequence[GraphState],
    directory: Optional[VertexDirectory] = None,
    impl: Optional[str] = None,
) -> TraversalCSR:
    """Fuse S partitioned shard states into one global
    :class:`~repro_torch.core.traversal.TraversalCSR` on the shards' device.

    The vertex columns are the canonical directory's; edge lanes are
    concatenated across shards (global lane = shard offset + local lane),
    validated against the directory (live lane, both endpoints present,
    incarnations match) and stably sorted by source slot, as ``build_csr``
    does.  Every traversal query runs on the result unchanged.  ``impl`` as
    in :func:`gather_live_vertices` (a given ``directory`` must come from
    the same route)."""
    if directory is None:
        directory = build_vertex_directory(states, impl)
    if _on_host(impl):
        return _fuse_host(states, directory, states[0].device)
    return _fuse_device(states, directory)


def live_edges(
    states: Sequence[GraphState], endpoints=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The incarnation-valid edge keys ``(us, vs)`` across shards, judged on
    the shards' device against the global endpoint index (an edge's
    endpoints generally live on other shards); ``endpoints`` is that index
    where the caller has it (:func:`gather_live_vertices`)."""
    sk, si = gather_live_vertices(states) if endpoints is None else endpoints
    e_ku, e_kv, e_live, e_bu, e_bv = _edge_columns(states)
    fu, pu = _lookup_sorted(sk, e_ku)
    fv, pv = _lookup_sorted(sk, e_kv)
    if sk.shape[0] == 0:
        valid = fu  # all False: no live endpoints, no valid edges
    else:
        valid = e_live & fu & fv & (si[pu] == e_bu) & (si[pv] == e_bv)
    return e_ku[valid], e_kv[valid]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def host_local_mesh(device="cpu") -> List[torch.device]:
    """Every local device of ``device``'s type: the cards ``cuda:0`` ..
    ``cuda:n-1``, or the one CPU (``repro``'s ``host_local_mesh`` over
    ``jax.devices()``)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return check_mesh([device])


def check_mesh(mesh: Sequence) -> List[torch.device]:
    """``mesh`` as a list of ``torch.device``; raises ``ValueError`` for an
    empty mesh or a ``meta`` device (no values live there), and
    ``RuntimeError`` for a card that is not there."""
    devs = [torch.device(d) for d in mesh]
    if not devs:
        raise ValueError("an empty mesh")
    for d in devs:
        if d.type == "meta":
            raise ValueError("a mesh of a meta device: graph shards hold values")
        if d.type == "cuda":
            idx = 0 if d.index is None else d.index
            if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
                raise RuntimeError(f"the mesh names {d}, and no such card is present")
    return devs


def place_shards(
    states: Sequence[GraphState], mesh: Optional[Sequence] = None
) -> List[GraphState]:
    """Put shard ``i`` on ``mesh[i % len(mesh)]`` (round-robin); ``mesh`` is
    a sequence of devices (default: :func:`host_local_mesh` of the first
    shard's device).  Placement never changes values."""
    mesh = host_local_mesh(states[0].device if states else "cpu") if mesh is None else mesh
    devs = check_mesh(mesh)
    return [GraphState(*(c.to(devs[i % len(devs)]) for c in st))
            for i, st in enumerate(states)]


def edge_shard_histogram(
    ops: np.ndarray, us: np.ndarray, vs: np.ndarray, n_shards: int
) -> np.ndarray:
    """Edge-op count per shard for one batch — the balance metric."""
    ops = np.asarray(ops, np.int32)
    mask = np.isin(ops, EDGE_OPS)
    sid = shard_of_edges(np.asarray(us, np.int32)[mask], np.asarray(vs, np.int32)[mask],
                         n_shards)
    return np.bincount(sid, minlength=n_shards)


def vertex_shard_histogram(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Vertex count per owner shard — the vertex-side balance metric."""
    sid = shard_of_vertices(np.asarray(keys, np.int32), n_shards)
    return np.bincount(sid, minlength=n_shards)

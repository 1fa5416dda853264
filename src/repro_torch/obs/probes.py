"""Probe-chain health: histograms over the open-addressing tables, derived
after the fact.

Port of ``repro.obs.probes``; the tables are read to the host with
``.cpu().numpy()``.  The engine never materializes per-key probe lengths,
but the length is recoverable from the final layout: a key in slot ``s``
with home slot ``h`` sits at the unique triangular-probe step
``t < MAX_PROBES`` with ``(h + t*(t+1)//2) & (cap-1) == s``.

Two flavours, with different invariance guarantees
(``tests/test_torch_obs.py``):

* **physical** (:func:`table_probe_histogram`) — the per-shard tables as
  the device probes them.  Invariant across ``maintenance_impl`` but not
  across shard counts: each shard hashes its partition into a private slot
  space.
* **canonical** (:func:`directory_probe_histogram`) — the global
  :class:`~repro_torch.core.sharding.VertexDirectory`, whose placement
  depends only on the live key set, so it is invariant across ``n_shards``.

Probe length is 1-based: ``1`` = key found at its home slot.
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np

from ..core.hashing import edge_hash32_np, vertex_hash32_np
from ..core.types import EMPTY_KEY, MAX_PROBES, GraphState


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _probe_lengths(home: np.ndarray, slot: np.ndarray, cap: int) -> np.ndarray:
    """1-based triangular-probe chain length of each occupied slot."""
    steps = np.arange(MAX_PROBES, dtype=np.int64)
    offs = (steps * (steps + 1)) // 2
    cand = (home.astype(np.int64)[:, None] + offs[None, :]) & (cap - 1)
    hit = cand == slot.astype(np.int64)[:, None]
    # every placed key is on its own chain within MAX_PROBES (the locate
    # bound): argmax finds the first, unique, hit
    return np.argmax(hit, axis=1).astype(np.int64) + 1


def _hist(lengths: np.ndarray) -> Dict[int, int]:
    counts = np.bincount(lengths)
    return {int(v): int(c) for v, c in enumerate(counts) if c}


def _merge(into: Dict[int, int], other: Dict[int, int]) -> Dict[int, int]:
    for k, v in other.items():
        into[k] = into.get(k, 0) + v
    return into


def _vertex_lengths(state: GraphState) -> np.ndarray:
    keys = _np(state.v_key)
    occ = keys != EMPTY_KEY
    cap = keys.shape[0]
    slot = np.flatnonzero(occ)
    home = (vertex_hash32_np(keys[occ]) & np.uint32(cap - 1)).astype(np.int64)
    return _probe_lengths(home, slot, cap)


def _edge_lengths(state: GraphState) -> np.ndarray:
    ku = _np(state.e_key_u)
    kv = _np(state.e_key_v)
    occ = ku != EMPTY_KEY
    cap = ku.shape[0]
    slot = np.flatnonzero(occ)
    home = (edge_hash32_np(ku[occ], kv[occ]) & np.uint32(cap - 1)).astype(np.int64)
    return _probe_lengths(home, slot, cap)


def _as_states(graph_or_states) -> Sequence[GraphState]:
    if isinstance(graph_or_states, GraphState):
        return (graph_or_states,)
    if hasattr(graph_or_states, "n_shards"):  # a WaitFreeGraph
        g = graph_or_states
        return tuple(g.shards) if g.n_shards > 1 else (g.state,)
    return tuple(graph_or_states)


def table_probe_histogram(graph_or_states) -> Dict[str, Dict[int, int]]:
    """Physical probe-length histograms (``{"vertex": {len: count},
    "edge": ...}``) over one state, a shard list, or a ``WaitFreeGraph``
    (summed across shards).  Occupied slots only — tombstones included,
    since the device probes past them too."""
    v_hist: Dict[int, int] = {}
    e_hist: Dict[int, int] = {}
    for st in _as_states(graph_or_states):
        _merge(v_hist, _hist(_vertex_lengths(st)))
        _merge(e_hist, _hist(_edge_lengths(st)))
    return {"vertex": v_hist, "edge": e_hist}


def directory_probe_histogram(graph_or_states, impl=None) -> Dict[int, int]:
    """Probe-length histogram of the canonical global vertex directory —
    deterministic in the live key set alone, hence identical for any
    ``n_shards`` holding the same abstract graph.  ``impl`` is the
    directory's route (``maintenance_impl``)."""
    # deferred: sharding imports maintenance and traversal
    from ..core.sharding import build_vertex_directory

    d = build_vertex_directory(_as_states(graph_or_states), impl=impl)
    cap = d.v_key.shape[0]
    sorted_key = _np(d.sorted_key)
    home = (vertex_hash32_np(sorted_key) & np.uint32(cap - 1)).astype(np.int64)
    return _hist(_probe_lengths(home, _np(d.sorted_slot).astype(np.int64), cap))


def mean_probe_len(graph_or_states) -> Union[float, None]:
    """Mean physical probe-chain length across both tables (vertex + edge,
    all shards).  ``None`` for empty tables."""
    h = table_probe_histogram(graph_or_states)
    total = sum(n * c for part in h.values() for n, c in part.items())
    count = sum(c for part in h.values() for c in part.values())
    return (total / count) if count else None


def record(reg, graph_or_states) -> Dict[str, Dict[int, int]]:
    """Record the physical histograms into ``reg`` (``probe.vertex`` /
    ``probe.edge`` exact-integer histograms) and return them."""
    h = table_probe_histogram(graph_or_states)
    for name, part in (("probe.vertex", h["vertex"]), ("probe.edge", h["edge"])):
        for length, count in sorted(part.items()):
            reg.hist(name, [length] * count)
    return h

"""Workload generators mirroring the paper's experimental setup (§5).

Copy of ``repro.core.workloads`` (numpy only).

The paper: initial graph of 1000 vertices; each thread draws ops from one of
three distributions over (AddV, RemV, ConV, AddE, RemE, ConE):

  * lookup-intensive : (2.5, 2.5, 45, 2.5, 2.5, 45) %
  * balanced         : (12.5, 12.5, 25, 12.5, 12.5, 25) %
  * update-intensive : (22.5, 22.5, 5, 22.5, 22.5, 5) %

Here "threads" are batch lanes: a batch of n ops is the ODA published by n
logical submitters, resolved concurrently by the engine.
"""

from __future__ import annotations

import numpy as np

from .types import (
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
)

MIXES = {
    "lookup": (0.025, 0.025, 0.45, 0.025, 0.025, 0.45),
    "balanced": (0.125, 0.125, 0.25, 0.125, 0.125, 0.25),
    "update": (0.225, 0.225, 0.05, 0.225, 0.225, 0.05),
    # traversal: edge-heavy build phase for reachability/BFS query workloads —
    # AddE dominates so the graph develops real path structure; RemV stays
    # nonzero so incarnation churn and stale edges are exercised.
    "traversal": (0.10, 0.02, 0.08, 0.60, 0.05, 0.15),
    # query_heavy: a trickle of mutations under a flood of membership lookups
    "query_heavy": (0.010, 0.003, 0.42, 0.045, 0.012, 0.51),
}

_OPS = np.array(
    [OP_ADD_VERTEX, OP_REMOVE_VERTEX, OP_CONTAINS_VERTEX,
     OP_ADD_EDGE, OP_REMOVE_EDGE, OP_CONTAINS_EDGE],
    dtype=np.int32,
)


def sample_batch(
    rng: np.random.Generator, n: int, mix: str = "balanced", key_space: int = 1000
):
    """Sample one op batch. Returns (ops, us, vs) numpy arrays."""
    probs = np.asarray(MIXES[mix])
    ops = _OPS[rng.choice(6, size=n, p=probs)]
    us = rng.integers(0, key_space, size=n).astype(np.int32)
    vs = rng.integers(0, key_space, size=n).astype(np.int32)
    return ops, us, vs


def sample_query_pairs(rng: np.random.Generator, n: int, key_space: int = 1000):
    """Sample (source, target) key pairs for batched reachability/GetPath
    queries."""
    us = rng.integers(0, key_space, size=n).astype(np.int32)
    vs = rng.integers(0, key_space, size=n).astype(np.int32)
    return us, vs


def sample_update_batch(rng: np.random.Generator, n: int, key_space: int = 1000):
    """Sample a small all-mutating batch — the mutation-only restriction of
    the ``query_heavy`` mix, renormalized."""
    probs = np.asarray(MIXES["query_heavy"], float)
    probs = np.where(np.isin(_OPS, (OP_CONTAINS_VERTEX, OP_CONTAINS_EDGE)), 0.0, probs)
    ops = _OPS[rng.choice(6, size=n, p=probs / probs.sum())]
    us = rng.integers(0, key_space, size=n).astype(np.int32)
    vs = rng.integers(0, key_space, size=n).astype(np.int32)
    return ops, us, vs


def skewed_update_batch(
    rng: np.random.Generator,
    n: int,
    key_space: int = 1000,
    zipf_a: float = 1.5,
    hot_key: int | None = None,
    hot_frac: float = 0.5,
):
    """Sample a mutation-only batch whose endpoints follow a Zipf law;
    with ``hot_key``, a ``hot_frac`` share of the ``u`` endpoints is pinned
    to that one key (extreme contention)."""
    probs = np.asarray(MIXES["query_heavy"], float)
    probs = np.where(np.isin(_OPS, (OP_CONTAINS_VERTEX, OP_CONTAINS_EDGE)), 0.0, probs)
    ops = _OPS[rng.choice(6, size=n, p=probs / probs.sum())]
    us = ((rng.zipf(zipf_a, size=n) - 1) % key_space).astype(np.int32)
    vs = ((rng.zipf(zipf_a, size=n) - 1) % key_space).astype(np.int32)
    if hot_key is not None:
        pin = rng.random(n) < hot_frac
        us = np.where(pin, np.int32(hot_key), us)
    return ops, us, vs


def shard_balance(ops, us, vs, n_shards: int) -> np.ndarray:
    """Edge-op count per hash-prefix shard for one batch
    (:func:`repro_torch.core.sharding.shard_of_edges` routing): the mixes
    draw keys uniformly, so shard loads stay near-uniform; a skewed
    histogram means a skewed key distribution, not a routing bug."""
    from .sharding import edge_shard_histogram

    return edge_shard_histogram(
        np.asarray(ops, np.int32), np.asarray(us, np.int32),
        np.asarray(vs, np.int32), n_shards,
    )


def initial_vertices(key_space: int = 1000):
    """The paper's initial graph: 1000 vertices (keys 0..999), no edges."""
    ops = np.full(key_space, OP_ADD_VERTEX, np.int32)
    us = np.arange(key_space, dtype=np.int32)
    vs = np.zeros(key_space, np.int32)
    return ops, us, vs

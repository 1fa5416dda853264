"""repro_torch.core — the paper's wait-free concurrent unbounded graph, in
PyTorch.  Module for module the counterpart of ``repro.core``:

  * :class:`repro_torch.core.graph.WaitFreeGraph` — unbounded graph, six ops,
    batched apply, growth, snapshot queries, one shard or hash-prefix
    sharded (``n_shards``), with telemetry (``obs``).
  * :func:`repro_torch.core.engine.apply_batch` — the wait-free combine pass;
    :func:`repro_torch.core.fastpath.apply_batch_fpsp` its fast-path-slow-path
    twin.
  * :mod:`repro_torch.core.baselines` — coarse / serial / lock-free
    comparisons (the paper's Fig. 4).
  * :mod:`repro_torch.core.oracle` — sequential specification (ground truth).
  * :mod:`repro_torch.core.traversal` — batched reachability/BFS/k-hop over
    CSR snapshots, built or delta-folded (``apply_delta``).
  * :mod:`repro_torch.core.maintenance` — the growth rehash (live-compact
    and snapshot-compact) and the CSR delta merge.
  * :mod:`repro_torch.core.sharding` — hash-prefix partitioning of the
    tables: shard routing, the canonical vertex directory, cross-shard
    snapshot fusion.
"""

from . import maintenance, sharding
from .graph import WaitFreeGraph
from .oracle import SequentialGraph, run_sequential
from .traversal import (
    TraversalCSR,
    apply_delta,
    bfs_levels,
    bfs_parents,
    build_csr,
    khop_mask,
    path_probe,
    reachable,
)
from .types import (
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_NOP,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
    ApplyResult,
    GraphState,
    OpBatch,
    make_batch,
    make_state,
    state_from_numpy,
    state_to_numpy,
)

__all__ = [
    "WaitFreeGraph",
    "maintenance",
    "sharding",
    "SequentialGraph",
    "run_sequential",
    "TraversalCSR",
    "build_csr",
    "apply_delta",
    "bfs_levels",
    "bfs_parents",
    "path_probe",
    "reachable",
    "khop_mask",
    "GraphState",
    "OpBatch",
    "ApplyResult",
    "make_batch",
    "make_state",
    "state_from_numpy",
    "state_to_numpy",
    "OP_NOP",
    "OP_ADD_VERTEX",
    "OP_REMOVE_VERTEX",
    "OP_CONTAINS_VERTEX",
    "OP_ADD_EDGE",
    "OP_REMOVE_EDGE",
    "OP_CONTAINS_EDGE",
]

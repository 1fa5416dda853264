"""Pure-Python sequential oracle for the graph's sequential specification.

Copy of ``repro.core.oracle`` (the port imports nothing of the JAX package),
with one change that leaves every answer as it was: the graph keeps an
out-neighbour and an in-neighbour index beside its edge set, so
``remove_vertex`` drops the incident edges in O(degree) and the traversal
queries walk the index instead of rebuilding an adjacency list per call.
That is what lets the oracle follow a graph at the scale of a real
deployment (millions of edges) op by op.

Semantics follow the paper's §2.1 on the *abstract* graph G=(V, E):
``remove_vertex(u)`` removes u and all incident edges — any later
``contains_edge``/``remove_edge`` touching u fails because u is not present,
and re-adding u yields a vertex with *no* incident edges.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .types import (
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_CONTAINS_EDGE,
    OP_CONTAINS_VERTEX,
    OP_NOP,
    OP_REMOVE_EDGE,
    OP_REMOVE_VERTEX,
)


class SequentialGraph:
    """Reference implementation: a plain sequential directed graph."""

    def __init__(self) -> None:
        self.vertices: Set[int] = set()
        self.edges: Set[Tuple[int, int]] = set()
        self._out: Dict[int, Set[int]] = {}
        self._in: Dict[int, Set[int]] = {}

    # -- the six operations (paper §2.1) --------------------------------
    def add_vertex(self, u: int) -> bool:
        if u in self.vertices:
            return False
        self.vertices.add(u)
        self._out[u] = set()
        self._in[u] = set()
        return True

    def remove_vertex(self, u: int) -> bool:
        if u not in self.vertices:
            return False
        self.vertices.discard(u)
        for b in self._out.pop(u):
            self.edges.discard((u, b))
            self._in[b].discard(u)
        for a in self._in.pop(u):
            self.edges.discard((a, u))
            self._out[a].discard(u)
        return True

    def contains_vertex(self, u: int) -> bool:
        return u in self.vertices

    def add_edge(self, u: int, v: int) -> bool:
        if u not in self.vertices or v not in self.vertices:
            return False
        if (u, v) in self.edges:
            return False
        self.edges.add((u, v))
        self._out[u].add(v)
        self._in[v].add(u)
        return True

    def remove_edge(self, u: int, v: int) -> bool:
        if u not in self.vertices or v not in self.vertices:
            return False
        if (u, v) not in self.edges:
            return False
        self.edges.discard((u, v))
        self._out[u].discard(v)
        self._in[v].discard(u)
        return True

    def contains_edge(self, u: int, v: int) -> bool:
        if u not in self.vertices or v not in self.vertices:
            return False
        return (u, v) in self.edges

    # -- traversal queries (sequential specification) --------------------
    def bfs(self, u: int) -> Dict[int, int]:
        """BFS level map {vertex: hop distance} from u (u itself at 0).
        Empty when u is absent — matching the engine's dead-source rows."""
        if u not in self.vertices:
            return {}
        levels = {u: 0}
        q = deque([u])
        while q:
            a = q.popleft()
            for b in self._out[a]:
                if b not in levels:
                    levels[b] = levels[a] + 1
                    q.append(b)
        return levels

    def reachable(self, u: int, v: int) -> bool:
        """Directed u ↝ v; u ↝ u is True iff u exists (the empty path)."""
        if u not in self.vertices or v not in self.vertices:
            return False
        return v in self.bfs(u)

    def khop(self, u: int, k: int) -> Set[int]:
        """Vertices within ≤k directed hops of u (including u)."""
        return {w for w, d in self.bfs(u).items() if d <= k}

    def path(self, u: int, v: int) -> Optional[List[int]]:
        """A shortest directed path u ↝ v as ``[u, ..., v]``, or None when
        unreachable / either endpoint absent.  ``path(u, u) == [u]`` when u
        exists.  Ties between equal-length paths are broken arbitrarily —
        callers check validity + length, not the exact route."""
        if u not in self.vertices or v not in self.vertices:
            return None
        parent = {u: u}
        q = deque([u])
        while q and v not in parent:
            a = q.popleft()
            for b in self._out[a]:
                if b not in parent:
                    parent[b] = a
                    q.append(b)
        if v not in parent:
            return None
        chain = [v]
        while chain[-1] != u:
            chain.append(parent[chain[-1]])
        return list(reversed(chain))

    def apply(self, op: int, u: int, v: int) -> bool:
        if op == OP_ADD_VERTEX:
            return self.add_vertex(u)
        if op == OP_REMOVE_VERTEX:
            return self.remove_vertex(u)
        if op == OP_CONTAINS_VERTEX:
            return self.contains_vertex(u)
        if op == OP_ADD_EDGE:
            return self.add_edge(u, v)
        if op == OP_REMOVE_EDGE:
            return self.remove_edge(u, v)
        if op == OP_CONTAINS_EDGE:
            return self.contains_edge(u, v)
        if op == OP_NOP:
            return False
        raise ValueError(f"unknown op {op}")


def run_sequential(
    ops: Sequence[int],
    us: Sequence[int],
    vs: Sequence[int],
    phases: Sequence[int] | None = None,
    graph: SequentialGraph | None = None,
) -> Tuple[List[bool], SequentialGraph]:
    """Apply a batch sequentially in increasing phase order.

    Returns results in the *original* batch order (matching the engine).
    """
    n = len(ops)
    g = graph if graph is not None else SequentialGraph()
    order: Iterable[int]
    if phases is None:
        order = range(n)
    else:
        order = sorted(range(n), key=lambda i: phases[i])
    results: List[bool] = [False] * n
    for i in order:
        results[i] = g.apply(int(ops[i]), int(us[i]), int(vs[i]))
    return results, g

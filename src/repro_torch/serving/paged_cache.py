"""Paged-KV page tables managed by the wait-free graph engine.

This is where the paper's technique is a first-class production feature:
the dynamic (sequence → page) ownership structure *is* a concurrent directed
graph, mutated by batches of operations:

  admission   -> AddVertex(seq)  + AddEdge(seq, page) per initial page
  growth      -> AddEdge(seq, page) when a sequence crosses a page boundary
  completion  -> RemoveVertex(seq)  — incarnation semantics make every
                 owned edge *abstractly* vanish at once (the paper's Fig. 3
                 mechanism doing real work: a later re-use of the same seq id
                 can never resurrect stale page ownership)
  validation  -> ContainsEdge(seq, page) before every page write

All mutations go through ``WaitFreeGraph.apply`` (fpsp engine), so the
linearization is the phase order of the op batch — identical on every host
given the same request stream.  The host-side mirrors (``seq_pages``,
``free``) are pure derivations of that deterministic history: any replica
(or a replacement after a node failure) reconstructs byte-identical tables
by replaying the op log (tested in tests/test_serving.py).

Port of ``repro.serving.paged_cache``: the page table is the port's
``WaitFreeGraph`` (FPSP engine by default), on the card unless ``device``
says otherwise; the op batches, mirrors and replay are the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import WaitFreeGraph
from ..core.types import (
    OP_ADD_EDGE,
    OP_ADD_VERTEX,
    OP_REMOVE_VERTEX,
)

# key-space split: sequence vertices get ids >= PAGE_KEYS
PAGE_KEYS = 1 << 20


class PagedKVManager:
    def __init__(self, num_pages: int, page_size: int, mode: str = "fpsp", device=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self.mode = mode
        def pow2(n: int) -> int:
            p = 1
            while p < n:
                p *= 2
            return p

        self.graph = WaitFreeGraph(
            v_capacity=pow2(max(64, 2 * num_pages)),
            e_capacity=pow2(max(256, 4 * num_pages)),
            mode=mode,
            device=device,
        )
        # page vertices exist for the lifetime of the cache
        ops = [OP_ADD_VERTEX] * num_pages
        us = list(range(num_pages))
        ok = self.graph.apply(ops, us, us)
        assert all(ok), "page vertex init failed"
        self.free: List[int] = list(range(num_pages - 1, -1, -1))  # pop order
        self.seq_pages: Dict[int, List[int]] = {}
        self.seq_len: Dict[int, int] = {}
        self.op_log: List[Tuple[list, list, list]] = []

    # -- op-batch construction (one batch per serving step) ------------------
    def step_ops(
        self,
        admit: Dict[int, int],      # seq_id -> prompt length (tokens)
        extend: List[int],          # seq_ids that produced one more token
        finish: List[int],          # seq_ids completed this step
    ):
        """Build + apply one deterministic op batch; returns per-seq new pages."""
        ops, us, vs = [], [], []
        plan: List[Tuple[str, int, Optional[int]]] = []

        for seq in sorted(admit):
            ops.append(OP_ADD_VERTEX)
            us.append(PAGE_KEYS + seq)
            vs.append(0)
            plan.append(("admit", seq, None))
            n_pages = -(-admit[seq] // self.page_size)
            for _ in range(max(n_pages, 1)):
                page = self._pop_free()
                ops.append(OP_ADD_EDGE)
                us.append(PAGE_KEYS + seq)
                vs.append(page)
                plan.append(("own", seq, page))

        for seq in extend:
            new_len = self.seq_len[seq] + 1
            if (new_len - 1) // self.page_size != (self.seq_len[seq] - 1) // self.page_size:
                page = self._pop_free()
                ops.append(OP_ADD_EDGE)
                us.append(PAGE_KEYS + seq)
                vs.append(page)
                plan.append(("own", seq, page))
            plan.append(("len", seq, None))

        for seq in finish:
            ops.append(OP_REMOVE_VERTEX)
            us.append(PAGE_KEYS + seq)
            vs.append(0)
            plan.append(("finish", seq, None))

        results = self.graph.apply(ops, us, vs) if ops else np.zeros((0,), bool)
        self.op_log.append((list(ops), list(us), list(vs)))

        # fold results back into the mirrors, in plan order
        ri = 0
        new_pages: Dict[int, List[int]] = {}
        for kind, seq, page in plan:
            if kind == "admit":
                assert bool(results[ri]), f"admit {seq}: vertex add failed"
                ri += 1
                self.seq_pages[seq] = []
                self.seq_len[seq] = 0
            elif kind == "own":
                assert bool(results[ri]), f"page grant {page} -> {seq} failed"
                ri += 1
                self.seq_pages[seq].append(page)
                new_pages.setdefault(seq, []).append(page)
            elif kind == "len":
                self.seq_len[seq] += 1
            elif kind == "finish":
                assert bool(results[ri]), f"finish {seq}: vertex remove failed"
                ri += 1
                for p in self.seq_pages.pop(seq):
                    self.free.append(p)
                self.seq_len.pop(seq)
        for seq, n in admit.items():
            self.seq_len[seq] = n
        return new_pages

    def _pop_free(self) -> int:
        if not self.free:
            raise RuntimeError("out of KV pages")
        return self.free.pop()

    # -- queries ----------------------------------------------------------------
    def block_table(self, seqs: List[int], pages_per_seq: int) -> np.ndarray:
        bt = np.zeros((len(seqs), pages_per_seq), np.int32)
        for i, s in enumerate(seqs):
            pages = self.seq_pages.get(s, [])
            assert len(pages) <= pages_per_seq, (s, len(pages))
            bt[i, : len(pages)] = pages
        return bt

    def owns(self, seq: int, page: int) -> bool:
        """Validated through the graph (the paper's ContainsEdge)."""
        return self.graph.contains_edge(PAGE_KEYS + seq, page)

    def replay(self) -> "PagedKVManager":
        """Reconstruct a fresh manager from the deterministic op log —
        the straggler/failover path: a replacement host reaches the same
        graph state *and* the same ordered page tables with no coordination,
        because edge grants appear in the log in phase order."""
        twin = PagedKVManager(self.num_pages, self.page_size, self.mode, self.graph.device)
        for ops, us, vs in self.op_log:
            if not ops:
                continue
            results = twin.graph.apply(ops, us, vs)
            for op, u, v, ok in zip(ops, us, vs, results):
                if op == OP_ADD_VERTEX and u >= PAGE_KEYS and ok:
                    twin.seq_pages[u - PAGE_KEYS] = []
                elif op == OP_ADD_EDGE and ok:
                    seq = u - PAGE_KEYS
                    twin.seq_pages[seq].append(v)
                    if v in twin.free:
                        twin.free.remove(v)
                elif op == OP_REMOVE_VERTEX and u >= PAGE_KEYS and ok:
                    for p in twin.seq_pages.pop(u - PAGE_KEYS, []):
                        twin.free.append(p)
            twin.op_log.append((list(ops), list(us), list(vs)))
        return twin

"""Continuous-batching serving engine over the wait-free page table.

Port of ``repro.serving.engine``, for every family:

  * **slot-based continuous batching** — ``max_batch`` cache slots step
    together every engine tick; a slot still consuming its prompt feeds the
    next prompt token (logits ignored), a generating slot feeds its last
    sampled token.  One ``decode_step`` per tick serves admission, prefill
    and decode at once.
  * **slot reuse** — admitting into a previously used slot zeroes that
    slot's rows in every cache leaf (KV rows, the hybrid's shared-block KV
    rows, recurrent states) and sets ``cache["start"][slot]`` so attention
    never sees the predecessor's rows.
  * **audio** — a prompt is (P, n_codebooks); a prompt row fills every
    codebook of the tick's token, a generated id is fed to all of them, and
    codebook 0's logits are sampled.  **vlm** serving is text-only: the
    cache holds no image K/V, as in the reference.
  * **wait-free page accounting** — every tick builds one op batch
    (admit/extend/finish) for :class:`PagedKVManager`, whose page table is
    the port's ``WaitFreeGraph`` in FPSP mode.
  * **failover** — ``failover()`` replays the op log into a fresh manager
    and verifies the page tables match; sampling is numpy, seeded per
    (seed, request, position), so a replacement host regenerates the same
    tokens.

The engine runs on the card unless ``device`` says otherwise.  Telemetry
(``obs``: ``None`` defers to ``REPRO_OBS``, ``True`` a fresh registry,
``False`` the no-op, or a registry to share) records the ``serving.*``
metrics of ``docs/OBSERVABILITY.md``; it changes neither admission,
sampling nor page accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import LM
from ..obs import metrics as obsm
from ..models.config import ArchConfig
from .paged_cache import PagedKVManager


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                      # (P,) int32, or (P, n_codebooks)
    max_new_tokens: int = 16
    temperature: float = 0.0                # 0 = greedy
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_tick: int = -1                   # stamped by ServingEngine.submit


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        max_batch: int = 4,
        max_len: int = 128,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        seed: int = 0,
        obs=None,
        device=None,
    ):
        self.cfg = cfg
        self.obs = obsm.resolve(obs)
        self.device = resolve_device(device, "ServingEngine")
        self.model = LM(cfg, self.device)
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        num_pages = num_pages or (max_batch * max_len) // page_size
        self.pages = PagedKVManager(num_pages, page_size, device=self.device)
        self.seed = seed

        self.cache = self._fresh_cache()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._consumed: List[int] = [0] * max_batch  # prompt tokens fed
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.ticks = 0

    def _fresh_cache(self):
        cache = self.model.decode_init(self.max_batch, self.max_len)
        cache["start"] = torch.zeros(self.max_batch, dtype=torch.int32, device=self.device)
        return cache

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        rows = () if self.cfg.n_codebooks == 1 else (self.cfg.n_codebooks,)
        p = req.prompt
        if p.ndim != 1 + len(rows) or p.shape[1:] != rows or len(p) < 1:
            raise ValueError(f"a request needs a non-empty prompt of shape (P,) + {rows}, "
                             f"got {p.shape}")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        req.submit_tick = self.ticks
        self.obs.counter("serving.submitted")
        self.queue.append(req)

    def run(self, max_ticks: int = 10_000) -> Dict[int, Request]:
        while self.queue or any(s is not None for s in self.slots):
            self.tick()
            if self.ticks >= max_ticks:
                raise RuntimeError("serving did not drain")
        return self.finished

    # -- one engine tick -----------------------------------------------------
    def tick(self) -> None:
        reg = self.obs
        if reg.enabled:
            reg.hist("serving.queue_depth", len(self.queue))
            reg.gauge("serving.active_slots", sum(1 for s in self.slots if s is not None))
        with reg.span("serving.tick"):
            self._tick()

    @torch.no_grad()
    def _tick(self) -> None:
        pos = int(self.cache["len"])
        # timeline compaction: once every slot is idle, restart the shared
        # position axis so long request streams drain on a bounded cache
        if pos > 0 and self.queue and all(s is None for s in self.slots):
            self.cache = self._fresh_cache()
            pos = 0
        admit: Dict[int, int] = {}
        extend: List[int] = []
        finish: List[int] = []

        # admission: fill free slots while page budget + timeline room allow
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            need = len(req.prompt) + req.max_new_tokens
            pages_needed = -(-need // self.page_size)
            if pos + need > self.max_len or len(self.pages.free) < pages_needed:
                break  # deterministic: head-of-line blocking, no reorder
            self.queue.pop(0)
            self._admit(slot, req, pos)
            admit[req.id] = len(req.prompt)
            if self.obs.enabled and req.submit_tick >= 0:
                # admission latency in engine ticks (deterministic, unlike
                # wall clock): how long the request sat head-of-line
                self.obs.hist("serving.admission_wait_ticks", self.ticks - req.submit_tick)

        # this tick's forced/sampled token per active slot
        ncb = self.cfg.n_codebooks
        tokens = np.zeros((self.max_batch, 1) + ((ncb,) if ncb > 1 else ()), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            c = self._consumed[slot]
            tokens[slot, 0] = req.prompt[c] if c < len(req.prompt) else req.generated[-1]

        active = [s for s in self.slots if s is not None]
        if not active and not admit:
            return

        logits, self.cache = self.model.decode_step(
            self.params, torch.as_tensor(tokens, device=self.device), self.cache
        )
        logits = logits[:, -1].float().cpu().numpy()  # (slots, [ncb,] Vp)

        # fold logits back: sample where the prompt is exhausted
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self._consumed[slot] += 1
            c = self._consumed[slot]
            if c >= len(req.prompt):
                req.generated.append(self._sample(req, logits[slot], position=c))
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    finish.append(req.id)
                    self.finished[req.id] = req
                    self.slots[slot] = None
                    self.obs.counter("serving.finished")
                else:
                    extend.append(req.id)

        # one deterministic page-table op batch per tick
        self.pages.step_ops(admit, extend, finish)
        self.ticks += 1

    # -- internals -------------------------------------------------------------
    def _admit(self, slot: int, req: Request, pos: int) -> None:
        self.slots[slot] = req
        self._consumed[slot] = 0
        # zero the slot's stale cache rows and recurrent states (every leaf
        # is laid out (layers, batch, ...)) and mark its admission offset
        for key in ("kv", "shared_kv", "states"):
            for leaf in self.cache.get(key, {}).values():
                leaf[:, slot] = 0
        self.cache["start"][slot] = pos

    def _sample(self, req: Request, logits_row: np.ndarray, position: int) -> int:
        if self.cfg.n_codebooks > 1:
            logits_row = logits_row[0]  # the first codebook drives the id stream
        logits_row = logits_row[: self.cfg.vocab]
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, req.id, position]))
        z = logits_row / req.temperature
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(rng.choice(len(p), p=p))

    # -- fault tolerance ---------------------------------------------------------
    def failover(self) -> PagedKVManager:
        """Replacement-host path: rebuild page tables from the op log and
        verify the twin matches (deterministic phase order ⇒ exact)."""
        twin = self.pages.replay()
        if twin.seq_pages != self.pages.seq_pages or sorted(twin.free) != sorted(self.pages.free):
            raise RuntimeError("failover replay: page tables differ")
        return twin

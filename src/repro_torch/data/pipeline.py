"""Deterministic, host-sharded, checkpointable synthetic token stream.

Port of ``repro.data.pipeline``, kept as the port's own copy (the port
imports nothing of ``repro``); numpy only, and the same batches bit for bit.

Every row of every step draws from its own PRNG stream, keyed by
(seed, step, global row), so:

* restoring a checkpoint at step N reproduces the exact batch sequence
  (the iterator's state is the step counter);
* host h of H draws the global batch rows [h B / H, (h + 1) B / H) of the
  same step-keyed stream, so the global batch does not depend on the number
  of hosts, and any host can recompute any other's shard;
* a rank of a mesh may name its rows instead (``rows=``, in the order it
  takes them: ``launch.shardings.data_rows``).

The "corpus" mixes Zipfian unigrams with short repeated motifs: enough
structure for a loss that falls, with no data to fetch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 1
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5


class SyntheticTokenStream:
    """Stateful iterator whose state is the step counter (checkpointable)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1, rows=None):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over {n_hosts} "
                             "hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        per_host = cfg.global_batch // n_hosts
        self.rows = (list(range(host_id * per_host, (host_id + 1) * per_host)) if rows is None
                     else [int(r) for r in rows])
        if any(not 0 <= r < cfg.global_batch for r in self.rows):
            raise ValueError(f"rows outside the global batch of {cfg.global_batch}")
        self.step = 0

    # -- checkpoint interface ------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: Dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: {state['seed']} != {self.cfg.seed}")
        self.step = int(state["step"])

    # -- batch generation ----------------------------------------------------
    def _rows(self, step: int, rows) -> np.ndarray:
        cfg = self.cfg
        shape = (cfg.seq_len + 1,) if cfg.n_codebooks == 1 else (cfg.seq_len + 1,
                                                                  cfg.n_codebooks)
        out = np.empty((len(rows),) + shape, np.int64)
        for i, row in enumerate(rows):
            rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, row]))
            toks = rng.zipf(cfg.zipf_a, size=shape) % cfg.vocab
            # overlay repeated motifs (learnable local structure)
            if rng.random() < cfg.motif_prob:
                m = rng.integers(0, cfg.vocab, cfg.motif_len)
                reps = (cfg.seq_len + 1) // cfg.motif_len
                motif_stream = np.tile(m, reps + 1)[: cfg.seq_len + 1]
                mask = rng.random(cfg.seq_len + 1) < 0.5
                if cfg.n_codebooks == 1:
                    toks = np.where(mask, motif_stream, toks)
                else:
                    toks = np.where(mask[:, None], motif_stream[:, None], toks)
            out[i] = toks
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        """tokens and targets (the tokens shifted by one), int32, and a mask
        of ones, for this host's rows of the next step."""
        rows = self._rows(self.step, self.rows)
        self.step += 1
        return {
            "tokens": np.ascontiguousarray(rows[:, :-1], np.int32),
            "targets": np.ascontiguousarray(rows[:, 1:], np.int32),
            "mask": np.ones((len(self.rows), self.cfg.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

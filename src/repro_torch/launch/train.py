"""End-to-end training command.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --full \\
      --batch 4 --seq 4096 --accum 2 --steps 20 --ckpt-dir /path/to/ckpt

Port of ``repro.launch.train`` on one card, with the same flags less
``--mesh`` (there is no mesh) and plus ``--device`` (default: the card):

* parameters drawn on the device from ``--seed``, or restored from the
  latest valid checkpoint in ``--ckpt-dir``;
* the deterministic, step-keyed token stream, whose step a restore resumes;
* async, atomic, self-validating checkpoints every ``--save-every`` steps;
  ``--crash-at N`` exits with code 42 after step N (after its save has
  started), and running the command again resumes from the latest valid
  checkpoint: the kill/resume path.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointStore
from ..configs import ARCH_NAMES, get_config, get_smoke_config
from ..data import DataConfig, SyntheticTokenStream
from ..models.module import tree_map
from ..optim import AdamWConfig, adamw_init
from .steps import build_train_step


class TrainRunner:
    """Owns the parameters, the optimizer state, the token stream and the
    checkpoint store; restartable at any saved step."""

    def __init__(self, cfg, *, ckpt_dir: Optional[str], batch: int, seq: int, accum: int = 1,
                 seed: int = 0, opt_cfg: Optional[AdamWConfig] = None, keep: int = 3,
                 device=None):
        self.cfg = cfg
        self.seed = seed
        self.store = CheckpointStore(ckpt_dir, keep=keep) if ckpt_dir else None
        self.data = SyntheticTokenStream(
            DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
                       n_codebooks=cfg.n_codebooks))
        self.step_fn, self.model, self.run = build_train_step(cfg, accum=accum, opt_cfg=opt_cfg,
                                                              device=device)
        self.device = self.model.device
        self.step = 0
        self.params = None
        self.opt_state = None
        self._saved_step = None

    # -- state ------------------------------------------------------------
    def init_or_restore(self) -> str:
        if self.store is not None and self.store.latest_step() is not None:
            self.restore(self.store.latest_step())
            return "restored"
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = self.model.init(gen)
        self.opt_state = adamw_init(self.params)
        return "initialized"

    def restore(self, step: int):
        meta = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device="meta"),
                        self.model.meta())
        like = {"params": meta, "opt": adamw_init(meta)}
        tree = self.store.restore(step, like, device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.data.load_state_dict(self.store.extra(step)["data"])
        self.step = self._saved_step = step

    def save(self, *, sync: bool = False):
        if self.store is None:
            return
        payload = {"params": self.params, "opt": self.opt_state}
        extra = {"data": self.data.state_dict(), "step": self.step}
        if sync:
            self.store.save(self.step, payload, extra=extra)
        else:
            self.store.save_async(self.step, payload, extra=extra)
        self._saved_step = self.step

    # -- loop ---------------------------------------------------------------
    def train(self, steps: int, *, log_every: int = 10, save_every: int = 50,
              crash_at: Optional[int] = None, log=print):
        """Steps until the step counter reaches ``steps``; returns the
        logged (step, loss) pairs.  Ends with a synchronous save of the last
        step, unless it was just saved."""
        if self.params is None:
            self.init_or_restore()
        losses = []
        t0 = time.time()
        while self.step < steps:
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, self.data.next_batch())
            self.step += 1
            if self.step % log_every == 0 or self.step == steps:
                loss = float(metrics["loss"])
                losses.append((self.step, loss))
                log(f"step {self.step:5d} loss {loss:.4f} grad_norm "
                    f"{float(metrics['grad_norm']):.4f} lr {float(metrics['lr']):.3e} "
                    f"({(time.time() - t0) / log_every:.2f}s/step)")
                t0 = time.time()
            if save_every and self.step % save_every == 0:
                self.save()
            if crash_at is not None and self.step >= crash_at:
                # a simulated node failure: the async save may be mid-write,
                # and the atomic rename keeps a restore from seeing it half
                # written
                raise SystemExit(42)
        if self.store is not None:
            if self._saved_step != self.step:
                self.save(sync=True)
            self.store.wait()
        return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    runner = TrainRunner(cfg, ckpt_dir=args.ckpt_dir, batch=args.batch, seq=args.seq,
                         accum=args.accum, seed=args.seed, device=args.device)
    print(f"[train] {cfg.name} ({'smoke' if args.smoke else 'FULL'}) on {runner.device} -> "
          f"{runner.init_or_restore()} @ step {runner.step}")
    runner.train(args.steps, log_every=args.log_every, save_every=args.save_every,
                 crash_at=args.crash_at)
    print(f"[train] done @ step {runner.step}")


if __name__ == "__main__":
    main()

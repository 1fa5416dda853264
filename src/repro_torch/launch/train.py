"""End-to-end training command.

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --full \\
      --batch 4 --seq 4096 --accum 2 --steps 20 --ckpt-dir /path/to/ckpt

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --mesh 2x2 --batch 8 --seq 64 --steps 20

Port of ``repro.launch.train``, with the same flags plus ``--device``
(default: the card):

* parameters drawn on the device from ``--seed``, or restored from the
  latest valid checkpoint in ``--ckpt-dir``;
* the deterministic, step-keyed token stream, whose step a restore resumes;
* async, atomic, self-validating checkpoints every ``--save-every`` steps;
  ``--crash-at N`` exits with code 42 after step N (after its save has
  started), and running the command again resumes from the latest valid
  checkpoint: the kill/resume path;
* ``--mesh DxM``: one rank a card under ``torchrun`` (which sets the
  rendezvous), D × M ranks on a ("data", "model") mesh, FSDP/ZeRO over the
  data axis.  Each rank holds its blocks of the parameters and of the
  optimizer state and draws its data coordinate's rows of each step; a
  checkpoint is the whole tree, so a run resumes on any mesh.  An attention
  stack trains in the sequence-parallel layout (``build_run``'s ``sp``:
  each rank S / M tokens of its rows, so ``--seq`` must divide by M; a
  layer's weights gathered inside its checkpoint).  The process
  group is ``torch.distributed``'s default for the device (NCCL on cards).
  Without ``--mesh`` the runner is the one-card one.
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
from ..optim import AdamWConfig, adamw_init, opt_pspecs
from ..parallel.mesh import data_axes, is_multi_pod, make_host_mesh
from ..parallel.spec import axis_index, axis_size, local_shard
from .shardings import data_rows
from .steps import build_train_step


class TrainRunner:
    """Owns the parameters, the optimizer state, the token stream and the
    checkpoint store; restartable at any saved step.  With ``mesh`` (a
    ``DeviceMesh``), this rank's blocks of the parameters and of the
    optimizer state, and its data coordinate's rows of each step."""

    def __init__(self, cfg, mesh=None, *, ckpt_dir: Optional[str], batch: int, seq: int,
                 accum: int = 1, seed: int = 0, opt_cfg: Optional[AdamWConfig] = None,
                 keep: int = 3, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.seed = seed
        self.store = CheckpointStore(ckpt_dir, keep=keep) if ckpt_dir else None
        self.step_fn, self.model, self.run = build_train_step(cfg, accum=accum, opt_cfg=opt_cfg,
                                                              device=device, mesh=mesh)
        rows = None
        if mesh is not None:
            dp = data_axes(mesh)
            rows = data_rows(batch, self.step_fn.accum, axis_size(mesh, dp), axis_index(mesh, dp))
            pspecs = self.model.pspecs(multi_pod=is_multi_pod(mesh))
            self.specs = {"params": pspecs, "opt": opt_pspecs(pspecs)}
        self.data = SyntheticTokenStream(
            DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
                       n_codebooks=cfg.n_codebooks), rows=rows)
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
        if self.mesh is not None:
            # every rank draws the same whole tree and keeps its blocks
            self.params = tree_map(lambda t, s: local_shard(t, s, self.mesh), self.params,
                                   self.specs["params"])
        self.opt_state = adamw_init(self.params)
        return "initialized"

    def restore(self, step: int):
        meta = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device="meta"),
                        self.model.meta())
        like = {"params": meta, "opt": adamw_init(meta)}
        mesh_kw = {} if self.mesh is None else {"mesh": self.mesh, "specs": self.specs}
        tree = self.store.restore(step, like, device=self.device, **mesh_kw)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.data.load_state_dict(self.store.extra(step)["data"])
        self.step = self._saved_step = step

    def save(self, *, sync: bool = False):
        if self.store is None:
            return
        payload = {"params": self.params, "opt": self.opt_state}
        extra = {"data": self.data.state_dict(), "step": self.step}
        mesh_kw = {} if self.mesh is None else {"mesh": self.mesh, "specs": self.specs}
        if sync:
            self.store.save(self.step, payload, extra=extra, **mesh_kw)
        else:
            self.store.save_async(self.step, payload, extra=extra, **mesh_kw)
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
    ap.add_argument("--mesh", default=None, help="DxM: a (data, model) mesh of D×M ranks, "
                    "launched by torchrun (default: one card, no mesh)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh, device, log = None, args.device, print
    if args.mesh:
        mesh, device = _mesh_from_flag(args.mesh, args.device)
        if torch.distributed.get_rank() != 0:
            log = _quiet
    runner = TrainRunner(cfg, mesh, ckpt_dir=args.ckpt_dir, batch=args.batch, seq=args.seq,
                         accum=args.accum, seed=args.seed, device=device)
    state = runner.init_or_restore()
    log(f"[train] {cfg.name} ({'smoke' if args.smoke else 'FULL'}) on {runner.device} "
        f"mesh={args.mesh or 'none'} -> {state} @ step {runner.step}")
    try:
        runner.train(args.steps, log_every=args.log_every, save_every=args.save_every,
                     crash_at=args.crash_at, log=log)
        log(f"[train] done @ step {runner.step}")
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _quiet(*_args, **_kw):
    pass


def _mesh_from_flag(spec: str, device):
    """Initialise ``torch.distributed`` from ``torchrun``'s environment (its
    default backend for the device) and build the ``DxM`` mesh; returns
    (mesh, this rank's device)."""
    import os

    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) != 2:
        raise ValueError("--mesh DxM")
    device_type = torch.device(device).type if device else "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--mesh on cards, and no CUDA device is available; pass "
                               "--device cpu")
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    torch.distributed.init_process_group()
    return make_host_mesh(shape, device_type=device_type), torch.device(device or device_type)


if __name__ == "__main__":
    main()

"""Multi-rank helpers for the port's tests: one world of CPU ranks over
gloo, and one run of the reference on forced host devices, each made once a
test session.

``spawn_once(name, fn, nprocs, tmp_path_factory, *args)`` runs
``fn(rank, world, *args)`` in ``nprocs`` processes of one
``torch.multiprocessing.spawn``, each in a gloo world of ``nprocs`` ranks
(a ``file://`` rendezvous, one torch thread a rank, a 120 s collective
timeout), and returns each rank's result (what ``fn`` returns, saved with
``torch.save``).  ``reference_once(name, script, tmp_path_factory)`` runs a
script of the reference in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and returns the
arrays it saved to ``$OUT`` (``np.savez``) and what it printed as JSON on
its last line.  Under ``pytest-xdist`` the workers share one result of
each (a file lock in the session's shared temporary directory), so every
world runs once whatever the split.
"""

from __future__ import annotations

import datetime
import fcntl
import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def _shared_dir(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    # xdist gives each worker basetemp/popen-gwN; the parent is shared
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = root / "torch_dist"
    out.mkdir(exist_ok=True)
    return out


@contextmanager
def _locked(path: Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _rank_main(rank, world, rendezvous, out_dir, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_once(name: str, fn, nprocs: int, tmp_path_factory, *args) -> list:
    shared = _shared_dir(tmp_path_factory)
    run_dir = shared / name
    done = shared / f"{name}.done"
    with _locked(shared / f"{name}.lock"):
        if not done.exists():
            run_dir.mkdir(exist_ok=True)
            torch.multiprocessing.spawn(
                _rank_main, args=(nprocs, str(run_dir / "rendezvous"), str(run_dir), fn, args),
                nprocs=nprocs)
            done.touch()
    return [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]


def reference_once(name: str, script: str, tmp_path_factory, env=None):
    """(arrays, info) of the reference's ``script``, run once a session,
    with ``env`` added to its environment."""
    shared = _shared_dir(tmp_path_factory)
    out = shared / f"{name}.npz"
    info_path = shared / f"{name}.json"
    with _locked(shared / f"{name}.lock"):
        if not info_path.exists():
            full = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu",
                    "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "OUT": str(out),
                    **(env or {})}
            res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                                 env=full, timeout=600)
            assert res.returncode == 0, res.stderr[-3000:]
            info_path.write_text(res.stdout.strip().splitlines()[-1])
    arrays = {}
    if out.exists():
        with np.load(out, allow_pickle=False) as data:
            arrays = {k: data[k] for k in data.files}
    return arrays, json.loads(info_path.read_text())

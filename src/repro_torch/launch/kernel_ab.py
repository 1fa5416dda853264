"""Time the graph kernels ``frontier_expand`` and ``probe_place`` of two
checkouts of the port in turns, on one card.

Each checkout's ``src/repro_torch`` runs in a process of its own (the two
packages share one name), which builds that checkout's kernels, makes the
same inputs from the seed and times each kernel's wrapper as called with
CUDA events, the L2 cache flushed before each run (as ``chip_smoke.py``
times them).  The inputs have the shapes of ``chip_smoke.py``'s phase 4:

* ``frontier_expand`` at S 16 and S 256 over a table of 2^23 + 1 columns
  (the sentinel last) and 2^23 edge lanes, 2,987,624 of them live between
  1,134,890 live slots (SNAP com-Youtube's counts) and sorted by source, the
  others on the sentinel column, as ``build_csr`` leaves them; each row of
  the frontier holds 1% of the live slots;
* ``probe_place`` of 1,134,890 keys in 2^21 lanes into 2^22 slots.

Each process prints one JSON line (its checkout, the card, the times, the
frontier's atomics); the runs go in the order of ``--roots``, then back.
A root is the top of a checkout (a parent commit unpacked with
``git archive`` under ``build/``, say); each builds its kernels there.

    PYTHONPATH=src python3 -m repro_torch.launch.kernel_ab --roots build/parent . [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

N_COLS = (1 << 23) + 1
N_EDGES = 1 << 23
LIVE_VERTICES, LIVE_EDGES = 1_134_890, 2_987_624
PLACE_M, PLACE_CAP, MAX_PROBES = 1 << 21, 1 << 22, 32
L2_FLUSH_BYTES = 256 << 20
FRONTIER_SHARE = 0.01  # of the live slots, on each row of the frontier


def cuda_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` in ms, L2 flushed before each run."""
    scrub = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_one(root: Path, seed: int) -> dict:
    """Build ``root``'s kernels and time them on the inputs of ``seed``."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.core.hashing import hash_vertex
    from repro_torch.kernels.compact import kernel as ck
    from repro_torch.kernels.frontier import kernel as fk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    live = torch.randperm(N_COLS - 1, generator=gen, device=dev)[:LIVE_VERTICES].to(torch.int32)
    src = torch.full((N_EDGES,), N_COLS - 1, dtype=torch.int32, device=dev)
    dst = src.clone()
    for col in (src, dst):
        col[:LIVE_EDGES] = live[torch.randint(0, LIVE_VERTICES, (LIVE_EDGES,), generator=gen,
                                              device=dev)]
    order = torch.argsort(src, stable=True)
    src, dst = src[order].contiguous(), dst[order].contiguous()
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    for s_n in (16, 256):
        frontier = torch.zeros((s_n, N_COLS), dtype=torch.bool, device=dev)
        on = torch.rand((s_n, LIVE_VERTICES), generator=gen, device=dev) < FRONTIER_SHARE
        frontier[:, live.long()] = on
        del on
        atomics = int(frontier.sum(0, dtype=torch.int64)[src.long()].sum())
        fk.frontier_expand(frontier, src, dst)
        out[f"frontier_expand_s{s_n}_ms"] = cuda_ms(
            torch, lambda: fk.frontier_expand(frontier, src, dst), 10)
        out[f"frontier_expand_s{s_n}_atomics"] = atomics
        del frontier
        torch.cuda.empty_cache()
    keys = torch.full((PLACE_M,), -1, dtype=torch.int32, device=dev)
    keys[:LIVE_VERTICES] = torch.randperm(1 << 24, generator=gen, device=dev)[:LIVE_VERTICES] \
        .to(torch.int32)
    active = torch.arange(PLACE_M, device=dev) < LIVE_VERTICES
    home = torch.where(active, hash_vertex(keys, PLACE_CAP), 0)
    ck.probe_place(home, active, capacity=PLACE_CAP, max_probes=MAX_PROBES)
    out["probe_place_ms"] = cuda_ms(
        torch, lambda: ck.probe_place(home, active, capacity=PLACE_CAP, max_probes=MAX_PROBES),
        20)
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--roots", nargs="+", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child's checkout
    args = parser.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve(), args.seed)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    code = 0
    for root in list(args.roots) + list(reversed(args.roots)):
        # this file run as a script, so the child imports only root's package
        res = subprocess.run(
            [sys.executable, __file__, "--roots", *map(str, args.roots), "--seed", str(args.seed),
             "--one", str(root)],
            env={**os.environ, "PYTHONPATH": ""}, timeout=900)
        code = code or res.returncode
    return code


if __name__ == "__main__":
    sys.exit(main())

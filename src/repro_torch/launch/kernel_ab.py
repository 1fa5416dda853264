"""Time kernels of two checkouts of the port in turns, on one card.

Each checkout's ``src/repro_torch`` runs in a process of its own (the two
packages share one name), which builds that checkout's kernels, makes the
same inputs from the seed and times each kernel's wrapper as called with
CUDA events, the L2 cache flushed before each run (as ``chip_smoke.py``
times them).  The inputs have the shapes of ``chip_smoke.py``'s phases 4
and 13:

* ``frontier_expand`` at S 16 and S 256 over a table of 2^23 + 1 columns
  (the sentinel last) and 2^23 edge lanes, 2,987,624 of them live between
  1,134,890 live slots (SNAP com-Youtube's counts) and sorted by source, the
  others on the sentinel column, as ``build_csr`` leaves them; each row of
  the frontier holds 1% of the live slots;
* ``probe_place`` of 1,134,890 keys in 2^21 lanes into 2^22 slots;
* ``hash_probe`` of 2^17 queries, half of them present, into a table of
  2^23 slots holding 1,134,890 keys placed by the engine's claim path, with
  the L2 flushed and warm;
* ``paged_attention`` at one bf16 decode step of qwen2-7b (28/4 heads of
  128, lengths 4,096-32,768) and of zamba2-1.2b's shared block (32 heads of
  64, lengths 1,024-4,096): 16 sequences, pages of 16, each table a random
  draw of the pool's pages; timed as called with the tables on the card and
  (where the checkout's wrapper takes them) on the host, each run's event
  time beside its host time, and its kernels' device time under
  ``torch.profiler``; where the wrapper stages host tables with a kernel,
  also with the tables copied by a copy engine instead
  (:func:`copy_engine_upload`);
* ``flash_attention`` at qwen2-7b's bf16 prefill shape (B 2, Hq 28, Hkv 4,
  S 4,096, D 128, causal), and where the checkout's wrapper takes
  ``q_offset`` also at the last of 4 blocks of that sequence (Sq 1,024 at
  offset 3,072), each run's time kept.

Each process prints one JSON line (its checkout, the card, the times); the
runs go in the order of ``--roots``, then back.  A root is the top of a
checkout (a parent commit unpacked with ``git archive`` under ``build/``,
say); each builds its kernels there.  ``--only`` names the kernels to time.

    PYTHONPATH=src python3 -m repro_torch.launch.kernel_ab --roots build/parent . [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_COLS = (1 << 23) + 1
N_EDGES = 1 << 23
LIVE_VERTICES, LIVE_EDGES = 1_134_890, 2_987_624
PLACE_M, PLACE_CAP, MAX_PROBES = 1 << 21, 1 << 22, 32
L2_FLUSH_BYTES = 256 << 20
HOLD_CYCLES = 400_000  # about 0.2 ms of the card's clock
FRONTIER_SHARE = 0.01  # of the live slots, on each row of the frontier
PROBE_CAP, PROBE_QUERIES = 1 << 23, 1 << 17
PAGED = {"qwen2-7b": (4096, 32768), "zamba2-1.2b": (1024, 4096)}  # decode lengths
PAGED_BATCH, PAGED_PAGE = 16, 16
KERNELS = ("frontier_expand", "probe_place", "hash_probe", "paged_attention", "flash_attention")
FLASH_ARCH, FLASH_BATCH, FLASH_SEQ, FLASH_BLOCKS, FLASH_REPS = "qwen2-7b", 2, 4096, 4, 20


def cuda_ms(torch, fn, reps: int, flush: bool = True, runs: list | None = None) -> float:
    """Median CUDA-event time of ``fn()`` in ms, L2 flushed before each run;
    with ``flush`` False the L2 stays as the last run left it, and a spin
    that touches no memory holds the card while the host enqueues.  Where
    ``runs`` is a list, each run's (event ms, host ms of ``fn()``) goes
    into it: an event time near the host time is the host's."""
    scrub = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        if flush:
            scrub.zero_()
        else:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if runs is not None:
            runs.append((round(times[-1], 5), round(1e3 * host, 5)))
    return statistics.median(times)


def device_ms(torch, fn, name: str, reps: int = 5) -> float:
    """Device time a call of ``fn`` spends in kernels whose name holds
    ``name``, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if name in e.key) / reps / 1e3


def time_graph_kernels(torch, dev, gen, out: dict, only) -> None:
    from repro_torch.core.hashing import hash_vertex
    from repro_torch.kernels.compact import kernel as ck
    from repro_torch.kernels.frontier import kernel as fk

    live = torch.randperm(N_COLS - 1, generator=gen, device=dev)[:LIVE_VERTICES].to(torch.int32)
    if "frontier_expand" in only:
        src = torch.full((N_EDGES,), N_COLS - 1, dtype=torch.int32, device=dev)
        dst = src.clone()
        for col in (src, dst):
            col[:LIVE_EDGES] = live[torch.randint(0, LIVE_VERTICES, (LIVE_EDGES,), generator=gen,
                                                  device=dev)]
        order = torch.argsort(src, stable=True)
        src, dst = src[order].contiguous(), dst[order].contiguous()
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
    if "probe_place" in only:
        keys = torch.full((PLACE_M,), -1, dtype=torch.int32, device=dev)
        keys[:LIVE_VERTICES] = torch.randperm(1 << 24, generator=gen, device=dev)[:LIVE_VERTICES] \
            .to(torch.int32)
        active = torch.arange(PLACE_M, device=dev) < LIVE_VERTICES
        home = torch.where(active, hash_vertex(keys, PLACE_CAP), 0)
        ck.probe_place(home, active, capacity=PLACE_CAP, max_probes=MAX_PROBES)
        out["probe_place_ms"] = cuda_ms(
            torch, lambda: ck.probe_place(home, active, capacity=PLACE_CAP,
                                          max_probes=MAX_PROBES), 20)


def time_hash_probe(torch, dev, gen, out: dict) -> None:
    """phase 4's shape: 2^17 queries, half present, into 2^23 slots."""
    from repro_torch.core.locate import claim_vertex_slots
    from repro_torch.kernels.hash_probe import kernel as hk

    keys = torch.randperm(1 << 30, generator=gen, device=dev)[:LIVE_VERTICES].to(torch.int32)
    table = torch.full((PROBE_CAP,), -1, dtype=torch.int32, device=dev)
    table, _, over, _ = claim_vertex_slots(
        table, keys, torch.ones(LIVE_VERTICES, dtype=torch.bool, device=dev))
    assert not bool(over)
    half = PROBE_QUERIES // 2
    q = torch.cat([keys[torch.randperm(LIVE_VERTICES, generator=gen, device=dev)[:half]],
                   torch.randint(1 << 30, 2**31 - 1, (half,), generator=gen, device=dev,
                                 dtype=torch.int32)])
    out["hash_probe_ms"] = cuda_ms(torch, lambda: hk.hash_probe(table, q), 20)
    out["hash_probe_warm_l2_ms"] = cuda_ms(torch, lambda: hk.hash_probe(table, q), 20,
                                           flush=False)


def copy_engine_upload(block_table, seq_lens, device):
    """Host tables onto ``device`` by ``cudaMemcpyAsync`` from a pinned
    buffer (a copy engine), for comparison with the wrapper's staging
    kernel."""
    import torch

    n = block_table.numel()
    buf = torch.empty(n + seq_lens.numel(), dtype=torch.int32, pin_memory=True)
    flat = buf.numpy()
    flat[:n] = block_table.numpy().reshape(-1)
    flat[n:] = seq_lens.numpy()
    dev = buf.to(device, non_blocking=True)
    return dev[:n].view(block_table.shape), dev[n:]


def time_paged_attention(torch, dev, seed: int, out: dict) -> None:
    """phase 13's shapes, on tables drawn from the pool at random."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pak

    for arch, (lo, hi) in PAGED.items():
        cfg = get_config(arch)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        rng = np.random.default_rng(seed)
        lens = rng.integers(lo, hi + 1, PAGED_BATCH).astype(np.int32)
        pps = -(-hi // PAGED_PAGE)
        pages = int(sum(-(-int(n) // PAGED_PAGE) for n in lens))
        table = np.zeros((PAGED_BATCH, pps), np.int32)
        perm, at = rng.permutation(pages).astype(np.int32), 0
        for i, n in enumerate(lens):
            k = -(-int(n) // PAGED_PAGE)
            table[i, :k], at = perm[at:at + k], at + k
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(PAGED_BATCH, hq, d, generator=gen, device=dev).bfloat16()
        kp, vp = (torch.randn(pages, PAGED_PAGE, hkv, d, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
        host = (torch.as_tensor(table), torch.as_tensor(lens))
        card = tuple(t.to(dev) for t in host)
        key = f"paged_attention_{arch}"
        out[f"{key}_card_tables_runs"] = []
        out[f"{key}_card_tables_ms"] = cuda_ms(torch, lambda: pak.paged_attention(q, kp, vp, *card),
                                               10, runs=out[f"{key}_card_tables_runs"])
        try:
            pak.paged_attention(q, kp, vp, *host)
            out[f"{key}_host_tables_runs"] = []
            out[f"{key}_host_tables_ms"] = cuda_ms(
                torch, lambda: pak.paged_attention(q, kp, vp, *host), 10,
                runs=out[f"{key}_host_tables_runs"])
        except ValueError:  # a wrapper that takes only tables on the card
            out[f"{key}_host_tables_ms"] = None
        if hasattr(pak, "_STAGING"):  # the same, the tables copied by a copy engine
            staged, pak._upload = pak._upload, copy_engine_upload
            try:
                out[f"{key}_host_tables_copy_engine_runs"] = []
                out[f"{key}_host_tables_copy_engine_ms"] = cuda_ms(
                    torch, lambda: pak.paged_attention(q, kp, vp, *host), 10,
                    runs=out[f"{key}_host_tables_copy_engine_runs"])
            finally:
                pak._upload = staged
        out[f"{key}_kernels_device_ms"] = device_ms(
            torch, lambda: pak.paged_attention(q, kp, vp, *card), "paged_")
        out[f"{key}_live_rows"] = int(lens.sum())
        del q, kp, vp
        torch.cuda.empty_cache()


def time_flash_attention(torch, dev, seed: int, out: dict) -> None:
    import inspect

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fak

    cfg = get_config(FLASH_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (FLASH_BATCH, cfg.n_heads, FLASH_SEQ, cfg.head_dim)
    q = torch.randn(shape, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((FLASH_BATCH, cfg.n_kv_heads, FLASH_SEQ, cfg.head_dim), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    out["flash_attention_runs"] = []
    out["flash_attention_ms"] = cuda_ms(torch, lambda: fak.flash_attention(q, k, v, causal=True),
                                        FLASH_REPS, runs=out["flash_attention_runs"])
    if "q_offset" in inspect.signature(fak.flash_attention).parameters:
        sq = FLASH_SEQ // FLASH_BLOCKS
        qb = q[:, :, -sq:].contiguous()
        out["flash_attention_sp_block_runs"] = []
        out["flash_attention_sp_block_ms"] = cuda_ms(
            torch, lambda: fak.flash_attention(qb, k, v, causal=True, q_offset=FLASH_SEQ - sq),
            FLASH_REPS, runs=out["flash_attention_sp_block_runs"])
    del q, k, v
    torch.cuda.empty_cache()


def run_one(root: Path, seed: int, only) -> dict:
    """Build ``root``'s kernels and time them on the inputs of ``seed``."""
    sys.path.insert(0, str(root / "src"))
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    if {"frontier_expand", "probe_place"} & set(only):
        time_graph_kernels(torch, dev, gen, out, only)
    if "hash_probe" in only:
        time_hash_probe(torch, dev, gen, out)
    if "paged_attention" in only:
        time_paged_attention(torch, dev, seed, out)
    if "flash_attention" in only:
        time_flash_attention(torch, dev, seed, out)
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--roots", nargs="+", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="+", choices=KERNELS, default=list(KERNELS))
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child's checkout
    args = parser.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve(), args.seed, args.only)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    code = 0
    for root in list(args.roots) + list(reversed(args.roots)):
        # this file run as a script, so the child imports only root's package
        res = subprocess.run(
            [sys.executable, __file__, "--roots", *map(str, args.roots), "--seed", str(args.seed),
             "--only", *args.only, "--one", str(root)],
            env={**os.environ, "PYTHONPATH": ""}, timeout=900)
        code = code or res.returncode
    return code


if __name__ == "__main__":
    sys.exit(main())

"""Serving command: continuous batching over the wait-free paged KV table.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --requests 16 --max-batch 4 --verify-failover

Port of ``repro.launch.serve``, with the same flags plus two: ``--full``
serves the published configuration instead of the reduced smoke one, and
``--device`` (default: the card) says where.  Parameters are random, drawn
on that device from ``--seed``.  Prints per-request completions, engine
throughput, page-table stats, and (with ``--verify-failover``) replays the
deterministic op log into a twin manager to show that a replacement host
reconstructs identical page tables.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_NAMES, get_config, get_smoke_config
from ..device import resolve_device
from ..models import LM
from ..serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-7b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published configuration, not the smoke one")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify-failover", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    device = resolve_device(args.device, "serve")
    model = LM(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServingEngine(
        cfg, params, max_batch=args.max_batch, max_len=args.max_len,
        page_size=args.page_size, seed=args.seed, device=device,
    )

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        shape = (plen,) if cfg.n_codebooks == 1 else (plen, cfg.n_codebooks)
        eng.submit(Request(
            id=i,
            prompt=rng.integers(0, cfg.vocab, size=shape).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
        ))

    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.generated) for r in done.values())
    print(f"[serve] {cfg.name} on {device}: {len(done)} requests, {total_new} tokens, "
          f"{eng.ticks} ticks, {total_new / dt:.1f} tok/s")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: {done[rid].generated}")
    print(f"[serve] page ops applied: {sum(len(o[0]) for o in eng.pages.op_log)}"
          f" | free pages {len(eng.pages.free)}/{eng.pages.num_pages}")
    if args.verify_failover:
        eng.failover()
        print("[serve] failover replay: page tables identical")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Readings behind two rules of the port's mesh tests, on the CPU, in a gloo
world of 4 ranks.

rwkv6 (``--part rwkv6``): the d-sharded layout's f32 gradients at the smoke
widths of ``tests/test_torch_recurrent_tp.py``, on each of its rwkv6 cases,
for several seeds of parameters and batch.  For each case and leaf it
prints the largest relative L2 distance, over the seeds and the ranks'
blocks, of the mesh's f32 leaf from one device's f32 leaf, of one device's
f32 leaf from its float64 one, and of the mesh's f32 leaf from one
device's float64 one: how far f32 rounding alone moves a leaf of that
random stack, against how far the mesh's ordering of the sums moves it.

zamba2 (``--part zamba2``): the FSDP train steps of
``tests/test_torch_sharded_train.py`` on (2, 2).  For each case it prints
the worst leaf of the state after step 1 against one device's, of the
state after step 2 against one device's two steps and against one
device's step 2 from the mesh's own state after step 1, and, for each leaf
that starts at zero, its elements that moved furthest from one device's
after step 1 beside the two clipped gradients and the bound lr · |a - b| /
(min(|a|, |b|) + eps) that the test holds them to.

    PYTHONPATH=src:tests python tools/torch_mesh_readings.py [--part rwkv6 zamba2] [--seeds 3]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import test_torch_recurrent_tp as R  # noqa: E402
import test_torch_sharded_train as S  # noqa: E402
from _torch_dist import _rank_main  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel.spec import local_shard  # noqa: E402

RWKV6_CASES = [(a, m) for a, m in R.CASES if a != "zamba2-1.2b"]


def _seeds(n: int) -> list:
    """(parameter seed, constants' seed, batch seed): the tests' first."""
    return [(5, 6, 1)] + [(10 * i + 1, 10 * i + 2, 10 * i + 3) for i in range(1, n)]


def _params(cfg, s0: int, s1: int):
    """``R._params`` at other seeds."""
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(s0))
    g = torch.Generator().manual_seed(s1)
    meta = model.meta()["blocks"]
    for name in sorted(meta):
        items = meta[name].items() if isinstance(meta[name], dict) else [(None, meta[name])]
        for key, m in items:
            if m.init not in ("zeros", "ones"):
                continue
            tree = params["blocks"] if key is None else params["blocks"][name]
            k = name if key is None else key
            tree[k] = tree[k] + 0.5 * torch.rand(tree[k].shape, generator=g)
    return params


def _batch(cfg, seed: int) -> dict:
    """``R._batch`` at another seed."""
    rng = np.random.default_rng(seed)
    mask = np.ones((R.B, R.SEQ), np.float32)
    mask[1, ::3] = 0.0
    mask[2, :5] = 0.0
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (R.B, R.SEQ)).astype(np.int32)),
            "targets": torch.as_tensor(rng.integers(0, cfg.vocab, (R.B, R.SEQ)).astype(np.int32)),
            "mask": torch.as_tensor(mask)}


def _world(fn, *args) -> list:
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(_rank_main, args=(4, f"{d}/rv", d, fn, args), nprocs=4)
        return [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(4)]


def _rwkv6_rank(rank, world, seeds):
    from repro_torch.parallel.mesh import make_host_mesh

    meshes = {n: make_host_mesh(s, device_type="cpu") for n, s in R.MESHES.items()}
    out = {}
    for seed in seeds:
        for arch, name in RWKV6_CASES:
            cfg, mesh = R._cfg(arch), meshes[name]
            model = LM(cfg, device="cpu")
            blocks = tree_map(lambda t, s: local_shard(t, s, mesh), _params(cfg, *seed[:2]),
                              model.pspecs(multi_pod=False))
            rows = R._rows(R.MESHES[name], mesh.get_local_rank("data"))
            mine = {k: v[rows] for k, v in _batch(cfg, seed[2]).items()}
            out[(seed, arch, name)] = R._loss_grads(model, blocks, mine,
                                                   {"mesh": mesh, "sp": True})[1]
    return out


def _rwkv6(seeds: list) -> None:
    ranks = _world(_rwkv6_rank, seeds)
    worst = {}
    for seed in seeds:
        for arch in sorted({a for a, _ in RWKV6_CASES}):
            cfg = R._cfg(arch)
            model = LM(cfg, device="cpu")
            params, batch = _params(cfg, *seed[:2]), _batch(cfg, seed[2])
            names = S._paths(params)
            g32 = R._loss_grads(model, params, batch, {})[1]
            p64 = tree_map(lambda t: t.double(), params)
            b64 = {**batch, "mask": batch["mask"].double()}
            with R._float64():
                g64 = R._loss_grads(model, p64, b64, {})[1]
            leaves = tree_leaves(params)
            g32 = [np.zeros(t.shape, np.float32) if g is None else g for t, g in zip(leaves, g32)]
            g64 = [np.zeros(t.shape) if g is None else g for t, g in zip(leaves, g64)]
            for _, name in [c for c in RWKV6_CASES if c[0] == arch]:
                shape = R.MESHES[name]
                for rank in range(4):
                    got = ranks[rank][(seed, arch, name)]
                    w32 = R._blocks(g32, arch, rank, shape)
                    w64 = R._blocks(g64, arch, rank, shape)
                    for i, leaf in enumerate(names):
                        if np.linalg.norm(w64[i]) < 1e-6:
                            continue
                        g = np.zeros(w32[i].shape, np.float32) if got[i] is None else got[i]
                        now = (R._rel_l2(g, w32[i]), R._rel_l2(w32[i], w64[i]),
                               R._rel_l2(g, w64[i]))
                        key = (f"{arch}|{name}", leaf)
                        worst[key] = tuple(max(a, b) for a, b in zip(worst.get(key, now), now))
    print(f"rwkv6 f32 gradients, {len(seeds)} seeds, relative L2 (the largest over seeds and "
          f"ranks)")
    print(f"{'case':22s} {'leaf':18s} {'mesh32-one32':>12s} {'one32-one64':>12s} "
          f"{'mesh32-one64':>12s}")
    for (case, leaf), (a, b, c) in sorted(worst.items()):
        print(f"{case:22s} {leaf:18s} {a:12.3e} {b:12.3e} {c:12.3e}")


def _zamba2() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _world(S._rank, tmp)
    opt = AdamWConfig(**S.STEP_OPT)
    for (arch, accum, _), key in zip(S.STEP_CASES, S.STEP_IDS):
        cfg = get_smoke_config(arch)
        specs = S._specs(cfg)
        start = S._params(cfg)
        names = S._paths({"params": start, "opt": adamw_init(start)})
        pnames = S._paths(start)
        want = S._oracle(arch, accum)
        after = S._step2_from_the_mesh(arch, accum, key, ranks)
        got = {k: S._assemble([r[key][k] for r in ranks], tree_leaves(specs))
               for k in ("state1", "state2")}
        grads = S._assemble([r[key]["grads"] for r in ranks], tree_leaves(specs["params"]))

        def worst(a, b):
            return max((S._rel_l2(x, y), n) for x, y, n in zip(a, b, names)
                       if np.linalg.norm(y) >= 1e-6)

        print(f"{key}: state after step 1 {worst(got['state1'], want['state1'])}; after step 2 "
              f"against one device's two steps {worst(got['state2'], want['state2'])}, against "
              f"one device's step 2 from the mesh's state {worst(got['state2'], after)}")
        norm_one = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                               for g in want["grads"]))
        scale = (min(1.0, opt.clip_norm / ranks[0][key]["grad_norm"][0]),
                 min(1.0, opt.clip_norm / norm_one))
        for j, (n, t) in enumerate(zip(pnames, tree_leaves(start))):
            if t.any():
                continue
            a = grads[j].astype(np.float64).ravel() * scale[0]
            b = want["grads"][j].astype(np.float64).ravel() * scale[1]
            i = names.index(f"params/{n}")
            err = np.abs(got["state1"][i].astype(np.float64) - want["state1"][i]).ravel()
            bound = opt.lr * np.abs(a - b) / (np.minimum(np.abs(a), np.abs(b)) + opt.eps)
            print(f"  {n}: {err.size} elements, worst |dp| {err.max():.3e}, every element "
                  f"within 2 bound + 1e-6 lr: {bool((err <= 2 * bound + 1e-6 * opt.lr).all())}")
            for e in np.argsort(-err)[:3]:
                print(f"    element {e}: |dp| {err[e]:.3e}; clipped gradient mesh {a[e]:.6e}, "
                      f"one device {b[e]:.6e}; bound {bound[e]:.3e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", nargs="+", choices=("rwkv6", "zamba2"), default=["rwkv6", "zamba2"])
    ap.add_argument("--seeds", type=int, default=3, help="rwkv6: seeds of parameters and batch")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if "rwkv6" in args.part:
        _rwkv6(_seeds(args.seeds))
    if "zamba2" in args.part:
        _zamba2()


if __name__ == "__main__":
    main()

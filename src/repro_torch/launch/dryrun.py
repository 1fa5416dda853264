"""Dry run of every (arch × shape) cell for one H100: count each step's
work and check its memory against one card, with nothing allocated.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh production [--multi-pod]
      [--sp-off]

The port's counterpart of ``repro.launch.dryrun``, which lowers and compiles
each cell's step on ``ShapeDtypeStruct`` stand-ins for a mesh of 256 or 512
TPU chips and reads ``memory_analysis()``, ``cost_analysis()`` and
``hloparse``.  Here the step is the port's own (``build_*_step(...,
device="meta")``), its inputs the ``input_specs`` stand-ins on the ``meta``
device, and ``opcost`` counts it as it is dispatched: flops, bytes,
transcendentals, collectives (none on one card), the ops that predict the
launches, and the bytes alive.  On ``meta`` the kernels' ``ops.py`` take
their plain versions, so the count is of the arithmetic, whatever runs it on
the card.  A train cell counts one microbatch (``train_step.microbatch``)
weighted by the reference's ``TRAIN_ACCUM``, then the rest of the step
once, as ``hloparse`` weights a scan body by its trip count; its memory is
the step's arguments, the f32 gradient sum, and the larger of the two
parts' own peaks.

Nothing runs on a device and CUDA is never initialised: like the
reference's dry run on the CPU host platform, this is a count, not a
fallback of any entry point that runs the model.  A cell fits when its
arguments and temporaries fit ``H100_BYTES``; the reference spreads the same
cells over 256 or 512 chips, and most do not fit one card.

**Per device** (``--mesh production``, ``--multi-pod``): each cell is the
program of one device of ``make_production_mesh()``, (16, 16) over
("data", "model") or (2, 16, 16) over ("pod", "data", "model"), as the
reference counts its cells.  The step is built with a ``MeshDescription``
standing for that device (:func:`counted_device`: data and pod index 0,
model index M - 1, whose q block is the last and so, under the causal mask,
the heaviest), its inputs are that device's blocks (``input_specs`` on the
description), and the collectives it calls return ``meta`` tensors of the
gathered or reduced shape, which ``opcost`` counts by kind at their
result's bytes.  The count is of the port's own program on NCCL or gloo,
not of the reference's HLO: a reduce-scatter is what the port issues, an
all-reduce of the whole tensor (in f32) and a copy of one's own block, so
its bytes and its buffer are the whole tensor's; and every all-gather
allocates beside its result the staging buffer of the result's size that
both backends allocate for the port's list all-gather
(``parallel/collectives.py``; ``chip_smoke.py`` phase 22 measures it on
each).  ``collective_bytes`` and ``fits`` are that program's.  The attention stacks run in the sequence-parallel layout
(``build_run``'s ``sp``), the recurrent stacks (ssm, hybrid) in the
d-sharded one (the residual's d over "model" between layers, each layer's
heads dealt over it; ``LM.layout`` names both, and ``gathered-whole`` where
``sp`` is off: every dense weight gathered whole for the step);
every decode cell in the striped-cache layout (``build_decode_step(mesh=)``:
the cache's T striped over "model", the partial softmaxes merged, one
layer's weights gathered at a time).  ``layout`` names it.
``spec_argument_bytes`` is the bytes of the inputs the step reads by their
specs' block shapes, which ``argument_bytes`` (what the count saw read) must
equal.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from ..configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config
from ..models.lm import ring_record
from ..models.module import tree_leaves
from ..parallel.mesh import axis_sizes, make_production_mesh
from . import opcost
from . import steps as S

# One H100 SXM's device memory as its data sheet gives it (80 GB); the card
# reports a little more (``total_memory``), which chip_smoke.py checks
H100_BYTES = 80 * 10**9
SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md §5)"


def counted_device(mesh):
    """The device of ``mesh`` (a ``MeshDescription``) that a per-device cell
    counts: index 0 on every data axis, the last model index."""
    return mesh.at(model=axis_sizes(mesh)["model"] - 1)


def _read_input_bytes(kind: str, specs) -> int:
    """The bytes of the stand-ins a step of ``kind`` reads: everything for a
    train step; the parameters, the tokens and the image memory for a
    prefill (the batch's targets and mask are not read); the parameters,
    the tokens and the cache for a decode step (the image memory is taken
    and not read, and without the cross K/V in the cache, as ``cache_specs``
    gives it, the cross blocks do not run)."""
    if kind == "prefill":
        batch = specs["batch"]
        specs = {"params": specs["params"], "tokens": batch["tokens"],
                 "memory": batch.get("memory")}
    elif kind == "decode":
        params = specs["params"]
        if "xkv" not in specs["cache"]:
            params = {k: v for k, v in params.items() if k != "xattn"}
        specs = {"params": params, "tokens": specs["tokens"], "cache": specs["cache"]}
    return sum(t.numel() * t.element_size() for t in tree_leaves(specs) if t is not None)


def _train_costs(step, params, opt_state, batch) -> opcost.Costs:
    """The train step's count: with accumulation, its f32 zeros, one
    microbatch weighted by ``step.accum`` and the update, each counted
    alone; the memory put together from the three."""
    if step.accum == 1:
        return opcost.count(step, params, opt_state, batch)
    rows = next(iter(batch.values())).shape[0] // step.accum
    begin = opcost.count(step.begin, params)
    gsum = begin.result
    body = opcost.count(step.microbatch, params, {k: v[:rows] for k, v in batch.items()}, gsum,
                        weight=step.accum)
    finish = opcost.count(step.finish, params, opt_state, gsum, body.result)
    gsum_bytes = begin.output_bytes
    given = opcost.storages((params, opt_state, batch))
    used = {k: n for part in (body, finish) for k, n in part.arguments_used.items()
            if k in given}
    step_args = sum(used.values())
    total = opcost.Costs(
        argument_bytes=step_args, output_bytes=finish.output_bytes,
        alias_bytes=finish.alias_bytes,
        peak_bytes=step_args + gsum_bytes + max(body.temp_bytes, finish.temp_bytes))
    for part in (begin, body, finish):
        total.add(part)
    return total


def run_cell(arch: str, shape, *, mesh=None, verbose: bool = True, cfg=None,
             run_overrides: dict = None) -> dict:
    """One cell: ``shape`` is a name of ``SHAPES`` or a dict with its keys
    (``seq_len``, ``global_batch``, ``kind``).  With ``mesh`` (a
    ``MeshDescription``), the program of one device of it: the one its
    ``coordinate`` names, or :func:`counted_device`.  ``cfg`` stands in for
    the arch's config (a test's smoke config); ``run_overrides`` go to the
    step's builder (``{"sp": False}`` counts the gathered-whole layout)."""
    cfg = cfg or get_config(arch)
    name = shape if isinstance(shape, str) else dict(shape)
    if isinstance(shape, str) and not cell_is_runnable(cfg, shape):
        return {"arch": arch, "shape": name, "status": "skipped", "reason": SKIP_REASON}
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    kind = sh["kind"]
    placed = {}
    if mesh is not None:
        if mesh.coordinate is None:
            mesh = counted_device(mesh)
        placed = {"mesh": {"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names)},
                  "device": dict(zip(mesh.mesh_dim_names, mesh.coordinate)),
                  "n_devices": int(math.prod(mesh.shape))}
    t0 = time.perf_counter()
    specs = S.input_specs(cfg, sh, mesh)
    micro = None
    if kind == "train":
        step, model, run = S.build_train_step(cfg, device=S.META, mesh=mesh,
                                              run_overrides=run_overrides)
        costs = _train_costs(step, **specs)
        micro = step.accum
    elif kind == "prefill":
        step, model, run = S.build_prefill_step(cfg, device=S.META, mesh=mesh,
                                                run_overrides=run_overrides)
        costs = opcost.count(step, **specs)
    else:
        step, model, run = S.build_decode_step(cfg, device=S.META, mesh=mesh,
                                               run_overrides=run_overrides)
        ring = ring_record(S.cache_specs(cfg, sh), S.META) if mesh is not None else None
        if ring is not None:  # as shardings.decode_cache records the rings' T
            specs["cache"]["ring"] = ring
        costs = opcost.count(step, **specs)
    trace_s = time.perf_counter() - t0
    if mesh is not None:
        # the layout a step on a mesh runs: the striped-cache decode, or the
        # prefill's and the loss's (``LM.layout``: sequence-parallel,
        # d-sharded or gathered-whole)
        layout = "striped-cache" if kind == "decode" else model.layout(run)
        placed.update(layout=layout, spec_argument_bytes=_read_input_bytes(kind, specs))
    summary = opcost.summarize(costs)
    memory = {"argument_bytes": costs.argument_bytes, "output_bytes": costs.output_bytes,
              "temp_bytes": costs.temp_bytes, "alias_bytes": costs.alias_bytes}
    result = {
        "arch": arch, "shape": name, "status": "ok", "n_devices": 1, **placed,
        "trace_s": round(trace_s, 1),
        "flops": summary["flops"], "bytes_accessed": summary["bytes"],
        "transcendentals": summary["transcendentals"],
        "collective_bytes": summary["collective_bytes"],
        "collective_counts": summary["collective_counts"],
        "exec": summary, "memory": memory,
        "fits": memory["argument_bytes"] + memory["temp_bytes"] <= H100_BYTES,
    }
    if micro is not None:
        result["microbatches"] = micro
    if verbose:
        gb = (memory["argument_bytes"] + memory["temp_bytes"]) / 1e9
        where = "" if mesh is None else f" on {tuple(mesh.shape)} at {placed['device']}"
        print(f"[{arch} × {shape if isinstance(shape, str) else kind}{where}] OK trace "
              f"{trace_s:.1f}s | flops {result['flops']:.3e} bytes {result['bytes_accessed']:.3e}"
              f" ops {summary['ops']:.0f} | args + temp {gb:.2f} GB, fits one H100: "
              f"{result['fits']}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", choices=["production"],
                    help="count one device of the production mesh, (16, 16)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh: the (2, 16, 16) mesh over (pod, data, model)")
    ap.add_argument("--sp-off", action="store_true",
                    help="with --mesh: run_overrides {'sp': False}, the gathered-whole layout")
    args = ap.parse_args(argv)
    if args.multi_pod and not args.mesh:
        ap.error("--multi-pod counts a device of the production mesh: add --mesh production")
    if args.sp_off and not args.mesh:
        ap.error("--sp-off picks a layout on a mesh: add --mesh production")
    mesh = make_production_mesh(multi_pod=args.multi_pod) if args.mesh else None
    tag = "" if mesh is None else "__" + "x".join(str(n) for n in mesh.shape)
    tag += "__sp_off" if args.sp_off else ""
    overrides = {"sp": False} if args.sp_off else None
    if args.all:
        cells = [(arch, shape) for arch in ARCH_NAMES for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        path = os.path.join(args.out, f"{arch}__{shape}{tag}.json")
        if os.path.exists(path) and not args.force:
            print(f"[{arch} × {shape}] cached")
            continue
        try:
            result = run_cell(arch, shape, mesh=mesh, run_overrides=overrides)
        except Exception as e:  # noqa: BLE001 — record the cell and go on
            traceback.print_exc()
            result = {"arch": arch, "shape": shape, "status": "error",
                      "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

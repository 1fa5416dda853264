"""Dry run of every (arch × shape) cell for one H100: count each step's
work and check its memory against one card, with nothing allocated.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR] [--force]

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
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config
from . import opcost
from . import steps as S

# One H100 SXM's device memory as its data sheet gives it (80 GB); the card
# reports a little more (``total_memory``), which chip_smoke.py checks
H100_BYTES = 80 * 10**9
SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md §5)"


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


def run_cell(arch: str, shape, *, verbose: bool = True) -> dict:
    """One cell: ``shape`` is a name of ``SHAPES`` or a dict with its keys
    (``seq_len``, ``global_batch``, ``kind``)."""
    cfg = get_config(arch)
    name = shape if isinstance(shape, str) else dict(shape)
    if isinstance(shape, str) and not cell_is_runnable(cfg, shape):
        return {"arch": arch, "shape": name, "status": "skipped", "reason": SKIP_REASON}
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    kind = sh["kind"]
    t0 = time.perf_counter()
    specs = S.input_specs(cfg, sh)
    micro = None
    if kind == "train":
        step, _, _ = S.build_train_step(cfg, device=S.META)
        costs = _train_costs(step, **specs)
        micro = step.accum
    elif kind == "prefill":
        step, _, _ = S.build_prefill_step(cfg, device=S.META)
        costs = opcost.count(step, **specs)
    else:
        step, _, _ = S.build_decode_step(cfg, device=S.META)
        costs = opcost.count(step, **specs)
    trace_s = time.perf_counter() - t0
    summary = opcost.summarize(costs)
    memory = {"argument_bytes": costs.argument_bytes, "output_bytes": costs.output_bytes,
              "temp_bytes": costs.temp_bytes, "alias_bytes": costs.alias_bytes}
    result = {
        "arch": arch, "shape": name, "status": "ok", "n_devices": 1,
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
        print(f"[{arch} × {shape if isinstance(shape, str) else kind}] OK trace {trace_s:.1f}s"
              f" | flops {result['flops']:.3e} bytes {result['bytes_accessed']:.3e} ops "
              f"{summary['ops']:.0f} | args + temp {gb:.2f} GB, fits one H100: {result['fits']}",
              flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(arch, shape) for arch in ARCH_NAMES for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        path = os.path.join(args.out, f"{arch}__{shape}.json")
        if os.path.exists(path) and not args.force:
            print(f"[{arch} × {shape}] cached")
            continue
        try:
            result = run_cell(arch, shape)
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

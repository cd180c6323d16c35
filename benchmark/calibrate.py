#!/usr/bin/env python3
"""Readings that a cell's limits for ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--controls 3] [--faults 3] [--out FILE]

For each seed, in one process: the cell's data, the program's checked steps
as a run drives them (no window), the reference in float64 over the
batches and draws the program made, and the numbers of ``compare.py``. On
the first ``--controls`` seeds also the reference put in the program's
place one precision below what the configuration states (``control`` in
the configuration file) and the other lower precisions listed below; on the
first ``--faults`` seeds the faults a training cell can have, planted in the
reference put in the program's place (half of the batch left out, the mean
over the rest; a step that leaves its state unchanged), and those of the
program's own draws and batches, planted in the program (``faults.py``:
draws that return their mean, draws or a batch that a step takes again).
Prints one JSON line per reading as it comes (and appends it to ``--out``),
then a summary: the largest program reading and the smallest control and
fault readings of each number.
"""

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from benchmark import env  # noqa: E402

env.prepare()  # before torch is imported

# lower precisions read besides the configuration's control: bfloat16
# locals, TF32 matrix products alone, float32 global sites alone, and plain
# float32 (the configuration's own precision)
EXTRA = {"bfloat16": {"local": "bfloat16", "glob": "float32"},
         "tf32": {"local": "tf32", "glob": "float64"},
         "float32_globals": {"local": "float32", "glob": "float32"},
         "float32": {"local": "float32", "glob": "float64"}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import compare, core, faults

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    device = "cuda"
    cell = core.Cell(ROOT, args.workload)
    control = cell.cfg["control"]
    variants = {"control": {"local": control["local"], "glob": control["global"]}, **EXTRA}
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    sizes = compare.batch_sizes(cell.cfg)

    def program_run(data, seed, fault=None):
        with tempfile.TemporaryDirectory(prefix="calib-") as tmp:
            run = cell.entry.Run(cell, data, seed, Path(tmp), device)
            run.build()
            with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
                state = run.checked_steps()
            run.close()
            del run
        core.free_device()
        return state

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        data, problem = core.make_problem(cell, seed, device)
        program = program_run(data, seed)
        steps = core.make_steps(data, program)
        t1 = time.perf_counter()
        ref = cell.reference.run_steps(cell.cfg, problem, steps, device=device)
        t2 = time.perf_counter()
        emit({"seed": seed, "side": "program", "setup_s": t1 - t0, "reference_s": t2 - t1,
              **compare.readings(program, ref, *sizes, detail=True)})
        if i < args.controls:
            for name, kw in variants.items():
                st = cell.reference.run_steps(cell.cfg, problem, steps, device=device, **kw)
                emit({"seed": seed, "side": name, **compare.readings(st, ref, *sizes,
                                                                     detail=True)})
        if i < args.faults:
            for fault in ("half_batch", "frozen"):
                st = cell.reference.run_steps(cell.cfg, problem, steps, device=device,
                                              fault=fault)
                emit({"seed": seed, "side": fault, **compare.readings(st, ref, *sizes,
                                                                      detail=True)})
            for fault in ("mean_draws", "reused_draws", "reused_batch"):
                st = program_run(data, seed, fault)
                f_ref = cell.reference.run_steps(cell.cfg, problem, core.make_steps(data, st),
                                                 device=device)
                emit({"seed": seed, "side": fault, **compare.readings(st, f_ref, *sizes,
                                                                      detail=True)})
        core.free_device()

    summary = {}
    for side in sorted({r["side"] for r in rows}):
        vals = [r for r in rows if r["side"] == side]
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[k] for r in vals) for k in compare.NUMBERS}
        summary[side]["seeds"] = len(vals)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Benchmark of tapqir_tpu_torch, the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which are also the last lines of standard
error. Exits non-zero, printing no result, without the cards, when the
program cannot be imported, or when jax, jaxlib, flax or the JAX package
tapqir_tpu were loaded. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from benchmark import env  # noqa: E402

env.prepare()  # before torch is imported


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from benchmark import core

    bench = core.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = core.run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace, T_START)
    found = core.forbidden_modules()
    if found:
        print(f"run.py: loaded {', '.join(found)}, which the benchmark must not load",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The harness: one run of one cell, from ``BENCHMARK.json`` to the result line.

Everything that belongs to one configuration, traffic mix, cell, entry or
per-layer metric sits in a file of its own under this folder and is found
by the name that ``BENCHMARK.json`` gives:

* ``configs/<config>.json`` (the ``file`` of the configuration) - sizes,
  truth, fit settings and the precision it states;
* ``reference/<model>.py`` - the plain reference of the configuration's
  model (``run_steps``, ``Spec``, ``likelihood_shape``);
* ``traffic/<traffic>.json`` - the traffic mix's parameters, naming the
  entry that drives it;
* ``entries/<entry>.py`` - how a window drives the program;
* ``cells/<workload>.json`` - the cell's limits for ``correct``, with the
  readings they were set from, and the rate its window is sized at;
* ``metrics/<metric>.py`` - the reader of a per-layer metric, or of an
  end-to-end metric that the device's trace gives, and the spans it needs;
  ``counts/<count>.py`` - operation and byte counts.

A run makes the cell's data from the seed, lets the entry set up the
program and drive its first steps (reading back the batches and draws the
program made), times the window, frees the program, runs the reference
over the same steps, and compares (``compare.py``).
"""

import gc
import hashlib
import importlib.util
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tapqir_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A Python file of the benchmark, imported by its path."""
    path = Path(path).resolve()
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in
                                       str(path.relative_to(path.parents[1])))
    name += "_" + hashlib.sha256(str(path).encode()).hexdigest()[:8]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with the files it names."""

    def __init__(self, root, workload):
        root = Path(root)
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.cfg = load_json(root / self.config_entry["file"])
        bdir = root / self.bench["paths"][0]
        self.dir = bdir
        self.traffic = load_json(bdir / "traffic" / f"{self.workload['traffic']}.json")
        cell_file = load_json(bdir / "cells" / f"{workload}.json")
        self.limits = cell_file["limits"]
        self.window = cell_file["window"]
        self.entry = load_module(bdir / "entries" / f"{self.traffic['entry']}.py")
        self.reference = load_module(bdir / "reference" / f"{self.cfg['model']}.py")

    def metrics(self, kind):
        """The metrics of ``kind`` ("end_to_end" or "per_layer") that this
        cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def metric_reader(self, name):
        return load_module(self.dir / "metrics" / f"{name}.py")

    def count(self, name):
        return load_module(self.dir / "counts" / f"{name}.py")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load:
    jax and its kin, and the JAX package (compared whole, so that the port
    ``tapqir_tpu_torch`` is not taken for it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def median_f32(images):
    """Per-channel median pixel as float32, as numpy's ``np.median`` of a
    float32 stack gives it (the mean of the two middle values for an even
    count), computed with ``torch.kthvalue`` where the images are."""
    import torch

    out = []
    for c in range(images.shape[2]):
        flat = images[:, :, c].reshape(-1)
        n = flat.numel()
        hi = flat.kthvalue(n // 2 + 1).values
        mid = hi if n % 2 else (flat.kthvalue(n // 2).values + hi) / 2
        out.append(float(mid.float()))
    return np.asarray(out, np.float32)


def make_problem(cell, seed, device):
    """The cell's data from the seed (host arrays, read-only) and what the
    reference needs of it: sizes, the offsets and ``bg0`` (per-channel
    median pixel less the mean offset, at least 1, in float32 as the
    model's initial values take it)."""
    from benchmark import simulate

    geo = cell.cfg["geometry"]
    data = simulate.make_dataset(geo, cell.cfg["truth"], seed, device)
    med = median_f32(data["images"])
    for k in ("images", "xy", "is_ontarget"):
        data[k] = data[k].cpu().numpy()
    for v in data.values():
        v.flags.writeable = False
    samples, weights = data["offset_samples"], data["offset_weights"]
    offset_mean = float((samples * weights).sum())
    w = np.clip(weights, np.finfo(np.float64).tiny, None)
    problem = {
        "Nt": geo["Nt"], "F": geo["F"], "C": geo["C"],
        "bg0": np.maximum(med - offset_mean, 1.0).astype(np.float32),
        "offset_samples": samples, "offset_logits": np.log(w / w.sum()),
    }
    return data, problem


def make_steps(data, program):
    """The checked steps' inputs for the reference: each step's AOI rows and
    frames and its flat draw vector as the program took them (``batches``
    and ``draws`` of its state), and the batch's data."""
    steps = []
    for (ndx, fidx), packed in zip(program["batches"], program["draws"]):
        imgs = data["images"][ndx][:, fidx]  # (n, f, C, P, P)
        steps.append({
            "ndx": ndx, "fidx": fidx,
            "obs": imgs.reshape(imgs.shape[:3] + (-1,)),
            "xy": data["xy"][ndx][:, fidx],
            "ont": data["is_ontarget"][ndx].astype(np.int64),
            "mask": np.ones((len(ndx),), np.float32),
            "packed": packed,
        })
    return steps


def free_device():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(device):
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def span_specs(cell, metrics):
    """The spans a run installs for ``metrics``: each reader's ``SPANS``,
    then the entry's over them, so that the span ``step`` is always the
    step the cell's entry drives, whatever a reader lists under that
    name."""
    specs = {}
    for m in metrics:
        specs.update(getattr(cell.metric_reader(m["name"]), "SPANS", {}))
    specs.update(cell.entry.SPANS)
    return specs


def run_cell(root, workload, seed, seconds, trace, t_start, device="cuda", log=None):
    """One run of ``workload``: returns the result line as a dict, with the
    numbers compared as its last key ``checks``."""
    from benchmark import compare, tracing

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell(root, workload)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        t = time.perf_counter()
        log(f"[{workload}] imports and start-up {t - t_start:.3f} s")
        data, problem = make_problem(cell, seed, device)
        log(f"[{workload}] data {time.perf_counter() - t:.3f} s")
        run = cell.entry.Run(cell, data, seed, Path(tmp), device, log)
        program_state = run.setup(seconds)
        # the metrics that this run reads through a reader of its own: the
        # per-layer ones when traced, else the end-to-end ones that the
        # device's trace gives (the profiled stretch runs in such a window)
        read = (cell.metrics("per_layer") if trace else
                [m for m in cell.metrics("end_to_end") if m["source"] == "device_trace"])
        tracer = None
        if read:
            tracer = tracing.Tracer(span_specs(cell, read), Path(tmp), cell.traffic["profile"])
            tracer.install(run.model, run.profile_start())
        setup_s = time.perf_counter() - t_start
        window = run.window()
        if tracer is not None:
            tracer.uninstall()
        log(f"[{workload}] window: {window['steps']} steps in {window['wall_s']:.3f} s; "
            f"peak device memory {window['memory_peak_bytes']} bytes; set-up {setup_s:.3f} s")
        if tracer is not None:
            log(f"[{workload}] profiled stretch: {tracer.prof_steps} steps in "
                f"{tracer.prof_wall:.3f} s of the window")
        run.close()
        del run
        free_device()

        t = time.perf_counter()
        steps = make_steps(data, program_state)
        ref_state = cell.reference.run_steps(cell.cfg, problem, steps, device=device)
        log(f"[{workload}] reference {time.perf_counter() - t:.3f} s")
        readings = compare.readings(program_state, ref_state,
                                    *compare.batch_sizes(cell.cfg))
        checks = {k: {"value": readings[k], "limit": cell.limits[k]} for k in compare.NUMBERS}
        correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                      for c in checks.values())

        dev = device_info(device)
        dev["memory_peak_bytes"] = window["memory_peak_bytes"]
        result = {"correct": correct, "attempted": window["attempted"],
                  "failed": window["attempted"] - window["steps"], "metrics": {},
                  "device": dev}
        view = tracer.view(cell, problem, data, window, device) if tracer else None
        if not trace:
            values = dict(cell.entry.end_to_end(window), setup_s=setup_s)
            for m in read:
                value = cell.metric_reader(m["name"]).read(view)
                if value is not None:
                    values[m["name"]] = value
                elif device_info(device)["platform"] == "gpu":
                    raise RuntimeError(f"{m['name']}: the device's trace of the profiled "
                                       "stretch gave nothing to read")
            for m in cell.metrics("end_to_end"):
                if m["name"] in values:  # a device-trace metric reads nothing off a card
                    result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                    "unit": m["unit"]}
        else:
            for m in read:
                value = cell.metric_reader(m["name"]).read(view)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            if view.trace is not None:
                dev["busy_s"] = view.trace.busy_s
                dev["window_s"] = view.trace.window_s
                result["breakdown"] = view.trace.breakdown()
        result["checks"] = checks
    return result

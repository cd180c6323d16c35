#!/usr/bin/env python3
"""Where a cosmos SVI step of the PyTorch port spends its time, on one card.

    python3 scripts/profile_torch_step.py [--steps 100] [--out DIR]

Builds the eLife-scale dataset of chip_smoke.py (Nt=856, F=790, P=14, 61
offset bins; its simulation and its save are timed), and for each
likelihood route - dense (the default) and factored (``use_factored =
True``) - initializes cosmos with batch 10 x 512 and then:

1. runs 5 steps under ``torch.cuda.set_sync_debug_mode("warn")`` and counts
   the operations that made the host wait on the card;
2. times ``--steps`` steps with the host clock around a synchronize
   (steps/s), twice per route in the order dense, factored, factored,
   dense; then ``Model.run(400)`` (with its checkpoints) twice per route in
   the order factored, dense, dense, factored;
3. profiles 5 steps with ``torch.profiler`` (CPU + CUDA): device busy
   share (sum of kernel times over wall time), kernel launches per step,
   the offset-Gamma kernel's share, the host and device time of the step's
   named phases (ELBO forward and its parts, window gather and scatter), and
   the top operators by CPU and by CUDA time; the Chrome trace of each
   route goes under ``--out`` (default ``profile_out/`` at the repository
   root) as ``cosmos_step_trace_<route>.json.gz``.

Prints one JSON line at the end with the numbers of both routes. Needs a
CUDA card.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _ranged(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(f"phase::{name}"):
            return fn(*args, **kwargs)
    return wrapped


def _count_kernels(event):
    """Device events launched by a host event and its children."""
    return len(event.kernels) + sum(_count_kernels(c) for c in event.cpu_children)


def _profile(model, trace_path, smi, route, n_prof=5):
    """Profile ``n_prof`` steps (the trace of 5 steps stays well under 64
    MiB); returns the per-step numbers and prints the top operators."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        model._run_chunk(n_prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    prof.export_chrome_trace(str(trace_path))

    # device events: kernels, copies and fills; the GPU side of the phase
    # ranges spans them and is left out
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == cuda and not e.name.startswith("phase::")]
    busy_us = sum(e.device_time_total for e in kernels)
    og_us = sum(e.device_time_total for e in kernels if "offset_gamma" in e.name)
    phases = {}
    for e in events:  # host side of each phase, with the kernels it launched
        if e.device_type != cuda and e.name.startswith("phase::"):
            ph = phases.setdefault(e.name[7:], {"host_ms_per_step": 0.0,
                                                "kernel_ms_per_step": 0.0,
                                                "launches_per_step": 0.0})
            ph["host_ms_per_step"] += e.cpu_time_total * 1e-3 / n_prof
            ph["kernel_ms_per_step"] += e.device_time_total * 1e-3 / n_prof
            ph["launches_per_step"] += _count_kernels(e) / n_prof
    avgs = prof.key_averages()
    top_cpu = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)[:15]
    top_cuda = sorted((a for a in avgs if not a.key.startswith("phase::")),
                      key=lambda a: a.self_device_time_total, reverse=True)[:10]
    print(f"[profile {route}] {torch.cuda.get_device_name(0)} ({smi})")
    print(f"[profile {route}] top operators by self CPU time (us total over "
          f"{n_prof} steps, calls):")
    for a in top_cpu:
        print(f"  {a.key[:60]:60s} {a.self_cpu_time_total:12.0f} {a.count:7d}")
    print(f"[profile {route}] top by self CUDA time (us total, calls):")
    for a in top_cuda:
        print(f"  {a.key[:60]:60s} {a.self_device_time_total:12.0f} {a.count:7d}")
    return {
        "profiled_ms_per_step": 1e3 * wall / n_prof,
        "device_busy_share": busy_us * 1e-6 / wall,
        "kernel_launches_per_step": len(kernels) / n_prof,
        "offset_gamma_ms_per_step": og_us * 1e-3 / n_prof,
        "phases": phases,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default=str(ROOT / "profile_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.utils.dataset import save

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t_sim = time.perf_counter()
    data = chip_smoke.make_dataset(856, 790, device="cuda")
    t_sim = time.perf_counter() - t_sim
    routes = {"dense": False, "factored": True}
    results, trained = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t_save = time.perf_counter()
        save(data, tmp)
        t_save = time.perf_counter() - t_save
        for route, factored in routes.items():
            model = models["cosmos"]()
            model.use_factored = factored
            model.data = data
            model.path = Path(tmp)
            model.run_path = Path(tmp) / f".tapqir_{route}"
            model.init(lr=0.005, nbatch_size=10, fbatch_size=512)
            model._run_chunk(20)  # warm-up: kernel build, allocator, cuBLAS
            torch.cuda.synchronize()

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                model._run_chunk(5)
                torch.cuda.set_sync_debug_mode("default")
            syncs = [f"{w.filename}:{w.lineno}: {str(w.message).splitlines()[0]}"
                     for w in caught if "synchroniz" in str(w.message)]
            torch.cuda.synchronize()
            results[route] = {"steps_per_s": [], "run_steps_per_s": [],
                              "host_syncs_in_5_steps": len(syncs),
                              "host_sync_examples": syncs[:5]}
            trained[route] = model

        # the two routes timed in turns, so drift on the host hits both
        for route in ("dense", "factored", "factored", "dense"):
            t0 = time.perf_counter()
            trained[route]._run_chunk(args.steps)
            torch.cuda.synchronize()
            results[route]["steps_per_s"].append(args.steps / (time.perf_counter() - t0))
        # whole fits as a user runs them: Model.run(400), two 200-step chunks
        # each ending in a loss check and a checkpoint, in turns as well
        for route in ("factored", "dense", "dense", "factored"):
            t0 = time.perf_counter()
            trained[route].run(400)
            torch.cuda.synchronize()
            results[route]["run_steps_per_s"].append(400 / (time.perf_counter() - t0))

        # name the phases of a step in the trace; the optimizer is the step
        # less the ELBO forward and the backward
        torch.autograd.grad = _ranged("backward", torch.autograd.grad)
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        for route, model in trained.items():
            for meth in ("_sparse_step", "elbo_from_windows", "_sample_sites",
                         "_dye_tables", "_likelihood", "scatter_windows",
                         "gather_windows"):
                setattr(model, meth, _ranged(meth, getattr(model, meth)))
            results[route].update(_profile(model, out / f"cosmos_step_trace_{route}.json.gz",
                                           smi, route))
    result = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        **results,
        "simulate_s": t_sim,
        "save_s": t_save,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""eLife-scale convergence run of the PyTorch port on a CUDA card: the port's
counterpart of scripts/elife_convergence.py (docs/elife_scale_run.md).

The real eLife 2022 DatasetA is not fetchable offline, so this fits the
same proxy as the JAX script: a simulated dataset at the reference
workload's shape - Nt = 856 AOIs (428 on target + 428 off target), F = 790
frames, P = 14, a 61-bin offset histogram around 90, with the ground-truth
labels kept - built from eight seeded chunks of Nt/8 AOIs, on-target rows
first and the chunks' labels concatenated, and reloaded when the
workspace's ``data.tpqr`` already has that shape and labels. The fit uses
the reference's documented defaults (lr 5e-3, 10 AOIs x 512 frames per
step, every frame for cosmos+hmm; ``--iters 0`` runs to the rolling
convergence criterion, at most 100k steps), resumes from the workspace's
checkpoint, and writes the full state every 10th checkpoint. ``--row-every
N`` splits ``--iters`` into runs of N steps, each followed by the statistics
and a JSON line, in one process (a long fit's rows without reloading).

``--model`` selects the simulated family: cosmos (C=1), crosstalk (C=2
dyes, alpha bleed-through) or cosmos+hmm (C=1, kon 0.02 / koff 0.2; the fit
then goes on through the port's ``ttfb`` and ``dwelltime`` commands to
recover the kinetic rates). ``--fit-model`` fits another family on that
dataset (e.g. cosmos as the warm-start stage of cosmos+hmm), and
``--warm-start`` starts a fresh cosmos+hmm fit from the workspace's cosmos
fit.

After the fit, ``compute_stats`` writes the statistics files (p(specific),
MCC / Recall / Precision against the labels, SNR, the global parameters'
intervals) and the script prints one JSON line with the JAX script's keys;
``device`` is the card's name and ``nvidia_smi`` the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them. Each line is followed on standard error by the extremes of the
global parameters over every checkpoint of the workspace's ``metrics.csv``.
A fit that ends with a global parameter's unconstrained value at the
exp(+-30) clamp of its transform has diverged: the script says so on
standard error and exits 1 after its line.

Run:  python3 scripts/elife_convergence_torch.py [--model M] [--iters 0] [--out DIR]
(needs a card; ``main(argv, device="cpu")`` and ``build_dataset(...,
device="cpu")`` let a test rehearse it small on the CPU).
"""

import argparse
import contextlib
import csv
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIM_PARAMS = {
    "pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15,
    "proximity": 0.2, "offset": 90.0, "height": 3000, "background": 150,
}
FULL_CHECKPOINT_EVERY = 10
EXP_CLAMP = 30.0  # the exponent clamp of constraints.positive / greater_than
# the posterior marginals cosmos and cosmos+hmm keep once computed
POSTERIOR_CACHES = ("_probs_cache", "_z_probs_cache", "_theta_probs_cache")
# samples and MLE steps of the kinetics commands, as the JAX script runs them
KINETICS = {"ttfb": (500, 5000), "dwelltime": (200, 5000)}
SUMMARY_ROWS = ("gain", "pi", "alpha", "init", "trans", "lamda", "proximity", "SNR",
                "MCC", "Recall", "Precision")


def model_sim_params(model_name):
    p = dict(SIM_PARAMS)
    if model_name == "crosstalk":
        p["alpha"] = [[0.85, 0.15], [0.1, 0.9]]
    elif model_name == "cosmos+hmm":
        del p["pi"]
        p.update(kon=0.02, koff=0.2)
    return p


def build_dataset(out: Path, model_name="cosmos", Nt=856, F=790, P=14, n_chunk=8,
                  device=None):
    """Simulate the eLife-scale dataset in AOI chunks, keeping the labels,
    and save it as ``out/data.tpqr``; reload it when it is there with this
    shape and labels."""
    from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData, load, save
    from tapqir_tpu_torch.utils.simulate import simulate

    C = 2 if model_name == "crosstalk" else 1
    sim_params = model_sim_params(model_name)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if (out / "data.tpqr").exists():
        data = load(out)
        if data.Nt == Nt and data.F == F and data.labels is not None:
            return data

    per = Nt // n_chunk
    chunks = [
        simulate(model_name, N=per, F=F, C=C, P=P, seed=i, params=sim_params,
                 device=device)
        for i in range(n_chunk)
    ]
    centers = np.arange(60, 121, dtype=np.float64)
    w = np.exp(-0.5 * ((centers - 90.0) / 8.0) ** 2)
    w /= w.sum()
    # every chunk's on-target rows first (the dataset convention), labels
    # concatenated in the same chunk order
    n_on = sum(int(d.is_ontarget.sum()) for d in chunks)
    images = np.concatenate([d.images[d.is_ontarget] for d in chunks]
                            + [d.images[~d.is_ontarget] for d in chunks])
    xy = np.concatenate([d.xy[d.is_ontarget] for d in chunks]
                        + [d.xy[~d.is_ontarget] for d in chunks])
    labels = np.concatenate([d.labels for d in chunks])
    is_ontarget = np.zeros(images.shape[0], bool)
    is_ontarget[:n_on] = True
    data = CosmosDataset(
        images=images, xy=xy, is_ontarget=is_ontarget, labels=labels,
        offset=OffsetData(centers, w), name=f"elife-scale-{model_name}",
    )
    save(data, out)
    return data


def _read_means(path):
    """{row name: Mean} of a kinetics parameter table."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    col = rows[0].index("Mean")
    return {r[0]: float(r[col]) for r in rows[1:]}


def _command(out, argv, device):
    """``python -m tapqir_tpu_torch --cd out <argv>`` in process, its log on
    standard error; returns the exit code."""
    from tapqir_tpu_torch import main as cli

    cpu = [] if torch.device(device).type == "cuda" else ["--cpu"]
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return cli.main(["--cd", str(out), *argv, *cpu])
    finally:
        log = logging.getLogger("tapqir_tpu_torch")
        for handler in list(log.handlers):
            handler.close()
            log.removeHandler(handler)


def recover_kinetics(out: Path, device="cuda:0"):
    """Run the port's ttfb and dwelltime commands on the converged hmm fit
    and collect the recovered rates."""
    out = Path(out)
    rates = {}
    samples, iters = KINETICS["ttfb"]
    code = _command(out, ["ttfb", "--model", "cosmos+hmm", "--num-samples", str(samples),
                          "--num-iter", str(iters)], device)
    if code == 0:
        rates["ttfb"] = _read_means(out / "cosmos+hmm_ttfb-params-channel0.csv")
    else:
        rates["ttfb_error"] = f"exit {code}"
    samples, iters = KINETICS["dwelltime"]
    code = _command(out, ["dwelltime", "--model", "cosmos+hmm", "--num-samples",
                          str(samples), "--num-iter", str(iters), "-K", "1"], device)
    if code == 0:
        rates["kon"] = _read_means(out / "cosmos+hmm_dwelltime-kon-channel0.csv")
        rates["koff"] = _read_means(out / "cosmos+hmm_dwelltime-koff-channel0.csv")
    else:
        rates["dwelltime_error"] = f"exit {code}"
    return rates


def _card(device):
    if torch.device(device).type != "cuda":
        return "cpu", None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def _summary_means(summary):
    means = {}
    for name, row in summary.items():
        if str(name).split("_")[0] not in SUMMARY_ROWS:
            continue
        v = row["Mean"]  # None where the statistic is empty (SNR without spots)
        means[name] = (None if v is None else float(v) if np.ndim(v) == 0
                       else np.asarray(v, float).tolist())
    return means


def clamped_globals(model):
    """Names of the global parameters whose unconstrained value is at the
    +-30 exponent clamp of their transform (``positive``,
    ``greater_than``): a fit that reaches it has diverged."""
    out = []
    for name, axes in model.param_partition().items():
        tname = model._transforms[name].name
        if axes or not (tname == "positive" or tname.startswith("greater_than")):
            continue
        if bool((model.params[name].abs() >= EXP_CLAMP).any()):
            out.append(name)
    return out


def metrics_extremes(path):
    """{column: (min, max)} over every checkpoint row of a ``metrics.csv``,
    and whether every -ELBO is finite."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    cols = np.array(rows[1:], dtype=np.float64)
    ext = {name: (float(cols[:, i].min()), float(cols[:, i].max()))
           for i, name in enumerate(rows[0]) if name != "iter"}
    return ext, bool(np.isfinite(cols[:, rows[0].index("-ELBO")]).all())


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="cosmos",
                    choices=["cosmos", "crosstalk", "cosmos+hmm"])
    ap.add_argument("--iters", type=int, default=0,
                    help="0 = run to convergence (max 100k)")
    ap.add_argument("--row-every", type=int, default=0,
                    help="with --iters N: the statistics and a JSON line every this "
                         "many steps")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--frame-sampling", default="random", choices=["random", "window"],
                    help="frame minibatch scheme (independent subsets vs cyclic window)")
    ap.add_argument("--fit-model", default=None,
                    choices=[None, "cosmos", "crosstalk", "cosmos+hmm"],
                    help="model family to fit (defaults to --model; e.g. fit cosmos "
                         "on the hmm-simulated dataset as the warm-start stage)")
    ap.add_argument("--warm-start", action="store_true",
                    help="cosmos+hmm: initialize from the workspace's converged "
                         "cosmos fit (run --fit-model cosmos on the same --out first)")
    return ap


def main(argv=None, device="cuda:0", dataset_shape=None):
    """Build or reload the dataset, fit, compute the statistics and print
    the JSON line; returns its object. ``dataset_shape`` (a dict of
    :func:`build_dataset`'s Nt, F, P, n_chunk) shrinks the dataset for a
    rehearsal."""
    from tapqir_tpu_torch.device import resolve_device
    from tapqir_tpu_torch.models import models

    device = resolve_device(device)  # raises without a card unless the CPU is asked for
    args = _parser().parse_args(argv)
    out = args.out or (Path(tempfile.gettempdir()) / "tapqir_elife_torch"
                       / args.model.replace("+", "_"))
    fit_name = args.fit_model or args.model
    kind, smi = _card(device)

    data = build_dataset(out, model_name=args.model, device=device, **(dataset_shape or {}))
    model = models[fit_name](device=device)
    model.frame_sampling = args.frame_sampling
    model.data = data
    model.path = out
    model.run_path = out / ".tapqir"
    # hmm's z-chain needs every frame per batch row (no frame subsampling)
    fbatch = data.F if fit_name == "cosmos+hmm" else 512
    model.init(lr=0.005, nbatch_size=10, fbatch_size=fbatch)
    if args.warm_start and fit_name == "cosmos+hmm":
        if model.iter == 0:
            print("[elife] warm-starting cosmos+hmm from the cosmos fit",
                  file=sys.stderr, flush=True)
            model.warm_start_from_cosmos()
        else:
            print("[elife] checkpoint exists; warm start skipped (resuming)",
                  file=sys.stderr, flush=True)
    model.full_checkpoint_every = FULL_CHECKPOINT_EVERY

    print(f"[elife] device: {kind} ({smi})", file=sys.stderr, flush=True)
    step = args.row_every if args.row_every > 0 and args.iters > 0 else args.iters
    end = model.iter + args.iters
    while True:
        result = _fit_and_report(model, data, args, min(step, end - model.iter), kind, smi)
        print(json.dumps(result), flush=True)
        ext, finite = metrics_extremes(out / ".tapqir" / "logs" / fit_name / "metrics.csv")
        print(f"[elife] checkpoints to {model.iter}: -ELBO finite={finite}; (min, max) "
              f"{json.dumps(ext)}", file=sys.stderr, flush=True)
        clamped = clamped_globals(model)
        if clamped:
            print(f"[elife] diverged: {', '.join(clamped)} at the exp(+-{EXP_CLAMP:g}) clamp "
                  f"at iteration {model.iter}", file=sys.stderr, flush=True)
            raise SystemExit(1)
        if args.iters <= 0 or model.iter >= end:
            return result


def _fit_and_report(model, data, args, num_iter, kind, smi):
    """``model.run(num_iter)``, the statistics, and the JSON line's object."""
    fit_name = model.name
    iters0 = model.iter
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.run(num_iter)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall_fit = time.perf_counter() - t0
    iters = model.iter
    done_now = max(iters - iters0, 1)
    print(f"[elife] fit: {iters} cumulative iters ({done_now} this invocation) in "
          f"{wall_fit:.1f} s ({done_now / wall_fit:.3f} steps/s sustained), "
          f"converged={model.converged}", file=sys.stderr, flush=True)

    for cache in POSTERIOR_CACHES:  # a row's statistics are of the fit as it is now
        model.__dict__.pop(cache, None)
    t1 = time.perf_counter()
    summary = model.compute_stats(CI=0.95)
    wall_stats = time.perf_counter() - t1

    p_spec = np.asarray(model.z_probs)[..., 1:].sum(-1)  # (Nt, F, Q)
    n_on = int(data.is_ontarget.sum())
    result = {
        "metric": "elife_scale_convergence_run",
        "model": fit_name,
        "dataset_model": args.model,
        "frame_sampling": args.frame_sampling,
        "warm_start": bool(args.warm_start),
        "device": kind,
        "nvidia_smi": smi,
        "Nt": data.Nt, "F": data.F, "P": data.P, "C": data.C,
        "iters": iters,
        "converged": bool(model.converged),
        "iters_this_invocation": done_now,
        "wall_fit_s": wall_fit,
        "steps_per_sec_sustained": done_now / wall_fit,
        "wall_stats_s": wall_stats,
        "p_specific_mean_ontarget": float(p_spec[:n_on].mean()),
        "summary": _summary_means(summary),
    }
    if fit_name == "cosmos+hmm":
        result["kinetics"] = recover_kinetics(model.path, model.device)
        result["kinetics"]["truth"] = {"kon": 0.02, "koff": 0.2}
    return result


if __name__ == "__main__":
    main()

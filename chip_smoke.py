#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tapqir_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one. Phases, each printing its findings; any failure is an exception:

1. device: the card's name and power limit;
2. build: compile the offset-Gamma kernels with nvcc for sm_90a (build
   seconds, registers and spills);
3. the summed kernel against its plain PyTorch version at the slice's
   shapes (M=4 configs, nb=5120 images, EVP=256 lanes, ev=196 pixels, J=61
   bins, float32: forward, concentration and rate gradients), then edge
   cases: pixels below every offset bin, ev-masked lanes, a ragged nb, M=16,
   a small float64 case, J in {1, 7, 64, 65, 1024} around the kernel's tile
   of 8 bins, and the inputs of VARIANTS (whole tiles of bins masked, a bin
   term spread over more than 100 log units, a < 1 with d just above 0);
   every case also launches each kernel twice and requires bitwise-equal
   outputs;
4. the per-pixel kernel against its plain version at 10x512x1x14x14 =
   1,003,520 pixels, J=61, M=1 and M=4 (forward, concentration and rate
   gradients), then pixels below every bin, a ragged pixel count, the M=1
   squeeze, a small float64 case, J in {1, 7, 64, 65, 1024}, the VARIANTS
   inputs and M in {2, 3, 5, 16} around the kernel's config chunks of 1, 2
   and 4; every case also launches each kernel twice and requires
   bitwise-equal outputs;
5. the factored kernel against its plain version at Kf=2 spots (M=4),
   nb=5120, EVP=256, ev=196, J=61 (forward; base, delta and rate
   gradients), then base < 1, pixels below every bin, a ragged nb, Kf=4
   (M=16), float64, ev-masked lanes with J=65, and the VARIANTS inputs
   (the small-d one with every concentration below 1);
6. timing of every kernel with CUDA events beside its plain version, the
   least time the card could take (bound) and the least time of its
   special-function unit for the exact evaluation (one log per pixel and
   bin, one exp per config, pixel and bin); the per-pixel kernels at M=4
   and, apart, at M=1;
7. the dense main path: simulate an eLife-scale cosmos dataset (Nt=856
   AOIs, F=790 frames, P=14, 61 offset bins) with the port's simulator,
   save it, then models["cosmos"]() -> load -> init(lr=0.005,
   nbatch_size=10, fbatch_size=512) -> run(200), and a held-out loss
   without gradient before and after (200 steps, cut from 400 to keep the
   script within its time limit with phases 17-19);
8. the factored main path: the same saved dataset, the same entry points
   with ``use_factored = True``, run(200);
9. the per-pixel path: KSMOGN(...).log_prob on 10 AOIs x 512 frames of that
   dataset (M=1) and the non-ev summed likelihood over the 4 spot configs
   (event_ndims=2), with gradients on height and background;
10. the command line's fit on phase 7's workspace: ``python -m
    tapqir_tpu_torch --cd <workspace> fit --model cosmos -n 10 -f 512 -it
    200 --no-input``, in process through ``main(argv)``: it resumes phase
    7's checkpoint (iteration 200 -> 400) and ends in ``compute_stats``
    (p(specific), credible intervals, SNR / chi2, MCC against the
    simulator's labels), on the card;
11. the command line's stats on the same workspace, with the checks of
    :func:`check_cli_stats` (z_probs bitwise equal to phase 10's), then the
    stats' arithmetic that runs no kernel on the card against float64 on
    the CPU (:func:`check_card_vs_cpu`);
12. the command line's hmm fit on the same workspace: ``fit --model
    cosmos+hmm -n 10 -it 200 --no-input``, in process; the workspace holds
    the cosmos fit and its ``cosmos_params.tpqr``, so the command
    warm-starts hmm from them, takes 200 steps of 10 AOIs x all 790 frames
    (nb = 7900 images per summed-kernel launch) and ends in the stats, with
    the checks of :func:`check_cli_hmm_fit`; then a ``torch.profiler`` count
    of the device launches per hmm step;
13. the hmm model on the card against the CPU (:func:`check_hmm_card_vs_cpu`):
    the ELBO of one batch in float32 against float64 with the same draws,
    the factored likelihood against the dense one, and one
    ``_compute_theta_probs`` block;
14. crosstalk through the command line: an eLife-scale two-dye dataset
    (Nt=856, F=790, C=2, the JAX package's crosstalk truth alpha = [[0.85,
    0.15], [0.1, 0.9]]) simulated and saved in a workspace of its own, then
    ``fit --model crosstalk -n 10 -f 512 -it 200 --no-input`` in process
    (200 `summed_stats` launches at M=16 over nb = 10x512x2 = 10240 images,
    two held-out `summed_fwd` there, then the stats, with the checks of
    :func:`check_cli_crosstalk_fit`), then 200 ``use_factored`` steps
    through ``Model.run`` (200 `factored_stats` launches at Kf=4), and a
    ``torch.profiler`` count of launches per step for both routes;
15. the crosstalk model on the card against the CPU
    (:func:`check_crosstalk_card_vs_cpu`): the ELBO of 2 AOIs x 128 frames
    in float32 against float64 with the same draws and the factored route
    against the dense one, then ``_probs_batch`` and ``snr_and_chi2`` as in
    phase 11;
16. the kinetics commands in process: ``ttfb --model cosmos -it 5000`` on
    phases 10-11's fit and ``dwelltime --model cosmos+hmm -K 1 -it 2500`` on
    phase 12's, at their default samples and a third and a quarter of their
    default MLE steps (cut for time as phases 7-8), each MLE fit's first rows (16, or
    as many as hold 32768 values) fitted again in float64 on the CPU
    (:func:`run_kinetics`, :func:`check_kinetics`).
17. the restart step's chain-batched kernels (:func:`run_chain_kernels`):
    summed statistics, summed forward and factored with a rate per chain at
    R=4 chains x nb=5120 (M=4, Kf=2), then at crosstalk's M=16 / Kf=4 over
    R=2 x 10240, each launch bitwise equal, image for image, to R
    single-chain launches and within the float64 tolerances above, timed
    beside the R single-chain launches, the plain version, the bound and
    the special-function floor; the summed statistics of the hmm restart
    step (R=4 x nb=7900) timed so too;
18. batched random restarts through the command line, in a workspace of its
    own on phase 7's saved data: ``fit --model cosmos -n 10 -f 512 -R 4
    --restart-iter 200 -it 200 --no-input`` (200 `summed_stats` launches
    at (4, 20480) - one per restart step for all 4 chains - then 200 at
    (4, 5120); ``cosmos_restarts.json``, the best chain the argmin of the
    trailing mean -ELBO, iteration 400), then ``stats``
    (:func:`check_cli_restarts`), and a ``torch.profiler`` count of the
    launches per restart step at R=4 beside a single-chain step's;
19. ``fit_restarts`` through the Python API, 20 steps each: cosmos with
    ``use_factored`` and cosmos+hmm (resuming phase 12's warm-started fit)
    at R=4, crosstalk at R=2, each with one kernel launch per step
    (:func:`check_api_restarts`), and one restart step of each on the card
    in float32 against float64 on the CPU with the same batches and draws
    (:func:`check_restart_card_vs_cpu`);
20. raw-data ingest at the eLife cell's width: a raw Glimpse folder drawn
    from a seed (:func:`write_glimpse_folder`: 512 x 512 frames in two
    ``.glimpse`` files, ``header.mat``, a driftlist within 2 px, Nt=856
    AOIs half on target in ``aoiinfo2`` files, P=14, the default 30 x 30
    offset region; depth cut to F=256 of 790 frames, as the int64
    ``data.tpqr`` is written compressed), then ``glimpse ... --no-input``
    in process, every crop checked bit for bit against the frames written,
    the targets inside the central pixel, the offset weights summing to 1,
    and the native decoder bitwise equal to the numpy decoder on every
    frame (:func:`run_ingest`, :func:`check_ingest`); ingest seconds by
    stage and the host's peak resident memory;
21. the ingested workspace through the command line in process
    (:func:`run_ingested_cli`, :func:`check_ingested_cli`): ``fit --model
    cosmos -n 10 -f 256 -it 20`` (exactly 20 `summed_stats` launches at
    nb = 2560, a finite -ELBO, steps/s), ``fit --profile 5`` (a
    ``torch.profiler`` trace with exactly 5 device events of the summed
    kernel; the checkpoint's bytes and the parameters unchanged), ``stats``
    (phase 11's checks that need no labels), ``subset`` of 20 AOIs and
    ``log`` with the pager captured;
22. the mesh (``parallel/sharding.py``: one process per shard, gloo, as
    the ranks share this one card): cosmos on a 2x2 mesh of four ranks on
    phase 7's saved data (428 AOIs x 395 frames per rank), ``use_mesh``,
    5 untimed steps of each route, then ``run(20)`` dense and 20 steps
    ``use_factored`` (exactly 20 `summed_stats` launches per rank at (4,
    3950), then 20 `factored_stats`),
    the replicas bitwise equal across ranks, one sharded step in float32
    on the card within MESH_STEP_RTOL of float64 on the CPU, the checkpoint
    gathered at the real Nt and reloaded bitwise by a single-device model,
    and the sharded posteriors against single-device ``_probs_batch`` on
    every block with the same draws; each rank first holds the summed and
    factored kernels against their plain versions at its step shape
    (:func:`mesh_cosmos_ranks`);
23. cosmos+hmm on a 1x2 mesh (every AOI's 790 frames split over two
    ranks, the chain scan, its boundary and start across them), 5 untimed
    steps and 20 timed, and the frame-sharded scan against the global one;
    crosstalk (M = 16) on a 2x1 mesh, 5 untimed and 20 timed dense steps
    (:func:`mesh_hmm_crosstalk_ranks`);
24. batched restarts on the 2x2 mesh through the command line's restarts,
    in the processes of phase 22 (one launch for both): R = 2 chains x 20
    steps (one launch per rank and step at (4, 7900)),
    ``cosmos_restarts.json`` and the winner's checkpoint, then 5 more mesh
    steps (:func:`mesh_restarts_ranks`). Phases 22-24 print steps/s,
    launches per rank and step, ``all_reduce`` ms per step, the
    checkpoint gather's and the sharded posteriors' seconds. On a machine
    with more than one card, ``fit --mesh auto`` and ``stats --mesh auto``
    then run through the command line, one rank per card over NCCL;
25. the AOI viewer (``gui.py``) on phase 21's workspace, on the host
    (:func:`run_viewer`): an ``AoiViewerState`` to its clamps, zoomed and
    through every key binding, three AOIs excluded, ``save_data`` and the
    mask read back, ``aoi_subset.txt`` and ``subset`` on it (the kept AOIs'
    images bit for bit), ``build_fov_state`` on phase 20's raw folder, and
    ``show -n 0``: the PNG where matplotlib is installed, else a non-zero
    exit naming it (the JAX command raises ModuleNotFoundError); no kernel
    launch.
Phase 3 also checks the summed kernel at nb = 7900 and at M=16, nb=10240,
phase 5 the factored kernel at Kf=4, nb=10240, and phase 6 times them
there, with the special-function floor of the exact evaluation beside that
of the logs the kernels issue at M=16 (one per chunk of 4 configs). The
kernels' launch counts are set to 0 just before each of the paths 7-16 and
read just after it, and so before and after phases 18 and 19 and each
command of phases 20-21 and 25. Phases 10-21 print their seconds (stats and
ingest: by stage) and their peak device memory; every phase prints its
wall time at the end.

The second-to-last line is a JSON object with one entry per kernel, its
launches summed over the paths 7-24 (over every rank in 22-24); the last
line is {"ok": true, "device": {...}}.
"""

import gc
import importlib
import json
import logging
import math
import resource
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# simulation parameters and offset histogram of the eLife-scale benchmark
SIM_PARAMS = {
    "pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15,
    "proximity": 0.2, "offset": 90.0, "height": 3000, "background": 150,
}
# the truth of the JAX package's eLife-scale crosstalk run
# (docs/elife_scale_run_multimodel.md): two dyes bleeding into two channels
XTALK_PARAMS = {**SIM_PARAMS, "alpha": [[0.85, 0.15], [0.1, 0.9]]}
# H100 SXM published peaks: HBM3 bandwidth and dense FP32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# the special-function unit (MUFU: ex2, lg2): 16 results per SM per clock
# on compute capability 9.0 (CUDA programming guide), 132 SMs, at the
# card's maximum SM clock of 1980 MHz (nvidia-smi clocks.max.sm)
PEAK_MUFU_PER_S = 16 * 132 * 1.98e9
KERNEL_SOURCE = "tapqir_tpu_torch/csrc/offset_gamma.cu"
KERNEL_CHUNK = 4  # configs per register chunk of the summed-template kernels (kChunk)
PALLAS_SOURCE = "tapqir_tpu/ops/offset_gamma.py"
# tolerances of tests/test_pallas.py, float32 kernel against the plain
# version in float64 on the same inputs
FWD_TOL = dict(rtol=3e-5, atol=1e-2)  # summed forward
GRAD_TOL = dict(rtol=2e-4, atol=1e-4)  # summed gradient
RATE_RTOL = 1e-3  # rate gradient
PIXEL_FWD_TOL = dict(rtol=2e-5, atol=2e-5)  # per-pixel forward
PIXEL_GRAD_TOL = dict(rtol=2e-3, atol=1e-3)  # per-pixel gradient
FACT_FWD_TOL = dict(rtol=3e-5, atol=1e-2)  # factored forward
FACT_GRAD_TOL = dict(rtol=2e-3, atol=2e-3)  # factored base, delta, rate gradients
F64_TOL = dict(rtol=1e-9, atol=1e-9)
# the crosstalk step's kernel shapes: K = 2 spots of Q = 2 dyes give
# 2^(K*Q) = 16 configs (Kf = Q*K = 4 factors) over 10 AOIs x 512 frames x
# C = 2 channels
XT_M, XT_KF, XT_NB = 16, 4, 10 * 512 * 2
F64_GRAD_TOL = dict(rtol=1e-6, atol=1e-6)  # Stirling digamma: < 7e-8 absolute


def offset_histogram(n_offsets=61):
    """Empirical-offset histogram: ``n_offsets`` integer bins around 90."""
    centers = np.arange(90 - n_offsets // 2, 90 + n_offsets // 2 + 1, dtype=np.float64)
    w = np.exp(-0.5 * ((centers - 90.0) / 8.0) ** 2)
    return centers, w / w.sum()


def offset_logits(n_offsets=61):
    """Exactly ``n_offsets`` integer bins from 90 - n_offsets // 2 (those of
    :func:`offset_histogram` for an odd count) and their log weights, taken
    in log space so that the far bins of a wide histogram (J=1024) stay
    finite."""
    centers = 90.0 - n_offsets // 2 + np.arange(n_offsets, dtype=np.float64)
    lw = -0.5 * ((centers - 90.0) / 8.0) ** 2
    return centers, lw - np.log(np.exp(lw).sum())


# the kernels' edge-case inputs (kernel_inputs, factored_inputs)
VARIANTS = {
    "masked-tiles": "bins in descending order and pixels just above the 3 "
                    "lowest offsets, so the leading tiles of bins are masked whole",
    "spread": "log weights of the lower half of the bins 150 below the upper "
              "half: the bin term spreads over more than 100 log units",
    "small-d": "a third of the pixels 2^-16 above an offset, with "
               "concentrations below 1",
}


def _apply_variant(variant, rng, x, g, w, ev):
    """Edit value x (nb, EVP) and the bins g, w in place for ``variant``
    (see VARIANTS); returns g, w."""
    if variant == "masked-tiles":
        g, w = g[::-1].copy(), w[::-1].copy()
        x[:, :ev] = np.sort(g)[rng.integers(0, 3, size=(x.shape[0], ev))] + 0.5
    elif variant == "spread":
        w = w + np.where(np.arange(len(g)) < len(g) // 2, -150.0, 0.0)
    elif variant == "small-d":
        k = rng.integers(0, len(g), size=(x.shape[0], ev // 3))
        x[:, : ev // 3] = g[k] + 2.0 ** -16
    elif variant is not None:
        raise ValueError(f"unknown variant {variant}")
    return g, w


def make_dataset(Nt, F, C=1, P=14, J=61, device="cuda", n_chunk=8, params=SIM_PARAMS):
    """Simulated dataset in AOI chunks (each half on-target), with a J-bin
    offset histogram: cosmos, or crosstalk where ``params`` holds ``alpha``
    (C dyes in C channels). The on-target AOIs of every chunk come first, as
    the dataset layout requires (the posteriors evaluate the first N AOIs),
    and the chunks' ground-truth labels are carried along with their AOI
    indices offset per chunk."""
    from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData
    from tapqir_tpu_torch.utils.simulate import simulate

    per = Nt // n_chunk
    kind = "crosstalk" if "alpha" in params else "cosmos"
    chunks = [
        simulate(kind, N=per, F=F, C=C, P=P, seed=i, params=params, device=device)
        for i in range(n_chunk)
    ]

    def cat(name):  # on-target AOIs of every chunk, then the off-target ones
        arrays = [getattr(d, name) for d in chunks]
        return np.concatenate([a[d.is_ontarget] for a, d in zip(arrays, chunks)]
                              + [a[~d.is_ontarget] for a, d in zip(arrays, chunks)])

    labels, first = [], 0
    for d in chunks:
        lab = d.labels.copy()
        lab["aoi"] += first
        labels.append(lab)
        first += d.N
    centers, w = offset_histogram(J)
    return CosmosDataset(
        images=cat("images"),
        xy=cat("xy"),
        is_ontarget=cat("is_ontarget"),
        labels=np.concatenate(labels),
        offset=OffsetData(centers, w),
        name=f"chip-smoke-elife-scale-{kind}",
    )


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reset_launches():
    from tapqir_tpu_torch.ops import offset_gamma as og

    for launcher in og.LAUNCHERS.values():
        launcher.launches = 0


def _read_launches():
    from tapqir_tpu_torch.ops import offset_gamma as og

    return {name: launcher.launches for name, launcher in og.LAUNCHERS.items()}


def prepare_dataset(workdir, Nt=856, F=790, P=14, J=61, device="cuda", n_chunk=8, C=1,
                    params=SIM_PARAMS):
    """Simulate the dataset of :func:`make_dataset` and save it as
    ``workdir/data.tpqr``; returns the seconds each took."""
    from tapqir_tpu_torch.utils.dataset import save

    t0 = time.perf_counter()
    data = make_dataset(Nt, F, C=C, P=P, J=J, device=device, n_chunk=n_chunk, params=params)
    t1 = time.perf_counter()
    save(data, workdir)
    return {"simulate_seconds": t1 - t0, "save_seconds": time.perf_counter() - t1}


def fit_path(workdir, nbatch=10, fbatch=512, num_iter=400, device="cuda",
             use_factored=False):
    """Fit cosmos on ``workdir``'s dataset through the user entry points.

    Returns the fit's numbers (steps/s, launches of every kernel during the
    run and the held-out evaluation, the held-out -ELBO before and after,
    the checkpoint's iteration on reload, the logged losses) and the model.
    """
    from tapqir_tpu_torch.models import models

    workdir = Path(workdir)
    t2 = time.perf_counter()
    model = models["cosmos"](device=device)
    model.use_factored = use_factored
    model.load(workdir)
    model.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    _sync(device)
    t3 = time.perf_counter()
    iter0 = model.iter

    def held_out_loss():
        gen = torch.Generator(device=model.device)
        gen.manual_seed(12345)
        with torch.no_grad():
            return -float(model.elbo(model.params, gen, model._data_dev))

    loss_before = held_out_loss()
    warnings = []

    class _Collect(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    handler = _Collect(level=logging.WARNING)
    log = logging.getLogger("tapqir_tpu_torch")
    log.addHandler(handler)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        _sync(device)
        t4 = time.perf_counter()
        model.run(num_iter)
        _sync(device)
        dt = time.perf_counter() - t4
        loss_after = held_out_loss()
        launches = _read_launches()
    finally:
        log.removeHandler(handler)
    peak = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda"
            else None)

    csv = workdir / ".tapqir" / "logs" / "cosmos" / "metrics.csv"
    rows = [ln.split(",") for ln in csv.read_text().splitlines()]
    col = rows[0].index("-ELBO")
    logged = np.array([float(r[col]) for r in rows[1:]])

    ckpt = workdir / ".tapqir" / "cosmos_model.tpqr"
    reloaded = models["cosmos"](device=device)
    reloaded.load(workdir)
    reloaded.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    same = all(
        torch.equal(reloaded.params[k], model.params[k]) for k in model.params
    )
    result = {
        "load_init_seconds": t3 - t2,
        "seconds": dt,
        "steps_per_s": num_iter / dt,
        "iter_before": iter0,
        "iter_after": model.iter,
        "iter_reloaded": reloaded.iter,
        "reloaded_params_equal": same,
        "checkpoint": str(ckpt),
        "checkpoint_exists": ckpt.exists(),
        "logged_losses": logged.tolist(),
        "loss_before": loss_before,
        "loss_after": loss_after,
        "warnings": warnings,
        "launches": launches,
        "peak_bytes": peak,
    }
    return result, model


def run_main_path(workdir, Nt=856, F=790, P=14, J=61, nbatch=10, fbatch=512,
                  num_iter=400, device="cuda", n_chunk=8):
    """Simulate, save, and fit cosmos with the dense likelihood through the
    user entry points; the result of :func:`fit_path` with the set-up
    times."""
    setup = prepare_dataset(workdir, Nt, F, P, J, device, n_chunk)
    res, _ = fit_path(workdir, nbatch, fbatch, num_iter, device)
    res.update(setup)
    return res


def run_factored_path(workdir, nbatch=10, fbatch=512, num_iter=400, device="cuda"):
    """Fit cosmos with ``use_factored = True`` on the dataset that
    :func:`prepare_dataset` saved in ``workdir`` (linked, not simulated or
    saved again), in a workspace of its own."""
    sub = Path(workdir) / "factored"
    sub.mkdir()
    (sub / "data.tpqr").symlink_to(Path(workdir) / "data.tpqr")
    return fit_path(sub, nbatch, fbatch, num_iter, device, use_factored=True)


def check_main_path(res, num_iter):
    """Raise unless the fit finished cleanly."""
    if res["warnings"]:
        raise RuntimeError(f"the fit logged warnings (restarts): {res['warnings']}")
    if not np.isfinite(res["logged_losses"]).all():
        raise RuntimeError(f"non-finite losses: {res['logged_losses']}")
    if not (math.isfinite(res["loss_before"]) and math.isfinite(res["loss_after"])):
        raise RuntimeError("non-finite held-out loss")
    if res["iter_after"] != res["iter_before"] + num_iter:
        raise RuntimeError(f"iteration count {res['iter_after']}")
    if not res["checkpoint_exists"] or res["iter_reloaded"] != res["iter_after"]:
        raise RuntimeError("the checkpoint was not written or did not reload")
    if not res["reloaded_params_equal"]:
        raise RuntimeError("reloaded parameters differ from the fit's")


def _checkpoint_iter(workdir):
    with np.load(Path(workdir) / ".tapqir" / "cosmos_model.tpqr") as z:
        return json.loads(bytes(z["meta"]).decode())["iter"]


# the commands that take --cpu
DEVICE_COMMANDS = ("fit", "stats", "ttfb", "dwelltime")


def run_cli(workdir, argv, device="cuda", setup=None):
    """``python -m tapqir_tpu_torch --cd workdir <argv>`` in process, through
    the module's ``main(argv)`` (with ``--cpu`` when ``device`` is the CPU
    and the command takes it),
    the kernels' launch counts set to 0 just before and read just after.
    ``setup(model)``, if given, is called on the model the command builds
    before the command uses it. Returns the exit code, that model, the
    launches, the wall seconds and the peak device memory."""
    from tapqir_tpu_torch import main as cli

    built = []
    make = cli._make_model

    def record(*args, **kwargs):  # keeps the model the command builds
        built.append(make(*args, **kwargs))
        if setup is not None:
            setup(built[-1])
        return built[-1]

    cuda = torch.device(device).type == "cuda"
    cpu_flag = [] if cuda or argv[0] not in DEVICE_COMMANDS else ["--cpu"]
    cli._make_model = record
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        code = cli.main(["--cd", str(workdir), *argv, *cpu_flag])
        _sync(device)
        seconds = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        cli._make_model = make
        log = logging.getLogger("tapqir_tpu_torch")
        for handler in list(log.handlers):  # the command's stdout and log file
            handler.close()
            log.removeHandler(handler)
    return {"code": code, "model": built[-1] if built else None, "launches": launches,
            "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def run_cli_fit(workdir, nbatch=10, fbatch=512, num_iter=200, device="cuda"):
    """Phase 10: ``fit --model cosmos -n nbatch -f fbatch -it num_iter
    --no-input`` on a workspace that holds a checkpoint; the command resumes
    it and ends in ``compute_stats``. Adds the checkpoint's iteration before
    and the z_probs the command wrote to :func:`run_cli`'s result."""
    before = _checkpoint_iter(workdir)
    res = run_cli(workdir, ["fit", "--model", "cosmos", "-n", str(nbatch), "-f",
                            str(fbatch), "-it", str(num_iter), "--no-input"], device)
    res["iter_before"] = before
    with np.load(Path(workdir) / "cosmos_params.tpqr") as z:
        res["z_probs"] = z["z_probs"]
    return res


def check_cli_fit(res, num_iter, device="cuda"):
    """Raise unless phase 10 exited 0 on ``device``, took ``num_iter`` steps
    (one summed-statistics launch each on the card, no other kernel) and
    wrote its files."""
    m = res["model"]
    if res["code"] != 0 or m is None:
        raise RuntimeError(f"CLI fit exited with {res['code']}")
    if m.device.type != torch.device(device).type:
        raise RuntimeError(f"CLI fit ran on {m.device}, not on {device}")
    if m.iter != res["iter_before"] + num_iter:
        raise RuntimeError(f"CLI fit: iteration {res['iter_before']} -> {m.iter}")
    want = dict.fromkeys(res["launches"], 0)
    if m.device.type == "cuda":
        want["summed_stats"] = num_iter
    if res["launches"] != want:
        raise RuntimeError(f"CLI fit: kernel launches {res['launches']}, expected {want}")
    for f in ("cosmos_params.tpqr", "cosmos_summary.csv", ".tapqir/config.yaml"):
        if not (m.path / f).exists():
            raise RuntimeError(f"CLI fit did not write {f}")


def run_cli_stats(workdir, device="cuda"):
    """Phase 11: ``stats --no-input`` on the same workspace."""
    res = run_cli(workdir, ["stats", "--no-input"], device)
    with np.load(Path(workdir) / "cosmos_params.tpqr") as z:
        res["z_probs"] = z["z_probs"]
    return res


def _check_intervals_and_snr(m, ps):
    """Raise unless every credible interval of ``m.ci_params`` in the stats
    ``ps`` is finite with LL <= Mean <= UL, and SNR and chi2 are finite on
    the on-target rows."""
    from tapqir_tpu_torch.utils.stats import _compute_snr_chi2

    for name in m.ci_params:
        ll, mean, ul = (np.asarray(ps[name][k]) for k in ("LL", "Mean", "UL"))
        bad = ~(np.isfinite(ll) & np.isfinite(mean) & np.isfinite(ul)
                & (ll <= mean) & (mean <= ul))
        if bad.any():
            raise RuntimeError(f"{m.name} {name}: {int(bad.sum())} of {bad.size} "
                               "intervals are not finite with LL <= Mean <= UL")
    N = m.data.N
    snr, chi2 = _compute_snr_chi2(m, ps)
    if not (np.isfinite(snr[:, :N]).all() and np.isfinite(chi2[:N]).all()):
        raise RuntimeError(f"{m.name}: non-finite SNR or chi2 on on-target rows")


def _check_stats_arrays(m, ps):
    """Raise unless the cosmos stats ``ps`` hold z_probs normalised on
    on-target rows and 0 on off-target ones, theta_probs summing to at most
    1, p_specific in [0, 1], and the checks of :func:`_check_intervals_and_snr`.
    Returns z_probs' largest sum error and theta_probs' largest sum."""
    N = m.data.N
    z, th = ps["z_probs"], ps["theta_probs"]
    z_sum_err = float(np.abs(z[:N].sum(-1) - 1.0).max())
    if z_sum_err > 1e-5 or z[N:].any() or th[:, N:].any():
        raise RuntimeError(f"z_probs: sum error {z_sum_err} or nonzero off-target rows")
    th_max = float(th.sum(0).max())
    if th_max > 1.0 + 1e-5:
        raise RuntimeError(f"theta_probs sum over spots up to {th_max}")
    p_spec = ps["p_specific"]
    if not ((p_spec >= 0).all() and (p_spec <= 1).all()):
        raise RuntimeError("p_specific outside [0, 1]")
    _check_intervals_and_snr(m, ps)
    return z_sum_err, th_max


def check_cli_stats(res, fit_res):
    """Raise unless phase 11's stats hold: z_probs normalised on on-target
    rows and 0 on off-target ones, theta_probs summing to at most 1,
    p_specific in [0, 1], LL <= Mean <= UL and finite for every CI
    parameter, SNR and chi2 finite on on-target rows, MCC / recall /
    precision present and in range, no kernel launched, and z_probs
    bitwise equal to those phase 10 wrote (both use the default seed).
    Returns the numbers checked."""
    m = res["model"]
    if res["code"] != 0 or m is None:
        raise RuntimeError(f"CLI stats exited with {res['code']}")
    if any(res["launches"].values()):
        raise RuntimeError(f"CLI stats launched kernels: {res['launches']}")
    ps, N = m.params_stats, m.data.N
    z_sum_err, th_max = _check_stats_arrays(m, ps)
    p_spec = ps["p_specific"]
    summary = m.summary
    metrics = {k: summary[k]["Mean"] for k in ("MCC", "Recall", "Precision")}
    if not (-1 <= metrics["MCC"] <= 1 and 0 <= metrics["Recall"] <= 1
            and 0 <= metrics["Precision"] <= 1):
        raise RuntimeError(f"classification metrics out of range: {metrics}")
    if not np.array_equal(res["z_probs"], fit_res["z_probs"]):
        raise RuntimeError("z_probs of stats differ from those of fit (same default seed)")
    return {
        **metrics,
        "SNR_0": summary["SNR_0"]["Mean"],
        "p_specific_mean_on_target": float(p_spec[:N].mean()),
        "z_sum_max_abs_err": z_sum_err,
        "theta_sum_max": th_max,
        "gain": summary["gain"]["Mean"],
        "proximity": summary["proximity"]["Mean"],
        "lamda": summary["lamda"]["Mean"],
        "pi": summary["pi"]["Mean"],
        "z_probs_bitwise_equal_to_fit": True,
    }


# the port's float32 arithmetic on the card against float64 on the CPU, on
# the same inputs and draws: absolute on probabilities; SNR absolute in
# units of the noise sigma beside relative (an SNR near 0 has no relative
# precision), chi2 relative
PROB_TOL = 1e-4
SNR_TOL = dict(rtol=1e-4, atol=1e-4)
CHI2_TOL = dict(rtol=1e-4, atol=0.0)


def check_card_vs_cpu(model, nbatch=10, fbatch=512, num_particles=50, n_aoi=64):
    """The arithmetic of the stats that runs no kernel, on the model's device
    in its dtype and on the CPU in float64 on the same inputs: ``_probs_batch``
    on the first block of nbatch x fbatch with the same draws, and
    ``snr_and_chi2`` on the first ``n_aoi`` AOIs at the saved means. Returns
    the max abs differences, after checking PROB_TOL, SNR_TOL, CHI2_TOL."""
    from tapqir_tpu_torch.utils.stats import snr_and_chi2

    dev = model.device
    N, F = model.data.N, model.data.F
    ndx = torch.arange(min(nbatch, N), device=dev)
    fdx = torch.arange(min(fbatch, F), device=dev)

    def cpu64(t):
        return t.detach().to("cpu", torch.float64)

    with torch.no_grad():
        pc = model.constrained()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        draws = model._probs_draws(pc, ndx, fdx, num_particles, gen)
        z_d, th_d = model._probs_batch(pc, ndx, fdx, model._data_dev, num_particles,
                                       draws=draws)
        z_h, th_h = model._probs_batch(
            {k: cpu64(v) for k, v in pc.items()}, ndx.cpu(), fdx.cpu(),
            {"is_ontarget": model._data_dev["is_ontarget"].cpu()}, num_particles,
            draws={k: cpu64(v) for k, v in draws.items()})
    err_probs = max(float((cpu64(z_d) - z_h).abs().max()),
                    float((cpu64(th_d) - th_h).abs().max()))
    if not err_probs <= PROB_TOL:
        raise RuntimeError(f"_probs_batch: card vs CPU float64 {err_probs} > {PROB_TOL}")

    ps, d = model.params_stats, model.data
    sl = slice(0, n_aoi)

    def inputs(device, dtype):
        def t(a):
            return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

        def spot(name):  # (K, Nt, F, Q) -> (n, F, Q, K)
            return t(np.moveaxis(ps[name]["Mean"], 0, -1)[sl])

        return (t(d.images[sl]), spot("height"), spot("width"), spot("x"), spot("y"),
                t(d.xy[sl]), t(ps["background"]["Mean"][sl]))

    const = (float(ps["gain"]["Mean"]), d.offset.mean, d.offset.var, d.P, None)
    with torch.no_grad():
        snr_d, chi2_d = snr_and_chi2(*inputs(dev, torch.float32), *const)
        snr_h, chi2_h = snr_and_chi2(*inputs("cpu", torch.float64), *const)
    snr_d, chi2_d = cpu64(snr_d).numpy(), cpu64(chi2_d).numpy()
    np.testing.assert_allclose(snr_d, snr_h.numpy(), **SNR_TOL, err_msg="SNR card vs CPU")
    np.testing.assert_allclose(chi2_d, chi2_h.numpy(), **CHI2_TOL, err_msg="chi2 card vs CPU")
    return {
        "probs_max_abs_err": err_probs,
        "snr_max_abs_err": float(np.abs(snr_d - snr_h.numpy()).max()),
        "chi2_max_rel_err": float((np.abs(chi2_d - chi2_h.numpy()) / chi2_h.numpy()).max()),
        "block": [int(ndx.numel()), int(fdx.numel())],
        "snr_aois": int(snr_h.shape[0]),
    }


# ---------------------------------------------------------------------------
# phases 12-13: the cosmos+hmm model
# ---------------------------------------------------------------------------

# the warm start clips the cosmos marginals at 1e-5 and renormalises them;
# float32 adds round-off through the log, the softmax and the scan's 10
# levels at F=790 (each well below 1e-6 here)
WARM_TOL = 1e-5 + 1e-5
# the hmm ELBO (a sum of ~1e5 float32 terms of up to ~1e3, the image terms
# within the summed kernel's rtol 3e-5) on the card against float64 on the
# CPU, and the factored kernel against the dense one on the card: relative
HMM_ELBO_RTOL = 1e-4


def held_out_loss(model):
    """-ELBO of one fixed batch and fixed draws, without gradient."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(12345)
    with torch.no_grad():
        return -float(model.elbo(model.params, gen, model._data_dev))


def run_cli_hmm_fit(workdir, nbatch=10, num_iter=200, device="cuda"):
    """Phase 12: ``fit --model cosmos+hmm -n nbatch -it num_iter --no-input``
    on a workspace that holds a cosmos fit and its ``cosmos_params.tpqr``,
    so the command warm-starts hmm from that fit, runs ``num_iter`` steps
    and ends in ``compute_stats``. Adds to :func:`run_cli`'s result the
    chain marginals right after the warm start (before any step) beside
    the cosmos z_probs they start from, a held-out -ELBO after the warm
    start and after the fit, the fit's seconds, and the shapes of every
    kernel launch."""
    workdir = Path(workdir)
    with np.load(workdir / "cosmos_params.tpqr") as z:
        cosmos_z = z["z_probs"]
    seen = {}

    def setup(model):
        warm, run = model.warm_start_from_cosmos, model.run

        def warm_start(*args, **kwargs):
            out = warm(*args, **kwargs)
            seen["warm_z"] = model.z_probs
            del model._z_probs_cache
            seen["held_out_before"] = held_out_loss(model)
            return out

        def timed_run(num_iter, progress_bar=None):
            seen["iter_before"] = model.iter
            _sync(device)
            t0 = time.perf_counter()
            run(num_iter, progress_bar)
            _sync(device)
            seen["run_seconds"] = time.perf_counter() - t0
            seen["held_out_after"] = held_out_loss(model)

        model.warm_start_from_cosmos, model.run = warm_start, timed_run

    with record_kernel_shapes() as rec:
        res = run_cli(workdir, ["fit", "--model", "cosmos+hmm", "-n", str(nbatch), "-it",
                                str(num_iter), "--no-input"], device, setup)
    res.update(seen, cosmos_z=cosmos_z, shapes=rec.shapes)
    return res


def check_cli_hmm_fit(res, num_iter, device="cuda"):
    """Raise unless phase 12 exited 0 on ``device`` with a warm start,
    stepped 0 -> ``num_iter`` with one summed-statistics launch per step at
    nb = n·F (and the two held-out losses' forward launches, nothing else),
    its chain marginals right after the warm start equal the cosmos z_probs
    on the on-target AOIs within WARM_TOL, and its stats hold: z_probs
    normalised, init / trans on the simplex, every LL <= Mean <= UL and
    finite (init and trans included), theta_probs summing to at most 1 and
    0 off target, finite SNR / chi2 on target. Returns the numbers
    checked."""
    m = res["model"]
    if res["code"] != 0 or m is None or m.name != "cosmos+hmm":
        raise RuntimeError(f"CLI hmm fit exited with {res['code']}")
    if m.device.type != torch.device(device).type:
        raise RuntimeError(f"CLI hmm fit ran on {m.device}, not on {device}")
    if "warm_z" not in res:
        raise RuntimeError("CLI hmm fit did not warm-start from the cosmos fit")
    if res["iter_before"] != 0 or m.iter != num_iter:
        raise RuntimeError(f"CLI hmm fit: iteration {res['iter_before']} -> {m.iter}")
    N, F, n = m.data.N, m.data.F, m.nbatch_size
    M = 1 << m.K
    want = dict.fromkeys(res["launches"], 0)
    if m.device.type == "cuda":
        want.update(summed_stats=num_iter, summed_fwd=2)
        if res["shapes"] != {("summed_stats", M, n * F), ("summed_fwd", M, n * F)}:
            raise RuntimeError(f"CLI hmm fit: launches at {res['shapes']}")
    if res["launches"] != want:
        raise RuntimeError(f"CLI hmm fit: kernel launches {res['launches']}, expected {want}")
    warm_err = float(np.abs(res["warm_z"][:N] - res["cosmos_z"][:N]).max())
    if not warm_err <= WARM_TOL:
        raise RuntimeError(f"warm start: chain marginals {warm_err} from the cosmos "
                           f"z_probs > {WARM_TOL}")
    for k in ("held_out_before", "held_out_after"):
        if not math.isfinite(res[k]):
            raise RuntimeError(f"CLI hmm fit: non-finite {k}")
    for f in ("cosmos+hmm_params.tpqr", "cosmos+hmm_summary.csv"):
        if not (m.path / f).exists():
            raise RuntimeError(f"CLI hmm fit did not write {f}")

    ps = m.params_stats
    z, th = ps["z_probs"], ps["theta_probs"]
    z_sum_err = float(np.abs(z.sum(-1) - 1.0).max())
    if z_sum_err > 1e-5:
        raise RuntimeError(f"hmm z_probs: sum error {z_sum_err}")
    th_max = float(th.sum(0).max())
    if th_max > 1.0 + 1e-5 or th[:, N:].any():
        raise RuntimeError(f"hmm theta_probs sum up to {th_max} or nonzero off target")
    simplex_err = 0.0
    for name in ("init_mean", "trans_mean"):
        v = m.param(name)
        simplex_err = max(simplex_err, float(np.abs(v.sum(-1) - 1.0).max()))
        if not ((v >= 0).all() and (v <= 1).all()):
            raise RuntimeError(f"{name} outside [0, 1]")
    if simplex_err > 1e-5:
        raise RuntimeError(f"init / trans rows sum to 1 within {simplex_err}")
    if not {"init", "trans"} <= set(m.ci_params):
        raise RuntimeError(f"hmm ci_params {m.ci_params}")
    _check_intervals_and_snr(m, ps)
    summary = m.summary
    return {
        "warm_start_max_abs_err": warm_err,
        "z_sum_max_abs_err": z_sum_err,
        "init_trans_simplex_max_abs_err": simplex_err,
        "theta_sum_max": th_max,
        "held_out_before": res["held_out_before"],
        "held_out_after": res["held_out_after"],
        "trans": summary["trans"]["Mean"],
        "gain": summary["gain"]["Mean"],
        "proximity": summary["proximity"]["Mean"],
        "MCC": summary["MCC"]["Mean"] if "MCC" in summary else None,
    }


def profile_steps(model, n_prof=3):
    """Device launches per step and the device's busy share, from a
    ``torch.profiler`` trace of ``n_prof`` steps (as
    ``scripts/profile_torch_step.py`` counts them); the steps move the
    model's parameters."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    model._run_chunk(1)  # warm-up outside the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model._run_chunk(n_prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    return {
        "launches_per_step": len(kernels) / n_prof,
        "device_busy_share": sum(e.device_time_total for e in kernels) * 1e-6 / wall,
        "profiled_ms_per_step": 1e3 * wall / n_prof,
    }


def check_hmm_card_vs_cpu(model, n_elbo=2, nbatch=10, num_particles=50):
    """Phase 13, on one hmm batch of the model's AOIs 0..n_elbo-1 over every
    frame with the same draws (recorded through the ELBO's draw seam): the
    hmm ELBO on the model's device in its dtype against float64 on the CPU,
    and the factored likelihood (``use_factored = True``) against the dense
    one on the model's device (both within HMM_ELBO_RTOL); then one
    ``_compute_theta_probs`` block (AOIs 0..nbatch-1, ``num_particles``
    particles) on the device against float64 on the CPU with the same
    draws (PROB_TOL). Returns the relative and absolute differences and the
    launches of the card-side evaluations."""
    from tapqir_tpu_torch.models import models

    # the module (the package binds the class to the same name)
    hmm_module = importlib.import_module("tapqir_tpu_torch.models.hmm")

    dev, F = model.device, model.data.F
    ndx = torch.arange(n_elbo, device=dev)
    win = {k: v.detach() for k, v in model.gather_windows(model.params, ndx, None).items()}
    # both sides score AOIs 0..n_elbo-1 on that block of the data (the
    # ELBO's plate scale takes Nt from the data it is given)
    per_aoi = ("images", "xy", "is_ontarget", "mask")
    block = {k: v[:n_elbo] if k in per_aoi else v for k, v in model._data_dev.items()}
    recorded = []
    packed = hmm_module.std_gamma_sample_packed

    def recording(concs, generator=None, draws=None):
        out = packed(concs, generator, draws)
        recorded.append(torch.cat([g.reshape(-1) for g in out]))
        return out

    _reset_launches()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    hmm_module.std_gamma_sample_packed = recording
    try:
        with torch.no_grad():
            elbo_dense = float(model.elbo_from_windows(win, gen, ndx, None, F, block))
    finally:
        hmm_module.std_gamma_sample_packed = packed
    draws = recorded[0]
    model.use_factored = True
    try:
        with torch.no_grad():
            elbo_fact = float(model.elbo_from_windows(win, None, ndx, None, F, block,
                                                      draws=draws))
    finally:
        model.use_factored = False
    _sync(dev)
    launches = _read_launches()

    def cpu64(t):
        return t.detach().to("cpu", torch.float64)

    cpu = models["cosmos+hmm"](S=model.S, K=model.K, device="cpu", dtype="double",
                               priors=model.priors)
    cpu.data, cpu._transforms = model.data, model._transforms
    cpu._build_constants()
    data = {k: v.cpu() if k == "is_ontarget" else v.cpu().double() for k, v in block.items()}
    with torch.no_grad():
        elbo_cpu = float(cpu.elbo_from_windows(
            {k: cpu64(v) for k, v in win.items()}, None, torch.arange(n_elbo), None, F,
            data, draws=cpu64(draws)))
    err_card = abs(elbo_dense - elbo_cpu) / abs(elbo_cpu)
    err_fact = abs(elbo_fact - elbo_dense) / abs(elbo_dense)
    if not (err_card <= HMM_ELBO_RTOL and err_fact <= HMM_ELBO_RTOL):
        raise RuntimeError(f"hmm ELBO: card vs CPU {err_card}, factored vs dense "
                           f"{err_fact} (relative) > {HMM_ELBO_RTOL}")

    bdx = torch.arange(min(nbatch, model.data.N), device=dev)
    z_map = torch.as_tensor(model.z_map, device=dev)[bdx]
    with torch.no_grad():
        pc = model.constrained()
        gen.manual_seed(0)
        tdraws = model._theta_draws(pc, bdx, num_particles, gen)
        th_d = model._theta_block(pc, bdx, z_map, num_particles, draws=tdraws)
        th_h = model._theta_block({k: cpu64(v) for k, v in pc.items()}, bdx.cpu(),
                                  z_map.cpu(), num_particles,
                                  draws={k: cpu64(v) for k, v in tdraws.items()})
    err_theta = float((cpu64(th_d) - th_h).abs().max())
    if not err_theta <= PROB_TOL:
        raise RuntimeError(f"hmm theta block: card vs CPU float64 {err_theta} > {PROB_TOL}")
    return {
        "elbo_card": elbo_dense, "elbo_cpu_f64": elbo_cpu, "elbo_factored": elbo_fact,
        "elbo_card_vs_cpu_rel_err": err_card, "elbo_factored_vs_dense_rel_err": err_fact,
        "theta_block_max_abs_err": err_theta, "elbo_images": n_elbo * F,
        "theta_block": [int(bdx.numel()), F], "launches": launches,
    }


# ---------------------------------------------------------------------------
# phases 14-16: the crosstalk model and the kinetics commands
# ---------------------------------------------------------------------------

# the crosstalk ELBO (float32 sums of ~1e5 terms, the image terms within the
# summed kernel's rtol 3e-5) on the card against float64 on the CPU, and
# the factored kernel against the dense one: relative
XTALK_ELBO_RTOL = 1e-4
# the kinetics fits (float64 Adam) on the card against the CPU: relative
MLE_RTOL = 1e-4
# phase 16's MLE steps, cut from the commands' defaults (15000, 10000) to
# keep the script within its time limit with the restart phases
TTFB_ITER, DWELL_ITER = 5000, 2500


class record_kernel_shapes:
    """Within the block, ``counts``: the launches of every summed and
    factored kernel per (kernel, configs, images), in the order first
    launched, the factored ones as ("factored_stats", Kf, configs, images);
    ``shapes``: the set of those keys."""

    def __enter__(self):
        from tapqir_tpu_torch.ops import offset_gamma as og

        self.counts = {}
        self._calls = (og._SummedLauncher.__call__, og._FactoredLauncher.__call__)
        summed, factored = self._calls
        counts = self.counts

        def add(key):
            counts[key] = counts.get(key, 0) + 1

        def summed_rec(launcher, x2, a3, *args):
            kind = "summed_stats" if launcher.stats else "summed_fwd"
            add((kind, int(a3.shape[0]), int(x2.shape[0])))
            return summed(launcher, x2, a3, *args)

        def factored_rec(launcher, x2, base, deltas, masks, *args):
            add(("factored_stats", int(deltas.shape[0]), len(masks), int(x2.shape[0])))
            return factored(launcher, x2, base, deltas, masks, *args)

        og._SummedLauncher.__call__ = summed_rec
        og._FactoredLauncher.__call__ = factored_rec
        return self

    def __exit__(self, *exc):
        from tapqir_tpu_torch.ops import offset_gamma as og

        og._SummedLauncher.__call__, og._FactoredLauncher.__call__ = self._calls

    @property
    def shapes(self):
        return set(self.counts)


def run_cli_crosstalk_fit(workdir, nbatch=10, fbatch=512, num_iter=200, device="cuda"):
    """Phase 14's command: ``fit --model crosstalk -n nbatch -f fbatch -it
    num_iter --no-input`` on a fresh crosstalk workspace; the command fits
    and ends in ``compute_stats``. Adds to :func:`run_cli`'s result the
    fit's seconds, a held-out -ELBO before and after the steps (one fixed
    batch and fixed draws, without gradient) and the shapes of every kernel
    launch."""
    seen = {}

    def setup(model):
        run = model.run

        def timed_run(num_iter, progress_bar=None):
            del model.run  # the command's run only: later runs are the class's
            seen["iter_before"] = model.iter
            seen["held_out_before"] = held_out_loss(model)
            _sync(device)
            t0 = time.perf_counter()
            run(num_iter, progress_bar)
            _sync(device)
            seen["run_seconds"] = time.perf_counter() - t0
            seen["held_out_after"] = held_out_loss(model)

        model.run = timed_run

    with record_kernel_shapes() as rec:
        res = run_cli(workdir, ["fit", "--model", "crosstalk", "-n", str(nbatch), "-f",
                                str(fbatch), "-it", str(num_iter), "--no-input"], device,
                      setup)
    res.update(seen, shapes=rec.shapes)
    return res


def check_cli_crosstalk_fit(res, num_iter, device="cuda"):
    """Raise unless phase 14's command exited 0 on ``device``, stepped 0 ->
    ``num_iter`` with one summed-statistics launch per step at M = 16 over
    nb = n·f·C images (and the two held-out losses' forward launches there,
    nothing else), and its stats hold: z_probs normalised for both dyes and
    0 off target, theta_probs summing to at most 1, alpha on the simplex,
    every LL <= Mean <= UL and finite (alpha's included), SNR and chi2
    finite for both channels, a summary with alpha, SNR_0 and SNR_1. Returns
    the numbers checked."""
    m = res["model"]
    if res["code"] != 0 or m is None or m.name != "crosstalk":
        raise RuntimeError(f"CLI crosstalk fit exited with {res['code']}")
    if m.device.type != torch.device(device).type:
        raise RuntimeError(f"CLI crosstalk fit ran on {m.device}, not on {device}")
    if res["iter_before"] != 0 or m.iter != num_iter:
        raise RuntimeError(f"CLI crosstalk fit: iteration {res['iter_before']} -> {m.iter}")
    N, C = m.data.N, m.data.C
    M, nb = 1 << (m.K * m.Q), m.nbatch_size * m.fbatch_size * C
    want = dict.fromkeys(res["launches"], 0)
    if m.device.type == "cuda":
        want.update(summed_stats=num_iter, summed_fwd=2)
        if res["shapes"] != {("summed_stats", M, nb), ("summed_fwd", M, nb)}:
            raise RuntimeError(f"CLI crosstalk fit: launches at {res['shapes']}")
    if res["launches"] != want:
        raise RuntimeError(f"CLI crosstalk fit: launches {res['launches']}, expected {want}")
    for k in ("held_out_before", "held_out_after"):
        if not math.isfinite(res[k]):
            raise RuntimeError(f"CLI crosstalk fit: non-finite {k}")
    for f in ("crosstalk_params.tpqr", "crosstalk_summary.csv"):
        if not (m.path / f).exists():
            raise RuntimeError(f"CLI crosstalk fit did not write {f}")
    ps = m.params_stats
    z, th = ps["z_probs"], ps["theta_probs"]
    if z.shape[-2:] != (m.Q, 1 + m.S) or m.Q != C:
        raise RuntimeError(f"crosstalk z_probs of shape {z.shape}")
    z_sum_err = float(np.abs(z[:N].sum(-1) - 1.0).max())
    if z_sum_err > 1e-5 or z[N:].any() or th[:, N:].any():
        raise RuntimeError(f"crosstalk z_probs: sum error {z_sum_err} or nonzero off target")
    th_max = float(th.sum(0).max())
    if th_max > 1.0 + 1e-5:
        raise RuntimeError(f"crosstalk theta_probs sum over spots up to {th_max}")
    alpha = m.param("alpha_mean")
    simplex_err = float(np.abs(alpha.sum(-1) - 1.0).max())
    if simplex_err > 1e-5 or not ((alpha >= 0) & (alpha <= 1)).all():
        raise RuntimeError(f"alpha_mean {alpha.tolist()} off the simplex")
    if m.ci_params[0] != "alpha" or ps["alpha"]["Mean"].shape != (m.Q, C):
        raise RuntimeError("crosstalk stats lack the alpha intervals")
    _check_intervals_and_snr(m, ps)
    summary = m.summary
    for row in ("alpha", "SNR_0", "SNR_1", "MCC"):
        if row not in summary:
            raise RuntimeError(f"crosstalk summary lacks {row}")
    return {
        "z_sum_max_abs_err": z_sum_err,
        "theta_sum_max": th_max,
        "alpha_simplex_max_abs_err": simplex_err,
        "held_out_before": res["held_out_before"],
        "held_out_after": res["held_out_after"],
        "alpha": summary["alpha"]["Mean"],
        "alpha_95_LL": summary["alpha"]["95% LL"],
        "alpha_95_UL": summary["alpha"]["95% UL"],
        "gain": summary["gain"]["Mean"],
        "proximity": summary["proximity"]["Mean"],
        "SNR": [summary["SNR_0"]["Mean"], summary["SNR_1"]["Mean"]],
        "MCC": summary["MCC"]["Mean"],
    }


def run_crosstalk_factored(model, num_iter=200):
    """Phase 14's second route: ``num_iter`` more steps of the command's
    model through ``Model.run`` with ``use_factored = True``, the launch
    counts set to 0 just before and read just after. Returns the seconds,
    steps/s, launches, their shapes and the peak device memory."""
    device = model.device
    cuda = device.type == "cuda"
    model.use_factored = True
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with record_kernel_shapes() as rec:
            _reset_launches()
            _sync(device)
            t0 = time.perf_counter()
            model.run(num_iter)
            _sync(device)
            seconds = time.perf_counter() - t0
            launches = _read_launches()
    finally:
        model.use_factored = False
    return {"seconds": seconds, "steps_per_s": num_iter / seconds, "launches": launches,
            "shapes": rec.shapes, "iter": model.iter,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def check_crosstalk_factored(res, model, num_iter):
    """Raise unless the factored route took its steps with exactly one
    factored launch each at Kf = Q·K, M = 2^Kf over n·f·C images."""
    Kf = model.K * model.Q
    nb = model.nbatch_size * model.fbatch_size * model.data.C
    want = dict.fromkeys(res["launches"], 0)
    if model.device.type == "cuda":
        want["factored_stats"] = num_iter
        if res["shapes"] != {("factored_stats", Kf, 1 << Kf, nb)}:
            raise RuntimeError(f"crosstalk factored: launches at {res['shapes']}")
    if res["launches"] != want:
        raise RuntimeError(f"crosstalk factored: launches {res['launches']}, expected {want}")


def check_crosstalk_card_vs_cpu(model, n_aoi=2, n_frames=128):
    """Phase 15, on AOIs 0..n_aoi-1 x frames 0..n_frames-1 with the same
    draws (recorded through the ELBO's draw seam): the crosstalk ELBO on the
    model's device in its dtype against float64 on the CPU, and the factored
    likelihood against the dense one on the device (both within
    XTALK_ELBO_RTOL). The batch is smaller than a step's because the CPU's
    plain version holds (16 configs, images, 256 lanes, 61 bins) float64
    intermediates. Returns the differences and the launches of the
    device-side evaluations."""
    from tapqir_tpu_torch.models import models

    # the module (the package binds the class to the same name)
    cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")

    dev = model.device
    ndx = torch.arange(n_aoi, device=dev)
    fidx = torch.arange(n_frames, device=dev)
    win = {k: v.detach() for k, v in model.gather_windows(model.params, ndx, fidx).items()}
    # both sides score that batch on the block of AOIs 0..n_aoi-1 (the
    # ELBO's plate scale takes Nt from the data it is given)
    per_aoi = ("images", "xy", "is_ontarget", "mask")
    block = {k: v[:n_aoi] if k in per_aoi else v for k, v in model._data_dev.items()}
    recorded = []
    packed = cosmos_module.std_gamma_sample_packed

    def recording(concs, generator=None, draws=None):
        out = packed(concs, generator, draws)
        recorded.append(torch.cat([g.reshape(-1) for g in out]))
        return out

    _reset_launches()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cosmos_module.std_gamma_sample_packed = recording
    try:
        with torch.no_grad():
            elbo_dense = float(model.elbo_from_windows(win, gen, ndx, fidx, n_frames, block))
    finally:
        cosmos_module.std_gamma_sample_packed = packed
    draws = recorded[0]
    model.use_factored = True
    try:
        with torch.no_grad():
            elbo_fact = float(model.elbo_from_windows(win, None, ndx, fidx, n_frames, block,
                                                      draws=draws))
    finally:
        model.use_factored = False
    _sync(dev)
    launches = _read_launches()

    def cpu64(t):
        return t.detach().to("cpu", torch.float64)

    cpu = models["crosstalk"](S=model.S, K=model.K, device="cpu", dtype="double",
                              priors=model.priors)
    cpu.data, cpu._transforms = model.data, model._transforms
    cpu._build_constants()
    data = {k: v.cpu() if k == "is_ontarget" else v.cpu().double() for k, v in block.items()}
    with torch.no_grad():
        elbo_cpu = float(cpu.elbo_from_windows(
            {k: cpu64(v) for k, v in win.items()}, None, torch.arange(n_aoi),
            torch.arange(n_frames), n_frames, data, draws=cpu64(draws)))
    err_card = abs(elbo_dense - elbo_cpu) / abs(elbo_cpu)
    err_fact = abs(elbo_fact - elbo_dense) / abs(elbo_dense)
    if not (err_card <= XTALK_ELBO_RTOL and err_fact <= XTALK_ELBO_RTOL):
        raise RuntimeError(f"crosstalk ELBO: card vs CPU {err_card}, factored vs dense "
                           f"{err_fact} (relative) > {XTALK_ELBO_RTOL}")
    return {
        "elbo_card": elbo_dense, "elbo_cpu_f64": elbo_cpu, "elbo_factored": elbo_fact,
        "elbo_card_vs_cpu_rel_err": err_card, "elbo_factored_vs_dense_rel_err": err_fact,
        "elbo_images": n_aoi * n_frames * model.data.C, "launches": launches,
    }


def run_kinetics(workdir, argv, device="cuda", cpu_rows=16, cpu_elems=1 << 15):
    """Phase 16: the kinetics command ``argv`` (``ttfb ...`` or ``dwelltime
    ...``) in process on ``workdir`` through :func:`run_cli`, recording its
    MLE fits, then each fit's first posterior samples fitted again in
    float64 on the CPU with the same data and steps (rows are independent
    fits): ``cpu_rows`` rows, fewer where a row holds more than
    ``cpu_elems`` / ``cpu_rows`` values (a dwell-time row of an early fit
    holds ~66,000 intervals), at least one. Adds the seconds of the z draws
    and of the fits, the largest relative difference card vs CPU, and the
    files written."""
    from tapqir_tpu_torch.utils import mle_analysis

    fits, times = [], {"z_sample": 0.0, "mle": 0.0}
    mle_fns = {name: getattr(mle_analysis, name) for name in ("ttfb_mle", "exp_mle")}

    def recorded(name):
        def fit(data, *args, **kwargs):
            t0 = time.perf_counter()
            out = mle_fns[name](data, *args, **kwargs)
            times["mle"] += time.perf_counter() - t0
            fits.append((name, np.asarray(data), args, kwargs, out))
            return out

        return fit

    def setup(model):
        draw = model.z_sample

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = draw(*args, **kwargs)
            times["z_sample"] += time.perf_counter() - t0
            times["z_samples_shape"] = list(out.shape)
            return out

        model.z_sample = timed

    for name in mle_fns:
        setattr(mle_analysis, name, recorded(name))
    try:
        res = run_cli(workdir, argv, device, setup)
    finally:
        for name, fn in mle_fns.items():
            setattr(mle_analysis, name, fn)

    t0 = time.perf_counter()
    rel = 0.0
    refit_rows = []
    for name, data, args, kwargs, out in fits:
        rows = max(1, min(cpu_rows, cpu_elems // data.shape[1]))
        refit_rows.append(rows)
        cpu = mle_fns[name](data[:rows], *args, **{**kwargs, "device": "cpu"})
        for k, v in out.items():
            if k == "losses":
                continue
            got, want = np.asarray(v)[:rows], np.asarray(cpu[k])
            if not np.isfinite(got).all():
                raise RuntimeError(f"{argv[0]}: non-finite {k}")
            rel = max(rel, float((np.abs(got - want) / np.abs(want)).max()))
    res.update(times, fits=[(f[0], list(f[1].shape)) for f in fits], mle_rel_err=rel,
               cpu_refit_rows=refit_rows,
               host_max_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
               cpu_refit_seconds=time.perf_counter() - t0, files=sorted(
                   p.name for p in Path(workdir).iterdir() if argv[0] in p.name))
    return res


def check_kinetics(res, name, C, n_fits, device="cuda"):
    """Raise unless the kinetics command exited 0 on ``device``, ran
    ``n_fits`` fits, launched no kernel, its fits on the device agree with
    float64 on the CPU within MLE_RTOL, and its parameter tables hold finite
    numbers with LL <= Mean <= UL for each of the C channels."""
    from tapqir_tpu_torch.utils.stats import read_summary

    m = res["model"]
    if res["code"] != 0 or m is None:
        raise RuntimeError(f"{name} exited with {res['code']}")
    if m.device.type != torch.device(device).type:
        raise RuntimeError(f"{name} ran on {m.device}, not on {device}")
    if any(res["launches"].values()):
        raise RuntimeError(f"{name} launched kernels: {res['launches']}")
    if len(res["fits"]) != n_fits:
        raise RuntimeError(f"{name}: {len(res['fits'])} fits, expected {n_fits}")
    if not res["mle_rel_err"] <= MLE_RTOL:
        raise RuntimeError(f"{name}: card vs CPU fits differ by {res['mle_rel_err']} "
                           f"(relative) > {MLE_RTOL}")
    tables = {}
    kinds = (("params",) if name == "ttfb" else ("kon", "koff"))
    for c in range(C):
        for kind in kinds:
            path = m.path / f"{m.name}_{name}-{kind}-channel{c}.csv"
            rows = read_summary(path)
            for row, cells in rows.items():
                mean, ll, ul = (cells[k] for k in ("Mean", "95% LL", "95% UL"))
                if not (all(map(math.isfinite, (mean, ll, ul))) and ll <= mean <= ul):
                    raise RuntimeError(f"{path.name} {row}: {cells}")
            tables[f"{kind}-channel{c}"] = {r: v["Mean"] for r, v in rows.items()}
    return tables


# ---------------------------------------------------------------------------
# restart phases (17-19)
# ---------------------------------------------------------------------------

# phase 18's command and phase 19's API runs
RESTARTS_R, RESTART_ITER, API_RESTART_ITER = 4, 200, 20
# one restart step on the card (float32) against float64 on the CPU: relative,
# per chain
RESTART_RTOL = 1e-4
# the chain-batched rate gradient against R single-chain launches: relative
CHAIN_RATE_RTOL = 1e-6


def chain_rates(R, seed):
    """R per-chain rates 1/gain around the simulation's gain of 7."""
    return 1.0 / np.random.default_rng(seed).uniform(6.0, 8.0, R)


def compare_chains(form, R, nb, EVP, ev, J, seed, fwd_tol, grad_tol, M=4, Kf=2):
    """Phase 17: one chain-batched launch of the summed (``form`` =
    "summed", M configs) or factored ("factored", Kf spots) kernel over R
    runs of nb images with a rate per run, against R single-chain launches
    (out, spl and spd bitwise equal, and each chain's rate gradient through
    the autograd wrapper within CHAIN_RATE_RTOL relative), and against the
    float64 plain version chain by chain, over pieces of images: forward,
    the concentration (or base and delta) gradients and each chain's rate
    gradient under a random cotangent. Returns the max errors."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    n_all = R * nb
    rates = torch.tensor(chain_rates(R, seed), device="cuda", dtype=torch.float32)
    if form == "summed":
        x, a, _, g, w = kernel_inputs(M, n_all, EVP, ev, J, torch.float32, seed, "cuda")
        leaves, axes = [a], [1]
        launchers = (og.summed_fwd, og.summed_stats)

        def launch(launcher, sl, r):
            return launcher(x[sl].contiguous(), a[:, sl].contiguous(), r, g, w, ev)

        def wrapper(sl, ls, r):
            return og.offset_gamma_summed(x[sl], ls[0], r, g, w, ev)

        def plain(sl, ls, r):
            return og.offset_gamma_summed_plain(x[sl, :ev].double(), ls[0], r,
                                                g.double(), w.double(), ev)
    else:
        x, base, deltas, mtab, _, g, w = factored_inputs(Kf, n_all, EVP, ev, J,
                                                         torch.float32, seed, "cuda")
        masks = og.config_masks(mtab, Kf)
        M = len(masks)
        leaves, axes = [base, deltas], [0, 1]
        launchers = (og.factored_stats,)

        def launch(launcher, sl, r):
            return launcher(x[sl].contiguous(), base[sl].contiguous(),
                            deltas[:, sl].contiguous(), masks, r, g, w, ev)

        def wrapper(sl, ls, r):
            return og.offset_gamma_factored_summed(x[sl], ls[0], ls[1], mtab, r, g, w, ev)

        def plain(sl, ls, r):
            return og.offset_gamma_factored_summed_plain(x[sl, :ev].double(), ls[0], ls[1],
                                                         mtab, r, g.double(), w.double(), ev)

    def part(t, ax, sl, lanes=False):
        p = t.narrow(ax, sl.start, sl.stop - sl.start)
        return p[..., :ev] if lanes and t.dim() > 1 else p

    runs = [slice(r * nb, (r + 1) * nb) for r in range(R)]
    everything = slice(0, n_all)
    for launcher in launchers:  # bitwise against R single-chain launches
        batched = launch(launcher, everything, rates)
        batched = batched if isinstance(batched, tuple) else (batched,)
        for r, sl in enumerate(runs):
            single = launch(launcher, sl, rates[r:r + 1])
            single = single if isinstance(single, tuple) else (single,)
            for name, u, v in zip(("out", "spl", "spd"), batched, single):
                if not torch.equal(u[:, sl], v):
                    raise RuntimeError(f"{form} {launcher.entry}: chain {r}'s {name} "
                                       "differs from its single-chain launch")
        del batched, single

    cot = torch.tensor(np.random.default_rng(seed + 1).uniform(-1, 1, (M, n_all)),
                       device="cuda", dtype=torch.float32)
    ls = [t.clone().requires_grad_(True) for t in leaves]
    rk = rates.clone().requires_grad_(True)
    out_k = wrapper(everything, ls, rk)
    grads_k = torch.autograd.grad((out_k * cot).sum(), ls + [rk])
    errs = {"rate_vs_single_rel": 0.0}
    for r, sl in enumerate(runs):
        ls_r = [part(t, ax, sl).clone().requires_grad_(True) for t, ax in zip(leaves, axes)]
        r1 = rates[r:r + 1].clone().requires_grad_(True)
        out_r = wrapper(sl, ls_r, r1)
        g_r = torch.autograd.grad((out_r * cot[:, sl]).sum(), [r1])[0]
        rel = abs(float(g_r) - float(grads_k[-1][r])) / abs(float(g_r))
        errs["rate_vs_single_rel"] = max(errs["rate_vs_single_rel"], rel)
    if errs["rate_vs_single_rel"] > CHAIN_RATE_RTOL:
        raise RuntimeError(f"{form}: chain-batched rate gradient {errs['rate_vs_single_rel']} "
                           f"from the single-chain launches (relative) > {CHAIN_RATE_RTOL}")

    # the float64 plain version, chain by chain over pieces of images
    names = ["grad_concentration"] if form == "summed" else ["grad_base", "grad_deltas"]

    def close(name, got, want, tol):
        got64, want64 = got.detach().double().cpu().numpy(), want.detach().cpu().numpy()
        np.testing.assert_allclose(got64, want64, err_msg=f"{form} {name}", **tol)
        errs[name] = max(errs.get(name, 0.0), float(np.abs(got64 - want64).max()))

    for r, sl in enumerate(runs):
        r64 = rates[r].double().requires_grad_(True)
        gr = 0.0
        for sel in _plain_chunks(torch.ones(nb, dtype=torch.bool), M * ev * J):
            piece = slice(sl.start + int(sel[0]), sl.start + int(sel[-1]) + 1)
            ls_p = [part(t, ax, piece, lanes=True).double().requires_grad_(True)
                    for t, ax in zip(leaves, axes)]
            out_p = plain(piece, ls_p, r64)
            g_p = torch.autograd.grad((out_p * cot[:, piece].double()).sum(), ls_p + [r64])
            gr = gr + g_p[-1]
            close("forward", out_k[:, piece], out_p, fwd_tol)
            for name, gk, gp, ax in zip(names, grads_k[:-1], g_p[:-1], axes):
                close(name, part(gk, ax, piece, lanes=True), gp, grad_tol)
        rel = abs(float(grads_k[-1][r]) - float(gr)) / abs(float(gr))
        errs["grad_rate_rel"] = max(errs.get("grad_rate_rel", 0.0), rel)
        if rel > (RATE_RTOL if form == "summed" else grad_tol["rtol"]):
            raise RuntimeError(f"{form}: chain {r}'s rate gradient {rel} from float64")
    return errs


def _time_chain_plain(plain, leaves, axes, rates, R, nb, M, grad, iters=3):
    """ms of the plain version over R runs of nb images, each run with its
    rate (forward only, or forward + autograd backward), in pieces of at
    most 40960 / M images."""
    step = max(1, 40960 // M)
    pieces = [(r, slice(r * nb + i, r * nb + min(i + step, nb)))
              for r in range(R) for i in range(0, nb, step)]

    def run():
        for r, sl in pieces:
            ls = [t.narrow(ax, sl.start, sl.stop - sl.start) for t, ax in zip(leaves, axes)]
            if grad:
                ls = [t.detach().requires_grad_(True) for t in ls]
                torch.autograd.grad(plain(sl, ls, rates[r]).sum(), ls)
            else:
                with torch.no_grad():
                    plain(sl, ls, rates[r])

    return time_ms(run, iters)


def run_chain_kernels():
    """Phase 17: the chain-batched launches of the restart step - the
    summed statistics, summed forward and factored kernels with a rate per
    chain - at the restart shapes (R=4 chains x nb=5120 images, M=4 / Kf=2;
    then crosstalk's M=16 / Kf=4 over R=2 x 10240) against R single-chain
    launches and float64 (:func:`compare_chains`), then timed with CUDA
    events beside the R single-chain launches, the plain version, the
    bound and the special-function floor; the summed statistics of the
    hmm restart step (R=4 x 7900) timed so too. Returns the errors and the
    timing rows (ms, plain ms, bound ms, bound by, floor ms, single ms)."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    EVP, ev, J = 256, 196, 61
    R4, nb4 = RESTARTS_R, 5120
    cases = [
        ("summed", R4, nb4, 4, 2, FWD_TOL, GRAD_TOL),
        ("factored", R4, nb4, 4, 2, FACT_FWD_TOL, FACT_GRAD_TOL),
        ("summed", 2, XT_NB, XT_M, XT_KF, FWD_TOL, GRAD_TOL),
        ("factored", 2, XT_NB, XT_M, XT_KF, FACT_FWD_TOL, FACT_GRAD_TOL),
    ]
    # the hmm restart step (phase 19): R=4 chains x 10 AOIs x 790 frames,
    # and a rank's restart step on phase 24's 2x2 mesh: R=2 chains x 10 AOIs
    # x its 395 frames; timed only (their arithmetic is checked at R=4 x
    # 5120 above)
    cases.append(("summed", R4, 10 * 790, 4, 2, None, None))
    cases.append(("summed", MESH_RESTARTS_R, 10 * 395, 4, 2, None, None))
    errs, timing = {}, {}
    for i, (form, R, nb, M, Kf, fwd_tol, grad_tol) in enumerate(cases):
        shape = f"M={M}" if form == "summed" else f"Kf={Kf} (M={M})"
        if fwd_tol is not None:
            errs[f"{form} R={R} x nb={nb} {shape}"] = compare_chains(
                form, R, nb, EVP, ev, J, 60 + i, fwd_tol, grad_tol, M=M, Kf=Kf)
            torch.cuda.empty_cache()

        n_all = R * nb
        rates = torch.tensor(chain_rates(R, 70 + i), device="cuda", dtype=torch.float32)
        singles = [rates[r:r + 1] for r in range(R)]
        runs = [slice(r * nb, (r + 1) * nb) for r in range(R)]
        if form == "summed":
            x, a, _, g, w = kernel_inputs(M, n_all, EVP, ev, J, torch.float32, 80 + i, "cuda")
            x[:, ev:] = 91.0  # finite padding for the plain version
            a[..., ev:] = 1.0
            parts = [(x[sl].contiguous(), a[:, sl].contiguous()) for sl in runs]
            floor = mufu_floor_ms(x[:, :ev], g, M)
            kernels = (("summed_stats", og.summed_stats, True),
                       ("summed_fwd", og.summed_fwd, False))
            for kname, launcher, stats in kernels if fwd_tol is not None else kernels[:1]:
                row = f"{kname} R={R} x nb={nb} M={M}"
                ms = time_ms(lambda: launcher(x, a, rates, g, w, ev), 20)
                single = time_ms(lambda: [launcher(xp, ap, r1, g, w, ev)
                                          for (xp, ap), r1 in zip(parts, singles)], 20)
                plain = _time_chain_plain(
                    lambda sl, ls, r: og.offset_gamma_summed_plain(x[sl], ls[0], r, g, w, ev),
                    [a], [1], rates, R, nb, M, grad=stats)
                timing[row] = (ms, plain, *bound_ms(x, a, g, ev, stats), floor, single)
            del x, a, parts
        else:
            x, base, deltas, mtab, _, g, w = factored_inputs(Kf, n_all, EVP, ev, J,
                                                             torch.float32, 80 + i, "cuda")
            x[:, ev:] = 91.0
            deltas[..., ev:] = 0.0
            masks = og.config_masks(mtab, Kf)
            parts = [(x[sl].contiguous(), base[sl].contiguous(), deltas[:, sl].contiguous())
                     for sl in runs]
            row = f"factored_stats R={R} x nb={nb} Kf={Kf}"
            ms = time_ms(lambda: og.factored_stats(x, base, deltas, masks, rates, g, w, ev), 20)
            single = time_ms(lambda: [og.factored_stats(xp, bp, dp, masks, r1, g, w, ev)
                                      for (xp, bp, dp), r1 in zip(parts, singles)], 20)
            plain = _time_chain_plain(
                lambda sl, ls, r: og.offset_gamma_factored_summed_plain(
                    x[sl], ls[0], ls[1], mtab, r, g, w, ev),
                [base, deltas], [0, 1], rates, R, nb, M, grad=True)
            timing[row] = (ms, plain, *bound_factored_ms(x, deltas, g, M, ev),
                           mufu_floor_ms(x[:, :ev], g, M), single)
            del x, base, deltas, parts
        torch.cuda.empty_cache()
    return errs, timing


def profile_restart_steps(model, R, n_prof=3):
    """Device launches per restart step of R chains (``Model._restart_step``
    on the model's parameters stacked R times) and the device's busy share,
    from a ``torch.profiler`` trace of ``n_prof`` steps, as
    :func:`profile_steps` counts a single-chain step's."""
    from tapqir_tpu_torch.parallel.restarts import stack_params

    params = stack_params(model.params, R, perturb=0.01)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    model._restart_step(params, mu, nu, 1, model.lr, gen)  # warm-up outside the trace
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(2, 2 + n_prof):
            model._restart_step(params, mu, nu, t, model.lr, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    return {
        "launches_per_step": len(kernels) / n_prof,
        "device_busy_share": sum(e.device_time_total for e in kernels) * 1e-6 / wall,
        "profiled_ms_per_step": 1e3 * wall / n_prof,
    }


def _timed_restarts(seen, device):
    """A stand-in for ``parallel.restarts.fit_restarts`` that times the call
    (with the device synchronised) and keeps its losses and best chain in
    ``seen``; returns it and the original to restore."""
    from tapqir_tpu_torch.parallel import restarts

    fit_restarts = restarts.fit_restarts

    def timed(model, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, best = fit_restarts(model, **kwargs)
        _sync(device)
        seen.update(restart_seconds=time.perf_counter() - t0, losses=losses, best=best,
                    iter_after_restarts=model.iter,
                    restart_peak_bytes=(torch.cuda.max_memory_allocated()
                                        if torch.device(device).type == "cuda" else None))
        return losses, best

    return restarts, timed, fit_restarts


def run_cli_restarts(workdir, nbatch=10, fbatch=512, R=RESTARTS_R, restart_iter=RESTART_ITER,
                     num_iter=200, device="cuda"):
    """Phase 18: in a workspace of its own beside phase 7's (its
    ``data.tpqr`` linked, not saved again), ``fit --model cosmos -n nbatch -f
    fbatch -R R --restart-iter restart_iter -it num_iter --no-input`` and
    then ``stats --no-input``, each in process with the launch counts set to
    0 just before and read just after. Adds to :func:`run_cli`'s result the
    restarts' seconds, losses and best chain, the count of launches per
    shape, the stats command's result, and the checkpoint's iteration."""
    sub = Path(workdir) / "restarts"
    sub.mkdir()
    (sub / "data.tpqr").symlink_to(Path(workdir) / "data.tpqr")
    seen = {}
    restarts, timed, original = _timed_restarts(seen, device)
    restarts.fit_restarts = timed
    try:
        with record_kernel_shapes() as rec:
            res = run_cli(sub, ["fit", "--model", "cosmos", "-n", str(nbatch), "-f",
                                str(fbatch), "-R", str(R), "--restart-iter", str(restart_iter),
                                "-it", str(num_iter), "--no-input"], device)
    finally:
        restarts.fit_restarts = original
    res.update(seen, counts=rec.counts, workdir=sub)
    res["restarts_json"] = json.loads((sub / ".tapqir" / "cosmos_restarts.json").read_text())
    res["iter_checkpoint"] = _checkpoint_iter(sub)
    res["stats"] = run_cli(sub, ["stats", "--no-input"], device)
    return res


def check_cli_restarts(res, R, restart_iter, num_iter, device="cuda"):
    """Raise unless phase 18's fit exited 0 on ``device``, wrote
    ``cosmos_restarts.json`` with R finite final losses and the best chain
    the argmin of the trailing mean -ELBO over max(1, min(50, T // 10))
    steps, reached iteration restart_iter + num_iter (model and
    checkpoint), launched exactly restart_iter summed-statistics kernels at
    (M, R·n·f) - one per restart step for all chains - then num_iter at (M,
    n·f) and nothing else, and its stats command exited 0 with normalised
    z_probs. Returns the numbers checked."""
    m = res["model"]
    if res["code"] != 0 or m is None:
        raise RuntimeError(f"CLI restarts fit exited with {res['code']}")
    if m.device.type != torch.device(device).type:
        raise RuntimeError(f"CLI restarts fit ran on {m.device}, not on {device}")
    meta, losses = res["restarts_json"], res["losses"]
    if (meta["num_restarts"], meta["restart_iter"]) != (R, restart_iter):
        raise RuntimeError(f"cosmos_restarts.json: {meta}")
    final = np.asarray(meta["final_losses"])
    if final.shape != (R,) or not np.isfinite(final).all():
        raise RuntimeError(f"cosmos_restarts.json final losses {final}")
    tail = max(1, min(50, restart_iter // 10))
    best = int(np.argmin(losses[:, -tail:].mean(1)))
    if losses.shape != (R, restart_iter) or meta["best_chain"] != best or res["best"] != best:
        raise RuntimeError(f"best chain {meta['best_chain']} / {res['best']}, trailing "
                           f"mean argmin {best}")
    if not np.array_equal(final, losses[:, -1]):
        raise RuntimeError("cosmos_restarts.json final losses differ from the run's")
    total = restart_iter + num_iter
    if res["iter_after_restarts"] != restart_iter or m.iter != total \
            or res["iter_checkpoint"] != total:
        raise RuntimeError(f"CLI restarts fit: iteration {res['iter_after_restarts']}, "
                           f"{m.iter}, checkpoint {res['iter_checkpoint']}")
    M, nb = 1 << m.K, m.nbatch_size * m.fbatch_size * m.data.C
    want = dict.fromkeys(res["launches"], 0)
    if m.device.type == "cuda":
        want["summed_stats"] = restart_iter + num_iter
        shapes = {("summed_stats", M, R * nb): restart_iter, ("summed_stats", M, nb): num_iter}
        if res["counts"] != shapes or list(res["counts"]) != list(shapes):
            raise RuntimeError(f"CLI restarts fit: launches per shape {res['counts']}, "
                               f"expected {shapes} in that order")
    if res["launches"] != want:
        raise RuntimeError(f"CLI restarts fit: launches {res['launches']}, expected {want}")
    stats = res["stats"]
    if stats["code"] != 0:
        raise RuntimeError(f"CLI restarts stats exited with {stats['code']}")
    z = stats["model"].params_stats["z_probs"]
    N = m.data.N
    z_err = float(np.abs(z[:N].sum(-1) - 1.0).max())
    if z_err > 1e-5:
        raise RuntimeError(f"restarts stats: z_probs sum error {z_err}")
    return {"best_chain": best, "final_losses": final.tolist(),
            "trailing_means": losses[:, -tail:].mean(1).tolist(), "z_sum_max_abs_err": z_err}


def run_api_restarts(workdir, name, R, num_iter=API_RESTART_ITER, nbatch=10, fbatch=512,
                     device="cuda", use_factored=False):
    """Phase 19: ``fit_restarts`` through the Python API on a fresh model of
    ``name`` loaded from ``workdir`` (it resumes the workspace's
    checkpoint: hmm phase 12's warm-started fit), ``num_iter`` steps of R
    chains, the launch counts set to 0 just before and read just after.
    Returns the seconds, steps/s, launches and their shapes, the losses and
    the peak device memory, and the model."""
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.parallel.restarts import fit_restarts

    model = models[name](device=device)
    model.use_factored = use_factored
    model.load(workdir)
    model.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    iter0 = model.iter
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with record_kernel_shapes() as rec:
        _reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        losses, best = fit_restarts(model, num_restarts=R, num_iter=num_iter, chunk=num_iter,
                                    perturb=0.01)
        _sync(device)
        seconds = time.perf_counter() - t0
        launches = _read_launches()
    return {"seconds": seconds, "steps_per_s": num_iter / seconds, "launches": launches,
            "counts": rec.counts, "losses": losses, "best": best, "iter_before": iter0,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}, model


def check_api_restarts(res, model, R, num_iter):
    """Raise unless the API run took ``num_iter`` steps with exactly one
    launch each of the model's kernel for all R chains (the factored one at
    (Kf, 2^Kf, R·n·f·C) with ``use_factored``, else the summed statistics
    at (M, R·n·f·C); hmm takes every frame) and finite losses, and handed
    the winner to the model."""
    f = model.data.F if model.name == "cosmos+hmm" else model.fbatch_size
    nb = R * model.nbatch_size * f * model.data.C
    Kf = model.K * (model.Q if model.name == "crosstalk" else 1)
    want = dict.fromkeys(res["launches"], 0)
    if getattr(model, "use_factored", False):
        key, want["factored_stats"] = ("factored_stats", Kf, 1 << Kf, nb), num_iter
    else:
        key, want["summed_stats"] = ("summed_stats", 1 << Kf, nb), num_iter
    if model.device.type == "cuda" and (res["launches"] != want
                                        or res["counts"] != {key: num_iter}):
        raise RuntimeError(f"{model.name} restarts: launches {res['launches']} at "
                           f"{res['counts']}, expected {want} at {key}")
    if res["losses"].shape != (R, num_iter) or not np.isfinite(res["losses"]).all():
        raise RuntimeError(f"{model.name} restarts: losses {res['losses']}")
    if model.iter != res["iter_before"] + num_iter:
        raise RuntimeError(f"{model.name} restarts: iteration {res['iter_before']} -> "
                           f"{model.iter}")


def check_restart_card_vs_cpu(model, R, n_aoi=4, n_frames=64, nbatch=2, fbatch=32):
    """Phase 19, one restart step of R chains (``Model._restart_step``) on
    the model's device in its dtype against float64 on the CPU, with the
    same batches (each chain its own rows among AOIs 0..n_aoi-1 and frames
    among 0..n_frames-1; hmm takes all n_frames) and the same draws
    (recorded through the packed draw): the per-chain losses within
    RESTART_RTOL relative. Both sides step the model's parameters over
    those AOIs and frames, stacked R times and jittered, on that block of
    the data (the CPU's float64 plain version holds (configs, images, 256
    lanes, 61 bins) intermediates). Returns the losses and the largest
    relative difference."""
    from tapqir_tpu_torch.distributions import core
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.models.cosmos import _chain_perms
    from tapqir_tpu_torch.parallel.restarts import stack_params

    dev = model.device
    hmm = model.name == "cosmos+hmm"
    block = (torch.arange(n_aoi, device=dev).expand(R, -1),
             torch.arange(n_frames, device=dev).expand(R, -1))
    params = {k: v.contiguous() for k, v in model.gather_chain_windows(
        stack_params(model.params, R, perturb=0.05), *block).items()}
    per_aoi = ("is_ontarget", "mask")
    data = {k: (v[:n_aoi, :n_frames] if k in ("images", "xy") else
                v[:n_aoi] if k in per_aoi else v) for k, v in model._data_dev.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    ndx = _chain_perms(R, n_aoi, gen, dev)[:, :nbatch]
    if hmm:
        fidx, f = None, n_frames
    else:
        fidx, f = torch.sort(_chain_perms(R, n_frames, gen, dev)[:, :fbatch], -1)[0], fbatch

    sampler, recorded = core.std_gamma_sample, []

    def recording(conc, generator=None, draws=None):
        out = sampler(conc, generator, draws)
        recorded.append(out.detach())
        return out

    def zeros(tree):
        return {k: torch.zeros_like(v) for k, v in tree.items()}

    p64 = {k: v.cpu().double() for k, v in params.items()}  # the step updates params
    full, model._data_dev = model._data_dev, data
    core.std_gamma_sample = recording
    try:
        card = model._restart_step(params, zeros(params), zeros(params), 1, model.lr, gen,
                                   batch=(ndx, fidx, f)).cpu().double()
    finally:
        core.std_gamma_sample = sampler
        model._data_dev = full
    cpu = models[model.name](S=model.S, K=model.K, device="cpu", dtype="double",
                             priors=model.priors)
    cpu.data, cpu._transforms = model.data, model._transforms
    cpu.nbatch_size, cpu.fbatch_size = model.nbatch_size, model.fbatch_size
    cpu._build_constants()
    cpu._data_dev = {k: v.cpu() if k == "is_ontarget" else v.cpu().double()
                     for k, v in data.items()}
    want = cpu._restart_step(p64, zeros(p64), zeros(p64), 1, model.lr, None,
                             batch=(ndx.cpu(), None if fidx is None else fidx.cpu(), f),
                             draws=recorded[0].cpu().double())
    rel = ((card - want).abs() / want.abs()).max().item()
    if not rel <= RESTART_RTOL:
        raise RuntimeError(f"{model.name} restart step: card vs CPU losses {card.tolist()} "
                           f"vs {want.tolist()}, {rel} relative > {RESTART_RTOL}")
    return {"losses_card": card.tolist(), "losses_cpu_f64": want.tolist(),
            "max_rel_err": rel, "images": R * nbatch * f * model.data.C}


# ---------------------------------------------------------------------------
# phases 20-21: raw-data ingest and the rest of the command line
# ---------------------------------------------------------------------------

# phase 20's raw Glimpse movie at the eLife cell's width: a 512 x 512 field
# of view, Nt = 856 AOIs (half on target) on a grid spaced 16 px, P = 14,
# the default 30 x 30 offset region at (10, 10); depth cut to 256 of the
# cell's 790 frames, as the int64 data.tpqr is written compressed (the
# 530 MB simulated stack of 790 frames takes 76-88 s to save)
GLIMPSE_FOV, GLIMPSE_F, GLIMPSE_NT, GLIMPSE_SPACING = 512, 256, 856, 16
GLIMPSE_OFFSET = (10, 10, 30)  # offset-x, offset-y, offset-P (the defaults)
# phase 21: the fit on the ingested workspace, its profile and the subset
INGEST_NBATCH, INGEST_ITER, INGEST_PROFILE, INGEST_SUBSET = 10, 20, 5, 20
SPOT_HEIGHT, SPOT_WIDTH = 400.0, 1.4  # the bright spots on target (counts, px)


def write_glimpse_folder(root, H=GLIMPSE_FOV, W=GLIMPSE_FOV, F=GLIMPSE_F, Nt=GLIMPSE_NT,
                         P=14, offset=GLIMPSE_OFFSET, spacing=GLIMPSE_SPACING, n_files=2,
                         seed=0):
    """Phase 20's raw Glimpse folder under ``root``, drawn with numpy from
    ``seed``: F frames of H x W as ``n_files`` ``<k>.glimpse`` files of
    big-endian int16 minus 2^15, a ``header.mat`` with per-frame file
    numbers, byte offsets and time stamps, a driftlist of per-frame (dy,
    dx) increments whose cumulative drift stays within 2 px, and Nt // 2
    on-target and Nt - Nt // 2 off-target AOIs at fractional 1-based
    coordinates (``aoiinfo2`` .mat files, picked on the middle frame) on a
    grid spaced ``spacing`` px, away from the edges and the offset region.
    Every pixel holds a camera offset of 85-95 counts, every pixel outside
    the offset region background photons, and the on-target AOIs a
    Gaussian spot in about 40% of the frames, at the drifted target.

    Returns the frames as ingest must read them ((F, H, W) unsigned), the
    true target of every AOI in every frame ((Nt, F, 2), x and y, 0-based),
    each file's frames and byte offsets, and the command's arguments."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    root = Path(root)
    gdir = root / "glimpse"
    gdir.mkdir(parents=True)
    ox, oy, oP = offset
    margin = P // 2 + 3  # half a crop, the drift and the fraction
    points = np.array([(x, y) for y in np.arange(spacing, H - margin, spacing)
                       for x in np.arange(spacing, W - margin, spacing)
                       if not (x - margin < ox + oP and y - margin < oy + oP
                               and x + margin > ox and y + margin > oy)], float)
    if len(points) < Nt:
        raise ValueError(f"{H} x {W} holds {len(points)} AOIs spaced {spacing} px, not {Nt}")
    xy0 = points[rng.permutation(len(points))[:Nt]] + rng.uniform(-0.4, 0.4, (Nt, 2))
    n_on = Nt // 2

    # the driftlist: increments (dy, dx) per frame, 0 at the anchor (the
    # AOIs' frame); the drift of frame f is the walk from the anchor to f
    anchor = F // 2
    step = min(0.015, 1.9 / max(1, F - anchor))
    deltas = rng.uniform(-step, step, (F, 2))
    deltas[anchor] = 0.0
    walk = np.zeros((F, 2))  # (dy, dx)
    for f in range(anchor + 1, F):
        walk[f] = walk[f - 1] + deltas[f]
    for f in range(anchor - 1, -1, -1):
        walk[f] = walk[f + 1] - deltas[f + 1]
    truth = xy0[:, None, :] + walk[None, :, ::-1]  # (Nt, F, 2) x, y

    r = np.arange(-7, 8)
    present = rng.random((n_on, F)) < 0.4
    frames = np.empty((F, H, W), np.uint16)
    for f in range(F):
        img = rng.integers(85, 96, (H, W))
        photons = rng.poisson(15, (H, W))
        photons[oy:oy + oP, ox:ox + oP] = 0
        img += photons
        c = truth[:n_on, f][present[:, f]]  # (n, 2) spot centres x, y
        base = np.round(c).astype(int)
        rows = base[:, 1, None, None] + r[None, :, None]
        cols = base[:, 0, None, None] + r[None, None, :]
        d2 = (cols - c[:, 0, None, None]) ** 2 + (rows - c[:, 1, None, None]) ** 2
        img[rows, cols] += (SPOT_HEIGHT * np.exp(-0.5 * d2 / SPOT_WIDTH**2)).astype(int)
        frames[f] = img

    per_file = -(-F // n_files)
    files, filenumber, offsets = [], [], []
    for k in range(n_files):
        path, idx = gdir / f"{k}.glimpse", np.arange(k * per_file, min(F, (k + 1) * per_file))
        file_offsets = []
        with open(path, "wb") as fh:
            for f in idx:
                file_offsets.append(fh.tell())
                (frames[f].astype(np.int32) - 2**15).astype(">i2").tofile(fh)
        files.append((path, idx, np.asarray(file_offsets, np.int64)))
        filenumber += [k] * len(idx)
        offsets += file_offsets
    ttb = np.arange(F) * 100.0 + 17.0
    savemat(gdir / "header.mat", {"vid": {
        "height": H, "width": W, "nframes": F, "filenumber": np.asarray(filenumber),
        "offset": np.asarray(offsets), "ttb": ttb, "time1": 12345.5}})
    drift = np.column_stack([np.arange(1, F + 1), deltas])  # (frame, dy, dx)
    savemat(root / "driftlist.mat", {"driftlist": drift})
    for name, sel in (("aoi_on.mat", slice(0, n_on)), ("aoi_off.mat", slice(n_on, Nt))):
        xy = xy0[sel]
        rows = np.column_stack([np.full(len(xy), anchor + 1.0), np.ones(len(xy)),
                                xy[:, 1] + 1, xy[:, 0] + 1, np.full(len(xy), 7.0),
                                np.arange(1, len(xy) + 1)])
        savemat(root / name, {"aoiinfo2": rows})
    argv = ["glimpse", "--dataset", "chip-smoke-glimpse", "-P", str(P),
            "--offset-x", str(ox), "--offset-y", str(oy), "--offset-p", str(oP),
            "--name", "green", "--glimpse-folder", str(gdir),
            "--driftlist", str(root / "driftlist.mat"),
            "--ontarget-aoiinfo", str(root / "aoi_on.mat"),
            "--offtarget-aoiinfo", str(root / "aoi_off.mat"), "--no-input"]
    return {"frames": frames, "truth": truth, "files": files, "ttb": ttb, "argv": argv,
            "shape": (H, W), "P": P, "n_on": n_on}


def _host_rss_kib():
    """This process's resident set in KiB (VmRSS of /proc/self/status)."""
    for ln in Path("/proc/self/status").read_text().splitlines():
        if ln.startswith("VmRSS:"):
            return int(ln.split()[1])
    raise RuntimeError("/proc/self/status has no VmRSS")


class host_peak_rss:
    """The largest resident set of this process while the block runs,
    sampled every 20 ms by a thread (``before`` and ``peak``, KiB): not
    every kernel keeps a peak that a process may reset."""

    def __enter__(self):
        self.before = self.peak = _host_rss_kib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, _host_rss_kib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _host_rss_kib())


def run_ingest(workdir, raw):
    """Phase 20: ``glimpse ... --no-input`` in process on the raw folder
    of :func:`write_glimpse_folder` (its result ``raw``), with the wall
    seconds of each ingest stage and the host's resident memory before and
    its peak during the command; then the checks of :func:`check_ingest`, and the
    native decoder against the numpy decoder on every frame of every
    file, bitwise, each timed. Returns the numbers."""
    import tapqir_tpu_torch.imscroll as imscroll
    from tapqir_tpu_torch.csrc import glimpse_native
    from tapqir_tpu_torch.utils.dataset import load

    stages, read = {}, imscroll.read_glimpse
    imscroll.read_glimpse = lambda *a, **k: read(*a, stage_seconds=stages, **k)
    try:
        with host_peak_rss() as rss:
            res = run_cli(workdir, raw["argv"], device="cpu")
    finally:
        imscroll.read_glimpse = read
    res["host_rss_before_gib"] = rss.before / 2**20
    res["host_peak_gib"] = rss.peak / 2**20
    res["stage_seconds"] = stages
    if res["code"] != 0:
        raise RuntimeError(f"glimpse exited with {res['code']}")
    res["checks"] = check_ingest(load(workdir), raw)

    H, W = raw["shape"]
    decode = {"native_seconds": 0.0, "numpy_seconds": 0.0, "frames": 0}
    for path, idx, offsets in raw["files"]:
        t0 = time.perf_counter()
        native = glimpse_native.read_frames(path, offsets, H, W)
        t1 = time.perf_counter()
        plain = glimpse_native.read_frames_plain(path, offsets, H, W)
        decode["native_seconds"] += t1 - t0
        decode["numpy_seconds"] += time.perf_counter() - t1
        if not (np.array_equal(native, plain) and np.array_equal(native, raw["frames"][idx])):
            raise RuntimeError(f"{path}: the native decoder differs from the numpy decoder "
                               "or from the frames written")
        decode["frames"] += len(idx)
    res["decoders"] = decode
    return res


def check_ingest(data, raw):
    """Raise unless the ingested dataset holds every AOI's crop of every
    frame bit for bit as cut in numpy from the frames written, at the
    written target less an integer corner, with every target inside the
    central pixel, the offset weights summing to 1 and the time stamps
    carried over. Returns the numbers checked."""
    P, truth, frames = raw["P"], raw["truth"], raw["frames"]
    Nt, F = truth.shape[:2]
    if data.images.shape != (Nt, F, 1, P, P) or data.N != raw["n_on"]:
        raise RuntimeError(f"ingested images {data.images.shape}, N={data.N}")
    if data.images.dtype != np.int64 or data.xy.dtype != np.float64:
        raise RuntimeError(f"ingested dtypes {data.images.dtype} / {data.xy.dtype}")
    xy = data.xy[:, :, 0]
    if not ((xy > 0.5 * P - 1).all() and (xy < 0.5 * P).all()):
        raise RuntimeError("an ingested target lies outside the central pixel")
    corner = truth - xy  # integer pixels: where each crop starts (x, y)
    off_grid = float(np.abs(corner - np.round(corner)).max())
    if off_grid > 1e-9:
        raise RuntimeError(f"targets {off_grid} px from the written ones less a corner")
    corner = np.round(corner).astype(int)
    r = np.arange(P)
    for f in range(F):
        rows = corner[:, f, 1, None, None] + r[None, :, None]
        cols = corner[:, f, 0, None, None] + r[None, None, :]
        if not np.array_equal(data.images[:, f, 0], frames[f][rows, cols]):
            raise RuntimeError(f"frame {f + 1}: ingested crops differ from the frame written")
    w_err = abs(float(data.offset.weights.sum()) - 1.0)
    if w_err > 1e-12:
        raise RuntimeError(f"offset weights sum to 1 within {w_err}")
    if not np.array_equal(data.ttb[:, 0], raw["ttb"]) or float(data.time1[0]) != 12345.5:
        raise RuntimeError("time stamps (ttb, time1) not carried over")
    return {"crops_bitwise_equal": True, "target_off_grid_px": off_grid,
            "offset_bins": len(data.offset.samples), "offset_weight_sum_err": w_err,
            "offset_mean": data.offset.mean, "images": list(data.images.shape)}


def _trace_kernels(path, name):
    """Device events of kernels whose name holds ``name`` in a Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))


def run_ingested_cli(workdir, nbatch=INGEST_NBATCH, num_iter=INGEST_ITER,
                     n_profile=INGEST_PROFILE, n_subset=INGEST_SUBSET, device="cuda"):
    """Phase 21, the command line on phase 20's ingested workspace, in
    process: ``fit --model cosmos -n nbatch -f F -it num_iter`` (timed
    steps, the kernels' shapes), ``fit --profile n_profile`` (the trace's
    device events of the summed kernel; the checkpoint's bytes and the
    parameters before and after), ``stats``, ``subset`` of ``n_subset``
    AOIs spread over both kinds, and ``log`` with the pager captured.
    Returns each command's :func:`run_cli` result with what it adds."""
    import pydoc

    from tapqir_tpu_torch.utils.dataset import load

    workdir = Path(workdir)
    F = load(workdir).F
    fit_argv = ["fit", "--model", "cosmos", "-n", str(nbatch), "-f", str(F), "--no-input"]
    seen = {}

    def setup(model):
        run = model.run

        def timed_run(num_iter, progress_bar=None):
            del model.run  # the command's run only
            seen["iter_before"] = model.iter
            _sync(device)
            t0 = time.perf_counter()
            run(num_iter, progress_bar)
            _sync(device)
            seen["run_seconds"] = time.perf_counter() - t0

        model.run = timed_run

    with record_kernel_shapes() as rec:
        fit = run_cli(workdir, fit_argv + ["-it", str(num_iter)], device, setup)
    fit.update(seen, shapes=rec.shapes)
    with np.load(workdir / "cosmos_params.tpqr") as z:
        fit["z_probs"] = z["z_probs"]

    ckpt = workdir / ".tapqir" / "cosmos_model.tpqr"
    before = ckpt.read_bytes()
    with record_kernel_shapes() as rec:
        prof = run_cli(workdir, fit_argv + ["--profile", str(n_profile)], device)
    prof["shapes"] = rec.shapes
    prof["checkpoint_unchanged"] = ckpt.read_bytes() == before
    if prof["model"] is not None:
        with np.load(ckpt) as z:
            prof["params_unchanged"] = all(
                np.array_equal(v.cpu().numpy(), z[f"p::{k}"])
                for k, v in prof["model"].params.items())
    trace = workdir / ".tapqir" / "profile" / "cosmos_trace.json"
    prof["trace_bytes"] = trace.stat().st_size if trace.exists() else 0
    prof["trace_kernel_events"] = (_trace_kernels(trace, "offset_gamma_summed_kernel")
                                   if trace.exists() else None)

    stats = run_cli(workdir, ["stats", "--no-input"], device)
    with np.load(workdir / "cosmos_params.tpqr") as z:
        stats["z_probs"] = z["z_probs"]

    data = load(workdir)
    idx = np.linspace(0, data.Nt - 1, n_subset).astype(int)
    (workdir / "aoi_subset.txt").write_text(", ".join(str(i) for i in idx) + "\n")
    sub = run_cli(workdir, ["subset"], device)
    sub["idx"] = idx

    paged, pager = [], pydoc.pager
    pydoc.pager = paged.append
    try:
        log = run_cli(workdir, ["log"], device)
    finally:
        pydoc.pager = pager
    log["paged"] = paged
    return {"fit": fit, "profile": prof, "stats": stats, "subset": sub, "log": log}


def check_ingested_cli(res, num_iter=INGEST_ITER, n_profile=INGEST_PROFILE, device="cuda"):
    """Raise unless phase 21's commands exited 0 on ``device``: the fit
    took ``num_iter`` steps from a fresh start with exactly one
    summed-statistics launch each at nb = n x F (nothing else) and a finite
    -ELBO; the profile left the checkpoint's bytes and the parameters as
    they were, launched 2 x ``n_profile`` (a warm-up chunk, then the
    traced one) and its trace holds exactly ``n_profile`` device events of
    the summed kernel on the card; the stats hold the checks of phase 11
    that need no labels (z_probs bitwise equal to the fit's); ``subset``
    wrote the listed AOIs and ``log`` paged the log file. Returns the
    numbers checked."""
    from tapqir_tpu_torch.utils.dataset import load

    fit, prof, stats = res["fit"], res["profile"], res["stats"]
    m = fit["model"]
    for label, r in res.items():
        if r["code"] != 0:
            raise RuntimeError(f"phase 21 {label} exited with {r['code']}")
    if m.device.type != torch.device(device).type:
        raise RuntimeError(f"fit on the ingested data ran on {m.device}, not on {device}")
    if fit["iter_before"] != 0 or m.iter != num_iter or not math.isfinite(m.iter_loss):
        raise RuntimeError(f"ingested fit: iteration {fit['iter_before']} -> {m.iter}, "
                           f"-ELBO {m.iter_loss}")
    cuda = m.device.type == "cuda"
    nb, M = m.nbatch_size * m.fbatch_size * m.data.C, 1 << m.K
    for label, r, n in (("fit", fit, num_iter), ("profile", prof, 2 * n_profile)):
        want = dict.fromkeys(r["launches"], 0)
        if cuda:
            want["summed_stats"] = n
            if r["shapes"] != {("summed_stats", M, nb)}:
                raise RuntimeError(f"ingested {label}: launches at {r['shapes']}")
        if r["launches"] != want:
            raise RuntimeError(f"ingested {label}: kernel launches {r['launches']}, "
                               f"expected {want}")
    if not (prof["checkpoint_unchanged"] and prof["params_unchanged"]):
        raise RuntimeError("fit --profile changed the checkpoint or the parameters")
    if prof["model"].iter != num_iter or prof["trace_bytes"] == 0:
        raise RuntimeError(f"fit --profile: iteration {prof['model'].iter}, trace "
                           f"{prof['trace_bytes']} bytes")
    if cuda and prof["trace_kernel_events"] != n_profile:
        raise RuntimeError(f"the profile trace holds {prof['trace_kernel_events']} summed "
                           f"kernel events, not {n_profile}")
    if any(stats["launches"].values()):
        raise RuntimeError(f"stats launched kernels: {stats['launches']}")
    sm = stats["model"]
    _check_stats_arrays(sm, sm.params_stats)
    if not np.array_equal(stats["z_probs"], fit["z_probs"]):
        raise RuntimeError("z_probs of stats differ from those of fit (same default seed)")

    data, sub, idx = load(m.path), load(m.path / "subset"), res["subset"]["idx"]
    for k in ("images", "xy", "is_ontarget", "mask"):
        if not np.array_equal(getattr(sub, k), getattr(data, k)[idx]):
            raise RuntimeError(f"subset/data.tpqr: {k} is not the listed AOIs'")
    log_text = (m.path / ".tapqir" / "loginfo").read_text()
    if res["log"]["paged"] != [log_text] or "Extracting AOIs: Done" not in log_text:
        raise RuntimeError("log did not page the log file")
    return {
        "ingested_fit_final_elbo": m.iter_loss,
        "launch_shape": ["summed_stats", M, nb],
        "profile_trace_kernel_events": prof["trace_kernel_events"],
        "profile_checkpoint_and_params_unchanged": True,
        "p_specific_mean_on_target": float(sm.params_stats["p_specific"][:sm.data.N].mean()),
        "z_probs_bitwise_equal_to_fit": True,
        "subset": list(sub.images.shape),
        "log_chars_paged": len(log_text),
    }


def run_pixel_path(data, n_aoi=10, n_frames=512, K=2, device="cuda"):
    """The per-pixel entry points on ``n_aoi`` AOIs x ``n_frames`` frames of
    ``data``'s images, with fixed spot parameters at the simulation's values
    (height 3000, width 1.4, gain 7, background 150; K spots, the second
    one pixel off the target): ``KSMOGN(...).log_prob`` (M=1) with and
    without gradient, and the non-ev summed likelihood over the 2^K spot
    configs (``offset_gamma_log_prob_summed(event_ndims=2)``), each with
    gradients on height and background. Checks that values and gradients
    are finite, that the configs with every spot on agree with
    ``log_prob``, and that both agree with the plain version in float64 on
    the first AOI. Returns the launches of every kernel in this run and the
    numbers checked."""
    from tapqir_tpu_torch.distributions import (
        KSMOGN,
        gaussian_spots,
        ksmogn_image,
        offset_gamma_log_prob_summed,
    )
    from tapqir_tpu_torch.infer.discrete import m_configs
    from tapqir_tpu_torch.ops.offset_gamma import offset_gamma_log_prob_plain

    f32 = dict(dtype=torch.float32, device=device)
    imgs = torch.as_tensor(np.asarray(data.images[:n_aoi, :n_frames]), **f32)
    xy = torch.as_tensor(np.asarray(data.xy[:n_aoi, :n_frames]), **f32)
    n, f, C, P = imgs.shape[:3] + imgs.shape[-1:]
    height = torch.full((n, f, C, K), 3000.0, **f32).requires_grad_(True)
    width = torch.full((n, f, C, K), 1.4, **f32)
    x = torch.zeros((n, f, C, K), **f32)
    x[..., 1:] = 1.0
    y = torch.zeros_like(x)
    background = torch.full((n, f, C), 150.0, **f32).requires_grad_(True)
    gain = torch.tensor(SIM_PARAMS["gain"], **f32)
    g = torch.as_tensor(data.offset.samples, **f32)
    w = torch.as_tensor(data.offset.logits, **f32)
    mtab = torch.as_tensor(m_configs(K), **f32)

    _reset_launches()
    d = KSMOGN(height, width, x, y, xy, background, gain, g, w, P)
    lp = d.log_prob(imgs)  # (n, f, C): per-pixel kernel, M=1
    g_h1, g_b1 = torch.autograd.grad(lp.sum(), (height, background))
    with torch.no_grad():
        lp_nograd = d.log_prob(imgs)
    spots = gaussian_spots(height, width, x, y, xy, P)  # (n, f, C, K, P, P)
    mu = background[..., None, None] + torch.einsum("mk,nfckij->mnfcij", mtab, spots)
    lp_m = offset_gamma_log_prob_summed(imgs, mu / gain, 1.0 / gain, g, w,
                                        event_ndims=2)  # (M, n, f, C)
    g_hm, g_bm = torch.autograd.grad(lp_m.sum(), (height, background))
    _sync(device)
    launches = _read_launches()

    for name, t in (("log_prob", lp), ("log_prob no grad", lp_nograd),
                    ("summed over configs", lp_m), ("d height", g_h1),
                    ("d background", g_b1), ("d height (configs)", g_hm),
                    ("d background (configs)", g_bm)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"per-pixel path: non-finite {name}")
    lp, lp_m = lp.detach(), lp_m.detach()
    # the two kernel variants round alike up to instruction scheduling
    np.testing.assert_allclose(lp.cpu().numpy(), lp_nograd.cpu().numpy(), rtol=1e-6,
                               err_msg="log_prob with vs without gradient")
    full = int(mtab.sum(1).argmax())  # the config with every spot on
    err_configs = float((lp_m[full] - lp).abs().max())
    np.testing.assert_allclose(lp_m[full].cpu().numpy(), lp.cpu().numpy(), rtol=1e-5,
                               err_msg="all-spots config vs log_prob")
    # the plain version in float64 on the first AOI
    with torch.no_grad():
        mu64 = ksmogn_image(*(t[:1].double() for t in (height, width, x, y, xy,
                                                         background)), P)
        gain64 = gain.double()
        want = offset_gamma_log_prob_plain(
            imgs[:1].double(), mu64 / gain64, 1.0 / gain64, g.double(), w.double(),
        ).sum((-2, -1))
    err_plain = float((lp[:1].double() - want).abs().max())
    np.testing.assert_allclose(lp[:1].double().cpu().numpy(),
                               want.cpu().numpy(), **FWD_TOL,
                               err_msg="log_prob vs float64 plain")
    return {
        "shape": [n, f, C, P, P],
        "launches": launches,
        "log_prob_mean": float(lp.mean()),
        "max_abs_err_configs_vs_log_prob": err_configs,
        "max_abs_err_vs_plain_f64": err_plain,
    }


# ---------------------------------------------------------------------------
# phases 22-24: the mesh, one process per shard, on one card
# ---------------------------------------------------------------------------

# steps of each mesh run (cut from the single-device phases' 200 for time:
# each launch pays its ranks' start-up once), and the untimed steps before
# a process's first timed run of a route (its kernels' first launches and
# the groups' first collectives)
MESH_ITER, MESH_RESTARTS_R, MESH_MORE_ITER, MESH_WARMUP = 20, 2, 5, 5
# the sharded step in float32 on the card against the same step in float64
# on the CPU: the loss and the whole gathered gradient (the norm of the
# difference over the norm) relative; and each parameter's gradient apart
# within MESH_PARAM_RTOL, loose enough for float32 sums that cancel (the
# global proximity_loc's: ~1e-3) and far below the factor of a gradient
# summed over a wrong group of ranks
MESH_STEP_RTOL, MESH_PARAM_RTOL = 1e-4, 1e-2
# particles of the sharded posterior check, and the sharded scan's float32
# log prefix products against the global scan's (absolute, log units)
MESH_PARTICLES, MESH_SCAN_TOL = 4, 1e-4


def _per_rank(mesh, values):
    """{name: [the value of rank 0, 1, ...]} from every rank's float
    ``values`` (collective)."""
    from tapqir_tpu_torch.parallel import sharding

    names = sorted(values)
    t = torch.tensor([float(values[k]) for k in names], dtype=torch.float64,
                     device=mesh.device)
    g = sharding.all_gather(t, mesh.world).cpu().numpy()
    return {k: g[:, i].tolist() for i, k in enumerate(names)}


class time_collectives:
    """Within the block, ``seconds`` and ``calls``: the host time every
    ``all_reduce`` of the mesh takes from a synchronised start (so the wait
    for the other ranks counts, the kernels before it do not), while
    ``active``."""

    def __enter__(self):
        from tapqir_tpu_torch.parallel import sharding

        self.seconds, self.calls, self.longest, self.active = 0.0, 0, 0.0, True
        self._orig = orig = sharding.all_reduce

        def timed(t, axis):
            if axis.size == 1 or not self.active:
                return orig(t, axis)
            _sync(t.device)
            t0 = time.perf_counter()
            orig(t, axis)
            dt = time.perf_counter() - t0
            self.seconds += dt
            self.calls += 1
            self.longest = max(self.longest, dt)
            return t

        sharding.all_reduce = timed
        return self

    def __exit__(self, *exc):
        from tapqir_tpu_torch.parallel import sharding

        sharding.all_reduce = self._orig


class checkpoints_apart:
    """Within the block, ``model``'s checkpoints run with the collectives'
    timer ``tc`` off; ``seconds``: their time."""

    def __init__(self, model, tc):
        self.model, self.tc, self.seconds = model, tc, 0.0

    def __enter__(self):
        save, dev = self.model.save_checkpoint, self.model.device

        def timed_save(*args, **kwargs):
            self.tc.active = False
            _sync(dev)
            t0 = time.perf_counter()
            try:
                return save(*args, **kwargs)
            finally:
                _sync(dev)
                self.seconds += time.perf_counter() - t0
                self.tc.active = True

        self.model.save_checkpoint = timed_save
        return self

    def __exit__(self, *exc):
        del self.model.save_checkpoint


def _mesh_run(model, num_iter):
    """``model.run(num_iter)`` on its mesh with the launch counts set to 0
    just before and read just after: the run's seconds and those of its
    checkpoints apart, launches per (kernel, shape), the steps'
    collectives' seconds and calls, the last loss and the iteration."""
    dev = model.device
    _reset_launches()
    with record_kernel_shapes() as rec, time_collectives() as tc, \
            checkpoints_apart(model, tc) as ckpt:
        _sync(dev)
        t0 = time.perf_counter()
        model.run(num_iter)
        _sync(dev)
        seconds = time.perf_counter() - t0
    return {"seconds": seconds, "checkpoint_seconds": ckpt.seconds,
            "step_seconds": seconds - ckpt.seconds, "launches": _read_launches(),
            "counts": rec.counts, "allreduce_seconds": tc.seconds,
            "allreduce_calls": tc.calls, "loss": model.iter_loss, "iter": model.iter}


def _barrier(mesh):
    """Every rank of the mesh waits here for the others (an all_reduce on
    the world, and one on each mesh axis, whose groups then exist before a
    timed run), so that no timed run counts another rank's untimed work."""
    from tapqir_tpu_torch.parallel import sharding

    for axis in (mesh.world, mesh.row, mesh.col):
        sharding.all_reduce(torch.zeros(1, device=mesh.device), axis)
    _sync(mesh.device)


def _launches_over_ranks(mesh, *runs):
    """The launches of every kernel in ``runs`` (of :func:`_mesh_run`),
    summed over the ranks (collective)."""
    total = {}
    for run in runs:
        for k, v in _per_rank(mesh, run["launches"]).items():
            total[k] = total.get(k, 0) + int(sum(v))
    return total


def _replicas_equal(model, mesh):
    """Whether every replicated parameter and Adam moment is bitwise equal
    on every rank of the group it is replicated on (collective)."""
    from tapqir_tpu_torch.parallel import sharding

    specs = model.param_partition()
    opt = model.opt_state
    equal = True
    for where in ("world", "row", "col"):
        axis = getattr(mesh, where)
        ts = [t for tree in (model.params, opt["mu"], opt["nu"]) for k, t in tree.items()
              if sharding._replicated_on(specs[k]) == where]
        if axis.size == 1 or not ts:
            continue
        slots = sharding.all_gather(torch.cat([t.reshape(-1) for t in ts]), axis)
        equal &= all(torch.equal(slots[i], slots[0]) for i in range(axis.size))
    return equal


def mesh_step_card_vs_cpu(model, mesh, n_aoi=4, n_frames=64, nbatch=2, fbatch=32):
    """One sharded step with a fixed batch per rank (rows from a generator
    its mesh row shares, frames from its own) on the block of the rank's
    first n_aoi AOIs x n_frames frames: the mesh's loss and this rank's
    reduced gradients (``Model._mesh_loss_and_grads``) on the card in the
    model's dtype against the same step in float64 on the CPU with the same
    draws (recorded on the card), both sides reducing over the same process
    group. Returns (on every rank) the loss's relative difference, the
    whole gradient's over all ranks (norm of the difference over the norm),
    the largest of each parameter's, and the losses."""
    from tapqir_tpu_torch.distributions import core
    from tapqir_tpu_torch.models import models

    dev = model.device
    n_l, f_l = model._data_dev["xy"].shape[:2]
    n_aoi, n_frames = min(n_aoi, n_l), min(n_frames, f_l)
    nbatch, fbatch = min(nbatch, n_aoi), min(fbatch, n_frames)
    block = (torch.arange(n_aoi, device=dev), torch.arange(n_frames, device=dev))
    per_aoi = ("is_ontarget", "mask")
    data = {k: (v[:n_aoi, :n_frames] if k in ("images", "xy") else
                v[:n_aoi] if k in per_aoi else v) for k, v in model._data_dev.items()}
    rows = torch.Generator(device=dev)
    rows.manual_seed(100 + mesh.aoi_index)
    gen = torch.Generator(device=dev)
    gen.manual_seed(200 + mesh.rank)
    ndx = torch.randperm(n_aoi, generator=rows, device=dev)[:nbatch]
    fidx = torch.sort(torch.randperm(n_frames, generator=gen, device=dev)[:fbatch])[0]

    def twin(device, dtype, params, data):
        m = models[model.name](S=model.S, K=model.K, device=device, dtype=dtype,
                               priors=model.priors)
        m.data, m._transforms, m._mesh = model.data, model._transforms, mesh
        m.use_factored = getattr(model, "use_factored", False)
        m._build_constants()
        m.params, m._data_dev = params, data
        return m

    card = twin(dev, model.dtype, {k: v.contiguous() for k, v in
                                   model.gather_windows(model.params, *block).items()}, data)
    sampler, recorded = core.std_gamma_sample, []

    def recording(conc, generator=None, draws=None):
        out = sampler(conc, generator, draws)
        recorded.append(out.detach())
        return out

    core.std_gamma_sample = recording
    try:
        loss_card, g_card = card._mesh_loss_and_grads(gen, batch=(ndx, fidx, fbatch))
    finally:
        core.std_gamma_sample = sampler
    cpu = twin("cpu", "double", {k: v.detach().cpu().double() for k, v in card.params.items()},
               {k: v.cpu() if k == "is_ontarget" else v.cpu().double() for k, v in data.items()})
    loss_cpu, g_cpu = cpu._mesh_loss_and_grads(
        None, batch=(ndx.cpu(), fidx.cpu(), fbatch), draws=recorded[0].cpu().double())
    loss_err = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    diff = {k: g_card[k].cpu().double() - g for k, g in g_cpu.items()}
    sq = {"d": sum(float(d.square().sum()) for d in diff.values()),
          "g": sum(float(g.square().sum()) for g in g_cpu.values())}
    worst = max(((float(diff[k].norm() / g.norm()), k) for k, g in g_cpu.items()
                 if g.norm() > 0))
    errs = _per_rank(mesh, {"loss": loss_err, "param": worst[0], **sq})
    return {"loss_rel_err": max(errs["loss"]),
            "grad_rel_err": math.sqrt(sum(errs["d"]) / sum(errs["g"])),
            "worst_param_rel_err": max(errs["param"]), "worst_param_on_rank0": worst[1],
            "loss_card": float(loss_card), "loss_cpu_f64": float(loss_cpu),
            "images_per_rank": nbatch * fbatch * model.data.C}


def _rank_kernel_checks(mesh, checks):
    """The on-path kernels against their plain versions at this rank's
    shapes: ``checks`` is a list of (label, form, kwargs) for
    :func:`compare` ("summed") or :func:`compare_factored` ("factored")."""
    out = {}
    for i, (label, form, kw) in enumerate(checks):
        seed = 60 + 10 * mesh.rank + i
        if form == "summed":
            out[label] = compare(kw["M"], kw["nb"], 256, 196, kw["J"], torch.float32, seed,
                                 FWD_TOL, GRAD_TOL)
        else:
            out[label] = compare_factored(kw["Kf"], kw["nb"], 256, 196, kw["J"],
                                          torch.float32, seed, FACT_FWD_TOL, FACT_GRAD_TOL)
    return out


def mesh_cosmos_ranks(mesh, ws, rws, nbatch=10, fbatch=512, num_iter=MESH_ITER,
                      n_particles=MESH_PARTICLES, kernels=True, R=MESH_RESTARTS_R,
                      more_iter=MESH_MORE_ITER, warmup=MESH_WARMUP):
    """Phases 22 and 24 in one rank of a 2x2 mesh (one launch: phase 24
    runs in processes that phase 22 warmed). Phase 22: cosmos from the
    workspace ``ws`` (its saved data, a fresh fit) through ``use_mesh``,
    ``warmup`` untimed steps of each route, then ``run(num_iter)`` dense
    and ``num_iter`` steps ``use_factored``; the replicas' bitwise
    equality; one sharded step on the card against float64 on the CPU
    (:func:`mesh_step_card_vs_cpu`); a checkpoint, gathered at the real Nt
    and reloaded by a single-device model on the first rank; and the
    sharded posterior marginals against single-device ``_probs_batch`` on
    every block with the same draws. ``kernels``: the summed and factored
    kernels against their plain versions at this rank's step shapes first.
    Phase 24: :func:`mesh_restarts_ranks` on the workspace ``rws``.
    Returns (on the first rank) every rank's numbers of each phase."""
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.parallel import sharding

    dev = mesh.device
    t0 = time.perf_counter()
    m = models["cosmos"](device=dev)
    m.load(ws)
    m.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    m.use_mesh(mesh)
    _sync(dev)
    setup = time.perf_counter() - t0
    n_l, f_l = m._data_dev["xy"].shape[:2]
    nb = min(nbatch, n_l) * min(fbatch, f_l) * m.data.C
    J = int(m._data_dev["offset_samples"].shape[0])
    checks = _rank_kernel_checks(mesh, [("summed_stats", "summed", dict(M=4, nb=nb, J=J)),
                                        ("factored_stats", "factored", dict(Kf=2, nb=nb, J=J))]
                                 ) if kernels else {}
    for factored in (False, True):
        m.use_factored = factored
        m.run(warmup)
    m.use_factored = False
    _barrier(mesh)
    dense = _mesh_run(m, num_iter)
    m.use_factored = True
    _barrier(mesh)
    fact = _mesh_run(m, num_iter)
    m.use_factored = False
    replicas = _replicas_equal(m, mesh)
    step = mesh_step_card_vs_cpu(m, mesh)

    _barrier(mesh)
    t0 = time.perf_counter()
    full = m.gather_tree(m.params)
    gather_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.save_checkpoint()
    _sync(dev)
    ckpt_seconds = time.perf_counter() - t0

    # the sharded posterior marginals, then (on the first rank) a
    # single-device model from the checkpoint and its blocks
    gen = torch.Generator(device=dev)
    gen.manual_seed(500 + mesh.rank)
    with torch.no_grad():
        draws = m._probs_draws(m.constrained(), torch.arange(n_l, device=dev),
                               torch.arange(f_l, device=dev), n_particles, gen)
    _barrier(mesh)
    t0 = time.perf_counter()
    z, th = m.compute_probs_arrays(num_particles=n_particles, draws=draws)
    _sync(dev)
    probs_seconds = time.perf_counter() - t0
    slots = {k: sharding.all_gather(v.contiguous(), mesh.world) for k, v in draws.items()}
    probs_err, reload = None, {}
    if mesh.is_main:
        r = models["cosmos"](device=dev)
        r.load(ws)
        r.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
        reload = {"iter": r.iter, "params_equal": all(
            np.array_equal(r.params[k].cpu().numpy(), v) for k, v in full.items()),
            "b_loc_shape": list(r.params["b_loc"].shape)}
        probs_err = 0.0
        pc = r.constrained()
        ont = r._data_dev["is_ontarget"]
        Nt, nf = m.data.Nt, mesh.shape["frame"]
        for rank in range(mesh.size):
            a, f = divmod(rank, nf)
            rows = torch.arange(a * n_l, min((a + 1) * n_l, Nt), device=dev)
            frames = torch.arange(f * f_l, (f + 1) * f_l, device=dev)
            d = {k: v[rank] for k, v in slots.items()}
            d["xs"], d["ys"] = d["xs"][:, :len(rows)], d["ys"][:, :len(rows)]
            with torch.no_grad():
                z_b, th_b = r._probs_batch(pc, rows, frames, r._data_dev, n_particles,
                                           draws=d)
            keep = ont[rows].to(z_b.dtype)
            want_z = (z_b.permute(1, 2, 3, 0) * keep[:, None, None, None]).cpu().numpy()
            want_th = (th_b * keep[None, :, None, None]).cpu().numpy()
            rs, fs = slice(int(rows[0]), int(rows[-1]) + 1), slice(f * f_l, (f + 1) * f_l)
            probs_err = max(probs_err, float(np.abs(z[rs, fs] - want_z).max()),
                            float(np.abs(th[:, rs, fs] - want_th).max()))
        del r
    del m
    restarts = mesh_restarts_ranks(mesh, rws, nbatch, fbatch, R, num_iter, more_iter)
    per_rank = _per_rank(mesh, {
        "setup_seconds": setup, "dense_seconds": dense["step_seconds"],
        "factored_seconds": fact["step_seconds"],
        "dense_checkpoint_seconds": dense["checkpoint_seconds"],
        "dense_allreduce_seconds": dense["allreduce_seconds"],
        "factored_allreduce_seconds": fact["allreduce_seconds"],
        "dense_summed_stats": dense["counts"].get(("summed_stats", 4, nb), 0),
        "dense_other_launches": sum(c for k, c in dense["counts"].items()
                                    if k != ("summed_stats", 4, nb)),
        "factored_launches": fact["counts"].get(("factored_stats", 2, 4, nb), 0),
        "factored_other_launches": sum(c for k, c in fact["counts"].items()
                                       if k != ("factored_stats", 2, 4, nb)),
        "replicas_equal": replicas, "gather_seconds": gather_seconds,
        "checkpoint_seconds": ckpt_seconds, "probs_seconds": probs_seconds,
    })
    cosmos = {"shape": dict(mesh.shape), "backend": mesh.backend,
            "devices": mesh.mesh.devices, "warmup": warmup,
            "local": [n_l, f_l], "nb": nb, "kernels": checks, "per_rank": per_rank,
            "launches": _launches_over_ranks(mesh, dense, fact),
            "losses": [dense["loss"], fact["loss"]],
            "iters": [dense["iter"], fact["iter"]], "step": step, "reload": reload,
            "probs_max_abs_err": probs_err, "z_shape": None if z is None else list(z.shape),
            "allreduce_calls_per_step": dense["allreduce_calls"] / max(num_iter, 1)}
    return {"22 mesh cosmos": cosmos, "24 mesh restarts": restarts}


def mesh_hmm_crosstalk_ranks(mesh, hws, xws, nbatch=10, fbatch=512, num_iter=MESH_ITER,
                             kernels=True, warmup=MESH_WARMUP):
    """Phase 23 in one rank of two: cosmos+hmm from the workspace ``hws``
    (a fresh, cold fit) on a 1x2 mesh, every AOI's frames split over the two
    ranks, ``warmup`` untimed steps, ``run(num_iter)``; the frame-sharded
    prefix scan of random (nbatch, F, C, 2, 2) log-transition matrices
    against the global scan; then crosstalk from ``xws`` on a 2x1 mesh,
    ``warmup`` untimed steps, ``run(num_iter)`` dense. ``kernels``: the
    summed kernel against its plain version at each model's per-rank step
    shape first."""
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.ops.scan import cumulative_logmatmulexp, sharded_cumulative_logmatmulexp
    from tapqir_tpu_torch.parallel import sharding

    dev = mesh.device
    out = {"devices": mesh.mesh.devices, "backend": mesh.backend, "warmup": warmup}
    fm = mesh.reshaped(1, 2)
    h = models["cosmos+hmm"](device=dev)
    h.load(hws)
    h.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    h.use_mesh(fm)
    n_l, f_l = h._data_dev["xy"].shape[:2]
    nb_h = min(nbatch, n_l) * f_l * h.data.C
    J = int(h._data_dev["offset_samples"].shape[0])
    out["hmm_kernels"] = _rank_kernel_checks(
        fm, [("summed_stats", "summed", dict(M=4, nb=nb_h, J=J))]) if kernels else {}
    h.run(warmup)
    _barrier(fm)
    hmm_run = _mesh_run(h, num_iter)
    hmm_replicas = _replicas_equal(h, fm)

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    F, C = h.data.F, h.data.C
    logA = torch.log_softmax(torch.randn((nbatch, F, C, 2, 2), generator=g, device=dev), -1)
    with torch.no_grad():
        local = logA[:, fm.frame_index * f_l:(fm.frame_index + 1) * f_l].contiguous()
        got = sharding.gather_blocks(sharded_cumulative_logmatmulexp(local, 1, fm.row),
                                     (None, "frame", None, None, None), fm)
        scan_err = float((got - cumulative_logmatmulexp(logA, 1)).abs().max())
    out.update(hmm_local=[n_l, f_l], hmm_nb=nb_h, hmm_loss=hmm_run["loss"],
               hmm_iter=hmm_run["iter"], scan_max_abs_err=scan_err,
               hmm_counts={str(k): v for k, v in hmm_run["counts"].items()})
    del h

    am = mesh.reshaped(2, 1)
    x = models["crosstalk"](device=dev)
    x.load(xws)
    x.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    x.use_mesh(am)
    n_l, f_l = x._data_dev["xy"].shape[:2]
    nb_x = min(nbatch, n_l) * min(fbatch, f_l) * x.data.C
    M_x = 1 << (x.K * x.Q)
    J = int(x._data_dev["offset_samples"].shape[0])
    out["crosstalk_kernels"] = _rank_kernel_checks(
        am, [("summed_stats", "summed", dict(M=M_x, nb=nb_x, J=J))]) if kernels else {}
    x.run(warmup)
    _barrier(am)
    xt_run = _mesh_run(x, num_iter)
    xt_replicas = _replicas_equal(x, am)
    out.update(crosstalk_local=[n_l, f_l], crosstalk_nb=nb_x, crosstalk_M=M_x,
               crosstalk_loss=xt_run["loss"], crosstalk_iter=xt_run["iter"],
               crosstalk_counts={str(k): v for k, v in xt_run["counts"].items()})
    out["per_rank"] = _per_rank(mesh, {
        "hmm_seconds": hmm_run["step_seconds"],
        "hmm_allreduce_seconds": hmm_run["allreduce_seconds"],
        "hmm_summed_stats": hmm_run["counts"].get(("summed_stats", 4, nb_h), 0),
        "hmm_other_launches": sum(c for k, c in hmm_run["counts"].items()
                                  if k != ("summed_stats", 4, nb_h)),
        "hmm_replicas_equal": hmm_replicas, "scan_max_abs_err": scan_err,
        "crosstalk_seconds": xt_run["step_seconds"],
        "crosstalk_allreduce_seconds": xt_run["allreduce_seconds"],
        "crosstalk_summed_stats": xt_run["counts"].get(("summed_stats", M_x, nb_x), 0),
        "crosstalk_other_launches": sum(c for k, c in xt_run["counts"].items()
                                        if k != ("summed_stats", M_x, nb_x)),
        "crosstalk_replicas_equal": xt_replicas,
    })
    out["launches"] = _launches_over_ranks(mesh, hmm_run, xt_run)
    return out


def mesh_restarts_ranks(mesh, ws, nbatch=10, fbatch=512, R=MESH_RESTARTS_R,
                        num_iter=MESH_ITER, more_iter=MESH_MORE_ITER):
    """Phase 24 in one rank of a 2x2 mesh: cosmos from the workspace ``ws``
    (a fresh fit) through the command line's restarts on the mesh
    (``main._restarts`` -> ``fit_restarts_sharded``: R chains, num_iter
    steps, ``cosmos_restarts.json`` and the winner's checkpoint), then
    ``run(more_iter)`` of the winner on the mesh."""
    from tapqir_tpu_torch import main as cli
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.parallel import sharding

    dev = mesh.device
    m = models["cosmos"](device=dev)
    m.load(ws)
    m.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    n_l = -(-m.data.Nt // mesh.shape["aoi"])
    f_l = m.data.F // mesh.shape["frame"]
    nb = min(nbatch, n_l) * min(fbatch, f_l) * m.data.C
    seen, fit = {}, sharding.fit_restarts_sharded
    _barrier(mesh)

    def timed(model, mesh_, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        losses, best = fit(model, mesh_, **kwargs)
        _sync(dev)
        seen.update(seconds=time.perf_counter() - t0, losses=losses, best=best)
        return losses, best

    sharding.fit_restarts_sharded = timed
    _reset_launches()
    try:
        with record_kernel_shapes() as rec, time_collectives() as tc, \
                checkpoints_apart(m, tc):
            cli._restarts(m, R, num_iter, mesh)
    finally:
        sharding.fit_restarts_sharded = fit
    restarts = {"launches": _read_launches()}
    iter_restarts = m.iter
    more = _mesh_run(m, more_iter)
    out = {"devices": mesh.mesh.devices, "backend": mesh.backend, "nb": nb, "R": R,
           "iter_restarts": iter_restarts, "iter_after": more["iter"],
           "losses": seen["losses"].tolist(), "best": seen["best"],
           "more_loss": more["loss"]}
    if mesh.is_main:
        out["restarts_json"] = json.loads(
            (Path(ws) / ".tapqir" / "cosmos_restarts.json").read_text())
        with np.load(Path(ws) / ".tapqir" / "cosmos_model.tpqr") as z:
            out["checkpoint_iter"] = json.loads(bytes(z["meta"]).decode())["iter"]
            out["checkpoint_b_loc"] = list(z["p::b_loc"].shape)
    out["per_rank"] = _per_rank(mesh, {
        "restart_seconds": seen["seconds"], "restart_allreduce_seconds": tc.seconds,
        "restart_allreduce_calls": tc.calls, "restart_allreduce_longest": tc.longest,
        "restart_summed_stats": rec.counts.get(("summed_stats", 4, R * nb), 0),
        "restart_other_launches": sum(c for k, c in rec.counts.items()
                                      if k != ("summed_stats", 4, R * nb)),
        "more_summed_stats": more["counts"].get(("summed_stats", 4, nb), 0),
        "more_other_launches": sum(c for k, c in more["counts"].items()
                                   if k != ("summed_stats", 4, nb)),
        "more_seconds": more["step_seconds"],
    })
    out["launches"] = _launches_over_ranks(mesh, restarts, more)
    return out


def _mesh_workspace(src, name):
    """A workspace ``src/name`` of its own on ``src``'s saved data (linked),
    with its ``.tapqir`` folder."""
    ws = Path(src) / name
    (ws / ".tapqir").mkdir(parents=True)
    (ws / "data.tpqr").symlink_to(Path(src) / "data.tpqr")
    return ws


def run_mesh_phases(tmp, xws, devices, nbatch=10, fbatch=512, num_iter=MESH_ITER,
                    R=MESH_RESTARTS_R, more_iter=MESH_MORE_ITER, kernels=True,
                    warmup=MESH_WARMUP, lap=None):
    """Phases 22-24 in two :func:`~tapqir_tpu_torch.parallel.sharding.launch`
    calls of their ranks on ``devices`` (four entries; one card repeated
    shares it over gloo): cosmos then restarts on 2x2
    (:func:`mesh_cosmos_ranks`), then cosmos+hmm on 1x2 and crosstalk on
    2x1 (:func:`mesh_hmm_crosstalk_ranks`), on the saved data of phase 7
    (``tmp``) and phase 14 (``xws``) in workspaces of their own. Returns
    each phase's result, phases 22 and 23 with their launch's wall seconds
    (the ranks' start-up included)."""
    from tapqir_tpu_torch.parallel.sharding import launch, make_mesh

    res = {}
    t0 = time.perf_counter()
    res.update(launch(make_mesh(2, 2, devices), mesh_cosmos_ranks,
                      _mesh_workspace(tmp, "mesh"), _mesh_workspace(tmp, "mesh_restarts"),
                      nbatch, fbatch, num_iter, MESH_PARTICLES, kernels, R, more_iter, warmup))
    res["22 mesh cosmos"]["seconds"] = time.perf_counter() - t0
    if lap is not None:
        lap("22+24 mesh cosmos, restarts")
    t0 = time.perf_counter()
    res["23 mesh hmm + crosstalk"] = launch(
        make_mesh(2, 1, devices[:2]), mesh_hmm_crosstalk_ranks, _mesh_workspace(tmp, "mesh_hmm"),
        _mesh_workspace(xws, "mesh"), nbatch, fbatch, num_iter, kernels, warmup)
    res["23 mesh hmm + crosstalk"]["seconds"] = time.perf_counter() - t0
    if lap is not None:
        lap("23 mesh hmm + crosstalk")
    return res


def check_mesh_phases(res, num_iter=MESH_ITER, R=MESH_RESTARTS_R, more_iter=MESH_MORE_ITER,
                      Nt=None, F=None, device="cuda"):
    """Raise unless phases 22-24 hold: on every rank exactly ``num_iter``
    launches of the step's kernel at the rank's shape and no other (dense
    and factored, hmm, crosstalk; restarts: ``num_iter`` at R x the step's
    images, then ``more_iter`` single-chain; none on the CPU, which takes
    the plain versions), the replicas bitwise equal,
    the sharded step within MESH_STEP_RTOL of float64 on the CPU, the
    checkpoint at the real (Nt, F) reloaded bitwise by a single-device
    model, the sharded posteriors within PROB_TOL of single-device blocks,
    the sharded scan within MESH_SCAN_TOL of the global one, finite losses,
    and the restarts' selection, file and iterations."""
    # launches per rank of each run: none on the CPU
    card = torch.device(device).type == "cuda"
    n_run, n_more = (num_iter, more_iter) if card else (0, 0)
    c = res["22 mesh cosmos"]
    pr = c["per_rank"]
    if any(v != n_run for v in pr["dense_summed_stats"] + pr["factored_launches"]) or \
            any(pr["dense_other_launches"] + pr["factored_other_launches"]):
        raise RuntimeError(f"phase 22: launches per rank {json.dumps(pr)} at nb={c['nb']}")
    if not all(pr["replicas_equal"]):
        raise RuntimeError(f"phase 22: replicated parameters differ across ranks {pr}")
    if not (c["step"]["loss_rel_err"] <= MESH_STEP_RTOL
            and c["step"]["grad_rel_err"] <= MESH_STEP_RTOL
            and c["step"]["worst_param_rel_err"] <= MESH_PARAM_RTOL):
        raise RuntimeError(f"phase 22: sharded step card vs CPU {c['step']}")
    rl = c["reload"]
    w = c["warmup"]
    if not (rl["params_equal"] and rl["iter"] == 2 * (w + num_iter)
            and (Nt is None or rl["b_loc_shape"][:2] == [Nt, F])):
        raise RuntimeError(f"phase 22: checkpoint reload {rl}")
    if not (c["probs_max_abs_err"] <= PROB_TOL and (Nt is None or c["z_shape"][0] == Nt)):
        raise RuntimeError(f"phase 22: sharded posteriors {c['probs_max_abs_err']} "
                           f"{c['z_shape']}")
    if not np.isfinite(c["losses"]).all() or c["iters"] != [2 * w + num_iter,
                                                          2 * (w + num_iter)]:
        raise RuntimeError(f"phase 22: losses {c['losses']} iterations {c['iters']}")
    h = res["23 mesh hmm + crosstalk"]
    pr = h["per_rank"]
    if any(v != n_run for v in pr["hmm_summed_stats"] + pr["crosstalk_summed_stats"]) or \
            any(pr["hmm_other_launches"] + pr["crosstalk_other_launches"]):
        raise RuntimeError(f"phase 23: launches per rank {json.dumps(pr)}")
    if not (all(pr["hmm_replicas_equal"]) and all(pr["crosstalk_replicas_equal"])):
        raise RuntimeError(f"phase 23: replicated parameters differ across ranks {pr}")
    if not max(pr["scan_max_abs_err"]) <= MESH_SCAN_TOL:
        raise RuntimeError(f"phase 23: sharded scan {pr['scan_max_abs_err']} > {MESH_SCAN_TOL}")
    if not (np.isfinite([h["hmm_loss"], h["crosstalk_loss"]]).all()
            and h["hmm_iter"] == h["crosstalk_iter"] == h["warmup"] + num_iter):
        raise RuntimeError(f"phase 23: losses or iterations {h}")
    r = res["24 mesh restarts"]
    pr = r["per_rank"]
    if any(v != n_run for v in pr["restart_summed_stats"]) or \
            any(v != n_more for v in pr["more_summed_stats"]) or \
            any(pr["restart_other_launches"] + pr["more_other_launches"]):
        raise RuntimeError(f"phase 24: launches per rank {json.dumps(pr)} at nb={r['nb']}")
    losses = np.asarray(r["losses"])
    tail = max(1, min(50, num_iter // 10))
    meta = r["restarts_json"]
    if not (losses.shape == (R, num_iter) and np.isfinite(losses).all()
            and r["best"] == int(np.argmin(losses[:, -tail:].mean(1))) == meta["best_chain"]
            and meta["num_restarts"] == R and meta["restart_iter"] == num_iter
            and np.allclose(meta["final_losses"], losses[:, -1])):
        raise RuntimeError(f"phase 24: restarts {r['losses']} best {r['best']} file {meta}")
    if not (r["iter_restarts"] == num_iter and r["iter_after"] == num_iter + more_iter
            and r["checkpoint_iter"] == num_iter + more_iter
            and np.isfinite(r["more_loss"])):
        raise RuntimeError(f"phase 24: iterations {r}")
    return {"phase22_launches_per_rank": num_iter, "replicas_equal": True,
            "step": c["step"], "probs_max_abs_err": c["probs_max_abs_err"],
            "scan_max_abs_err": max(h["per_rank"]["scan_max_abs_err"]),
            "restarts_best": r["best"]}


def run_mesh_cli(tmp, nbatch=10, fbatch=512, num_iter=MESH_ITER):
    """On a machine with more than one card: ``fit --mesh auto`` then
    ``stats --mesh auto`` in process on phase 7's saved data in a workspace
    of its own, one rank per card (an AOI mesh over every card, NCCL).
    Raises unless both exit 0 and write the fit's files; returns their
    seconds and the mesh the option resolves to."""
    from tapqir_tpu_torch import main as cli

    ws = _mesh_workspace(tmp, "mesh_cli")
    mesh = cli._resolve_mesh(ws, "auto")
    fit = run_cli(ws, ["fit", "--model", "cosmos", "-n", str(nbatch), "-f", str(fbatch),
                       "-it", str(num_iter), "--mesh", "auto", "--no-input"])
    stats = run_cli(ws, ["stats", "--mesh", "auto", "--no-input"])
    files = [f for f in ("cosmos_params.tpqr", "cosmos_summary.csv", ".tapqir/cosmos_model.tpqr")
             if not (ws / f).exists()]
    if fit["code"] or stats["code"] or files:
        raise RuntimeError(f"mesh command line: fit exit {fit['code']}, stats exit "
                           f"{stats['code']}, missing {files}")
    return {"mesh": repr(mesh), "fit_seconds": fit["seconds"],
            "stats_seconds": stats["seconds"]}


def print_mesh_phases(res, checks, cli_res, name, smi):
    """Phases 22-24's lines, each number beside the card and its power
    limit."""
    c, h, r = (res[k] for k in ("22 mesh cosmos", "23 mesh hmm + crosstalk",
                                "24 mesh restarts"))
    pr = c["per_rank"]
    for route in ("dense", "factored"):
        s_max = max(pr[f"{route}_seconds"])
        ar = 1e3 * max(pr[f"{route}_allreduce_seconds"]) / MESH_ITER
        print(f"[mesh-cosmos] {route}: 2x2 mesh, 4 ranks on {c['devices']} over {c['backend']} "
              f"on {name} ({smi}): {c['local'][0]} AOIs x {c['local'][1]} frames per rank, "
              f"{MESH_ITER} steps (after {c['warmup']} untimed of each route; run less its "
              f"checkpoint) in {s_max:.3f} s = "
              f"{MESH_ITER / s_max:.3f} steps/s (slowest rank); one launch per rank and step "
              f"at nb={c['nb']}; all_reduce {ar:.3f} ms per step (slowest rank, "
              f"{c['allreduce_calls_per_step']:.1f} calls per step); per rank "
              f"{json.dumps(pr[f'{route}_seconds'])} s", flush=True)
    print(f"[mesh-cosmos] run's checkpoint {max(pr['dense_checkpoint_seconds']):.3f} s; "
          f"checkpoint gather (params) {max(pr['gather_seconds']):.3f} s, "
          f"save_checkpoint (params + moments, gathered and written) "
          f"{max(pr['checkpoint_seconds']):.3f} s, sharded posteriors ({MESH_PARTICLES} "
          f"particles) {max(pr['probs_seconds']):.3f} s, ranks' set-up "
          f"{max(pr['setup_seconds']):.1f} s, launch wall (phases 22 and 24) "
          f"{c['seconds']:.1f} s on {name} "
          f"({smi}); step card vs CPU {json.dumps(c['step'])} (tolerances {MESH_STEP_RTOL}, "
          f"per parameter {MESH_PARAM_RTOL}); "
          f"reload {json.dumps(c['reload'])}; posteriors max abs err "
          f"{c['probs_max_abs_err']:.3g} (tolerance {PROB_TOL}); kernels at the rank's "
          f"shape {json.dumps(c['kernels'])}", flush=True)
    hp = h["per_rank"]
    for label, key, nb in (("cosmos+hmm 1x2", "hmm", h["hmm_nb"]),
                           (f"crosstalk 2x1 M={h['crosstalk_M']}", "crosstalk",
                            h["crosstalk_nb"])):
        s_max = max(hp[f"{key}_seconds"])
        ar = 1e3 * max(hp[f"{key}_allreduce_seconds"]) / MESH_ITER
        print(f"[mesh-{key}] {label}, 2 ranks on {h['devices']} over {h['backend']} on {name} "
              f"({smi}): {MESH_ITER} steps (after {h['warmup']} untimed) in {s_max:.3f} s = "
              f"{MESH_ITER / s_max:.3f} steps/s; "
              f"one launch per rank and step at nb={nb}; all_reduce {ar:.3f} ms per step; "
              f"kernels at the rank's shape {json.dumps(h[f'{key}_kernels'])}", flush=True)
    print(f"[mesh-hmm] sharded scan max abs err {max(hp['scan_max_abs_err']):.3g} (tolerance "
          f"{MESH_SCAN_TOL}); launch wall {h['seconds']:.1f} s", flush=True)
    rp = r["per_rank"]
    s_max = max(rp["restart_seconds"])
    print(f"[mesh-restarts] R={r['R']} chains on the 2x2 mesh on {name} ({smi}): "
          f"{MESH_ITER} restart steps in {s_max:.3f} s = {MESH_ITER / s_max:.3f} steps/s; "
          f"one launch per rank and step at nb={r['R']} x {r['nb']}; all_reduce "
          f"{1e3 * max(rp['restart_allreduce_seconds']) / MESH_ITER:.3f} ms per step; best "
          f"chain {r['best']}; then {MESH_MORE_ITER} steps in {max(rp['more_seconds']):.3f} s; "
          f"iteration {r['iter_after']}; in phase 22's launch; per rank: restart seconds "
          f"{json.dumps(rp['restart_seconds'])}, all_reduce seconds "
          f"{json.dumps(rp['restart_allreduce_seconds'])} in "
          f"{json.dumps(rp['restart_allreduce_calls'])} calls, the longest "
          f"{json.dumps(rp['restart_allreduce_longest'])} s", flush=True)
    print(f"[mesh] checks {json.dumps(checks)}", flush=True)
    if cli_res is None:
        print(f"[mesh-cli] {torch.cuda.device_count()} card: no layout of one rank per card "
              f"(NCCL) to run; fit/stats --mesh auto take the single-device path here",
              flush=True)
    else:
        print(f"[mesh-cli] fit/stats --mesh auto over {cli_res['mesh']} on {name} ({smi}): "
              f"{json.dumps(cli_res)}", flush=True)


# ---------------------------------------------------------------------------
# phase 25: the AOI viewer on phase 21's workspace
# ---------------------------------------------------------------------------

# the browser's frame window, and the AOIs phase 25 excludes (clipped to Nt)
VIEWER_WINDOW, VIEWER_EXCLUDED = 15, (1, 100, 500)


def run_viewer(workdir, H=GLIMPSE_FOV, W=GLIMPSE_FOV, window=VIEWER_WINDOW,
               excluded=VIEWER_EXCLUDED, device="cuda"):
    """Phase 25 on phase 21's ingested and fitted workspace ``workdir``
    (``gui.py``): an ``AoiViewerState`` driven to its clamps, zoomed and
    through every key binding; a few AOIs excluded, ``save_data`` and the
    mask read back from ``data.tpqr``; ``aoi_subset.txt`` written and
    ``subset`` run on it, its ``subset/data.tpqr`` holding exactly the kept
    AOIs; ``build_fov_state`` on the raw folder of phase 20 (frames of H x
    W); and ``show -n 0``, which writes the PNG where matplotlib is
    installed and otherwise exits non-zero naming it, as the JAX command
    does. The kernels' launch counts are set to 0 before and read after.
    Raises on any failed check; returns the numbers checked."""
    import importlib.util

    from tapqir_tpu_torch import gui
    from tapqir_tpu_torch.utils.dataset import load

    workdir = Path(workdir)
    _reset_launches()
    t0 = time.perf_counter()
    m = gui._load_model_with_stats(workdir, "cosmos")
    load_seconds = time.perf_counter() - t0
    if m.device.type != "cpu":
        raise RuntimeError(f"the viewer's model is on {m.device}, not on the CPU")
    s = gui.AoiViewerState(m, window=window)
    Nt, F = s.data.Nt, s.data.F

    def expect(label, got, want):
        if got != want:
            raise RuntimeError(f"viewer {label}: {got!r}, expected {want!r}")

    expect("clamps", [s.set_aoi(-5), s.set_aoi(Nt + 10), s.set_frame(-3),
                      s.set_frame(F + 100), s.f2], [0, Nt - 1, 0, F - window, F])
    s.set_frame(F - window)
    expect("zoom", [s.toggle("zoom"), s.span, s.f1, s.f2],
           [True, 4 * window, max(0, F - 4 * window), F])
    expect("zoom back", [s.toggle("zoom", False), s.span, s.f1],
           [False, window, max(0, F - 4 * window)])
    s.set_aoi(1)
    s.set_frame(0)
    was_excluded = s.is_excluded()
    keys = [("ArrowUp", "n", 2), ("ArrowDown", "n", 1), ("ArrowRight", "f1", window),
            ("ArrowLeft", "f1", 0), ("z", "zoom", True), ("z", "zoom", False),
            ("o", "show_targets", True), ("n", "show_nonspecific", False),
            ("e", "is_excluded", not was_excluded), ("e", "is_excluded", was_excluded)]
    for key, attr, want in keys:
        consumed = s.handle_key(key)
        value = getattr(s, attr)
        expect(f"key {key}", (consumed, value() if callable(value) else value), (True, want))
    expect("unbound key", s.handle_key("q"), False)

    excl = sorted({min(n, Nt - 1) for n in excluded} | set(s.excluded_aois().tolist()))
    for n in excl:
        s.toggle_exclude(excluded=True, n=n)
    kept = s.included_aois()
    expect("excluded AOIs", s.excluded_aois().tolist(), excl)
    t0 = time.perf_counter()
    s.save_data()
    save_seconds = time.perf_counter() - t0
    mask = load(workdir).mask
    if not np.array_equal(mask, s.data.mask) or mask.sum() != Nt - len(excl):
        raise RuntimeError("data.tpqr's mask after save_data is not the viewer's")
    subset_file = s.write_aoi_subset()
    expect("aoi_subset.txt", subset_file.read_text(), ", ".join(map(str, kept)) + "\n")
    counts = [_read_launches()]  # each command sets the counts to 0 and reads them
    sub = run_cli(workdir, ["subset"], device)
    _reset_launches()
    if sub["code"] != 0:
        raise RuntimeError(f"subset exited with {sub['code']}")
    data = load(workdir / "subset")
    if data.Nt != len(kept) or not np.array_equal(data.images, s.data.images[kept]):
        raise RuntimeError(f"subset/data.tpqr holds {data.Nt} AOIs, not the {len(kept)} kept")
    del data

    fov = gui.build_fov_state(workdir)
    if fov is None:
        raise RuntimeError("build_fov_state found no raw folder in phase 21's workspace")
    expect("FOV", [fov.fov.F, fov.fov.dtypes, dict(fov.show), fov.set_frame(-1),
                   fov.set_frame(10**6), fov.toggle("offset"), fov.visible_dtypes,
                   fov.fov[int(fov.fov.frames[0])].shape],
           [F, ["ontarget", "offtarget"], {"ontarget": True, "offtarget": True,
                                           "offset": False},
            0, F - 1, True, ["ontarget", "offtarget", "offset"], (H, W)])

    matplotlib = importlib.util.find_spec("matplotlib") is not None
    png = workdir / "cosmos_aoi0-channel0.png"
    counts.append(_read_launches())
    show = run_cli(workdir, ["show", "-n", "0"], device)
    log_text = (workdir / ".tapqir" / "loginfo").read_text()
    if matplotlib:
        if show["code"] != 0 or not png.is_file() or "Saved AOI viewer figure in" not in log_text:
            raise RuntimeError(f"show exited with {show['code']}, PNG written: {png.is_file()}")
    elif show["code"] == 0 or png.exists() or "show needs matplotlib" not in log_text:
        raise RuntimeError(f"show without matplotlib exited with {show['code']}, PNG "
                           f"written: {png.exists()}")
    counts += [sub["launches"], show["launches"]]
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    if any(launches.values()):
        raise RuntimeError(f"the viewer launched kernels: {launches}")
    return {"matplotlib": matplotlib, "show_exit": show["code"],
            "png_bytes": png.stat().st_size if png.exists() else 0,
            "aois": Nt, "frames": F, "excluded": excl, "subset_aois": len(kept),
            "fov_frames": fov.fov.F, "load_seconds": load_seconds,
            "save_data_seconds": save_seconds, "subset_seconds": sub["seconds"],
            "show_seconds": show["seconds"], "launches": launches}


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def kernel_inputs(M, nb, EVP, ev, J, dtype, seed, device, variant=None):
    """Inputs at realistic magnitudes: J integer offset bins around 90,
    pixel values from one above the lowest bin to 399 (some below some
    bins), concentrations 10..80 (0.05..0.95 for the small-d variant), rate
    1/7; ``variant`` names an edge case of VARIANTS. Lanes >= ev hold NaN:
    the kernel must never read them."""
    rng = np.random.default_rng(seed)
    g, w = offset_logits(J)
    x = rng.integers(int(g.min()) + 1, 400, size=(nb, EVP)).astype(np.float64)
    a = rng.uniform(10.0, 80.0, size=(M, nb, EVP))
    g, w = _apply_variant(variant, rng, x, g, w, ev)
    if variant == "small-d":
        a = rng.uniform(0.05, 0.95, size=(M, nb, EVP))
    x[:, ev:] = np.nan
    a[:, :, ev:] = np.nan
    t = dict(device=device, dtype=dtype)
    return (
        torch.tensor(x, **t), torch.tensor(a, **t),
        torch.tensor(1.0 / 7.0, **t), torch.tensor(g, **t), torch.tensor(w, **t),
    )


def _check_close(errs, name, got, want, tol):
    got64 = got.detach().double().cpu().numpy()
    want64 = want.detach().double().cpu().numpy()
    np.testing.assert_allclose(got64, want64, err_msg=name, **tol)
    errs[name] = float(np.abs(got64 - want64).max())


def _check_rate(errs, got, want, rtol):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, err_msg="grad_rate")
    errs["grad_rate_rel"] = abs(float(got) - float(want)) / abs(float(want))


def _check_repeat(label, launcher, *args):
    """Two launches on the same inputs must give bitwise-equal outputs."""
    first, second = launcher(*args), launcher(*args)
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        raise RuntimeError(f"{label}: two launches on the same inputs differ")


# elements (configs x images x pixels x bins) of one piece of the plain
# version: its float64 intermediates at M=16, nb=10240, J=61 would take
# tens of GB at once, so the comparisons run it over pieces of images
PLAIN_ELEMS = 1 << 27


def _plain_chunks(keep, per_image):
    """The indices of the images ``keep`` selects, in pieces of at most
    PLAIN_ELEMS / ``per_image`` images."""
    idx = keep.nonzero().flatten()
    step = max(1, PLAIN_ELEMS // per_image)
    return [idx[i:i + step] for i in range(0, idx.numel(), step)]


def _check_below(outs, sel):
    for o in outs:
        v = o[sel]
        if not (torch.isfinite(v).all() and (v < -1e29).all()):
            raise RuntimeError(f"below-every-bin entries gave {v.flatten()[:8].tolist()}")


def compare(M, nb, EVP, ev, J, dtype, seed, fwd_tol, grad_tol, below=False,
            variant=None):
    """Summed kernel (through the autograd wrapper) against the plain
    version: forward, concentration gradient and rate gradient under a
    random cotangent in [-1, 1], on the inputs of ``variant`` (VARIANTS);
    both kernel variants must repeat bitwise. Returns the max abs errors,
    after checking the tolerances."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = kernel_inputs(M, nb, EVP, ev, J, dtype, seed, "cuda", variant)
    keep = torch.ones(nb, dtype=torch.bool, device="cuda")
    if below:  # image 0: five pixels below every offset bin
        x[0, :5] = g.min() - 10.0
        keep[0] = False  # the plain version's value there is -inf
    cot = torch.tensor(np.random.default_rng(seed + 1).uniform(-1, 1, (M, nb)),
                       device="cuda", dtype=dtype) * keep

    a_k = a.clone().requires_grad_(True)
    r_k = rate.clone().requires_grad_(True)
    out_k = og.offset_gamma_summed(x, a_k, r_k, g, w, ev)
    ga_k, gr_k = torch.autograd.grad((out_k * cot).sum(), (a_k, r_k))
    with torch.no_grad():
        out_k_nograd = og.offset_gamma_summed(x, a, rate, g, w, ev)
    torch.cuda.synchronize()
    if below:
        _check_below((out_k, out_k_nograd), (slice(None), 0))
    for launcher in (og.summed_fwd, og.summed_stats):
        _check_repeat("summed", launcher, x, a, rate.reshape(1), g, w, ev)

    # the plain version on the real lanes (it would read the NaN padding), in
    # float64 on the same values: float32 round-off of the plain version
    # itself is of the order of the gradient tolerance. Images left out of
    # the comparison (below every bin) are left out of the plain version.
    def plain(dt):
        r_p = rate.to(dt).requires_grad_(True)
        outs, grads, gr = [], [], 0.0
        for sel in _plain_chunks(keep, M * ev * J):
            a_p = a[:, sel, :ev].to(dt).requires_grad_(True)
            out_p = og.offset_gamma_summed_plain(
                x[sel, :ev].to(dt), a_p, r_p, g.to(dt), w.to(dt), ev
            )
            ga, g_r = torch.autograd.grad((out_p * cot[:, sel].to(dt)).sum(), (a_p, r_p))
            outs.append(out_p.detach())
            grads.append(ga)
            gr = gr + g_r
        return torch.cat(outs, 1), torch.cat(grads, 1), gr

    out_p, ga_p, gr_p = plain(torch.float64)
    errs = {}
    if dtype == torch.float32:  # the float32 plain version, for scale
        out_p32, ga_p32, _ = plain(torch.float32)
        errs["plain_f32_forward"] = float((out_p32 - out_p).abs().max())
        errs["plain_f32_grad_concentration"] = float((ga_p32 - ga_p).abs().max())
        del out_p32, ga_p32
    if not torch.isfinite(ga_k).all():
        raise RuntimeError("non-finite kernel gradient")
    if (ga_k[..., ev:] != 0).any():
        raise RuntimeError("ev-masked lanes got a nonzero gradient")
    _check_close(errs, "forward", out_k[:, keep], out_p, fwd_tol)
    _check_close(errs, "forward_nograd", out_k_nograd[:, keep], out_p, fwd_tol)
    _check_close(errs, "grad_concentration", ga_k[:, keep, :ev], ga_p, grad_tol)
    _check_rate(errs, gr_k, gr_p, RATE_RTOL if dtype == torch.float32 else grad_tol["rtol"])
    return errs


def pixel_arrays(M, n_px, J, seed, variant=None):
    """Per-pixel inputs as float64 numpy arrays, at the magnitudes of
    :func:`kernel_inputs`: value (n_px,), concentration (M, n_px), rate,
    offsets and log weights (J,); ``variant`` names an edge case of
    VARIANTS."""
    rng = np.random.default_rng(seed)
    g, w = offset_logits(J)
    x = rng.integers(int(g.min()) + 1, 400, size=n_px).astype(np.float64)
    a = rng.uniform(10.0, 80.0, size=(M, n_px))
    g, w = _apply_variant(variant, rng, x[None], g, w, n_px)
    if variant == "small-d":
        a = rng.uniform(0.05, 0.95, size=(M, n_px))
    return x, a, 1.0 / 7.0, g, w


def pixel_inputs(M, n_px, J, dtype, seed, device, variant=None):
    """:func:`pixel_arrays` as tensors of ``dtype`` on ``device``."""
    t = dict(device=device, dtype=dtype)
    return tuple(torch.tensor(v, **t) for v in pixel_arrays(M, n_px, J, seed, variant))


def compare_pixel(M, n_px, J, dtype, seed, fwd_tol, grad_tol, below=False,
                  squeeze=False, variant=None):
    """Per-pixel kernel (through ``offset_gamma_log_prob``) against the
    plain version in float64: forward with and without gradient,
    concentration and rate gradients under a random cotangent, on the
    inputs of ``variant`` (VARIANTS); both kernel variants must repeat
    bitwise. ``squeeze`` passes an M=1 concentration of the value's shape.
    Returns the max abs errors, after checking the tolerances."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = pixel_inputs(M, n_px, J, dtype, seed, "cuda", variant)
    if squeeze:
        a = a[0]
    keep = torch.ones(n_px, dtype=torch.bool, device="cuda")
    if below:  # five pixels below every offset bin
        x[:5] = g.min() - 10.0
        keep[:5] = False  # the plain version's value there is -inf
    cot = torch.tensor(np.random.default_rng(seed + 1).uniform(-1, 1, tuple(a.shape)),
                       device="cuda", dtype=dtype) * keep

    a_k = a.clone().requires_grad_(True)
    r_k = rate.clone().requires_grad_(True)
    out_k = og.offset_gamma_log_prob(x, a_k, r_k, g, w)
    ga_k, gr_k = torch.autograd.grad((out_k * cot).sum(), (a_k, r_k))
    with torch.no_grad():
        out_k_nograd = og.offset_gamma_log_prob(x, a, rate, g, w)
    torch.cuda.synchronize()
    if out_k.shape != a.shape:
        raise RuntimeError(f"per-pixel output {tuple(out_k.shape)} for {tuple(a.shape)}")
    if below:
        _check_below((out_k, out_k_nograd), (..., slice(0, 5)))
    for launcher in (og.pixel_fwd, og.pixel_stats):
        _check_repeat("pixel", launcher, x, a.reshape(-1, n_px), rate.reshape(1), g, w)

    a_p = a[..., keep].double().requires_grad_(True)
    r_p = rate.double().requires_grad_(True)
    out_p = og.offset_gamma_log_prob_plain(x[keep].double(), a_p, r_p, g.double(), w.double())
    ga_p, gr_p = torch.autograd.grad((out_p * cot[..., keep].double()).sum(), (a_p, r_p))
    errs = {}
    if not torch.isfinite(ga_k).all():
        raise RuntimeError("non-finite kernel gradient")
    _check_close(errs, "forward", out_k[..., keep], out_p, fwd_tol)
    _check_close(errs, "forward_nograd", out_k_nograd[..., keep], out_p, fwd_tol)
    _check_close(errs, "grad_concentration", ga_k[..., keep], ga_p, grad_tol)
    _check_rate(errs, gr_k, gr_p, RATE_RTOL if dtype == torch.float32 else grad_tol["rtol"])
    return errs


def factored_inputs(Kf, nb, EVP, ev, J, dtype, seed, device, variant=None):
    """Factored inputs at cosmos magnitudes (per-image base b/gain 10..40,
    spot contributions 0..40 with half the pixels near zero, as away from
    a spot's centre) and the full 2^Kf config table; ``variant`` names an
    edge case of VARIANTS (small-d: base 0.05 and contributions 0..0.4, so
    every concentration is below 1). Lanes >= ev of value and deltas hold
    NaN: the kernel must never read them."""
    from tapqir_tpu_torch.infer.discrete import m_configs

    rng = np.random.default_rng(seed)
    g, w = offset_logits(J)
    x = rng.integers(int(g.min()) + 1, 400, size=(nb, EVP)).astype(np.float64)
    base = rng.uniform(10.0, 40.0, size=nb)
    deltas = rng.uniform(0.0, 40.0, size=(Kf, nb, EVP))
    deltas[:, :, rng.integers(0, ev, size=ev // 2)] *= 1e-3
    g, w = _apply_variant(variant, rng, x, g, w, ev)
    if variant == "small-d":
        base[:] = 0.05
        deltas *= 1e-2
    x[:, ev:] = np.nan
    deltas[:, :, ev:] = np.nan
    t = dict(device=device, dtype=dtype)
    return (torch.tensor(x, **t), torch.tensor(base, **t), torch.tensor(deltas, **t),
            m_configs(Kf), torch.tensor(1.0 / 7.0, **t), torch.tensor(g, **t),
            torch.tensor(w, **t))


def compare_factored(Kf, nb, EVP, ev, J, dtype, seed, fwd_tol, grad_tol,
                     below=False, small_base=False, variant=None):
    """Factored kernel (through ``offset_gamma_factored_summed``) against
    the plain version (dense concentration) in float64: forward with and
    without gradient, base, delta and rate gradients under a random
    cotangent, on the inputs of ``variant`` (VARIANTS); the kernel must
    repeat bitwise. Returns the max abs errors, after checking the
    tolerances."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, base, deltas, mtab, rate, g, w = factored_inputs(Kf, nb, EVP, ev, J, dtype,
                                                        seed, "cuda", variant)
    M = mtab.shape[0]
    if small_base:  # base < 1: the Pallas kernel flips its base-factor shift
        base.fill_(0.05)
    keep = torch.ones(nb, dtype=torch.bool, device="cuda")
    if below:  # image 0: five pixels below every offset bin
        x[0, :5] = g.min() - 10.0
        keep[0] = False
    cot = torch.tensor(np.random.default_rng(seed + 1).uniform(-1, 1, (M, nb)),
                       device="cuda", dtype=dtype) * keep

    leaves = [t.clone().requires_grad_(True) for t in (base, deltas, rate)]
    out_k = og.offset_gamma_factored_summed(x, leaves[0], leaves[1], mtab, leaves[2],
                                            g, w, ev)
    gb_k, gd_k, gr_k = torch.autograd.grad((out_k * cot).sum(), leaves)
    with torch.no_grad():
        out_k_nograd = og.offset_gamma_factored_summed(x, base, deltas, mtab, rate, g, w, ev)
    torch.cuda.synchronize()
    if below:
        _check_below((out_k, out_k_nograd), (slice(None), 0))
    _check_repeat("factored", og.factored_stats, x, base, deltas, og.config_masks(mtab, Kf),
                  rate.reshape(1), g, w, ev)
    if not (torch.isfinite(gb_k).all() and torch.isfinite(gd_k[..., :ev]).all()):
        raise RuntimeError("non-finite kernel gradient")
    if (gd_k[..., ev:] != 0).any():
        raise RuntimeError("ev-masked lanes got a nonzero delta gradient")

    r_p = rate.double().requires_grad_(True)
    parts, gr_p = [], 0.0
    for sel in _plain_chunks(keep, M * ev * J):
        leaves_p = [base[sel].double().requires_grad_(True),
                    deltas[:, sel, :ev].double().requires_grad_(True), r_p]
        out = og.offset_gamma_factored_summed_plain(
            x[sel, :ev].double(), leaves_p[0], leaves_p[1], mtab, r_p,
            g.double(), w.double(), ev,
        )
        gb, gd, g_r = torch.autograd.grad((out * cot[:, sel].double()).sum(), leaves_p)
        parts.append((out.detach(), gb, gd))
        gr_p = gr_p + g_r
    out_p, gb_p, gd_p = (torch.cat(t, dim) for t, dim in zip(zip(*parts), (1, 0, 1)))
    errs = {}
    _check_close(errs, "forward", out_k[:, keep], out_p, fwd_tol)
    _check_close(errs, "forward_nograd", out_k_nograd[:, keep], out_p, fwd_tol)
    _check_close(errs, "grad_base", gb_k[keep], gb_p, grad_tol)
    _check_close(errs, "grad_deltas", gd_k[:, keep, :ev], gd_p, grad_tol)
    _check_rate(errs, gr_k, gr_p, grad_tol["rtol"])
    return errs


def time_ms(fn, iters):
    """Mean ms per call with CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mufu_floor_ms(x_real, g, M, logs=1):
    """Least time of the special-function unit: ``logs`` logs per (pixel,
    bin) pair with x > g_j and one exp per config and such pair, over
    PEAK_MUFU_PER_S (x_real: the real pixels' values). ``logs=1`` is the
    exact evaluation's floor; the summed-template kernels take the log once
    per chunk of KERNEL_CHUNK configs, ceil(M / KERNEL_CHUNK) times."""
    pairs = float((x_real[..., None] > g).sum())
    return 1e3 * pairs * (logs + M) / PEAK_MUFU_PER_S


def bound_ms(x, a, g, ev, stats):
    """Least time for the summed function on these inputs: max of bytes
    moved (the ev real lanes of x and a read once, outputs written once)
    over the memory rate, and the float32 operations the data needs over
    the fp32 peak. Operations are counted per (pixel, bin) pair with
    x > g_j - the masked pairs need no work: 3 (difference, log, weight) +
    per config 4 (exponent, max, exp, sum) or 6 with the two statistics
    sums; plus per (pixel, config) 4 (log of the sum, rate term, lgamma,
    event sum) and 5 more with the statistics."""
    M, nb, EVP = a.shape
    item = a.element_size()
    read = nb * ev * (1 + M) * item
    write = M * nb * item + (2 * M * nb * EVP * item if stats else 0)
    pairs = float((x[:, :ev, None] > g).sum())
    ops = pairs * (3 + (6 if stats else 4) * M) + nb * ev * M * (4 + (5 if stats else 0))
    return _bound(read + write, ops)


def bound_pixel_ms(x, a2, g, stats):
    """Least time for the per-pixel function on these inputs (x (n_px,), a2
    (M, n_px)): x and a read once, out (and spl, spd) written once, against
    the operations per (pixel, bin) pair with x > g_j - 3 (difference, log,
    weight) + per config 4 (exponent, max, exp, sum) or 6 with the two
    statistics sums - plus per (pixel, config) 3 (log of the sum, rate
    term, lgamma) and 5 more with the statistics."""
    M, n_px = a2.shape
    item = a2.element_size()
    nbytes = n_px * (1 + M) * item + M * n_px * item * (3 if stats else 1)
    pairs = float((x[:, None] > g).sum())
    ops = pairs * (3 + (6 if stats else 4) * M) + n_px * M * (3 + (5 if stats else 0))
    return _bound(nbytes, ops)


def bound_factored_ms(x, deltas, g, M, ev):
    """Least time for the factored function with its statistics on these
    inputs (x (nb, EVP), deltas (Kf, nb, EVP), M configs): x, base and the
    deltas read once over the ev real lanes, out (M, nb) and spl, spd (M,
    nb, EVP) written once, against the operations of the factored form per
    (pixel, bin) pair with x > g_j, the fewest the function needs:
    3 (difference, log, weight) + 3 for the first pass (max of the bin
    term, least and largest difference) + (1 + Kf) exps and their 1 + Kf
    exponents + per config 1 product and 3 sums (s, sum p L, sum p d); plus
    per (pixel, config) 1 (concentration) + 4 (log of the sum with its
    shift, rate term, lgamma, event sum) + 5 statistics."""
    Kf, nb, EVP = deltas.shape
    item = deltas.element_size()
    nbytes = (nb * ev * (1 + Kf) + nb) * item + (M * nb + 2 * M * nb * EVP) * item
    pairs = float((x[:, :ev, None] > g).sum())
    ops = pairs * (6 + 2 * (1 + Kf) + 4 * M) + nb * ev * M * 10
    return _bound(nbytes, ops)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tapqir_tpu_torch.ops import offset_gamma as og

    t_start = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    walls, last = {}, [t_start]

    def lap(phase):  # wall seconds of each phase, printed as it ends
        now = time.perf_counter()
        walls[phase] = round(now - last[0], 3)
        last[0] = now
        print(f"[wall] phase {phase}: {walls[phase]} s (at {now - t_start:.1f} s)", flush=True)

    # phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)
    lap("1 device")

    # phase 2: build
    og.library.get()
    ptx = [ln.strip() for ln in og.library.build_log.splitlines()
           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"[build] {og.library.path.name} in {og.library.build_seconds:.1f} s "
          f"(nvcc {' '.join(og.NVCC_FLAGS)})", flush=True)
    for ln in ptx:
        print(f"[build] {ln}", flush=True)
    lap("2 build")

    # phase 3: summed kernel against plain
    M, nb, EVP, ev, J = 4, 5120, 256, 196, 61
    errs = compare(M, nb, EVP, ev, J, f32, 0, FWD_TOL, GRAD_TOL)
    print(f"[summed] slice shapes M={M} nb={nb} EVP={EVP} ev={ev} J={J} f32: "
          f"{json.dumps(errs)} (fwd {FWD_TOL}, grad {GRAD_TOL}, rate rtol {RATE_RTOL})",
          flush=True)
    cases = [
        ("below-every-bin", dict(M=4, nb=64, EVP=256, ev=196, J=61, dtype=f32, below=True)),
        ("ev-masked lanes", dict(M=4, nb=64, EVP=256, ev=130, J=61, dtype=f32)),
        ("ragged nb", dict(M=4, nb=37, EVP=256, ev=196, J=61, dtype=f32)),
        ("nb=7900 (hmm step)", dict(M=4, nb=7900, EVP=256, ev=196, J=61, dtype=f32)),
        (f"M={XT_M} nb={XT_NB} (crosstalk step)",
         dict(M=XT_M, nb=XT_NB, EVP=256, ev=196, J=61, dtype=f32)),
        ("M=16", dict(M=16, nb=300, EVP=256, ev=196, J=61, dtype=f32)),
        ("float64", dict(M=4, nb=12, EVP=256, ev=196, J=7, dtype=f64)),
        *((f"J={Jc}", dict(M=4, nb=64 if Jc < 1024 else 8, EVP=256, ev=196, J=Jc,
                           dtype=f32)) for Jc in (1, 7, 64, 65, 1024)),
        *((v, dict(M=4, nb=64, EVP=256, ev=196, J=61, dtype=f32, variant=v))
          for v in VARIANTS),
    ]
    for i, (label, c) in enumerate(cases):
        is64 = c["dtype"] == f64
        e = compare(c["M"], c["nb"], c["EVP"], c["ev"], c["J"], c["dtype"], 10 + i,
                    F64_TOL if is64 else FWD_TOL, F64_GRAD_TOL if is64 else GRAD_TOL,
                    below=c.get("below", False), variant=c.get("variant"))
        print(f"[summed] edge case {label}: {json.dumps(e)}", flush=True)
    lap("3 summed kernel")

    # phase 4: per-pixel kernel against plain
    n_px = 10 * 512 * 1 * 14 * 14
    pixel_errs = {}
    for Mp in (1, 4):
        pixel_errs[Mp] = compare_pixel(Mp, n_px, J, f32, 20 + Mp, PIXEL_FWD_TOL,
                                       PIXEL_GRAD_TOL)
        print(f"[pixel] M={Mp} n_px={n_px} J={J} f32: {json.dumps(pixel_errs[Mp])} "
              f"(fwd {PIXEL_FWD_TOL}, grad {PIXEL_GRAD_TOL}, rate rtol {RATE_RTOL})",
              flush=True)
        torch.cuda.empty_cache()
    cases = [
        ("below-every-bin", dict(M=4, n_px=5000, J=61, dtype=f32, below=True)),
        ("ragged n_px", dict(M=4, n_px=n_px + 77, J=61, dtype=f32)),
        ("M=1 squeeze", dict(M=1, n_px=5000, J=61, dtype=f32, squeeze=True)),
        ("float64", dict(M=4, n_px=3000, J=7, dtype=f64)),
        *((f"J={Jc}", dict(M=4, n_px=20000 if Jc < 1024 else 3000, J=Jc, dtype=f32))
          for Jc in (1, 7, 64, 65, 1024)),
        *((v, dict(M=4, n_px=20000, J=61, dtype=f32, variant=v)) for v in VARIANTS),
        *((f"M={Mc}", dict(M=Mc, n_px=20000, J=61, dtype=f32)) for Mc in (2, 3, 5, 16)),
    ]
    for i, (label, c) in enumerate(cases):
        is64 = c["dtype"] == f64
        e = compare_pixel(c["M"], c["n_px"], c["J"], c["dtype"], 30 + i,
                          F64_TOL if is64 else PIXEL_FWD_TOL,
                          F64_GRAD_TOL if is64 else PIXEL_GRAD_TOL,
                          below=c.get("below", False), squeeze=c.get("squeeze", False),
                          variant=c.get("variant"))
        print(f"[pixel] edge case {label}: {json.dumps(e)}", flush=True)
    torch.cuda.empty_cache()
    lap("4 per-pixel kernel")

    # phase 5: factored kernel against plain
    Kf = 2
    fact_errs = compare_factored(Kf, nb, EVP, ev, J, f32, 40, FACT_FWD_TOL, FACT_GRAD_TOL)
    print(f"[factored] Kf={Kf} (M={1 << Kf}) nb={nb} EVP={EVP} ev={ev} J={J} f32: "
          f"{json.dumps(fact_errs)} (fwd {FACT_FWD_TOL}, grad {FACT_GRAD_TOL})", flush=True)
    cases = [
        ("base < 1", dict(Kf=2, nb=64, ev=196, J=61, dtype=f32, small_base=True)),
        ("below-every-bin", dict(Kf=2, nb=64, ev=196, J=61, dtype=f32, below=True)),
        ("ragged nb", dict(Kf=2, nb=37, ev=196, J=61, dtype=f32)),
        ("Kf=4 (M=16)", dict(Kf=4, nb=300, ev=196, J=61, dtype=f32)),
        (f"Kf={XT_KF} nb={XT_NB} (crosstalk factored step)",
         dict(Kf=XT_KF, nb=XT_NB, ev=196, J=61, dtype=f32)),
        ("float64", dict(Kf=2, nb=12, ev=196, J=7, dtype=f64)),
        ("ev-masked lanes, J=65", dict(Kf=2, nb=64, ev=130, J=65, dtype=f32)),
        *((v, dict(Kf=2, nb=64, ev=196, J=61, dtype=f32, variant=v)) for v in VARIANTS),
    ]
    for i, (label, c) in enumerate(cases):
        is64 = c["dtype"] == f64
        e = compare_factored(c["Kf"], c["nb"], EVP, c["ev"], c["J"], c["dtype"], 50 + i,
                             F64_TOL if is64 else FACT_FWD_TOL,
                             F64_GRAD_TOL if is64 else FACT_GRAD_TOL,
                             below=c.get("below", False),
                             small_base=c.get("small_base", False),
                             variant=c.get("variant"))
        print(f"[factored] edge case {label}: {json.dumps(e)}", flush=True)
    torch.cuda.empty_cache()
    lap("5 factored kernel")

    # phase 6: timing at the slice shapes
    timing = {}
    x, a, rate, g, w = kernel_inputs(M, nb, EVP, ev, J, f32, 0, "cuda")
    x[:, ev:] = 91.0  # finite padding for the plain version
    a[..., ev:] = 1.0
    r1 = rate.reshape(1)

    def plain_pair(fn, leaves, axes, go, chunks=1):
        """ms of the plain version ``fn(images, *leaves)`` without and with
        its gradient (forward + autograd backward against ``go``, whose
        last axis is the image axis), over ``chunks`` pieces of the images
        (``axes``: each leaf's image axis, None for a shared leaf)."""
        n = go.shape[-1]
        step = -(-n // chunks)
        pieces = [slice(i, min(i + step, n)) for i in range(0, n, step)]

        def part(sl, ts):
            return [t if ax is None else t.narrow(ax, sl.start, sl.stop - sl.start)
                    for t, ax in zip(ts, axes)]

        def fwd():
            with torch.no_grad():
                for sl in pieces:
                    fn(sl, *part(sl, leaves))

        def grad():
            for sl in pieces:
                ls = [t.detach().requires_grad_(True) for t in part(sl, leaves)]
                torch.autograd.grad(fn(sl, *ls), ls, go[..., sl])

        return time_ms(fwd, 5), time_ms(grad, 5)

    def summed_plain(x_):
        return lambda sl, a_, r_: og.offset_gamma_summed_plain(x_[sl], a_, r_, g, w, ev)

    timing["summed_fwd"] = [time_ms(lambda: og.summed_fwd(x, a, r1, g, w, ev), 50)]
    timing["summed_stats"] = [time_ms(lambda: og.summed_stats(x, a, r1, g, w, ev), 50)]
    p_fwd, p_grad = plain_pair(summed_plain(x), [a, rate], [1, None],
                               torch.ones((M, nb), device="cuda"))
    timing["summed_fwd"] += [p_fwd, *bound_ms(x, a, g, ev, stats=False)]
    timing["summed_stats"] += [p_grad, *bound_ms(x, a, g, ev, stats=True)]
    floor = dict.fromkeys(("summed_fwd", "summed_stats", "factored_stats"),
                          mufu_floor_ms(x[:, :ev], g, M))
    del x, a
    nb_hmm = 10 * 790  # a dense hmm step: 10 AOIs x every frame
    x, a, _, _, _ = kernel_inputs(M, nb_hmm, EVP, ev, J, f32, 1, "cuda")
    x[:, ev:] = 91.0
    a[..., ev:] = 1.0
    _, p_grad = plain_pair(summed_plain(x), [a, rate], [1, None],
                           torch.ones((M, nb_hmm), device="cuda"))
    hmm_row = f"summed_stats nb={nb_hmm}"
    timing[hmm_row] = [time_ms(lambda: og.summed_stats(x, a, r1, g, w, ev), 50), p_grad,
                       *bound_ms(x, a, g, ev, stats=True)]
    floor[hmm_row] = mufu_floor_ms(x[:, :ev], g, M)
    del x, a
    # a rank's step on phase 22's 2x2 mesh: 10 AOIs x its 395 frames
    nb_mesh = 10 * 395
    x, a, _, _, _ = kernel_inputs(M, nb_mesh, EVP, ev, J, f32, 3, "cuda")
    x[:, ev:] = 91.0
    a[..., ev:] = 1.0
    _, p_grad = plain_pair(summed_plain(x), [a, rate], [1, None],
                           torch.ones((M, nb_mesh), device="cuda"))
    mesh_row = f"summed_stats nb={nb_mesh}"
    timing[mesh_row] = [time_ms(lambda: og.summed_stats(x, a, r1, g, w, ev), 50), p_grad,
                        *bound_ms(x, a, g, ev, stats=True)]
    floor[mesh_row] = mufu_floor_ms(x[:, :ev], g, M)
    del x, a
    torch.cuda.empty_cache()

    # the crosstalk step: 16 configs over nb = 10 AOIs x 512 frames x 2
    # channels, dense (the summed pair) and factored (Kf = 4); the plain
    # version in 4 pieces of images (its float32 intermediates at this size
    # would take tens of GB at once)
    floor_issued = {}
    x, a, _, _, _ = kernel_inputs(XT_M, XT_NB, EVP, ev, J, f32, 2, "cuda")
    x[:, ev:] = 91.0
    a[..., ev:] = 1.0
    p_fwd, p_grad = plain_pair(summed_plain(x), [a, rate], [1, None],
                               torch.ones((XT_M, XT_NB), device="cuda"), chunks=4)
    for kname, launcher, p_ms, stats in (("summed_fwd", og.summed_fwd, p_fwd, False),
                                         ("summed_stats", og.summed_stats, p_grad, True)):
        row = f"{kname} M={XT_M} nb={XT_NB}"
        timing[row] = [time_ms(lambda: launcher(x, a, r1, g, w, ev), 20), p_ms,
                       *bound_ms(x, a, g, ev, stats=stats)]
        floor[row] = mufu_floor_ms(x[:, :ev], g, XT_M)
        floor_issued[row] = mufu_floor_ms(x[:, :ev], g, XT_M, -(-XT_M // KERNEL_CHUNK))
    del x, a
    torch.cuda.empty_cache()

    # per-pixel at M=4 (the kernels' JSON entries) and at M=1 (KSMOGN.log_prob)
    xp, ap, _, _, _ = pixel_inputs(M, n_px, J, f32, 0, "cuda")
    for Mp, tag in ((M, ""), (1, " M=1")):
        a2 = ap[:Mp].contiguous()
        ms_f = time_ms(lambda: og.pixel_fwd(xp, a2, r1, g, w), 50)
        ms_s = time_ms(lambda: og.pixel_stats(xp, a2, r1, g, w), 50)
        p_fwd, p_grad = plain_pair(
            lambda sl, a_, r_: og.offset_gamma_log_prob_plain(xp[sl], a_, r_, g, w),
            [a2, rate], [1, None], torch.ones_like(a2))
        timing["pixel_fwd" + tag] = [ms_f, p_fwd, *bound_pixel_ms(xp, a2, g, False)]
        timing["pixel_stats" + tag] = [ms_s, p_grad, *bound_pixel_ms(xp, a2, g, True)]
        floor["pixel_fwd" + tag] = floor["pixel_stats" + tag] = mufu_floor_ms(xp, g, Mp)
    del xp, ap, a2

    for Kf_t, nb_t, row, chunks in ((Kf, nb, "factored_stats", 1),
                                    (Kf, nb_mesh, f"factored_stats nb={nb_mesh}", 1),
                                    (XT_KF, XT_NB, f"factored_stats Kf={XT_KF} nb={XT_NB}", 4)):
        xf, base, deltas, mtab, _, _, _ = factored_inputs(Kf_t, nb_t, EVP, ev, J, f32, 0,
                                                          "cuda")
        xf[:, ev:] = 91.0
        deltas[..., ev:] = 0.0
        masks = og.config_masks(mtab, Kf_t)
        ms_fact = time_ms(lambda: og.factored_stats(xf, base, deltas, masks, r1, g, w, ev),
                          50 if chunks == 1 else 20)
        _, p_grad = plain_pair(
            lambda sl, b_, d_, r_: og.offset_gamma_factored_summed_plain(
                xf[sl], b_, d_, mtab, r_, g, w, ev),
            [base, deltas, rate], [0, 1, None], torch.ones((len(masks), nb_t), device="cuda"),
            chunks=chunks)
        timing[row] = [ms_fact, p_grad, *bound_factored_ms(xf, deltas, g, len(masks), ev)]
        floor.setdefault(row, mufu_floor_ms(xf[:, :ev], g, len(masks)))
        if chunks > 1:
            floor_issued[row] = mufu_floor_ms(xf[:, :ev], g, len(masks),
                                              -(-len(masks) // KERNEL_CHUNK))
        del xf, base, deltas
        torch.cuda.empty_cache()
    for k, (ms, plain_ms, b, by) in timing.items():
        issued = (f", special-function floor of the logs the kernel issues "
                  f"{floor_issued[k]:.6f} ms" if k in floor_issued else "")
        print(f"[timing] {k} on {name} ({smi}): kernel {ms:.6f} ms, plain {plain_ms:.4f} "
              f"ms, bound {b:.6f} ms ({by}), special-function floor {floor[k]:.6f} ms"
              f"{issued}; library: none (no single PyTorch call computes this function)",
              flush=True)
    print(f"[timing] kernel phases done at {time.perf_counter() - t_start:.1f} s", flush=True)
    lap("6 timing")

    # phases 7-11: the dense and factored fits, the per-pixel path, and the
    # command line's fit and stats on the dense fit's workspace
    num_iter, cli_iter = 200, 200
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        dense = run_main_path(tmp, num_iter=num_iter, device="cuda")
        gc.collect()  # the dense models' device data must not count in the next peak
        check_main_path(dense, num_iter)
        lap("7 dense fit")
        fact, fmodel = run_factored_path(tmp, num_iter=num_iter, device="cuda")
        check_main_path(fact, num_iter)
        lap("8 factored fit")
        pixel = run_pixel_path(fmodel.data, device="cuda")
        del fmodel
        gc.collect()
        lap("9 per-pixel path")
        cli_fit = run_cli_fit(tmp, num_iter=cli_iter, device="cuda")
        check_cli_fit(cli_fit, cli_iter, device="cuda")
        fit_stage_seconds = cli_fit.pop("model").stats_seconds
        gc.collect()
        lap("10 CLI fit")
        cli_stats = run_cli_stats(tmp, device="cuda")
        stats_checks = check_cli_stats(cli_stats, cli_fit)
        card_cpu = check_card_vs_cpu(cli_stats["model"])
        stats_stage_seconds = cli_stats.pop("model").stats_seconds
        gc.collect()
        lap("11 CLI stats")
        cli_hmm = run_cli_hmm_fit(tmp, num_iter=cli_iter, device="cuda")
        hmm_checks = check_cli_hmm_fit(cli_hmm, cli_iter, device="cuda")
        hmm_model = cli_hmm.pop("model")
        hmm_stage_seconds = hmm_model.stats_seconds
        hmm_profile = profile_steps(hmm_model)
        lap("12 CLI hmm fit")
        hmm_card_cpu = check_hmm_card_vs_cpu(hmm_model)
        del hmm_model
        gc.collect()
        lap("13 hmm card vs CPU")

        # phases 14-15: crosstalk in a workspace of its own
        xws = Path(tmp) / "crosstalk"
        xws.mkdir()
        xt_setup = prepare_dataset(xws, C=2, params=XTALK_PARAMS, device="cuda")
        xt_fit = run_cli_crosstalk_fit(xws, num_iter=cli_iter, device="cuda")
        xt_checks = check_cli_crosstalk_fit(xt_fit, cli_iter, device="cuda")
        xt_model = xt_fit.pop("model")
        xt_stage_seconds = xt_model.stats_seconds
        xt_fact = run_crosstalk_factored(xt_model, num_iter=cli_iter)
        check_crosstalk_factored(xt_fact, xt_model, cli_iter)
        xt_profile = {"dense": profile_steps(xt_model)}
        xt_model.use_factored = True
        try:
            xt_profile["factored"] = profile_steps(xt_model)
        finally:
            xt_model.use_factored = False
        lap("14 CLI crosstalk fit")
        xt_card_cpu = check_crosstalk_card_vs_cpu(xt_model)
        xt_card_cpu.update(check_card_vs_cpu(xt_model))
        del xt_model
        gc.collect()
        lap("15 crosstalk card vs CPU")

        # phase 16: the kinetics commands on the cosmos and hmm fits above
        ttfb = run_kinetics(tmp, ["ttfb", "--model", "cosmos", "-it", str(TTFB_ITER)],
                            device="cuda")
        ttfb_tables = check_kinetics(ttfb, "ttfb", 1, 1, device="cuda")
        ttfb.pop("model")
        gc.collect()
        dwell = run_kinetics(tmp, ["dwelltime", "--model", "cosmos+hmm", "-K", "1", "-it",
                                   str(DWELL_ITER)], device="cuda")
        dwell_tables = check_kinetics(dwell, "dwelltime", 1, 2, device="cuda")
        dwell.pop("model")
        gc.collect()
        lap("16 kinetics")

        # phase 17: the chain-batched kernels against single-chain launches
        # and float64, and their times
        torch.cuda.reset_peak_memory_stats()
        chain_errs, chain_timing = run_chain_kernels()
        print(f"[chains] peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        lap("17 chain-batched kernels")

        # phase 18: fit -R through the command line, then stats
        cli_restarts = run_cli_restarts(tmp, num_iter=cli_iter, device="cuda")
        restart_checks = check_cli_restarts(cli_restarts, RESTARTS_R, RESTART_ITER, cli_iter)
        rmodel = cli_restarts.pop("model")
        restart_profile = {"R=1": profile_steps(rmodel),
                           f"R={RESTARTS_R}": profile_restart_steps(rmodel, RESTARTS_R)}
        cli_restarts["stats"].pop("model")
        del rmodel
        gc.collect()
        lap("18 CLI restarts")

        # phase 19: fit_restarts through the API for the other models and
        # routes, and one restart step of each against float64 on the CPU
        api = {}
        for label, wdir, mname, chains, factored in (
                ("cosmos use_factored", tmp, "cosmos", RESTARTS_R, True),
                ("cosmos+hmm", tmp, "cosmos+hmm", RESTARTS_R, False),
                ("crosstalk", xws, "crosstalk", 2, False)):
            res, amodel = run_api_restarts(wdir, mname, chains, device="cuda",
                                           use_factored=factored)
            check_api_restarts(res, amodel, chains, API_RESTART_ITER)
            res["card_vs_cpu"] = check_restart_card_vs_cpu(amodel, chains)
            res["R"] = chains
            api[label] = res
            del amodel
            gc.collect()
        lap("19 API restarts")

        # phase 20: raw Glimpse files at the cell's width -> data.tpqr
        gws = Path(tmp) / "glimpse"
        gws.mkdir()
        t0 = time.perf_counter()
        raw = write_glimpse_folder(Path(tmp) / "raw")
        raw_seconds = time.perf_counter() - t0
        ingest = run_ingest(gws, raw)
        del raw
        gc.collect()
        lap("20 ingest")

        # phase 21: the ingested workspace through fit, fit --profile,
        # stats, subset and log
        ingested = run_ingested_cli(gws, device="cuda")
        ingested_checks = check_ingested_cli(ingested, device="cuda")
        ingested_fit = ingested["fit"]
        ingested_prof = ingested["profile"]
        ingested_seconds = {k: r["seconds"] for k, r in ingested.items()}
        ingested_stage_seconds = ingested["stats"]["model"].stats_seconds
        for r in ingested.values():
            r.pop("model")  # the models' device data must not outlive the phase
        del ingested
        gc.collect()
        torch.cuda.empty_cache()
        lap("21 ingested CLI")

        # phases 22-24: the mesh, its ranks sharing this one card over gloo;
        # on more cards, the command line's mesh over NCCL
        mesh_res = run_mesh_phases(tmp, xws, ["cuda:0"] * 4, lap=lap)
        mesh_checks = check_mesh_phases(mesh_res, Nt=856, F=790)
        mesh_cli = run_mesh_cli(tmp) if torch.cuda.device_count() > 1 else None

        # phase 25: the AOI viewer on phase 21's workspace (no kernel)
        viewer = run_viewer(gws)
        lap("25 viewer")
    for label, res in (("dense", dense), ("factored", fact)):
        print(f"[{label}] cosmos Nt=856 F=790 P=14 J=61 batch 10x512: {num_iter} steps "
              f"in {res['seconds']:.3f} s = {res['steps_per_s']:.3f} steps/s on {name} "
              f"({smi}); peak memory {res['peak_bytes'] / 2**30:.3f} GiB; "
              f"load+init {res['load_init_seconds']:.1f} s; held-out -ELBO "
              f"{res['loss_before']:.6g} -> {res['loss_after']:.6g}; logged -ELBO "
              f"{res['logged_losses']}; launches {res['launches']}; checkpoint "
              f"reloaded at iter {res['iter_reloaded']}", flush=True)
        if not res["loss_after"] < res["loss_before"]:
            raise RuntimeError(f"{label}: {num_iter} SVI steps did not lower the held-out -ELBO")
    print(f"[setup] simulate {dense['simulate_seconds']:.1f} s, save "
          f"{dense['save_seconds']:.1f} s", flush=True)
    print(f"[pixel-path] {json.dumps(pixel)}", flush=True)
    for label, res, stages in (("cli-fit", cli_fit, fit_stage_seconds),
                               ("cli-stats", cli_stats, stats_stage_seconds)):
        print(f"[{label}] exit {res['code']} in {res['seconds']:.3f} s on {name} ({smi}); "
              f"peak memory {res['peak_bytes'] / 2**30:.3f} GiB; launches "
              f"{res['launches']}; stats seconds by stage {json.dumps(stages)}", flush=True)
    print(f"[cli-fit] iteration {cli_fit['iter_before']} -> "
          f"{cli_fit['iter_before'] + cli_iter}", flush=True)
    print(f"[cli-stats] checks {json.dumps(stats_checks)}", flush=True)
    print(f"[card-vs-cpu] {json.dumps(card_cpu)} (tolerances: probabilities absolute "
          f"{PROB_TOL}, SNR {SNR_TOL}, chi2 {CHI2_TOL})", flush=True)
    print(f"[cli-hmm] fit --model cosmos+hmm (warm start from the cosmos fit) exit "
          f"{cli_hmm['code']} in {cli_hmm['seconds']:.3f} s on {name} ({smi}): "
          f"{cli_iter} steps in {cli_hmm['run_seconds']:.3f} s = "
          f"{cli_iter / cli_hmm['run_seconds']:.3f} steps/s; peak memory "
          f"{cli_hmm['peak_bytes'] / 2**30:.3f} GiB; launches {cli_hmm['launches']} at "
          f"(kernel, M, nb) {sorted(cli_hmm['shapes'])}; stats seconds by stage "
          f"{json.dumps(hmm_stage_seconds)}", flush=True)
    print(f"[cli-hmm] profiled steps {json.dumps(hmm_profile)}", flush=True)
    print(f"[cli-hmm] checks {json.dumps(hmm_checks)} (warm-start tolerance {WARM_TOL})",
          flush=True)
    print(f"[hmm-card-vs-cpu] {json.dumps(hmm_card_cpu)} (tolerances: ELBO relative "
          f"{HMM_ELBO_RTOL}, theta probabilities absolute {PROB_TOL})", flush=True)
    print(f"[setup-crosstalk] Nt=856 F=790 C=2: simulate {xt_setup['simulate_seconds']:.1f} s, "
          f"save {xt_setup['save_seconds']:.1f} s", flush=True)
    print(f"[cli-crosstalk] fit --model crosstalk exit {xt_fit['code']} in "
          f"{xt_fit['seconds']:.3f} s on {name} ({smi}): {cli_iter} dense steps in "
          f"{xt_fit['run_seconds']:.3f} s = {cli_iter / xt_fit['run_seconds']:.3f} steps/s; "
          f"peak memory {xt_fit['peak_bytes'] / 2**30:.3f} GiB; launches {xt_fit['launches']} "
          f"at (kernel, M, nb) {sorted(xt_fit['shapes'])}; stats seconds by stage "
          f"{json.dumps(xt_stage_seconds)}", flush=True)
    print(f"[cli-crosstalk] factored: {cli_iter} steps of Model.run in "
          f"{xt_fact['seconds']:.3f} s = {xt_fact['steps_per_s']:.3f} steps/s; peak memory "
          f"{xt_fact['peak_bytes'] / 2**30:.3f} GiB; launches {xt_fact['launches']} at "
          f"(kernel, Kf, M, nb) {sorted(xt_fact['shapes'])}", flush=True)
    print(f"[cli-crosstalk] profiled steps {json.dumps(xt_profile)}", flush=True)
    print(f"[cli-crosstalk] checks {json.dumps(xt_checks)}", flush=True)
    print(f"[crosstalk-card-vs-cpu] {json.dumps(xt_card_cpu)} (tolerances: ELBO relative "
          f"{XTALK_ELBO_RTOL}, probabilities absolute {PROB_TOL}, SNR {SNR_TOL}, "
          f"chi2 {CHI2_TOL})", flush=True)
    for label, res, tables in (("ttfb", ttfb, ttfb_tables), ("dwelltime", dwell, dwell_tables)):
        print(f"[kinetics] {label} exit {res['code']} in {res['seconds']:.3f} s on {name} "
              f"({smi}): z samples {res['z_samples_shape']} in {res['z_sample']:.3f} s, "
              f"fits {res['fits']} in {res['mle']:.3f} s; peak memory "
              f"{res['peak_bytes'] / 2**30:.3f} GiB (host: the process's largest "
              f"resident set so far {res['host_max_rss_gib']:.3f} GiB); card vs CPU float64 "
              f"{res['mle_rel_err']:.3g} relative (tolerance {MLE_RTOL}; CPU refit of rows "
              f"{res['cpu_refit_rows']} in {res['cpu_refit_seconds']:.1f} s); files "
              f"{res['files']}; {json.dumps(tables)}",
              flush=True)
    for row, errs_r in chain_errs.items():
        print(f"[chains] {row}: {json.dumps(errs_r)} (bitwise against single-chain "
              f"launches; rate gradient {CHAIN_RATE_RTOL} relative; float64: fwd "
              f"{FWD_TOL}, grad {GRAD_TOL} summed / {FACT_GRAD_TOL} factored)", flush=True)
    for k, (ms, plain_ms, b, by, fl_ms, single_ms) in chain_timing.items():
        print(f"[chains-timing] {k} on {name} ({smi}): kernel {ms:.6f} ms (R single-chain "
              f"launches {single_ms:.6f} ms), plain {plain_ms:.4f} ms, bound {b:.6f} ms "
              f"({by}), special-function floor {fl_ms:.6f} ms", flush=True)
    cr = cli_restarts
    print(f"[cli-restarts] fit -R {RESTARTS_R} --restart-iter {RESTART_ITER} -it {cli_iter} "
          f"exit {cr['code']} in {cr['seconds']:.3f} s on {name} ({smi}): "
          f"{RESTART_ITER} restart steps of {RESTARTS_R} chains in "
          f"{cr['restart_seconds']:.3f} s = {RESTART_ITER / cr['restart_seconds']:.3f} "
          f"restart steps/s; restarts' peak memory {cr['restart_peak_bytes'] / 2**30:.3f} "
          f"GiB, the command's {cr['peak_bytes'] / 2**30:.3f} GiB; launches "
          f"{cr['launches']} per shape {sorted(cr['counts'].items())}; stats exit "
          f"{cr['stats']['code']} in {cr['stats']['seconds']:.3f} s", flush=True)
    print(f"[cli-restarts] checks {json.dumps(restart_checks)}", flush=True)
    print(f"[cli-restarts] profiled steps {json.dumps(restart_profile)}", flush=True)
    for label, res in api.items():
        print(f"[api-restarts] {label} R={res['R']}: {API_RESTART_ITER} steps in "
              f"{res['seconds']:.3f} s = {res['steps_per_s']:.3f} steps/s on {name} ({smi}); "
              f"peak memory {res['peak_bytes'] / 2**30:.3f} GiB; launches {res['launches']} "
              f"per shape {sorted(res['counts'].items())}; card vs CPU float64 "
              f"{json.dumps(res['card_vs_cpu'])} (tolerance {RESTART_RTOL})", flush=True)
    print(f"[ingest] raw Glimpse folder {GLIMPSE_FOV} x {GLIMPSE_FOV} x {GLIMPSE_F} frames "
          f"in 2 files, Nt={GLIMPSE_NT}, written in {raw_seconds:.3f} s; glimpse exit "
          f"{ingest['code']} in {ingest['seconds']:.3f} s on {name} ({smi}); seconds by "
          f"stage {json.dumps(ingest['stage_seconds'])}; host resident "
          f"{ingest['host_rss_before_gib']:.3f} GiB before, peak during "
          f"{ingest['host_peak_gib']:.3f} GiB", flush=True)
    print(f"[ingest] checks {json.dumps(ingest['checks'])}; decoders on every frame "
          f"{json.dumps(ingest['decoders'])} (bitwise equal)", flush=True)
    print(f"[ingested-cli] fit -n {INGEST_NBATCH} -f {GLIMPSE_F} -it {INGEST_ITER} exit "
          f"{ingested_fit['code']} on {name} ({smi}): {INGEST_ITER} steps in "
          f"{ingested_fit['run_seconds']:.3f} s = "
          f"{INGEST_ITER / ingested_fit['run_seconds']:.3f} steps/s; peak memory "
          f"{ingested_fit['peak_bytes'] / 2**30:.3f} GiB; launches "
          f"{ingested_fit['launches']}; stats seconds by stage "
          f"{json.dumps(ingested_stage_seconds)}", flush=True)
    print(f"[ingested-cli] fit --profile {INGEST_PROFILE}: {ingested_prof['trace_bytes']} "
          f"bytes of trace, {ingested_prof['trace_kernel_events']} device events of "
          f"offset_gamma_summed_kernel; launches {ingested_prof['launches']}; command "
          f"seconds {json.dumps(ingested_seconds)}", flush=True)
    print(f"[ingested-cli] checks {json.dumps(ingested_checks)}", flush=True)
    print_mesh_phases(mesh_res, mesh_checks, mesh_cli, name, smi)
    print(f"[viewer] {'with' if viewer['matplotlib'] else 'without'} matplotlib: show -n 0 "
          f"exit {viewer['show_exit']} ({viewer['png_bytes']} bytes of PNG); on {name} "
          f"({smi}), the viewer on the host: {json.dumps(viewer)}", flush=True)
    dl, fl, pl = dense["launches"], fact["launches"], pixel["launches"]
    if dl["summed_stats"] < num_iter or dl["summed_fwd"] < 1:
        raise RuntimeError(f"dense path: kernel launches {dl}")
    if fl["factored_stats"] < num_iter or fl["summed_fwd"] or fl["summed_stats"]:
        raise RuntimeError(f"factored path: kernel launches {fl}")
    if pl["pixel_fwd"] < 1 or pl["pixel_stats"] < 2:
        raise RuntimeError(f"per-pixel path: kernel launches {pl}")
    print(f"[done] in {time.perf_counter() - t_start:.1f} s; wall seconds by phase "
          f"{json.dumps(walls)}", flush=True)

    def entry(kname, body, launches, max_abs_err):
        ms, plain_ms, b, by = timing[kname]
        return dict(name=f"offset_gamma_{kname}", route="cuda", source=KERNEL_SOURCE,
                    replaces=f"{PALLAS_SOURCE}:{body}", launches=launches,
                    max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                    bound_by=by, library_ms=None)

    perr = pixel_errs[M]
    # launches over every path driven: phases 7, 8, 9, 10, 12, 14, 18, 19,
    # 21 and 22-24 (every rank's mesh runs; phases 11, 16, 20 and 25 launch
    # none; 13, 15 and 17 compare the card with the CPU or the kernels with
    # their plain versions, as do the ranks before their runs)
    paths = (dl, fl, pl, cli_fit["launches"], cli_hmm["launches"], xt_fit["launches"],
             xt_fact["launches"], cli_restarts["launches"], cli_restarts["stats"]["launches"],
             *(res["launches"] for res in api.values()), ingested_fit["launches"],
             ingested_prof["launches"], *(r["launches"] for r in mesh_res.values()))
    total = {k: sum(r.get(k, 0) for r in paths) for k in dl}
    kernels = [
        entry("summed_fwd", 365, total["summed_fwd"], errs["forward_nograd"]),
        entry("summed_stats", 384, total["summed_stats"],
              max(errs["forward"], errs["grad_concentration"])),
        entry("pixel_fwd", 137, total["pixel_fwd"], perr["forward_nograd"]),
        entry("pixel_stats", 151, total["pixel_stats"],
              max(perr["forward"], perr["grad_concentration"])),
        entry("factored_stats", 520, total["factored_stats"],
              max(fact_errs[k] for k in ("forward", "grad_base", "grad_deltas"))),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

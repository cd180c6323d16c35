"""Command-line interface: ``python -m tapqir_tpu_torch [--cd DIR]
glimpse|fit|stats|ttfb|dwelltime|subset|log`` (counterpart of the workspace
and of these commands of tapqir_tpu/main.py).

Every command runs inside an analysis folder (``--cd``, default: the
working directory) that holds ``.tapqir/`` (config.yaml, loginfo, model
checkpoints, logs) next to ``data.tpqr`` and the result files. The options,
short flags, defaults and config keys are the JAX package's, and so are the
files, so either package's CLI continues a workspace the other wrote.

* ``glimpse`` extracts the AOIs of raw Glimpse movies into ``data.tpqr``
  (``imscroll/glimpse_reader.py``), asking for each channel's missing
  files, and persists its options and ``channels`` to config.yaml;
* ``fit`` fits the model by SVI (``Model.run``), then computes the stats;
  with ``-R/--num-restarts`` R > 1 it first runs R chains at once for
  ``--restart-iter`` steps (``parallel/restarts.py``), writes
  ``.tapqir/<model>_restarts.json`` and continues the best chain; with
  ``--profile N`` it writes a ``torch.profiler`` trace of N steps under
  ``.tapqir/profile/`` instead and leaves the fit as it was;
* ``stats`` loads the checkpoint's parameters and computes the stats:
  p(specific), credible intervals, SNR / chi2 and, with ground-truth
  labels, MCC, recall and precision;
* ``fit`` and ``stats`` take ``--mesh``: ``auto`` (the default) shards over
  every visible card as an AOI mesh when there is more than one card, and
  runs on one device otherwise; ``none``, ``off`` and ``1x1`` mean one
  device; ``AxB`` is an explicit (aoi, frame) mesh, B dividing F, of at
  most as many shards as cards. A mesh runs one process per card
  (``parallel/sharding.py``); ``stats`` shards only the posterior
  marginals. ``--cpu`` ignores ``--mesh``, as the JAX command does;
* ``ttfb`` fits the time-to-first-binding model (ka, kns, Af) to z samples
  of a fit's posterior, per channel;
* ``dwelltime`` fits K-exponential mixtures to the bound and unbound dwell
  times of those samples (koff, kon), per channel;
* ``subset`` writes the AOIs listed in ``aoi_subset.txt`` to
  ``subset/data.tpqr``;
* ``log`` pages ``.tapqir/loginfo``.

Options of ``fit`` and ``stats`` not given on the command line are asked for
on the terminal unless ``--no-input``, in this process before any mesh
starts. Commands run on the CUDA card; ``--cpu`` asks for the CPU, and
without a card and without ``--cpu`` a command exits non-zero, as does a
mesh rank that fails. ``show`` is not ported yet and exits non-zero with a
message naming the ROADMAP item that ports it. Plots need matplotlib;
without it (or with the ``CI`` environment variable set) they are skipped
with a logged warning, as in the JAX package.
"""

import argparse
import copy
import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from tapqir_tpu_torch.device import resolve_device
from tapqir_tpu_torch.exceptions import CudaOutOfMemoryError, TapqirFileNotFoundError
from tapqir_tpu_torch.logger import init_logger
from tapqir_tpu_torch.parallel.sharding import MeshError, launch, make_mesh
from tapqir_tpu_torch.utils.config import dump_config, load_config
from tapqir_tpu_torch.utils.stats import hpdi, write_summary

AVAIL_MODELS = ["cosmos", "crosstalk", "cosmos+hmm"]

# glimpse's per-channel options, in the order of a channel's config keys:
# flag (= "--" + config key), option name, help
GLIMPSE_CHANNEL_OPTIONS = (
    ("--name", "names", "Channel name"),
    ("--glimpse-folder", "glimpse_folders", "Channel header/glimpse folder"),
    ("--driftlist", "driftlists", "Channel driftlist file"),
    ("--ontarget-aoiinfo", "ontarget_aoiinfos", "On-target aoiinfo file"),
    ("--offtarget-aoiinfo", "offtarget_aoiinfos", "Off-target aoiinfo file"),
    ("--ontarget-labels", "ontarget_labels", "On-target label intervals"),
    ("--offtarget-labels", "offtarget_labels", "Off-target label intervals"),
)

# the config a new workspace starts from (the JAX package's)
DEFAULT_CONFIG = {
    "P": 14,
    "nbatch-size": 10,
    "fbatch-size": 512,
    "learning-rate": 0.005,
    "num-channels": 1,
    "cuda": True,
    "matlab": False,
    "priors": {
        "background_mean_std": 1000,
        "background_std_std": 100,
        "lamda_rate": 1,
        "height_std": 10000,
        "width_min": 0.75,
        "width_max": 2.25,
        "proximity_rate": 1,
        "gain_std": 50,
    },
    "offset-x": 10,
    "offset-y": 10,
    "offset-P": 30,
    "bin-size": 1,
}

logger = logging.getLogger("tapqir_tpu_torch")


class CliError(Exception):
    """A command cannot run; the message says why."""


def _config_path(cd):
    return Path(cd) / ".tapqir" / "config.yaml"


def save_config(cd, config):
    _config_path(cd).write_text(dump_config(config))


def init_workspace(cd):
    """Create ``<cd>/.tapqir`` and its config.yaml where missing, start the
    log, and return the config."""
    workdir = Path(cd) / ".tapqir"
    first_time = not workdir.is_dir()
    workdir.mkdir(exist_ok=True)
    cfg = _config_path(cd)
    if not cfg.is_file():
        save_config(cd, copy.deepcopy(DEFAULT_CONFIG))
    init_logger(cd)
    if first_time:
        print(f"Initialized Tapqir workspace at {workdir}.")
    config = load_config(cfg.read_text())
    logger.info(f"Configuration options are read from {cfg}.")
    return config


# ---------------------------------------------------------------------------
# options and prompts
# ---------------------------------------------------------------------------


def _parser():
    S = argparse.SUPPRESS  # defaults come from the config, after --cd is known
    parser = argparse.ArgumentParser(
        prog="python -m tapqir_tpu_torch",
        description="Bayesian analysis of co-localization single-molecule "
                    "microscopy image data, in PyTorch on a CUDA card.",
    )
    parser.add_argument("--cd", type=Path, default=Path.cwd(),
                        help="Change working directory.")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--model", choices=AVAIL_MODELS, default=S, help="Tapqir model")
        p.add_argument("-S", "--num-states", dest="S", type=int, default=S,
                       help="Number of spot states")
        p.add_argument("--cpu", dest="cpu", action="store_true", default=S,
                       help="Run on the CPU instead of the CUDA card")
        p.add_argument("--cuda", dest="cpu", action="store_false", default=S,
                       help="Run on the CUDA card (the default)")
        p.add_argument("--nbatch-size", "-n", type=int, default=S, help="AOI batch size")
        p.add_argument("--fbatch-size", "-f", type=int, default=S,
                       help="Frame batch size")
        p.add_argument("--k-max", "-k", type=int, default=S,
                       help="Maximum number of spots per image")
        p.add_argument("--matlab", action="store_true", default=S,
                       help="Save parameters in matlab format")
        p.add_argument("--dtype", choices=["float32", "double"], default=S,
                       help="Floating point precision")
        p.add_argument("--mesh", type=str, default=S,
                       help="Multi-card mesh: 'auto' (default), 'none', or 'AxB'")
        p.add_argument("--no-input", action="store_true", default=S,
                       help="Disable interactive prompt.")

    fit = sub.add_parser("fit", help="Fit the data to the selected model, then "
                                     "compute the stats")
    common(fit)
    fit.add_argument("--learning-rate", "-lr", type=float, default=S,
                     help="Learning rate")
    fit.add_argument("--frame-sampling", choices=["random", "window"], default=S,
                     help="Frame minibatch scheme: independent random subsets or a "
                          "cyclic contiguous window")
    fit.add_argument("--num-iter", "-it", type=int, default=S,
                     help="Number of iterations (0 = run to convergence)")
    fit.add_argument("--num-restarts", "-R", type=int, default=S,
                     help="Batched random restarts: run R SVI chains at once for "
                          "--restart-iter steps, keep the best (by trailing -ELBO) "
                          "and continue it (default 1: no restarts)")
    fit.add_argument("--restart-iter", type=int, default=S,
                     help="Steps per restart chain before selection (default 2000)")
    fit.add_argument("--profile", type=int, default=S,
                     help="Profile N training steps and exit")
    fit.add_argument("--warm-start", dest="warm_start", action="store_true", default=S,
                     help="cosmos+hmm only: start from the workspace's cosmos fit")
    fit.add_argument("--no-warm-start", dest="warm_start", action="store_false",
                     default=S)
    fit.add_argument("--overwrite", "-w", action="store_true", default=S,
                     help="Persist these values to config.yaml")
    sub.add_parser("stats", help="Compute credible intervals and other statistics")
    common(sub.choices["stats"])

    def kinetics(p, num_samples, num_iter):
        p.add_argument("--model", choices=AVAIL_MODELS, default=S, help="Tapqir model")
        p.add_argument("-S", "--num-states", dest="S", type=int, default=S,
                       help="Number of spot states")
        p.add_argument("--k-max", "-k", type=int, default=S,
                       help="Maximum number of spots per image")
        p.add_argument("--cpu", dest="cpu", action="store_true", default=S,
                       help="Run on the CPU instead of the CUDA card")
        p.add_argument("--cuda", dest="cpu", action="store_false", default=S,
                       help="Run on the CUDA card (the default)")
        p.add_argument("--num-samples", "-n", type=int, default=S,
                       help=f"Number of posterior samples (default {num_samples})")
        p.add_argument("--num-iter", "-it", type=int, default=S,
                       help=f"Number of MLE iterations (default {num_iter})")

    ttfb_p = sub.add_parser("ttfb", help="Time-to-first-binding analysis")
    kinetics(ttfb_p, 2000, 15000)
    ttfb_p.add_argument("--binary", dest="binary", action="store_true", default=S,
                        help="Plot a binary rastergram")
    ttfb_p.add_argument("--probabilistic", dest="binary", action="store_false",
                        default=S, help="Plot a probabilistic rastergram (the default)")
    dwell_p = sub.add_parser("dwelltime", help="Dwell-time analysis: kon and koff")
    kinetics(dwell_p, 500, 10000)
    dwell_p.add_argument("-K", "--num-exponentials", dest="K", type=int, default=S,
                         help="Number of exponentials (default 3)")

    g = sub.add_parser("glimpse", help="Extract AOIs from raw Glimpse files into "
                                       "data.tpqr")
    g.add_argument("--dataset", default=S, help="Dataset name")
    g.add_argument("-P", "--aoi-size", dest="P", type=int, default=S, help="AOI image size")
    g.add_argument("--num-channels", "-C", type=int, default=S,
                   help="Number of color channels")
    g.add_argument("--offset-x", type=int, default=S, help="Offset region top-left x")
    g.add_argument("--offset-y", type=int, default=S, help="Offset region top-left y")
    g.add_argument("--offset-p", dest="offset_P", type=int, default=S,
                   help="Offset region size")
    g.add_argument("--bin-size", type=int, default=S, help="Offset histogram bin size")
    g.add_argument("--frame-start", type=int, default=S, help="First frame")
    g.add_argument("--frame-end", type=int, default=S, help="Last frame")
    g.add_argument("--use-offtarget", dest="use_offtarget", action="store_true",
                   default=S,
                   help="Use off-target control AOIs (default: config.yaml's, else on)")
    g.add_argument("--no-offtarget", dest="use_offtarget", action="store_false",
                   default=S)
    g.add_argument("--labels", dest="labels", action="store_true", default=S,
                   help="Parse spot-picker label intervals")
    g.add_argument("--no-labels", dest="labels", action="store_false", default=S)
    for flag, dest, text in GLIMPSE_CHANNEL_OPTIONS:
        g.add_argument(flag, dest=dest, action="append", default=S,
                       help=f"{text} (repeat per channel)")
    g.add_argument("--overwrite", "-w", action="store_true", default=S,
                   help="Persist these values to config.yaml")
    g.add_argument("--no-input", action="store_true", default=S,
                   help="Disable interactive prompt.")
    sub.add_parser("subset", help="Write the AOIs listed in aoi_subset.txt to "
                                  "subset/data.tpqr")
    sub.add_parser("log", help="Show logging info")
    # takes any arguments (none is an option here), so that it always
    # reaches the message naming the ROADMAP item
    show = sub.add_parser("show", prefix_chars="+", help="AOI viewer (not ported yet)")
    show.add_argument("args", nargs="*")
    return parser


def _defaults(command, config):
    if command == "fit":
        return {
            "model": "cosmos", "S": 1, "cpu": False,
            "nbatch_size": config.get("nbatch-size", 10),
            "fbatch_size": config.get("fbatch-size", 512),
            "learning_rate": config.get("learning-rate", 0.005),
            "frame_sampling": "random", "num_iter": 0, "k_max": 2,
            "num_restarts": 1, "restart_iter": 2000, "profile": 0,
            "matlab": bool(config.get("matlab", False)), "dtype": "float32",
            "warm_start": None, "mesh": "auto", "overwrite": True, "no_input": False,
        }
    if command == "glimpse":
        return {
            "dataset": config.get("dataset", "dataset"), "P": config.get("P", 14),
            "num_channels": config.get("num-channels", 1),
            "offset_x": config.get("offset-x", 10), "offset_y": config.get("offset-y", 10),
            "offset_P": config.get("offset-P", 30), "bin_size": config.get("bin-size", 1),
            "frame_start": config.get("frame-start"), "frame_end": config.get("frame-end"),
            "use_offtarget": bool(config.get("use-offtarget", True)), "labels": False,
            **{dest: [] for _, dest, _ in GLIMPSE_CHANNEL_OPTIONS},
            "overwrite": True, "no_input": False,
        }
    if command in ("subset", "log", "show"):
        return {}
    fitted = {"model": config.get("model", "cosmos"), "S": config.get("S", 1),
              "k_max": config.get("k-max", 2), "cpu": False}
    if command == "ttfb":
        return {**fitted, "binary": False, "num_samples": 2000, "num_iter": 15000}
    if command == "dwelltime":
        return {**fitted, "K": 3, "num_samples": 500, "num_iter": 10000}
    return {
        "model": config.get("model", "cosmos"), "S": config.get("S", 1), "cpu": False,
        "nbatch_size": config.get("nbatch-size", 10),
        "fbatch_size": config.get("fbatch-size", 512),
        "k_max": config.get("k-max", 2), "matlab": False, "dtype": "float32",
        "mesh": "auto", "no_input": False,
    }


def _choice(choices):
    def cast(text):
        if text not in choices:
            raise ValueError(text)
        return text

    return cast


def _make_prompter(given):
    """ask(name, value, text, ...): the value of an option given on the
    command line as it is; otherwise the answer on the terminal, the
    current value on an empty answer."""

    def ask(name, value, text, cast=None, is_bool=False):
        if name in given:
            return value
        if is_bool:
            hint = "Y/n" if value else "y/N"
            while True:
                answer = input(f"{text} [{hint}]: ").strip().lower()
                if not answer:
                    return bool(value)
                if answer in ("y", "yes", "n", "no"):
                    return answer.startswith("y")
                print("Error: invalid input")
        cast = cast or type(value)
        while True:
            answer = input(f"{text} [{value}]: ").strip()
            if not answer:
                return value
            try:
                return cast(answer)
            except ValueError:
                print(f"Error: {answer!r} is not a valid value.")

    return ask


def _make_model(model, S, k_max, cpu, dtype, priors, device=None):
    """The model on ``device`` (a mesh rank's), else on the card, or on the
    CPU with ``cpu``."""
    from tapqir_tpu_torch.models import models

    if device is None:
        try:
            device = resolve_device("cpu" if cpu else None)
        except RuntimeError as err:
            raise CliError(str(err)) from err
    return models[model](S=S, K=k_max, device=device, dtype=dtype, priors=priors)


def _resolve_mesh(cd, mesh_opt):
    """The ("aoi", "frame") mesh of ``--mesh`` over the visible cards, or
    None for one device (JAX: ``_resolve_mesh``): "auto" is an AOI mesh over
    every card when there is more than one; "none", "off" and "1x1" are one
    device; "AxB" needs B to divide F (the frame axis is not padded; AOI
    counts are) and A x B cards."""
    if mesh_opt in (None, "none", "off", "1x1"):
        return None
    n_cards = torch.cuda.device_count()
    if mesh_opt == "auto":
        if n_cards <= 1:
            return None
        logger.info(f"Auto mesh: {n_cards} aoi x 1 frame over {n_cards} devices")
        return make_mesh(n_cards, 1)
    try:
        n_a, n_f = (int(x) for x in mesh_opt.lower().split("x"))
    except ValueError:
        raise CliError(f"--mesh must be 'auto', 'none' or 'AxB', got {mesh_opt!r}") from None
    if n_a * n_f <= 1:
        return None
    from tapqir_tpu_torch.utils.dataset import load

    F = load(cd).F
    if F % n_f:
        raise CliError(f"mesh frame axis {n_f} must divide F={F} (the frame axis is not "
                       "padded); AOI counts are padded automatically")
    if n_a * n_f > n_cards:
        raise CliError(f"need {n_a * n_f} devices, have {n_cards}")
    return make_mesh(n_a, n_f)


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------


def _cosmos_fit_for_warm_start(cd, asked):
    """Whether the workspace holds a cosmos fit to warm-start from;
    ``asked`` (``--warm-start``) requires one."""
    cosmos_ckpt = Path(cd) / ".tapqir" / "cosmos_model.tpqr"
    if not cosmos_ckpt.exists() and asked:
        raise CliError(
            f"--warm-start requires a cosmos fit in this workspace ({cosmos_ckpt} "
            "not found); run `fit --model cosmos` first"
        )
    return cosmos_ckpt.exists()


def _warm_start(cd, model, asked):
    """cosmos -> cosmos+hmm warm start: by default for a fresh hmm fit when
    the workspace holds a cosmos fit; ``asked`` (``--warm-start``) requires
    that fit and warm-starts a resumed hmm fit too."""
    if not _cosmos_fit_for_warm_start(cd, asked):
        return
    if model.iter == 0 or asked:
        logger.info("Warm-starting cosmos+hmm from the cosmos fit (--no-warm-start "
                    "to disable)")
        model.warm_start_from_cosmos()


def _restarts(model, num_restarts, restart_iter, mesh=None):
    """R chains for ``restart_iter`` steps, the best kept: the selection in
    ``<model>_restarts.json``, the winner checkpointed before ``run``
    continues it. On a mesh every chain shards the data
    (``fit_restarts_sharded``) and the first rank writes the files."""
    from tapqir_tpu_torch.parallel.restarts import fit_restarts
    from tapqir_tpu_torch.parallel.sharding import fit_restarts_sharded

    logger.info(f"Running {num_restarts} batched random restarts ...")
    kwargs = dict(
        num_restarts=num_restarts, num_iter=restart_iter,
        progress=lambda it, loss: logger.info(f"restarts @{it}: best -ELBO {loss:.1f}"),
    )
    try:
        if mesh is None:
            losses, best = fit_restarts(model, **kwargs)
        else:
            losses, best = fit_restarts_sharded(model, mesh, **kwargs)
    except torch.cuda.OutOfMemoryError as err:
        raise CudaOutOfMemoryError() from err
    logger.info(f"Selected restart #{best}")
    if mesh is None or mesh.is_main:
        with open(model.run_path / f"{model.name}_restarts.json", "w") as fh:
            json.dump({
                "num_restarts": num_restarts,
                "restart_iter": restart_iter,
                "best_chain": int(best),
                "final_losses": [float(x) for x in losses[:, -1]],
            }, fh)
    model.save_checkpoint()
    logger.info("Continuing the winning chain ...")


def _fit_model(cd, opts, m, mesh=None):
    """Load, initialize and fit ``m``, then compute the stats; on a mesh
    (every rank calls this with its ``RankMesh``) the fit and the
    posterior marginals are sharded."""
    m.frame_sampling = opts["frame_sampling"]
    m.load(cd)
    m.init(opts["learning_rate"], opts["nbatch_size"], opts["fbatch_size"])
    if opts["model"] == "cosmos+hmm" and opts["warm_start"] is not False:
        _warm_start(cd, m, opts["warm_start"])
    if opts["profile"]:
        out = m.profile_trace(num_steps=opts["profile"])
        logger.info(f"Profiler trace written to {out}")
        return
    if opts["num_restarts"] > 1:
        _restarts(m, opts["num_restarts"], opts["restart_iter"], mesh)
    elif mesh is not None:
        m.use_mesh(mesh)
    m.run(opts["num_iter"])
    logger.info("Fitting the data: Done")

    logger.info("Computing stats ...")
    m.compute_stats(save_matlab=opts["matlab"])
    logger.info("Computing stats: Done")


def _fit_on_mesh(mesh, cd, opts, priors):
    """``fit`` in one rank of a mesh (the first rank logs)."""
    if mesh.is_main:
        init_logger(cd)
    m = _make_model(opts["model"], opts["S"], opts["k_max"], False, opts["dtype"], priors,
                    device=mesh.device)
    _fit_model(cd, opts, m, mesh)


def _stats_on_mesh(mesh, cd, opts, priors, lr):
    """``stats`` in one rank of a mesh: the posterior marginals sharded."""
    if mesh.is_main:
        init_logger(cd)
    m = _make_model(opts["model"], opts["S"], opts["k_max"], False, opts["dtype"], priors,
                    device=mesh.device)
    m.load(cd)
    m.init(lr, opts["nbatch_size"], opts["fbatch_size"])
    m.load_checkpoint(param_only=True)
    m.use_mesh(mesh)
    m.compute_stats(save_matlab=opts["matlab"])


def fit(cd, config, opts, given):
    """Fit the data to the selected model, then compute the stats."""
    if not opts["no_input"]:
        ask = _make_prompter(given)
        opts["model"] = ask("model", opts["model"], "Tapqir model",
                            cast=_choice(AVAIL_MODELS))
        opts["S"] = ask("S", opts["S"], "Number of spot states")
        opts["cpu"] = not ask("cpu", not opts["cpu"],
                              "Run computations on the accelerator?", is_bool=True)
        opts["nbatch_size"] = ask("nbatch_size", opts["nbatch_size"], "AOI batch size")
        opts["fbatch_size"] = ask("fbatch_size", opts["fbatch_size"], "Frame batch size")
        opts["learning_rate"] = ask("learning_rate", opts["learning_rate"],
                                    "Learning rate")
        opts["num_iter"] = ask("num_iter", opts["num_iter"],
                               "Number of iterations (0 = run to convergence)")
        opts["matlab"] = ask("matlab", opts["matlab"],
                             "Save parameters in matlab format?", is_bool=True)
        opts["overwrite"] = ask("overwrite", opts["overwrite"],
                                "Overwrite default values?", is_bool=True)

    if opts["overwrite"]:
        config.update({
            "cuda": not opts["cpu"],
            "nbatch-size": opts["nbatch_size"],
            "fbatch-size": opts["fbatch_size"],
            "learning-rate": opts["learning_rate"],
            "matlab": opts["matlab"],
            # the model topology, so that stats rebuilds the model of the fit
            "model": opts["model"],
            "S": opts["S"],
            "k-max": opts["k_max"],
        })
        save_config(cd, config)

    logger.info("Fitting the data ...")
    # --cpu ignores --mesh, and --profile profiles one device, as in the JAX
    # package
    mesh = None if opts["cpu"] or opts["profile"] else _resolve_mesh(cd, opts["mesh"])
    if mesh is not None:
        if opts["model"] == "cosmos+hmm" and opts["warm_start"]:
            _cosmos_fit_for_warm_start(cd, True)
        launch(mesh, _fit_on_mesh, cd, opts, config.get("priors"))
        return
    m = _make_model(opts["model"], opts["S"], opts["k_max"], opts["cpu"], opts["dtype"],
                    config.get("priors"))
    _fit_model(cd, opts, m)


def stats(cd, config, opts, given):
    """Compute credible intervals and other statistics of a fitted model."""
    if not opts["no_input"]:
        ask = _make_prompter(given)
        opts["model"] = ask("model", opts["model"], "Tapqir model",
                            cast=_choice(AVAIL_MODELS))
        opts["cpu"] = not ask("cpu", not opts["cpu"],
                              "Run computations on the accelerator?", is_bool=True)
        opts["matlab"] = ask("matlab", opts["matlab"],
                             "Save parameters in matlab format?", is_bool=True)

    logger.info("Computing stats ...")
    mesh = None if opts["cpu"] else _resolve_mesh(cd, opts["mesh"])
    if mesh is not None:
        launch(mesh, _stats_on_mesh, cd, opts, config.get("priors"),
               config.get("learning-rate", 0.005))
        logger.info("Computing stats: Done")
        return
    m = _make_model(opts["model"], opts["S"], opts["k_max"], opts["cpu"], opts["dtype"],
                    config.get("priors"))
    m.load(cd)
    m.init(config.get("learning-rate", 0.005), opts["nbatch_size"], opts["fbatch_size"])
    m.load_checkpoint(param_only=True)
    m.compute_stats(save_matlab=opts["matlab"])
    logger.info("Computing stats: Done")


def _load_fit(cd, config, opts):
    """The workspace's fitted model (float32, as the JAX package's kinetics
    commands build it) with its checkpoint's parameters and its saved
    stats."""
    m = _make_model(opts["model"], opts["S"], opts["k_max"], opts["cpu"], "float32",
                    config.get("priors"))
    m.load(cd, data_only=False)
    m.init(config.get("learning-rate", 0.005), config.get("nbatch-size", 10),
           config.get("fbatch-size", 512))
    m.load_checkpoint(param_only=True)
    return m


def _write_table(path, index, columns, rows):
    """A table as ``pandas.DataFrame(...).to_csv(path)`` writes it: an
    unnamed index column, then ``columns``; ``rows`` align with ``index``."""
    write_summary({i: dict(zip(columns, row)) for i, row in zip(index, rows)}, path)


def _write_intervals(path, rows):
    """``rows`` {name: (Mean, LL, UL)} as the JAX package's kinetics
    parameter tables."""
    _write_table(path, list(rows), ["Mean", "95% LL", "95% UL"], rows.values())


def _hpdi_row(vals):
    ll, ul = hpdi(vals, 0.95)
    return float(vals.mean()), float(ll), float(ul)


def _plot(out_path, draw):
    """Draw one figure with ``draw(ax)`` into ``out_path``; skipped under
    the ``CI`` environment variable, and a failure (matplotlib missing
    included) is a logged warning, as in the JAX package."""
    if os.environ.get("CI"):
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        draw(ax)
        fig.savefig(out_path, dpi=300)
        plt.close(fig)
    except Exception as err:  # plotting must never fail the pipeline
        logger.warning(f"plotting failed: {err}")


def _draw_rastergram(z_sorted, title):
    def draw(ax):
        ax.imshow(z_sorted, vmin=0, vmax=1, aspect="auto", interpolation="none")
        ax.set_xlabel("Time (frame)")
        ax.set_ylabel("AOI")
        ax.set_title(title)

    return draw


def _draw_fraction_bound(t, fb_mean, fb_ll, fb_ul, best_fit, title):
    def draw(ax):
        ax.fill_between(t, fb_ll, fb_ul, alpha=0.3, color="C2")
        ax.plot(t, fb_mean, color="C2", label="fraction bound")
        ax.plot(t, best_fit, color="k", label="best fit")
        ax.set_xlabel("Time (frame)")
        ax.set_ylabel("Cumulative fraction")
        ax.set_ylim(-0.05, 1.05)
        ax.set_title(title)
        ax.legend()

    return draw


def _draw_dwelltime_hist(dwell_times, fit, K, title):
    def draw(ax):
        dt = dwell_times()
        vals = dt[dt > 0]
        if vals.size:
            ax.hist(vals, bins=min(100, max(10, int(vals.max()))), density=True)
        t = np.arange(max(2, int(dt.max())))
        y = 0
        for i in range(K):
            A_i, k_i = float(fit["A"][:, i].mean()), float(fit["k"][:, i].mean())
            y = y + A_i * k_i * np.exp(-k_i * t)
            ax.plot(A_i * k_i * np.exp(-k_i * t), "k--")
        ax.plot(y, "k-")
        ax.set_xlabel("Time interval (frame)")
        ax.set_ylabel("Density")
        ax.set_title(title)

    return draw


def ttfb(cd, config, opts, given):
    """Time-to-first-binding analysis: per channel, the ttfb of every
    posterior z sample and AOI, the MLE of ka, kns and Af per sample, their
    means and 95% HPD intervals, and the fraction bound against the best
    fit."""
    from tapqir_tpu_torch.utils.imscroll import time_to_first_binding
    from tapqir_tpu_torch.utils.mle_analysis import ttfb_mle

    cd = Path(cd)
    m = _load_fit(cd, config, opts)
    p_specific = np.asarray(m.params_stats["p_specific"])
    z = (p_specific > 0.5) if opts["binary"] else p_specific
    r_type = "binary" if opts["binary"] else "probabilistic"
    z_samples = m.z_sample(num_samples=opts["num_samples"])
    mask = m.data.mask[: m.data.N]
    z_samples_masked = z_samples[:, mask]
    Tmax = m.data.F
    for c in range(m.data.C):
        logger.info(f"Channel #{c} ({m.data.channels[c]})")
        z_masked = z[: m.data.N, :, c][mask]
        sdx = np.argsort(-time_to_first_binding(z_masked))
        png = f"{m.name}_ttfb-rastergram-channel{c}.png"
        _plot(cd / png, _draw_rastergram(z_masked[sdx], f"Channel {c}"))
        logger.info(f"Saved a {r_type} rastergram in {png}")

        data = time_to_first_binding(z_samples_masked[..., c])  # (samples, AOIs)
        _write_table(cd / f"{m.name}_ttfb-data-points-channel{c}.csv",
                     range(data.shape[0]), range(data.shape[1]), data)

        fit = ttfb_mle(data, None, Tmax, lr=5e-3, n_steps=opts["num_iter"],
                       device=m.device)
        rows = {par: _hpdi_row(fit[par].squeeze(-1)) for par in ("ka", "kns", "Af")}
        _write_intervals(cd / f"{m.name}_ttfb-params-channel{c}.csv", rows)
        logger.info(f"Saved fit parameters in {m.name}_ttfb-params-channel{c}.csv")

        # the fraction bound against the best fit
        nz = (data == 0).sum(1, keepdims=True)
        N = data.shape[1]
        t = np.arange(Tmax)
        fraction_bound = (data[..., None] < t).mean(1)
        fb_ll, fb_ul = np.quantile(fraction_bound, [0.025, 0.975], axis=0)
        fb_mean = fraction_bound.mean(0)
        ka_m, kns_m, Af_m = (rows[par][0] for par in ("ka", "kns", "Af"))
        best_fit = (
            nz / N
            + (1 - nz / N)
            * (Af_m * (1 - np.exp(-(ka_m + kns_m) * t))
               + (1 - Af_m) * (1 - np.exp(-kns_m * t)))
        ).mean(0)
        _write_table(cd / f"{m.name}_ttfb-fraction-bound-channel{c}.csv", range(Tmax),
                     ["time", "best fit", "fraction bound mean", "fraction bound 95% ll",
                      "fraction bound 95% ul"],
                     zip(t, best_fit, fb_mean, fb_ll, fb_ul))
        _plot(cd / f"{m.name}_ttfb-plot-channel{c}.png",
              _draw_fraction_bound(t, fb_mean, fb_ll, fb_ul, best_fit, f"Channel {c}"))
        logger.info(f"Saved data plots in {m.name}_ttfb-plot-channel{c}.png")


def dwelltime(cd, config, opts, given):
    """Dwell-time analysis: per channel, the intervals of every posterior z
    sample (``.mat``), and K-exponential MLE fits of the bound (koff) and
    unbound (kon) dwell times per sample, with their means and 95% HPD
    intervals."""
    from scipy.io import savemat

    from tapqir_tpu_torch.utils.imscroll import (
        bound_dwell_times,
        count_intervals,
        unbound_dwell_times,
    )
    from tapqir_tpu_torch.utils.mle_analysis import exp_mle

    cd = Path(cd)
    K = opts["K"]
    m = _load_fit(cd, config, opts)
    z_samples = m.z_sample(num_samples=opts["num_samples"])
    mask = m.data.mask[: m.data.N]
    z_samples_masked = z_samples[:, mask]
    z_map = np.asarray(m.params_stats["z_map"])
    for c in range(m.data.C):
        logger.info(f"Channel #{c} ({m.data.channels[c]})")
        intervals = count_intervals(z_samples_masked[..., c])
        # the JAX package also pickles its DataFrame (.pkl); the port writes
        # the .mat file only (ROADMAP Queue C). Integer columns as int64, as
        # savemat stores the JAX package's lists of Python ints.
        savemat(cd / f"{m.name}_dwelltime-intervals-channel{c}.mat",
                {k: np.asarray(v, np.int64) for k, v in intervals.items()})
        logger.info(f"Saved time intervals in {m.name}_dwelltime-intervals-channel{c}")

        z_map_intervals = count_intervals(z_map[: m.data.N][None, mask, :, c])
        for state, tag, rate_name in ((1, "bound", "koff"), (0, "unbound", "kon")):
            logger.info(f"{rate_name} calculation ...")
            dwell = bound_dwell_times if state else unbound_dwell_times
            fit = exp_mle(dwell(intervals), K, lr=5e-3, n_steps=opts["num_iter"],
                          device=m.device)
            rows = {}
            for i in range(K):
                rows[f"A{i}"] = _hpdi_row(fit["A"][:, i])
                rows[f"{rate_name}{i}"] = _hpdi_row(fit["k"][:, i])
            csv_name = f"{m.name}_dwelltime-{rate_name}-channel{c}.csv"
            _write_intervals(cd / csv_name, rows)
            logger.info(f"Saved {rate_name} parameters in {csv_name}")
            # the histogram's dwell times of z_map are made only to be drawn:
            # the JAX package makes them first and fails the command when
            # z_map has no complete interval (ROADMAP Queue C)
            _plot(cd / f"{m.name}_dwelltime-{tag}-histogram-channel{c}.png",
                  _draw_dwelltime_hist(lambda: dwell(z_map_intervals)[0], fit, K,
                                       f"{tag.capitalize()} dwell times channel {c}"))


def _ask_required(text):
    """An answer on the terminal to ``text``; asked again while empty."""
    while True:
        answer = input(f"{text}: ").strip()
        if answer:
            return answer


def glimpse(cd, config, opts, given):
    """Extract the AOIs of raw Glimpse movies into ``data.tpqr``: the
    channels' files from the command line, else from config.yaml, else
    asked for (an error under ``--no-input``); the options and the channels
    are persisted to config.yaml (``--overwrite``, always on as in the JAX
    package)."""
    from tapqir_tpu_torch.imscroll import read_glimpse

    C = opts["num_channels"]
    # a copy: prompted values reach the config only through the persisting
    # below, never a later command of the same process otherwise
    channels = copy.deepcopy(config.get("channels") or [])
    for c in range(C):
        if c >= len(channels):
            channels.append({})
        ch = channels[c]
        for flag, dest, _ in GLIMPSE_CHANNEL_OPTIONS:
            key = flag[2:]
            if c < len(opts[dest]):
                ch[key] = str(opts[dest][c])
            elif key.endswith("-labels"):
                ch[key] = ch.get(key)  # the JAX package writes a null
        required = ["name", "glimpse-folder", "driftlist", "ontarget-aoiinfo"]
        if opts["use_offtarget"]:
            required.append("offtarget-aoiinfo")
        for key in required:
            if ch.get(key) is None:
                if opts["no_input"]:
                    raise CliError(f"channel {c}: missing required option '{key}'")
                ch[key] = _ask_required(f"Channel #{c}: {key}")
    channels = channels[:C]

    settings = {
        "dataset": opts["dataset"],
        "P": opts["P"],
        "num-channels": C,
        "offset-x": opts["offset_x"],
        "offset-y": opts["offset_y"],
        "offset-P": opts["offset_P"],
        "bin-size": opts["bin_size"],
        "frame-start": opts["frame_start"],
        "frame-end": opts["frame_end"],
        "use-offtarget": opts["use_offtarget"],
    }
    if opts["overwrite"]:
        config.update({**settings, "channels": channels})
        save_config(cd, config)

    logger.info("Extracting AOIs ...")
    read_glimpse(cd, **settings, **{
        "channels": channels,
        "frame-range": opts["frame_start"] is not None and opts["frame_end"] is not None,
        "labels": opts["labels"],
    })
    logger.info("Extracting AOIs: Done")


def subset(cd, config, opts, given):
    """Write the AOIs listed in ``aoi_subset.txt`` (one line of
    comma-separated indices) to ``subset/data.tpqr``. The labels are passed
    on whole, not subset, as in the JAX package."""
    from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData, load, save

    path = Path(cd)
    subset_path = path / "subset"
    subset_path.mkdir(exist_ok=True)
    data = load(path)
    with open(path / "aoi_subset.txt") as f:
        line = f.readline().rstrip("\n")
    idx = [int(i.strip()) for i in line.split(",")]
    save(CosmosDataset(
        images=data.images[idx],
        xy=data.xy[idx],
        is_ontarget=data.is_ontarget[idx],
        mask=data.mask[idx],
        labels=data.labels,
        offset=OffsetData(data.offset.samples, data.offset.weights),
        time1=data.time1,
        ttb=data.ttb,
        name=data.name,
        channels=data.channels,
    ), subset_path)
    logger.info("Created a new data file at `subset/data.tpqr`")


def log(cd, config, opts, given):
    """Page the workspace's log file ``.tapqir/loginfo``."""
    import pydoc

    pydoc.pager((Path(cd) / ".tapqir" / "loginfo").read_text())


def show(cd, config, opts, given):
    raise CliError("show (the AOI viewer) is not ported yet (ROADMAP Queue A item 9)")


COMMANDS = {"glimpse": glimpse, "fit": fit, "stats": stats, "ttfb": ttfb,
            "dwelltime": dwelltime, "subset": subset, "log": log, "show": show}


def main(argv=None) -> int:
    """Run one command; returns the exit code (argument errors exit with 2)."""
    parser = _parser()
    ns = parser.parse_args(argv)
    if not ns.cd.is_dir():
        parser.error(f"--cd: directory {ns.cd} does not exist")
    given = set(vars(ns)) - {"cd", "command"}
    config = init_workspace(ns.cd)
    opts = {**_defaults(ns.command, config), **{k: getattr(ns, k) for k in given}}
    try:
        COMMANDS[ns.command](ns.cd, config, opts, given)
    except CliError as err:
        logger.error(str(err))
        return 1
    except TapqirFileNotFoundError as err:
        logger.exception(f"Failed to load {err.name} file")
        return 1
    except CudaOutOfMemoryError:
        logger.exception("Failed to fit the data")
        return 1
    except MeshError as err:
        logger.error(str(err))
        return 1
    return 0

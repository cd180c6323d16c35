"""Posterior summaries: credible intervals, SNR / chi2 and classification
metrics (counterpart of tapqir_tpu/utils/stats.py).

The credible intervals are computed on the host with scipy from the fitted
variational parameters, as in the JAX package; SNR and chi2 run on the
model's device with torch, in chunks of AOIs. The classification metrics
(MCC, recall, precision, confusion counts) are numpy with scikit-learn's
conventions, and the summary CSV is written with the ``csv`` module in the
layout ``pandas.DataFrame.to_csv`` gives the JAX package's summary, so
``pandas.read_csv(path, index_col=0)`` reads the same frame from either.
"""

import csv
import json
import logging
import os
import time
from pathlib import Path

import numpy as np
import scipy.stats as st
import torch

from tapqir_tpu_torch.distributions.core import dirichlet_mean, gamma_mean
from tapqir_tpu_torch.distributions.util import gaussian_spots

logger = logging.getLogger(__name__)

__all__ = [
    "snr_and_chi2", "save_stats", "ci_from_scipy", "hpdi", "quantile",
    "matthews_corrcoef", "recall_score", "precision_score", "confusion_matrix",
    "read_summary", "write_summary",
]


def quantile(samples, q):
    return np.quantile(np.asarray(samples, np.float64), q)


def hpdi(samples, prob):
    """Highest posterior density interval: the narrowest interval holding a
    fraction ``prob`` of the samples."""
    sorted_ = np.sort(np.asarray(samples, np.float64).ravel())
    n = len(sorted_)
    mass = max(1, int(np.floor(prob * n)))
    widths = sorted_[mass - 1:] - sorted_[: n - mass + 1]
    start = int(np.argmin(widths))
    return sorted_[start], sorted_[start + mass - 1]


def ci_from_scipy(dist_name, CI, **kw):
    """{"Mean", "LL", "UL"} of a guide family at credible level ``CI``.

    ``dist_name`` is "gamma" (concentration, rate), "affine_beta" (mean,
    sample_size, low, high) or "dirichlet" (concentration; per-component
    Beta marginals); the keyword arguments are the family's constrained
    parameters as numpy arrays.
    """
    if dist_name == "gamma":
        conc, rate = np.asarray(kw["concentration"]), np.asarray(kw["rate"])
        d = st.gamma(conc, scale=1.0 / rate)
        mean = gamma_mean(conc, rate)
    elif dist_name == "affine_beta":
        mean = np.asarray(kw["mean"])
        size = np.asarray(kw["sample_size"])
        low, high = kw["low"], kw["high"]
        c1 = size * (mean - low) / (high - low)
        c0 = size * (high - mean) / (high - low)
        d = st.beta(a=c1, b=c0, loc=low, scale=high - low)
    elif dist_name == "dirichlet":
        conc = np.asarray(kw["concentration"])
        d = st.beta(a=conc, b=conc.sum(-1, keepdims=True) - conc)
        mean = dirichlet_mean(conc)
    else:
        raise NotImplementedError(dist_name)
    LL, UL = d.interval(CI)
    return {"Mean": np.asarray(mean), "LL": np.asarray(LL), "UL": np.asarray(UL)}


def snr_and_chi2(
    data, height, width, x, y, target_locs, background, gain,
    offset_mean, offset_var, P, theta_probs,
):
    r"""Signal-to-noise ratio per spot and chi2 statistic per image.

    SNR = sum_ij (D - b - offset_mean) N(i, j | x, y, w) / sqrt(offset_var +
    b gain), chi2 = mean_ij (D - ideal image - offset_mean)^2 / ideal image.
    Tensors in the (..., K)-last layout: height, width, x, y (N, F, Q, K),
    data (N, F, C, P, P), target_locs (N, F, C, 2), background (N, F, C).
    Returns snr (N, F, C, K) and chi2 (N, F, C).
    """
    del theta_probs  # the caller selects spots, as in the JAX package
    gaussians = gaussian_spots(height, width, x, y, target_locs, P)  # (N, F, C, K, P, P)
    weights = gaussians / height[..., None, None]
    resid = (data - background[..., None, None] - offset_mean)[..., None, :, :]
    signal = (resid * weights).sum((-2, -1))  # (N, F, C, K)
    noise = torch.sqrt(offset_var + background * gain)
    snr = signal / noise[..., None]

    img_ideal = background[..., None, None] + gaussians.sum(-3)  # (N, F, C, P, P)
    chi2 = ((data - img_ideal - offset_mean) ** 2 / img_ideal).mean((-2, -1))
    return snr, chi2


def _compute_snr_chi2(model, ci_stats, chunk=64):
    """Whole-dataset SNR (K, Nt, F, Q) and chi2 (Nt, F, Q) as float64 numpy,
    computed in float32 on the model's device (as the JAX package computes
    them), ``chunk`` AOIs at a time."""
    data = model.data
    height = np.moveaxis(ci_stats["height"]["Mean"], 0, -1)  # (Nt, F, Q, K)
    width = np.moveaxis(ci_stats["width"]["Mean"], 0, -1)
    xm = np.moveaxis(ci_stats["x"]["Mean"], 0, -1)
    ym = np.moveaxis(ci_stats["y"]["Mean"], 0, -1)
    bg = ci_stats["background"]["Mean"]  # (Nt, F, C)
    gain = float(np.asarray(ci_stats["gain"]["Mean"]))

    def put(a):
        return torch.as_tensor(np.asarray(a)).to(device=model.device, dtype=torch.float32)

    snr = np.zeros((data.Nt, data.F, model.Q, model.K), np.float64)
    chi2 = np.zeros((data.Nt, data.F, model.Q), np.float64)
    with torch.no_grad():
        for i in range(0, data.Nt, chunk):
            sl = slice(i, min(i + chunk, data.Nt))
            s, c = snr_and_chi2(
                put(data.images[sl]), put(height[sl]), put(width[sl]), put(xm[sl]),
                put(ym[sl]), put(data.xy[sl]), put(bg[sl]), gain,
                data.offset.mean, data.offset.var, data.P, None,
            )
            snr[sl] = s.cpu().numpy()
            chi2[sl] = c.cpu().numpy()
    return np.moveaxis(snr, -1, 0), chi2


# ---------------------------------------------------------------------------
# classification metrics (scikit-learn's conventions)
# ---------------------------------------------------------------------------


def confusion_matrix(y_true, y_pred, labels):
    """C[i, j]: the samples of true label ``labels[i]`` predicted as
    ``labels[j]``; labels outside ``labels`` are not counted."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    return np.array([[int(np.sum((y_true == t) & (y_pred == p))) for p in labels]
                     for t in labels], np.int64)


def matthews_corrcoef(y_true, y_pred):
    """Matthews correlation coefficient over the labels present in either
    array (multiclass form); 0 where a margin of the confusion matrix leaves
    the correlation undefined."""
    labels = np.union1d(np.asarray(y_true).ravel(), np.asarray(y_pred).ravel())
    C = confusion_matrix(y_true, y_pred, labels).astype(np.float64)
    t_sum, p_sum = C.sum(1), C.sum(0)
    n_correct, n = np.trace(C), C.sum()
    cov_ytyp = n_correct * n - t_sum @ p_sum
    cov_ypyp = n * n - p_sum @ p_sum
    cov_ytyt = n * n - t_sum @ t_sum
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


def recall_score(y_true, y_pred):
    """TP / (TP + FN) for the positive label 1; 0 when there is no positive."""
    (_, _), (fn, tp) = confusion_matrix(y_true, y_pred, (0, 1))
    return float(tp / (tp + fn)) if tp + fn else 0.0


def precision_score(y_true, y_pred):
    """TP / (TP + FP) for the positive label 1; 0 when none is predicted."""
    (_, fp), (_, tp) = confusion_matrix(y_true, y_pred, (0, 1))
    return float(tp / (tp + fp)) if tp + fp else 0.0


# ---------------------------------------------------------------------------
# summary table: {row: {column: value}}, value a number, a list or None
# ---------------------------------------------------------------------------


def _cell(value):
    """A cell as ``DataFrame.to_csv`` writes an object column: ``str`` of
    the value, nothing for a missing one."""
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return ""
    return str(value)


def write_summary(summary, path):
    """Write ``summary`` (rows in order, each {column: value}) as CSV with
    an unnamed index column."""
    columns = list(next(iter(summary.values())))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + columns)
        for row, cells in summary.items():
            writer.writerow([row] + [_cell(cells[c]) for c in columns])


def _parse(cell):
    if cell == "":
        return None
    if cell.startswith("["):  # str() of a (nested) list of floats
        return json.loads(cell.replace("nan", "NaN").replace("inf", "Infinity"))
    for cast in (int, float):
        try:
            return cast(cell)
        except ValueError:
            pass
    return cell


def read_summary(path):
    """Read a summary CSV written by either package into {row: {column:
    value}}, numbers as int or float, vector cells as lists, empty cells as
    None."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    columns = rows[0][1:]
    return {r[0]: dict(zip(columns, map(_parse, r[1:]))) for r in rows[1:]}


# ---------------------------------------------------------------------------
# save_stats
# ---------------------------------------------------------------------------


def _plot_rastergram(model, ci_stats, path):
    """p(specific) rastergram per channel; skipped under the ``CI``
    environment variable, and a failure (matplotlib missing included) is a
    logged warning, as in the JAX package."""
    if os.environ.get("CI", None):
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for c in range(model.data.C):
            fig, ax = plt.subplots()
            ax.imshow(
                ci_stats["p_specific"][: model.data.N, :, c][
                    model.data.mask[: model.data.N]
                ],
                vmin=0, vmax=1, aspect="auto", interpolation="none",
            )
            ax.set_xlabel("Time (frame)")
            ax.set_ylabel("AOI")
            ax.set_title(f"Channel {c}")
            fig.savefig(Path(path) / f"{model.name}_rastergram-channel{c}.png", dpi=300)
            plt.close(fig)
    except Exception as err:  # plotting must never fail the pipeline
        logger.warning(f"rastergram plotting failed: {err}")


def save_stats(model, path, CI=0.95, save_matlab=False):
    """Summary statistics and the parameter export: ``<model>_params.tpqr``
    (npz, ``param/stat`` keys), ``<model>_summary.csv`` and, with
    ``save_matlab``, ``<model>_params.mat``. Returns the summary and sets
    ``model.summary``, ``model.params_stats`` and ``model.stats_seconds``
    (the seconds of each stage: probabilities, credible intervals, SNR/chi2,
    files)."""
    seconds = {}
    t0 = time.perf_counter()
    ll_col = f"{int(100 * CI)}% LL"
    ul_col = f"{int(100 * CI)}% UL"
    summary = {p: dict.fromkeys(("Mean", ll_col, ul_col)) for p in model._global_params}

    logger.info("- credible intervals & spot probabilities")
    model.compute_probs  # noqa: B018 - fills the cache compute_params reads
    seconds["probabilities"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ci_stats = model.compute_params(CI)
    for param in model._global_params:
        row, ci = summary[param], ci_stats[param]
        if np.ndim(ci["Mean"]) == 0:
            row.update({"Mean": float(ci["Mean"]), ll_col: float(ci["LL"]),
                        ul_col: float(ci["UL"])})
        else:
            row.update({"Mean": np.asarray(ci["Mean"]).tolist(),
                        ll_col: np.asarray(ci["LL"]).tolist(),
                        ul_col: np.asarray(ci["UL"]).tolist()})

    if path is not None:
        _plot_rastergram(model, ci_stats, path)

    # display ranges
    theta_mask = ci_stats["theta_probs"] > 0.5
    hmax = (
        np.percentile(ci_stats["height"]["Mean"][theta_mask], 99)
        if theta_mask.sum()
        else 1.0
    )
    ci_stats["height"]["vmin"] = -0.03 * hmax
    ci_stats["height"]["vmax"] = 1.3 * hmax
    ci_stats["width"]["vmin"] = 0.5
    ci_stats["width"]["vmax"] = 2.5
    for p in ("x", "y"):
        ci_stats[p]["vmin"] = -9
        ci_stats[p]["vmax"] = 9
    bmax = np.percentile(np.asarray(ci_stats["background"]["Mean"]).ravel(), 99)
    ci_stats["background"]["vmin"] = -0.03 * bmax
    ci_stats["background"]["vmax"] = 1.3 * bmax

    if model.data.time1 is not None:
        ci_stats["time1"] = model.data.time1
    if model.data.ttb is not None:
        ci_stats["ttb"] = model.data.ttb

    model.params_stats = ci_stats
    seconds["credible_intervals"] = time.perf_counter() - t0

    logger.info("- SNR and Chi2-test")
    t0 = time.perf_counter()
    snr, chi2 = _compute_snr_chi2(model, ci_stats)
    for q in range(model.Q):
        sel = ci_stats["theta_probs"][..., q] > 0.5
        snr_masked = snr[..., q][sel]
        summary[f"SNR_{q}"] = {
            "Mean": float(snr_masked.mean()) if snr_masked.size else None,
            ll_col: None, ul_col: None,
        }
    cmax = quantile(chi2.ravel(), 0.99)
    ci_stats["chi2"] = {"values": chi2, "vmin": -0.03 * cmax, "vmax": 1.3 * cmax}

    # classification metrics against the ground-truth labels
    if model.data.labels is not None:
        pred_labels = np.asarray(model.z_map)[model.data.is_ontarget].ravel()
        true_labels = model.data.labels["z"][: model.data.N].ravel()
        counts = confusion_matrix(true_labels, pred_labels, (0, 1)).ravel()
        metrics = {
            "MCC": matthews_corrcoef(true_labels, pred_labels),
            "Recall": recall_score(true_labels, pred_labels),
            "Precision": precision_score(true_labels, pred_labels),
            **{k: int(v) for k, v in zip(("TN", "FP", "FN", "TP"), counts)},
        }
        for k, v in metrics.items():
            summary[k] = {"Mean": v, ll_col: None, ul_col: None}

        lbl_mask = model.data.labels["z"][: model.data.N] > 0
        z_arg = np.argmax(np.asarray(model.z_probs)[model.data.is_ontarget], axis=-1)
        samples = z_arg[lbl_mask]
        if len(samples):
            z_ll, z_ul = hpdi(samples, CI)
            summary["p(specific)"] = {"Mean": float(quantile(samples, 0.5)),
                                      ll_col: float(z_ll), ul_col: float(z_ul)}
        else:
            summary["p(specific)"] = {"Mean": 0.0, ll_col: 0.0, ul_col: 0.0}
    seconds["snr_chi2"] = time.perf_counter() - t0

    model.summary = summary
    t0 = time.perf_counter()
    if path is not None:
        path = Path(path)
        param_path = path / f"{model.name}_params.tpqr"
        flat = {}
        for param, field in ci_stats.items():
            if isinstance(field, dict):
                for stat, value in field.items():
                    flat[f"{param}/{stat}"] = np.asarray(value)
            else:
                flat[param] = np.asarray(field)
        with open(param_path, "wb") as f:
            np.savez_compressed(f, **flat)
        logger.info(f"Parameters were saved in {param_path}")
        if save_matlab:
            from scipy.io import savemat

            savemat(path / f"{model.name}_params.mat",
                    {k.replace("/", "_"): v for k, v in flat.items()})
            logger.info(f"Matlab parameters were saved in {model.name}_params.mat")
        write_summary(summary, path / f"{model.name}_summary.csv")
        logger.info(f"Summary statistics were saved in {model.name}_summary.csv")
    seconds["files"] = time.perf_counter() - t0
    model.stats_seconds = seconds
    logger.debug(f"Stats seconds by stage: {seconds}")
    return summary

"""The port's stats layer against the JAX package and the reference goldens
on the CPU: credible intervals, SNR / chi2, hpdi and quantile, the numpy
classification metrics against scikit-learn, and ``save_stats`` end to end
(both packages load one JAX-written checkpoint, get the same posterior
probabilities, and write files that agree)."""

import io
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.io
import torch
from sklearn import metrics as skm

from _torch_port_data import numpy_dataset, perturbed_params
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.utils import stats as jax_stats
from tapqir_tpu.utils.dataset import save as jax_save
from tapqir_tpu_torch.exceptions import TapqirFileNotFoundError
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils import stats
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The module-scoped fixtures here build float64 JAX models, which turn
    x64 on before conftest's per-test fixture records the flag; put the flag
    back when the module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)


# -- credible intervals ---------------------------------------------------------


def _ci_cases(sc):
    return {
        "gamma": (dict(concentration=sc["ci_gamma_conc"], rate=sc["ci_gamma_rate"]),
                  "ci_gamma"),
        "affine_beta": (dict(mean=sc["ci_ab_mean"], sample_size=sc["ci_ab_size"],
                             low=float(sc["ci_ab_low"]), high=float(sc["ci_ab_high"])),
                        "ci_ab"),
        "dirichlet": (dict(concentration=sc["ci_dir_conc"]), "ci_dir"),
    }


@pytest.mark.parametrize("family", ["gamma", "affine_beta", "dirichlet"])
def test_ci_from_scipy_matches_golden_and_jax(family):
    sc = dict(np.load(GOLDEN / "reference_scan_ci.npz"))
    kw, prefix = _ci_cases(sc)[family]
    CI = float(sc["ci_level"])
    got = stats.ci_from_scipy(family, CI, **kw)
    want = jax_stats.ci_from_scipy(family, CI, **kw)
    np.testing.assert_allclose(got["LL"], sc[f"{prefix}_ll"], rtol=1e-12)
    np.testing.assert_allclose(got["UL"], sc[f"{prefix}_ul"], rtol=1e-12)
    for k in ("Mean", "LL", "UL"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-15, err_msg=k)


# -- SNR / chi2 -------------------------------------------------------------------


def test_snr_and_chi2_match_golden():
    s = dict(np.load(GOLDEN / "reference_stats.npz"))

    def ours(a):  # the reference's (K, N, F) -> (N, F, C=1, K)
        return torch.as_tensor(np.moveaxis(a, 0, -1)[:, :, None])

    snr, chi2 = stats.snr_and_chi2(
        torch.as_tensor(s["data"][:, :, None]), ours(s["height"]), ours(s["width"]),
        ours(s["x"]), ours(s["y"]), torch.as_tensor(s["target_locs"][:, :, None]),
        torch.as_tensor(s["background"][:, :, None]), float(s["gain"]),
        float(s["offset_mean"]), float(s["offset_var"]), int(s["P"]), None,
    )
    np.testing.assert_allclose(np.moveaxis(snr.numpy()[:, :, 0], -1, 0), s["snr"],
                               rtol=1e-12)
    np.testing.assert_allclose(chi2.numpy()[:, :, 0], s["chi2"], rtol=1e-12)


def test_snr_and_chi2_match_jax():
    rng = np.random.default_rng(0)
    N, F, C, K, P = 3, 4, 1, 2, 14
    args = [
        rng.gamma(150.0 / 7, 7.0, (N, F, C, P, P)) + 90.0,  # data
        rng.uniform(500, 4000, (N, F, C, K)),  # height
        rng.uniform(0.8, 2.2, (N, F, C, K)),  # width
        rng.uniform(-3, 3, (N, F, C, K)),  # x
        rng.uniform(-3, 3, (N, F, C, K)),  # y
        np.full((N, F, C, 2), 6.5) + rng.uniform(-0.5, 0.5, (N, F, C, 2)),
        rng.uniform(100, 200, (N, F, C)),  # background
    ]
    const = (7.0, 90.0, 4.0, P, None)
    snr, chi2 = stats.snr_and_chi2(*map(torch.as_tensor, args), *const)
    snr_j, chi2_j = jax_stats.snr_and_chi2(*map(jnp.asarray, args), *const)
    np.testing.assert_allclose(snr.numpy(), np.asarray(snr_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(chi2_j), rtol=1e-10)


def test_hpdi_and_quantile_match_jax():
    samples = np.random.default_rng(1).gamma(2.0, 1.5, 1001)
    for prob in (0.5, 0.9, 0.95):
        assert stats.hpdi(samples, prob) == jax_stats.hpdi(samples, prob)
    np.testing.assert_array_equal(stats.quantile(samples, [0.1, 0.5, 0.99]),
                                  jax_stats.quantile(samples, [0.1, 0.5, 0.99]))


# -- classification metrics ----------------------------------------------------------

_rng = np.random.default_rng(2)
LABELS = {
    "random": (_rng.integers(0, 2, 200), _rng.integers(0, 2, 200)),
    "true all 0": (np.zeros(50, int), _rng.integers(0, 2, 50)),
    "true all 1": (np.ones(50, int), _rng.integers(0, 2, 50)),
    "pred all 0": (_rng.integers(0, 2, 50), np.zeros(50, int)),
    "pred all 1": (_rng.integers(0, 2, 50), np.ones(50, int)),
    "both all 0": (np.zeros(20, int), np.zeros(20, int)),
    "both all 1": (np.ones(20, int), np.ones(20, int)),
    "opposite": (np.zeros(20, int), np.ones(20, int)),
    "perfect": (np.tile([0, 1], 15), np.tile([0, 1], 15)),
}


@pytest.mark.parametrize("case", list(LABELS))
def test_classification_metrics_match_sklearn(case):
    y_true, y_pred = LABELS[case]
    with np.errstate(divide="ignore", invalid="ignore"):
        mcc = skm.matthews_corrcoef(y_true, y_pred)
    assert stats.matthews_corrcoef(y_true, y_pred) == pytest.approx(mcc, abs=1e-15)
    assert stats.recall_score(y_true, y_pred) == skm.recall_score(
        y_true, y_pred, zero_division=0)
    assert stats.precision_score(y_true, y_pred) == skm.precision_score(
        y_true, y_pred, zero_division=0)
    np.testing.assert_array_equal(
        stats.confusion_matrix(y_true, y_pred, (0, 1)),
        skm.confusion_matrix(y_true, y_pred, labels=(0, 1)))


# -- save_stats end to end --------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One JAX-written checkpoint, loaded by both packages in two copies of
    the workspace; both get the JAX package's posterior probabilities and
    write their stats files (``--matlab`` included)."""
    ws_j = tmp_path_factory.mktemp("stats_jax")
    data = numpy_dataset(CosmosDataset, OffsetData, Nt=6, F=9, seed=7)
    rng = np.random.default_rng(8)
    labels = np.zeros((data.N, data.F, 1), dtype=[("aoi", int), ("frame", int), ("z", int)])
    labels["aoi"] = np.arange(data.N).reshape(-1, 1, 1)
    labels["frame"] = np.arange(data.F).reshape(-1, 1)
    labels["z"] = rng.integers(0, 2, (data.N, data.F, 1))
    data.labels = labels
    jax_save(data, ws_j)
    jm = jax_models["cosmos"](dtype="double")
    jm.load(ws_j)
    jm.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()}, seed=9,
                            scale=0.5)
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    jm.iter, jm.iter_loss = 200, 100.0
    jm.save_checkpoint()

    ws_t = tmp_path_factory.mktemp("stats_port")
    shutil.copytree(ws_j, ws_t, dirs_exist_ok=True)
    tm = models["cosmos"](device="cpu", dtype="double")
    tm.load(ws_t)
    tm.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    tm.load_checkpoint(param_only=True)
    for k, v in jm.params.items():
        np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(v), err_msg=k)

    probs = jm.compute_probs_arrays(num_particles=3)
    jm._probs_cache = probs
    tm._probs_cache = tuple(a.copy() for a in probs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")  # no rastergram
        want = jm.compute_stats(save_matlab=True)
        got = tm.compute_stats(save_matlab=True)
    return ws_j, ws_t, want, got, tm


def test_save_stats_params_file_matches_jax(saved):
    ws_j, ws_t = saved[:2]
    with np.load(ws_j / "cosmos_params.tpqr") as zj, \
            np.load(ws_t / "cosmos_params.tpqr") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].shape == zj[k].shape, k
            np.testing.assert_allclose(zt[k], zj[k], rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(zt["z_map"], zj["z_map"])


def _assert_summaries_close(got, want):
    """Same rows, columns and empty cells; numbers and lists equal to the
    round-off of the two packages' arithmetic: float64 transforms of the
    same parameters for the credible intervals; for SNR, which both packages
    compute in float32 whatever the model's dtype (by XLA and by torch),
    float32 round-off of a mean over spots."""
    assert list(got) == list(want)
    for row in want:
        assert list(got[row]) == list(want[row]), row
        for col, w in want[row].items():
            g = got[row][col]
            if w is None or isinstance(w, (int, str)):
                assert g == w, (row, col)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5 if row.startswith("SNR_") else 1e-12,
                                           err_msg=f"{row}/{col}")


def test_save_stats_summary_csv_reads_to_the_same_frame(saved):
    ws_j, ws_t, want, got, tm = saved
    fj = pd.read_csv(ws_j / "cosmos_summary.csv", index_col=0)
    ft = pd.read_csv(ws_t / "cosmos_summary.csv", index_col=0)
    assert list(ft.index) == list(fj.index) == list(got)
    assert list(ft.columns) == list(fj.columns) == ["Mean", "95% LL", "95% UL"]
    assert {"MCC", "Recall", "Precision", "TN", "FP", "FN", "TP", "p(specific)"} <= set(ft.index)
    pd.testing.assert_frame_equal(ft.isna(), fj.isna())
    # the port reads its own file back to the summary it computed, and the
    # JAX package's to the same numbers
    assert stats.read_summary(ws_t / "cosmos_summary.csv") == got
    _assert_summaries_close(got, stats.read_summary(ws_j / "cosmos_summary.csv"))


def test_summary_csv_is_what_pandas_writes(tmp_path):
    """The same values through the port's csv writer and through the JAX
    package's DataFrame and ``to_csv``: the same bytes, the same frame."""
    rows = {
        "gain": [7.123456001281738, 6.5, 1e-07],
        "lamda": [[0.5000000238418579], [0.25], [0.75]],
        "pi": [[[0.85, 0.15]], [[0.8, 0.1]], [[0.9, 0.2]]],
        "SNR_0": [float("nan"), None, None],
        "MCC": [0.3, None, None],
        "TN": [3, None, None],
        "p(specific)": [0.0, 0.0, 1.0],
    }
    cols = ["Mean", "95% LL", "95% UL"]
    frame = pd.DataFrame(index=["gain", "lamda", "pi"], columns=cols)
    for row, vals in rows.items():
        for col, v in zip(cols, vals):
            if v is not None:
                frame.loc[row, col] = v
    summary = {row: dict(zip(cols, vals)) for row, vals in rows.items()}
    path = tmp_path / "summary.csv"
    stats.write_summary(summary, path)
    assert path.read_text() == frame.to_csv()
    pd.testing.assert_frame_equal(pd.read_csv(path, index_col=0),
                                  pd.read_csv(io.StringIO(frame.to_csv()), index_col=0))


def test_save_stats_matlab_files_hold_the_same_keys(saved):
    ws_j, ws_t = saved[:2]
    mj = scipy.io.loadmat(ws_j / "cosmos_params.mat")
    mt = scipy.io.loadmat(ws_t / "cosmos_params.mat")
    keys = sorted(k for k in mj if not k.startswith("__"))
    assert sorted(k for k in mt if not k.startswith("__")) == keys
    assert "height_Mean" in keys and "z_probs" in keys
    for k in keys:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-6, err_msg=k)


def test_each_package_loads_the_others_stats(saved, tmp_path):
    ws_j, ws_t, _, got, _ = saved
    tm = models["cosmos"](device="cpu")
    tm.load(ws_j, data_only=False)
    with np.load(ws_j / "cosmos_params.tpqr") as zj:
        assert sorted(tm.params_stats) == sorted(zj.files)
    _assert_summaries_close(got, tm.summary)
    jm = jax_models["cosmos"]()
    jm.load(ws_t, data_only=False)
    pd.testing.assert_frame_equal(
        jm.summary, pd.read_csv(ws_t / "cosmos_summary.csv", index_col=0))
    assert sorted(jm.params_stats) == sorted(tm.params_stats)
    shutil.copy(ws_t / "data.tpqr", tmp_path)
    with pytest.raises(TapqirFileNotFoundError, match="parameter"):
        models["cosmos"](device="cpu").load(tmp_path, data_only=False)
    shutil.copy(ws_t / "cosmos_params.tpqr", tmp_path)
    with pytest.raises(TapqirFileNotFoundError, match="summary"):
        models["cosmos"](device="cpu").load(tmp_path, data_only=False)

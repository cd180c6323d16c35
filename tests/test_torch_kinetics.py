"""The port's kinetics against the JAX package on the CPU.

``utils/imscroll.py`` against the reference goldens
(``tests/golden/reference_kinetics.npz``, produced by the original Tapqir's
own code) and against the JAX package's functions on the same inputs;
``utils/mle_analysis.py``'s fits against the JAX package's with the same
data and steps (Adam with the same constants: rtol 1e-6 in float64); and
the ``ttfb`` and ``dwelltime`` commands on a tiny fitted workspace, with
the same z samples injected into both packages' models, against the JAX
command line's files (numbers at rtol 1e-6, everything else equal), the
port's tables byte-equal to what pandas writes for the same values.
"""

import csv
import shutil
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner
from scipy.io import loadmat

from tapqir_tpu.main import app as jax_app
from tapqir_tpu.models.cosmos import cosmos as jax_cosmos
from tapqir_tpu.utils import imscroll as jax_imscroll
from tapqir_tpu.utils import mle_analysis as jax_mle
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.models.cosmos import cosmos as port_cosmos
from tapqir_tpu_torch.utils import imscroll, mle_analysis
from tapqir_tpu_torch.utils.dataset import save
from tapqir_tpu_torch.utils.simulate import simulate

torch.set_num_threads(1)
RTOL = 1e-6
GOLDEN = Path(__file__).resolve().parent / "golden" / "reference_kinetics.npz"
PARAMS = {"pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
          "offset": 90.0, "height": 3000, "background": 150}


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The JAX fits here run in float64; put the flag back when the module
    is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def kin():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _markov_z(rng, shape, kon=0.15, koff=0.3):
    """Binary two-state chains over the last axis, int32."""
    z = np.zeros(shape, np.int32)
    z[..., 0] = rng.random(shape[:-1]) < kon / (kon + koff)
    for f in range(1, shape[-1]):
        u = rng.random(shape[:-1])
        z[..., f] = np.where(z[..., f - 1] == 1, u >= koff, u < kon)
    return z


def _columns(frame):
    return {c: frame[c].to_numpy() for c in frame.columns}


# -- imscroll -------------------------------------------------------------------


@pytest.mark.parametrize("source", ["golden", "chains", "edge-cases"])
def test_count_intervals_and_dwell_times_match_reference_and_jax(kin, source):
    if source == "golden":
        z = kin["z"]
    elif source == "chains":
        z = _markov_z(np.random.default_rng(0), (4, 6, 40))
    else:  # tests/test_imscroll.py's labels: censored at both ends, one frame
        z = np.array([[[0, 0, 1], [1, 0, 1], [0, 1, 0], [1, 1, 0]]], bool)
    got = imscroll.count_intervals(z)
    want = jax_imscroll.count_intervals(z)
    assert tuple(got) == imscroll.INTERVAL_COLUMNS == tuple(want.columns)
    for c, col in _columns(want).items():
        np.testing.assert_array_equal(got[c], col, err_msg=c)
        assert got[c].dtype == col.dtype, c
    if source == "golden":
        for c in got:
            np.testing.assert_array_equal(got[c], kin[f"intervals_{c}"], err_msg=c)
    for fn in ("bound_dwell_times", "unbound_dwell_times"):
        out = getattr(imscroll, fn)(got)
        np.testing.assert_array_equal(out, getattr(jax_imscroll, fn)(want), err_msg=fn)
        assert out.dtype == np.float32
        if source == "golden":
            np.testing.assert_array_equal(out, kin[fn], err_msg=fn)


def test_time_to_first_binding_matches_reference_and_jax(kin):
    z2 = kin["z"].reshape(-1, kin["z"].shape[-1])
    p2 = kin["probs"].reshape(-1, kin["probs"].shape[-1])
    for labels, key in ((z2, "ttfb_binary"), (z2.astype(bool), "ttfb_binary"),
                        (z2.astype(np.int32), "ttfb_binary"), (p2, "ttfb_probs")):
        got = imscroll.time_to_first_binding(labels)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, kin[key], rtol=1e-12)
        np.testing.assert_allclose(got, jax_imscroll.time_to_first_binding(labels),
                                   rtol=1e-12)
    # integer states beyond {0, 1} take the probabilities' formula, as in JAX
    z3 = np.array([[0, 2, 0, 1], [0, 0, 0, 0]])
    np.testing.assert_array_equal(imscroll.time_to_first_binding(z3),
                                  jax_imscroll.time_to_first_binding(z3))


def test_rates_match_reference_and_jax(kin):
    for fn in ("association_rate", "dissociation_rate"):
        for labels, tag in ((kin["z"], "binary"), (kin["probs"], "probs")):
            got = getattr(imscroll, fn)(labels)
            key = ("kon_" if fn == "association_rate" else "koff_") + tag
            np.testing.assert_allclose(got, kin[key], rtol=1e-12)
            np.testing.assert_allclose(got, getattr(jax_imscroll, fn)(labels), rtol=1e-12)


def test_bootstrap_and_posterior_estimate_match_jax():
    samples = np.random.default_rng(0).normal(5.0, 1.0, size=500)
    got = imscroll.bootstrap(samples, np.mean, 300, rng=np.random.default_rng(1))
    want = jax_imscroll.bootstrap(samples, np.mean, 300, rng=np.random.default_rng(1))
    assert got == want and got[0] < 5.0 < got[1]

    def draw(i):
        return np.random.default_rng(i).normal(2.0, 0.5, size=50)

    got = imscroll.posterior_estimate(draw, np.median, 200, probs=0.9)
    assert got == jax_imscroll.posterior_estimate(draw, np.median, 200, probs=0.9)


# -- MLE ----------------------------------------------------------------------------


def _ttfb_data(rng, B=3, N=300, Tmax=400.0, ka=0.08, kns=0.002, Af=0.9):
    active = rng.random((B, N)) < Af
    tau = rng.exponential(1 / np.where(active, ka + kns, kns))
    return np.floor(np.minimum(tau, Tmax))


@pytest.mark.parametrize("control", [False, True], ids=["targets", "with-control"])
def test_ttfb_mle_matches_jax(control):
    rng = np.random.default_rng(1)
    data = _ttfb_data(rng)
    ctrl = _ttfb_data(rng, N=50, Af=0.0) if control else None
    want = jax_mle.ttfb_mle(data, ctrl, 400.0, n_steps=1500)
    got = mle_analysis.ttfb_mle(data, ctrl, 400.0, n_steps=1500, device="cpu")
    for k in ("ka", "kns", "Af", "losses"):
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("K", [1, 2])
def test_exp_mle_matches_jax(K):
    rng = np.random.default_rng(2)
    data = rng.exponential(1 / 0.25, size=(3, 400)).astype(np.float32)
    data[:, 350:] = 0  # zero padding, as the dwell-time arrays have
    want = jax_mle.exp_mle(data, K, n_steps=1500)
    got = mle_analysis.exp_mle(data, K, n_steps=1500, device="cpu")
    for k in ("k", "A", "losses"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(got["A"].sum(-1), 1.0, rtol=1e-12)


def test_mle_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mle_analysis.exp_mle(np.ones((1, 3)), 1, n_steps=1)


# -- the commands -------------------------------------------------------------------

N_SAMPLES, N_ITER = 12, 300


@pytest.fixture(scope="module")
def fitted_ws(tmp_path_factory):
    """A port cosmos fit (2 steps) with its stats on 8 AOIs x 30 frames,
    and z samples for both packages' models: two-state chains over the 4
    on-target AOIs."""
    ws = tmp_path_factory.mktemp("kinetics")
    save(simulate("cosmos", N=8, F=30, C=1, P=14, seed=0, params=PARAMS, device="cpu"), ws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        assert cli.main(["--cd", str(ws), "fit", "--model", "cosmos", "-n", "4", "-f",
                         "30", "-it", "2", "--cpu", "--no-input"]) == 0
    rng = np.random.default_rng(3)
    z = _markov_z(rng, (N_SAMPLES, 4, 1, 30)).transpose(0, 1, 3, 2)
    # a z_map with complete intervals: the JAX command takes the dwell
    # times of z_map for its histograms and fails without any
    with np.load(ws / "cosmos_params.tpqr") as f:
        stats = {k: f[k] for k in f.files}
    stats["z_map"] = _markov_z(rng, (8, 1, 30)).transpose(0, 2, 1).astype(stats["z_map"].dtype)
    with open(ws / "cosmos_params.tpqr", "wb") as f:
        np.savez_compressed(f, **stats)
    return ws, np.ascontiguousarray(z)


def _run_both(fitted_ws, tmp_path, monkeypatch, argv):
    """``argv`` through the JAX command line and the port's, each on its own
    copy of the workspace, both models' ``z_sample`` returning the same
    samples."""
    ws, z = fitted_ws
    seen = []

    def z_sample(self, num_samples, *args, **kwargs):
        seen.append(num_samples)
        return z[:num_samples]

    monkeypatch.setattr(jax_cosmos, "z_sample", z_sample)
    monkeypatch.setattr(port_cosmos, "z_sample", z_sample)
    monkeypatch.setenv("CI", "true")
    j_ws = Path(shutil.copytree(ws, tmp_path / "jax"))
    t_ws = Path(shutil.copytree(ws, tmp_path / "port"))
    result = CliRunner().invoke(jax_app, ["--cd", str(j_ws), *argv, "--cpu"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert cli.main(["--cd", str(t_ws), *argv, "--cpu"]) == 0
    assert seen == [N_SAMPLES, N_SAMPLES]
    return j_ws, t_ws


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_same_table(got_path, want_path):
    """Same header, index and shape; numbers at rtol 1e-6."""
    got, want = _read_csv(got_path), _read_csv(want_path)
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    g = np.array([[float(v) for v in r[1:]] for r in got[1:]])
    w = np.array([[float(v) for v in r[1:]] for r in want[1:]])
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-300, err_msg=str(got_path))


def test_ttfb_command_matches_jax_command(fitted_ws, tmp_path, monkeypatch):
    j_ws, t_ws = _run_both(fitted_ws, tmp_path, monkeypatch,
                           ["ttfb", "--model", "cosmos", "-n", str(N_SAMPLES),
                            "-it", str(N_ITER)])
    for kind in ("data-points", "params", "fraction-bound"):
        name = f"cosmos_ttfb-{kind}-channel0.csv"
        _assert_same_table(t_ws / name, j_ws / name)
    params = pd.read_csv(t_ws / "cosmos_ttfb-params-channel0.csv", index_col=0)
    assert list(params.index) == ["ka", "kns", "Af"]
    assert (params["95% LL"] <= params["Mean"]).all()
    assert (params["Mean"] <= params["95% UL"]).all()
    points = pd.read_csv(t_ws / "cosmos_ttfb-data-points-channel0.csv", index_col=0)
    assert points.shape == (N_SAMPLES, 4)


def test_dwelltime_command_matches_jax_command(fitted_ws, tmp_path, monkeypatch):
    j_ws, t_ws = _run_both(fitted_ws, tmp_path, monkeypatch,
                           ["dwelltime", "--model", "cosmos", "-K", "2", "-n",
                            str(N_SAMPLES), "-it", str(N_ITER)])
    for rate in ("kon", "koff"):
        name = f"cosmos_dwelltime-{rate}-channel0.csv"
        _assert_same_table(t_ws / name, j_ws / name)
        rows = [r[0] for r in _read_csv(t_ws / name)][1:]
        assert rows == ["A0", f"{rate}0", "A1", f"{rate}1"]
    mat = "cosmos_dwelltime-intervals-channel0.mat"
    got, want = loadmat(t_ws / mat), loadmat(j_ws / mat)
    cols = [k for k in want if not k.startswith("__")]
    assert sorted(cols) == sorted(imscroll.INTERVAL_COLUMNS)
    for k in cols:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    # the JAX package also pickles its DataFrame; the port has no pandas
    assert (j_ws / "cosmos_dwelltime-intervals-channel0.pkl").exists()
    assert not (t_ws / "cosmos_dwelltime-intervals-channel0.pkl").exists()


def test_kinetics_tables_are_what_pandas_writes(tmp_path):
    """The port's table writer against ``DataFrame.to_csv`` on the values
    of the three ttfb tables and a kinetics parameter table."""
    rng = np.random.default_rng(4)
    data = np.floor(rng.uniform(0, 30, (5, 4)))
    data[0, 1] = 30.0
    cli._write_table(tmp_path / "a.csv", range(5), range(4), data)
    pd.DataFrame(data=data).to_csv(tmp_path / "b.csv")
    t = np.arange(30)
    cols = [rng.random(30) * 10 ** e for e in (-7, 0, 0, 3)]
    names = ["time", "best fit", "fraction bound mean", "fraction bound 95% ll",
             "fraction bound 95% ul"]
    cli._write_table(tmp_path / "c.csv", range(30), names, zip(t, *cols))
    pd.DataFrame(data=dict(zip(names, [t, *cols]))).to_csv(tmp_path / "d.csv")
    rows = {"ka": (0.0123, 1e-05, 0.5), "kns": (2.0, 1.5, 3.25)}
    cli._write_intervals(tmp_path / "e.csv", rows)
    frame = pd.DataFrame(columns=["Mean", "95% LL", "95% UL"])
    for par, (mean, ll, ul) in rows.items():
        frame.loc[par, "Mean"], frame.loc[par, "95% LL"], frame.loc[par, "95% UL"] = (
            mean, ll, ul)
    frame.to_csv(tmp_path / "f.csv")
    for a, b in (("a", "b"), ("c", "d"), ("e", "f")):
        assert (tmp_path / f"{a}.csv").read_bytes() == (tmp_path / f"{b}.csv").read_bytes()


def test_dwelltime_without_complete_intervals_in_z_map(fitted_ws, tmp_path,
                                                       monkeypatch):
    """The histograms' dwell times of z_map are made only when drawn: a
    z_map of whole-record runs skips them (the JAX command fails there)."""
    ws = Path(shutil.copytree(fitted_ws[0], tmp_path / "ws"))
    with np.load(ws / "cosmos_params.tpqr") as f:
        stats = {k: f[k] for k in f.files}
    stats["z_map"][:] = 1
    with open(ws / "cosmos_params.tpqr", "wb") as f:
        np.savez_compressed(f, **stats)
    monkeypatch.setattr(port_cosmos, "z_sample",
                        lambda self, num_samples, *a, **k: fitted_ws[1][:num_samples])
    assert cli.main(["--cd", str(ws), "dwelltime", "-K", "1", "-n", "4", "-it", "5",
                     "--cpu"]) == 0
    assert (ws / "cosmos_dwelltime-kon-channel0.csv").exists()


@pytest.mark.parametrize("command", ["ttfb", "dwelltime"])
def test_kinetics_commands_exit_nonzero_without_card_or_fit(fitted_ws, tmp_path,
                                                            monkeypatch, caplog, command):
    ws = Path(shutil.copytree(fitted_ws[0], tmp_path / "ws"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--cd", str(ws), command, "-n", "2", "-it", "1"]) == 1
    assert "no CUDA device is available" in caplog.text
    (ws / "cosmos_params.tpqr").unlink()
    assert cli.main(["--cd", str(ws), command, "-n", "2", "-it", "1", "--cpu"]) == 1
    assert "Failed to load parameter file" in caplog.text

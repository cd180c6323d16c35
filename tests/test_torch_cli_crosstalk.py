"""The port's command line with ``--model crosstalk`` on the CPU: fit then
stats on a two-channel workspace (Q from the data), the alpha rows and the
SNR of both channels in the summary, crosstalk workspaces handed between
the JAX package's CLI and the port's in both directions, and the non-zero
exit without a card."""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from tapqir_tpu.main import app as jax_app
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.config import load_config
from tapqir_tpu_torch.utils.dataset import save
from tapqir_tpu_torch.utils.simulate import simulate
from tapqir_tpu_torch.utils.stats import read_summary

torch.set_num_threads(1)
PARAMS = {"pi": 0.3, "alpha": [[0.85, 0.15], [0.1, 0.9]], "width": 1.4, "gain": 7.0,
          "lamda": 0.15, "proximity": 0.2, "offset": 90.0, "height": 3000,
          "background": 150}
FILES = ("crosstalk_params.tpqr", "crosstalk_summary.csv", ".tapqir/config.yaml",
         ".tapqir/loginfo", ".tapqir/crosstalk_model.tpqr")
FIT = ["fit", "--model", "crosstalk", "-n", "2", "-f", "5", "-it", "2", "--cpu",
       "--no-input"]


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The JAX CLI's fit here turns x64 on (its default dtype is double)
    before conftest's per-test fixture records the flag; put the flag back
    when the module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def _no_rastergram(monkeypatch):
    monkeypatch.setenv("CI", "true")


def _dataset(path, N=2, F=5):
    save(simulate("crosstalk", N=N, F=F, C=2, P=14, seed=0, params=PARAMS,
                  device="cpu"), path)
    return path


@pytest.fixture(scope="module")
def port_ws(tmp_path_factory):
    """``fit --model crosstalk`` then ``stats --matlab`` on a 2-AOI,
    5-frame, 2-channel workspace."""
    ws = _dataset(tmp_path_factory.mktemp("port_xtalk_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        fit = cli.main(["--cd", str(ws), *FIT])
        stats = cli.main(["--cd", str(ws), "stats", "--cpu", "--matlab", "--no-input"])
    return ws, fit, stats


def test_crosstalk_fit_and_stats_commands(port_ws):
    ws, fit, stats = port_ws
    assert fit == 0 and stats == 0
    assert all((ws / f).exists() for f in FILES + ("crosstalk_params.mat",))
    config = load_config((ws / ".tapqir" / "config.yaml").read_text())
    assert (config["model"], config["S"], config["k-max"]) == ("crosstalk", 1, 2)
    summary = read_summary(ws / "crosstalk_summary.csv")
    assert list(summary)[:7] == ["gain", "proximity", "lamda", "pi", "alpha",
                                 "SNR_0", "SNR_1"]
    alpha = np.array(summary["alpha"]["Mean"])
    assert alpha.shape == (2, 2)
    np.testing.assert_allclose(alpha.sum(-1), 1.0, rtol=1e-5)
    assert (np.array(summary["alpha"]["95% LL"]) <= alpha).all()
    assert (alpha <= np.array(summary["alpha"]["95% UL"])).all()
    with np.load(ws / "crosstalk_params.tpqr") as z:
        assert z["alpha/Mean"].shape == (2, 2) and z["z_probs"].shape == (2, 5, 2, 2)
        assert z["chi2/values"].shape == (2, 5, 2)
        np.testing.assert_allclose(z["z_probs"][:1].sum(-1), 1.0, rtol=1e-5)
    with np.load(ws / ".tapqir" / "crosstalk_model.tpqr") as z:
        assert z["p::alpha_mean"].shape == (2, 2) and z["p::alpha_size"].shape == (2, 1)


def test_port_stats_reads_a_jax_crosstalk_workspace(tmp_path):
    ws = _dataset(tmp_path)
    result = CliRunner().invoke(jax_app, [
        "--cd", str(ws), "fit", "--model", "crosstalk", "-n", "2", "-f", "5", "-it", "1",
        "--cpu", "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    with np.load(ws / "crosstalk_params.tpqr") as z:
        jax_keys, jax_alpha = sorted(z.files), z["alpha/Mean"]
    assert cli.main(["--cd", str(ws), "stats", "--cpu", "--dtype", "double",
                     "--no-input"]) == 0
    with np.load(ws / "crosstalk_params.tpqr") as z:
        assert sorted(z.files) == jax_keys
        # the intervals come from the same checkpoint: equal in either package
        np.testing.assert_allclose(z["alpha/Mean"], jax_alpha, rtol=1e-6)
    # the port resumes the JAX package's crosstalk checkpoint
    m = models["crosstalk"](device="cpu")
    m.load(ws)
    m.init(lr=0.005, nbatch_size=2, fbatch_size=5)
    assert m.iter == 1 and m.Q == 2
    m.run(1)
    assert m.iter == 2


def test_jax_stats_reads_a_port_crosstalk_workspace(port_ws, tmp_path):
    ws = Path(shutil.copytree(port_ws[0], tmp_path / "ws"))
    with np.load(ws / "crosstalk_params.tpqr") as z:
        port_keys, port_alpha = sorted(z.files), z["alpha/Mean"]
    (ws / "crosstalk_summary.csv").unlink()
    result = CliRunner().invoke(jax_app, ["--cd", str(ws), "stats", "--cpu", "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert all((ws / f).exists() for f in FILES)
    with np.load(ws / "crosstalk_params.tpqr") as z:
        assert sorted(z.files) == port_keys
        np.testing.assert_allclose(z["alpha/Mean"], port_alpha, rtol=1e-6)


def test_crosstalk_fit_without_card_exits_nonzero(tmp_path, caplog, monkeypatch):
    ws = _dataset(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--cd", str(ws), *[a for a in FIT if a != "--cpu"]]) == 1
    assert "no CUDA device is available" in caplog.text
    assert not (ws / ".tapqir" / "crosstalk_model.tpqr").exists()

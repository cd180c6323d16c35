"""The port's command line with ``--model cosmos+hmm`` on the CPU: fit then
stats, the warm start from a cosmos fit (on by default for a fresh hmm fit,
refused without a cosmos fit when asked for, off with ``--no-warm-start``),
and hmm workspaces handed between the JAX package's CLI and the port's in
both directions."""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from tapqir_tpu.main import app as jax_app
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.models.hmm import hmm
from tapqir_tpu_torch.utils.config import load_config
from tapqir_tpu_torch.utils.dataset import save
from tapqir_tpu_torch.utils.simulate import simulate

torch.set_num_threads(1)
PARAMS = {"kon": 0.2, "koff": 0.2, "width": 1.4, "gain": 7.0, "lamda": 0.15,
          "proximity": 0.2, "offset": 90.0, "height": 3000, "background": 150}
FILES = ("cosmos+hmm_params.tpqr", "cosmos+hmm_summary.csv", ".tapqir/config.yaml",
         ".tapqir/loginfo", ".tapqir/cosmos+hmm_model.tpqr")
FIT = ["fit", "--model", "cosmos+hmm", "-n", "2", "-f", "5", "-it", "2", "--cpu",
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
    save(simulate("cosmos+hmm", N=N, F=F, C=1, P=14, seed=0, params=PARAMS,
                  device="cpu"), path)
    return path


def _cosmos_fit(ws):
    assert cli.main(["--cd", str(ws), "fit", "--model", "cosmos", "-n", "2", "-f", "5",
                     "-it", "2", "--cpu", "--no-input"]) == 0
    return ws


@pytest.fixture
def warm_calls(monkeypatch):
    """The models ``hmm.warm_start_from_cosmos`` ran on."""
    calls = []
    orig = hmm.warm_start_from_cosmos

    def counted(self, *args, **kwargs):
        calls.append(self)
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(hmm, "warm_start_from_cosmos", counted)
    return calls


@pytest.fixture(scope="module")
def port_ws(tmp_path_factory):
    """``fit --model cosmos+hmm`` then ``stats`` on a workspace without a
    cosmos fit."""
    ws = _dataset(tmp_path_factory.mktemp("port_hmm_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        fit = cli.main(["--cd", str(ws), *FIT])
        stats = cli.main(["--cd", str(ws), "stats", "--cpu", "--no-input"])
    return ws, fit, stats


def test_hmm_fit_and_stats_commands(port_ws):
    ws, fit, stats = port_ws
    assert fit == 0 and stats == 0
    assert all((ws / f).exists() for f in FILES)
    assert not (ws / ".tapqir" / "cosmos_model.tpqr").exists()
    config = load_config((ws / ".tapqir" / "config.yaml").read_text())
    assert (config["model"], config["S"], config["k-max"]) == ("cosmos+hmm", 1, 2)
    summary = (ws / "cosmos+hmm_summary.csv").read_text().splitlines()
    assert [ln.split(",")[0] for ln in summary[1:5]] == [
        "gain", "proximity", "lamda", "trans"]
    with np.load(ws / "cosmos+hmm_params.tpqr") as z:
        assert z["z_trans"].shape == (2, 5, 1, 2, 2)
        assert z["init/Mean"].shape == (1, 2) and z["trans/LL"].shape == (1, 2, 2)
        np.testing.assert_allclose(z["z_probs"].sum(-1), 1.0, rtol=1e-5)
    log = (ws / ".tapqir" / "loginfo").read_text()
    assert "Iteration #2: -ELBO" in log  # the progress line of the checkpoint
    assert "Warm-starting" not in log


def test_fit_warm_starts_from_a_cosmos_fit_by_default(tmp_path, warm_calls, caplog):
    ws = _cosmos_fit(_dataset(tmp_path))
    (ws / "cosmos_params.tpqr").unlink()  # the warm start computes the posterior
    assert cli.main(["--cd", str(ws), *FIT]) == 0
    assert len(warm_calls) == 1 and warm_calls[0].iter == 2
    assert "Warm-started cosmos+hmm from the cosmos fit" in caplog.text
    # a resumed hmm fit is not warm-started again unless asked
    assert cli.main(["--cd", str(ws), *FIT]) == 0
    assert len(warm_calls) == 1 and warm_calls[0].iter == 2
    assert cli.main(["--cd", str(ws), *FIT, "--warm-start"]) == 0
    assert len(warm_calls) == 2 and warm_calls[1].iter == 2


def test_warm_start_without_a_cosmos_fit_exits_nonzero(tmp_path, warm_calls, caplog):
    ws = _dataset(tmp_path)
    assert cli.main(["--cd", str(ws), *FIT, "--warm-start"]) == 1
    assert str(ws / ".tapqir" / "cosmos_model.tpqr") in caplog.text
    assert "--warm-start requires a cosmos fit" in caplog.text
    assert not warm_calls and not (ws / ".tapqir" / "cosmos+hmm_model.tpqr").exists()


def test_no_warm_start_ignores_the_cosmos_fit(tmp_path, warm_calls):
    ws = _cosmos_fit(_dataset(tmp_path))
    assert cli.main(["--cd", str(ws), *FIT, "--no-warm-start"]) == 0
    assert not warm_calls
    assert all((ws / f).exists() for f in FILES)


def test_port_stats_reads_a_jax_hmm_workspace(tmp_path):
    ws = _dataset(tmp_path)
    result = CliRunner().invoke(jax_app, [
        "--cd", str(ws), "fit", "--model", "cosmos+hmm", "-n", "2", "-f", "5", "-it", "1",
        "--cpu", "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    with np.load(ws / "cosmos+hmm_params.tpqr") as z:
        jax_keys, jax_z = sorted(z.files), z["z_probs"]
    assert cli.main(["--cd", str(ws), "stats", "--cpu", "--dtype", "double",
                     "--no-input"]) == 0
    with np.load(ws / "cosmos+hmm_params.tpqr") as z:
        assert sorted(z.files) == jax_keys
        # the chain marginals are deterministic: the same from either package
        np.testing.assert_allclose(z["z_probs"], jax_z, rtol=1e-6, atol=1e-12)


def test_jax_stats_reads_a_port_hmm_workspace(port_ws, tmp_path):
    ws = Path(shutil.copytree(port_ws[0], tmp_path / "ws"))
    with np.load(ws / "cosmos+hmm_params.tpqr") as z:
        port_keys = sorted(z.files)
    (ws / "cosmos+hmm_summary.csv").unlink()
    result = CliRunner().invoke(jax_app, ["--cd", str(ws), "stats", "--cpu", "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert all((ws / f).exists() for f in FILES)
    with np.load(ws / "cosmos+hmm_params.tpqr") as z:
        assert sorted(z.files) == port_keys

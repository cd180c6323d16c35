"""The port's command line, ``python -m tapqir_tpu_torch fit|stats``, on the
CPU: fit then stats on a small workspace, workspaces handed between the
JAX package's CLI and the port's in both directions, ``config.yaml``
against PyYAML both ways, the prompts, and the non-zero exits for the
options the JAX commands lack and for a missing card."""

import builtins
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from tapqir_tpu.main import app as jax_app
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.utils.config import dump_config, load_config
from tapqir_tpu_torch.utils.dataset import save
from tapqir_tpu_torch.utils.simulate import simulate

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PARAMS = {"pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
          "offset": 90.0, "height": 3000, "background": 150}
FILES = ("cosmos_params.tpqr", "cosmos_summary.csv", ".tapqir/config.yaml",
         ".tapqir/loginfo", ".tapqir/cosmos_model.tpqr")


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The module-scoped fixtures here build float64 JAX models, which turn
    x64 on before conftest's per-test fixture records the flag; put the flag
    back when the module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


def _dataset(path, N=2, F=5):
    save(simulate("cosmos", N=N, F=F, C=1, P=14, seed=0, params=PARAMS, device="cpu"), path)
    return path


def _files_exist(ws, *extra):
    return all((ws / f).exists() for f in FILES + extra)


@pytest.fixture(scope="module")
def port_ws(tmp_path_factory):
    """``fit`` then ``stats --matlab`` with ``--cpu --no-input`` on a 2-AOI,
    5-frame workspace, as the JAX package's CLI test does."""
    ws = _dataset(tmp_path_factory.mktemp("port_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")  # no rastergram
        fit = cli.main(["--cd", str(ws), "fit", "--model", "cosmos", "-S", "1",
                        "--learning-rate", "0.005", "--nbatch-size", "2",
                        "--fbatch-size", "5", "--num-iter", "2", "--cpu", "--no-input"])
        stats = cli.main(["--cd", str(ws), "stats", "--model", "cosmos",
                          "--nbatch-size", "2", "--fbatch-size", "5", "--cpu",
                          "--matlab", "--no-input"])
    return ws, fit, stats


@pytest.fixture(scope="module")
def jax_ws(tmp_path_factory):
    """The JAX package's ``fit`` on the same kind of workspace."""
    ws = _dataset(tmp_path_factory.mktemp("jax_cli"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        result = CliRunner().invoke(jax_app, [
            "--cd", str(ws), "fit", "--model", "cosmos", "-S", "1", "-n", "2", "-f", "5",
            "-it", "1", "--cpu", "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    return ws


def test_fit_and_stats_commands(port_ws):
    ws, fit, stats = port_ws
    assert fit == 0 and stats == 0
    assert _files_exist(ws, "cosmos_params.mat")
    config = load_config((ws / ".tapqir" / "config.yaml").read_text())
    assert (config["model"], config["S"], config["k-max"]) == ("cosmos", 1, 2)
    assert (config["nbatch-size"], config["fbatch-size"], config["cuda"]) == (2, 5, False)
    summary = (ws / "cosmos_summary.csv").read_text().splitlines()
    assert summary[0] == ",Mean,95% LL,95% UL"
    assert [ln.split(",")[0] for ln in summary[1:6]] == [
        "gain", "proximity", "lamda", "pi", "SNR_0"]
    assert "MCC" in (ws / "cosmos_summary.csv").read_text()  # simulated labels


def test_port_stats_reads_a_jax_workspace(jax_ws, tmp_path):
    ws = Path(shutil.copytree(jax_ws, tmp_path / "ws"))
    with np.load(ws / "cosmos_params.tpqr") as z:
        jax_keys = sorted(z.files)
    (ws / "cosmos_params.tpqr").unlink()
    (ws / "cosmos_summary.csv").unlink()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        assert cli.main(["--cd", str(ws), "stats", "--cpu", "--no-input"]) == 0
    assert _files_exist(ws)
    with np.load(ws / "cosmos_params.tpqr") as z:
        assert sorted(z.files) == jax_keys


def test_jax_stats_reads_a_port_workspace(port_ws, tmp_path):
    ws = Path(shutil.copytree(port_ws[0], tmp_path / "ws"))
    (ws / "cosmos_summary.csv").unlink()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        result = CliRunner().invoke(jax_app, ["--cd", str(ws), "stats", "--cpu",
                                              "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert _files_exist(ws)


def test_python_dash_m_runs_the_cli(tmp_path):
    """``show`` in an empty workspace exits 1 on the missing data file, as
    the JAX command does."""
    proc = subprocess.run(
        [sys.executable, "-m", "tapqir_tpu_torch", "--cd", str(tmp_path), "show"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    assert "Failed to load data file" in proc.stdout
    assert (tmp_path / ".tapqir" / "config.yaml").exists()


# -- config.yaml ---------------------------------------------------------------

CONFIG = {
    **cli.DEFAULT_CONFIG,
    "learning-rate": 1e-05,
    "dataset": "yes",
    "frame-start": None,
    "frame-end": -3,
    "use-offtarget": True,
    "channels": [
        {"name": "green 'dye'", "glimpse-folder": "/data/run 1/glimpse",
         "driftlist": "C:\\drift\\list.dat", "ontarget-aoiinfo": "a: b #c",
         "offtarget-aoiinfo": "", "ontarget-labels": None, "offtarget-labels": "1.5"},
        {"name": "red", "glimpse-folder": "-x", "driftlist": "null",
         "ontarget-aoiinfo": "on", "offtarget-aoiinfo": "[x]", "ontarget-labels": "~",
         "offtarget-labels": "tab\there"},
    ],
    "empty-list": [],
    "empty-map": {},
}


def test_config_written_by_the_port_reads_back_with_pyyaml():
    text = dump_config(CONFIG)
    assert yaml.safe_load(text) == CONFIG
    assert load_config(text) == CONFIG


def test_config_written_by_pyyaml_reads_back_with_the_port():
    text = yaml.dump(CONFIG, sort_keys=False)
    assert load_config(text) == CONFIG
    assert load_config(yaml.dump(CONFIG, sort_keys=False, width=20)) == CONFIG
    assert load_config("# a comment\nP: 14  # trailing\n") == {"P": 14}
    with pytest.raises(ValueError):
        load_config("a: &anchor 1\nb: *anchor\n")


def test_jax_workspace_config_reads_with_the_port(jax_ws):
    text = (jax_ws / ".tapqir" / "config.yaml").read_text()
    assert load_config(text) == yaml.safe_load(text)


# -- prompts and exits -----------------------------------------------------------


def test_fit_prompts_for_options_not_given(tmp_path, monkeypatch):
    """Prompts for what the command line leaves out, an empty answer keeps
    the default and an invalid one is asked again."""
    _dataset(tmp_path)
    monkeypatch.setenv("CI", "true")
    # model (invalid, then default), S, accelerator -> n, lr, num_iter -> 1,
    # matlab -> n, overwrite
    answers = iter(["bogus", "", "", "n", "", "1", "n", ""])
    asked = []

    def fake_input(prompt):
        asked.append(prompt)
        return next(answers)

    monkeypatch.setattr(builtins, "input", fake_input)
    assert cli.main(["--cd", str(tmp_path), "fit", "--nbatch-size", "2",
                     "--fbatch-size", "5"]) == 0
    assert asked[0] == asked[1] == "Tapqir model [cosmos]: "
    assert "Run computations on the accelerator? [Y/n]: " in asked
    assert any(p.startswith("Number of iterations") for p in asked)
    assert not any("batch size" in p for p in asked)  # given on the command line
    assert next(answers, None) is None
    assert (tmp_path / ".tapqir" / "cosmos_model.tpqr").exists()
    assert load_config((tmp_path / ".tapqir" / "config.yaml").read_text())["cuda"] is False


@pytest.mark.parametrize("command, extra, item", [
    ("fit", ["--mesh", "4x2"], 8),
    ("show", ["-n", "3", "--model", "cosmos"], 9),
    ("stats", ["--mesh", "auto"], 8),
])
def test_unported_models_and_options_exit_nonzero(tmp_path, caplog, port_ws, monkeypatch,
                                                  command, extra, item):
    """``show`` takes the JAX command's options only: ``--cpu`` and
    ``--no-input`` are usage errors (exit 2, as click's), and without them
    it exits 1 on the missing data file, as the JAX command does.
    ``--mesh``: with ``--cpu`` the JAX command ignores it, so ``fit`` and
    ``stats`` with ``--cpu --mesh`` run on one device and write the files of
    ``port_ws``'s commands, with the same arrays."""
    if item == 9:
        for flags in (["--cpu", "--no-input"], ["--no-input"], ["--cpu"]):
            with pytest.raises(SystemExit) as err:
                cli.main(["--cd", str(tmp_path), command, *extra, *flags])
            assert err.value.code == 2
            result = CliRunner().invoke(jax_app, ["--cd", str(tmp_path), command, *extra,
                                                  *flags])
            assert result.exit_code == 2 and "No such option" in result.output
        assert cli.main(["--cd", str(tmp_path), command, *extra]) == 1
        assert "Failed to load data file" in caplog.text
        return
    monkeypatch.setenv("CI", "true")
    ws = port_ws[0]
    if command == "fit":
        _dataset(tmp_path)
        argv = ["--cd", str(tmp_path), "fit", "--model", "cosmos", "-S", "1",
                "--learning-rate", "0.005", "--nbatch-size", "2", "--fbatch-size", "5",
                "--num-iter", "2"]
        checked = (".tapqir/cosmos_model.tpqr", "p::")
    else:
        tmp_path = Path(shutil.copytree(ws, tmp_path / "ws"))
        (tmp_path / "cosmos_params.tpqr").unlink()
        argv = ["--cd", str(tmp_path), "stats", "--model", "cosmos", "--nbatch-size", "2",
                "--fbatch-size", "5", "--matlab"]
        checked = ("cosmos_params.tpqr", "")
    assert cli.main([*argv, *extra, "--cpu", "--no-input"]) == 0
    assert "Mesh" not in caplog.text  # no mesh was started
    assert _files_exist(tmp_path)
    with np.load(tmp_path / checked[0]) as got, np.load(ws / checked[0]) as want:
        keys = [k for k in want.files if k.startswith(checked[1]) and k != "meta"]
        assert keys and set(keys) <= set(got.files)
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("command", ["fit", "stats"])
def test_missing_card_without_cpu_exits_nonzero(tmp_path, caplog, monkeypatch, command):
    _dataset(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--cd", str(tmp_path), command, "--no-input"]) == 1
    assert "no CUDA device is available" in caplog.text
    assert not (tmp_path / ".tapqir" / "cosmos_model.tpqr").exists()


@pytest.mark.parametrize("command", ["fit", "stats"])
def test_mesh_beyond_the_cards_exits_nonzero(tmp_path, caplog, monkeypatch, command):
    """``AxB`` with more shards than cards exits 1 with the JAX package's
    message (which the JAX command raises as an assertion), before any rank
    starts."""
    _dataset(tmp_path, N=2, F=4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.main(["--cd", str(tmp_path), command, "--mesh", "2x2", "--no-input"]) == 1
    assert "need 4 devices, have 2" in caplog.text
    assert not (tmp_path / ".tapqir" / "cosmos_model.tpqr").exists()


def test_mesh_frame_axis_must_divide_f(tmp_path, caplog, monkeypatch):
    _dataset(tmp_path, N=2, F=5)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli.main(["--cd", str(tmp_path), "fit", "--mesh", "1x2", "--no-input"]) == 1
    assert "mesh frame axis 2 must divide F=5" in caplog.text
    assert cli.main(["--cd", str(tmp_path), "fit", "--mesh", "two", "--no-input"]) == 1
    assert "--mesh must be 'auto', 'none' or 'AxB'" in caplog.text


@pytest.mark.parametrize("cards, mesh", [(0, "auto"), (1, "auto"), (4, "none"), (4, "1x1")])
def test_mesh_auto_on_one_card_takes_the_single_device_path(monkeypatch, cards, mesh):
    """``auto`` with at most one card, and ``none`` / ``1x1`` with any,
    resolve to no mesh (the single-device path); ``auto`` with more cards
    is an AOI mesh over all of them, ``AxB`` the mesh asked for."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert cli._resolve_mesh(None, mesh) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    auto = cli._resolve_mesh(None, "auto")
    assert auto.shape == {"aoi": 4, "frame": 1}
    assert auto.devices == [f"cuda:{i}" for i in range(4)] and auto.backend == "nccl"


def test_bad_workspace_and_missing_data(tmp_path, caplog):
    with pytest.raises(SystemExit) as err:
        cli.main(["--cd", str(tmp_path / "missing"), "fit", "--cpu", "--no-input"])
    assert err.value.code == 2
    assert cli.main(["--cd", str(tmp_path), "stats", "--cpu", "--no-input"]) == 1
    assert "Failed to load data file" in caplog.text

"""The port's ``glimpse``, ``subset`` and ``log`` commands and ``fit
--profile`` on the CPU: ``glimpse`` through ``main(argv)`` and ``python -m
tapqir_tpu_torch`` against the JAX package's command on the same raw
folder (``data.tpqr`` and ``config.yaml`` both ways), its prompts and its
non-zero exit under ``--no-input``, ``subset`` against the JAX command's
file, ``log`` with a captured pager, and ``fit --profile`` leaving the fit
as it was."""

import builtins
import json
import os
import pydoc
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
from tapqir_tpu_torch import main as cli, tracing
from tapqir_tpu_torch.models.model import seed_to_key
from tapqir_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests" / "golden"))
from glimpse_synth import synthesize  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """A fixture here runs the JAX CLI; put the x64 flag back when the
    module is done so that it cannot leak into another file's fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The golden's raw folder (two files, drift, a frame range, labels)
    and the glimpse command's arguments for it."""
    root = tmp_path_factory.mktemp("raw")
    cfg = synthesize(root)
    ch = cfg["channels"][0]
    argv = ["glimpse", "--dataset", cfg["dataset"], "-P", str(cfg["P"]),
            "--offset-x", str(cfg["offset-x"]), "--offset-y", str(cfg["offset-y"]),
            "--offset-p", str(cfg["offset-P"]), "--bin-size", str(cfg["bin-size"]),
            "--frame-start", str(cfg["frame-start"]), "--frame-end", str(cfg["frame-end"]),
            "--labels", "--name", ch["name"]]
    for key in ("glimpse-folder", "driftlist", "ontarget-aoiinfo", "offtarget-aoiinfo",
                "ontarget-labels", "offtarget-labels"):
        argv += [f"--{key}", ch[key]]
    return argv + ["--no-input"]


def _jax_cli(ws, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        result = CliRunner().invoke(jax_app, ["--cd", str(ws), *argv])
    assert result.exit_code == 0, result.output + repr(result.exception)


def _port_cli(ws, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        return cli.main(["--cd", str(ws), *argv])


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory, raw):
    """The port's and the JAX package's ``glimpse`` on the same folder,
    each in a workspace of its own."""
    port = tmp_path_factory.mktemp("port_ws")
    jax_ws = tmp_path_factory.mktemp("jax_ws")
    assert _port_cli(port, raw) == 0
    _jax_cli(jax_ws, raw)
    return port, jax_ws


def _assert_same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _config(ws):
    return yaml.safe_load((ws / ".tapqir" / "config.yaml").read_text())


def test_glimpse_command_matches_jax(workspaces):
    port, jax_ws = workspaces
    _assert_same_npz(port / "data.tpqr", jax_ws / "data.tpqr")
    assert _config(port) == _config(jax_ws)
    text = (port / ".tapqir" / "config.yaml").read_text()
    assert load_config(text) == yaml.safe_load(text)
    cfg = _config(port)
    assert cfg["frame-start"] == 2 and cfg["channels"][0]["name"] == "blue"
    assert "Extracting AOIs: Done" in (port / ".tapqir" / "loginfo").read_text()


def test_python_dash_m_glimpse(workspaces, raw, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tapqir_tpu_torch", "--cd", str(tmp_path), *raw],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CI": "true"},
    )
    assert proc.returncode == 0, proc.stderr
    _assert_same_npz(tmp_path / "data.tpqr", workspaces[0] / "data.tpqr")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_yaml_drives_the_other_package(workspaces, tmp_path, writer):
    """``glimpse --no-input`` without channel options reads the channels
    the other package's command persisted, and writes the same file."""
    src = workspaces[0] if writer == "port" else workspaces[1]
    ws = Path(shutil.copytree(src, tmp_path / "ws"))
    (ws / "data.tpqr").unlink()
    argv = ["glimpse", "--labels", "--no-input"]
    if writer == "port":
        _jax_cli(ws, argv)
    else:
        assert _port_cli(ws, argv) == 0
    _assert_same_npz(ws / "data.tpqr", src / "data.tpqr")
    assert _config(ws) == _config(src)


def test_glimpse_prompts_for_missing_channel_options(raw, tmp_path, monkeypatch):
    """A channel option missing from the command line and the config is
    asked for (again while empty); given ones are not."""
    argv = list(raw[:-1])  # without --no-input
    drop = argv.index("--driftlist")
    driftlist = argv[drop + 1]
    del argv[drop:drop + 2]
    name = argv.index("--name")
    del argv[name:name + 2]
    answers = iter(["", "blue", driftlist])
    asked = []

    def fake_input(prompt):
        asked.append(prompt)
        return next(answers)

    monkeypatch.setattr(builtins, "input", fake_input)
    assert _port_cli(tmp_path, argv) == 0
    assert asked == ["Channel #0: name: ", "Channel #0: name: ", "Channel #0: driftlist: "]
    ch = _config(tmp_path)["channels"][0]
    assert (ch["name"], ch["driftlist"]) == ("blue", driftlist)
    assert (tmp_path / "data.tpqr").exists()


def test_glimpse_missing_option_without_input_exits_nonzero(raw, tmp_path, caplog,
                                                             monkeypatch):
    argv = list(raw)
    drop = argv.index("--offtarget-aoiinfo")
    del argv[drop:drop + 2]
    monkeypatch.setattr(builtins, "input", lambda prompt: pytest.fail("prompted"))
    assert _port_cli(tmp_path, argv) == 1
    assert "channel 0: missing required option 'offtarget-aoiinfo'" in caplog.text
    assert not (tmp_path / "data.tpqr").exists()
    # without off-target AOIs that file is not required
    assert _port_cli(tmp_path, [*argv[:-1], "--no-offtarget", "--no-input"]) == 0
    assert _config(tmp_path)["use-offtarget"] is False


def test_subset_matches_jax(workspaces, tmp_path):
    """Both packages' ``subset`` on copies of the port's workspace: the
    same subset/data.tpqr, key by key (labels passed on whole)."""
    out = {}
    for who in ("port", "jax"):
        ws = Path(shutil.copytree(workspaces[0], tmp_path / who))
        (ws / "aoi_subset.txt").write_text("4, 0,2\n")
        if who == "port":
            assert _port_cli(ws, ["subset"]) == 0
        else:
            _jax_cli(ws, ["subset"])
        out[who] = ws / "subset" / "data.tpqr"
    _assert_same_npz(out["port"], out["jax"])
    with np.load(out["port"]) as z, np.load(workspaces[0] / "data.tpqr") as full:
        np.testing.assert_array_equal(z["images"], full["images"][[4, 0, 2]])
        np.testing.assert_array_equal(z["labels"], full["labels"])


def test_log_pages_the_log_file(workspaces, monkeypatch):
    paged = []
    monkeypatch.setattr(pydoc, "pager", paged.append)
    assert _port_cli(workspaces[0], ["log"]) == 0
    assert paged == [(workspaces[0] / ".tapqir" / "loginfo").read_text()]
    assert "Extracting AOIs: Done" in paged[0]


def test_fit_profile_leaves_the_fit_as_it_was(workspaces, tmp_path):
    """``fit --profile 3 --cpu`` on an ingested workspace with a fit:
    exit 0, a Chrome trace written with the program's ``span::`` ranges in
    each step, tracing off again, no restarts run, and the checkpoint's
    bytes, the parameters, the Adam state, the iteration and the seed as
    they were."""
    ws = Path(shutil.copytree(workspaces[0], tmp_path / "ws"))
    fit = ["fit", "--model", "cosmos", "-n", "3", "-f", "10", "--cpu", "--no-input"]
    assert _port_cli(ws, fit + ["-it", "2"]) == 0
    ckpt, params = ws / ".tapqir" / "cosmos_model.tpqr", ws / "cosmos_params.tpqr"
    before = ckpt.read_bytes(), params.read_bytes()

    built = []
    make = cli._make_model
    cli._make_model = lambda *a, **k: built.append(make(*a, **k)) or built[-1]
    try:
        # as in the JAX package the profile comes before any restarts
        assert _port_cli(ws, fit + ["--profile", "3", "-R", "2"]) == 0
    finally:
        cli._make_model = make
    assert (ckpt.read_bytes(), params.read_bytes()) == before
    assert not (ws / ".tapqir" / "cosmos_restarts.json").exists()
    trace = ws / ".tapqir" / "profile" / "cosmos_trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("span::"):
            ranges.setdefault(e["name"][6:], []).append(float(e["ts"]))
    (chunk_start,), steps = ranges["fit.chunk"], sorted(ranges["step.batch"])
    assert len(steps) == 3 and chunk_start <= steps[0]
    edges = steps + [float("inf")]
    for name in ("step.update", "elbo.sites"):  # one in each step
        assert [sum(a <= t < b for t in ranges[name])
                for a, b in zip(edges, edges[1:])] == [1, 1, 1], name
    assert not tracing.enabled()
    m = built[0]
    with np.load(ckpt) as z:
        for prefix, tree in (("p", m.params), ("mu", m.opt_state["mu"]),
                             ("nu", m.opt_state["nu"]), ("count", m.opt_state["count"])):
            for k, v in tree.items():
                np.testing.assert_array_equal(v.numpy(), z[f"{prefix}::{k}"], err_msg=k)
        assert m.iter == json.loads(bytes(z["meta"]).decode())["iter"] == 2
        np.testing.assert_array_equal(seed_to_key(m._seed), z["rng::key"])

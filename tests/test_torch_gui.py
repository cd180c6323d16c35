"""The port's AOI viewer (``tapqir_tpu_torch/gui.py``) and its ``show``
command against the JAX package's (``tapqir_tpu/gui.py``) on the CPU.

One fitted workspace (a port fit at N=6, F=20, P=14, then the stats) is
copied for each package, since the two packages' files are
interchangeable: a seeded sequence of viewer actions through both
controllers, the files they write (``data.tpqr``, ``aoi_subset.txt``) and
``subset`` on them, the figures' data exactly, ``show``'s PNG and exit
codes, the field-of-view controller on workspaces made by both packages'
``glimpse``, and the widgets (the browser, the app's tabs, the run buttons'
command lines)."""

import inspect
import json
import logging
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import tapqir_tpu.gui as jgui
import tapqir_tpu_torch.gui as tgui
from tapqir_tpu.main import app as jax_app
from tapqir_tpu.utils.dataset import load as jax_load
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.config import dump_config, load_config
from tapqir_tpu_torch.utils.dataset import load, save
from tapqir_tpu_torch.utils.simulate import simulate
from test_torch_glimpse import glimpse_test_folder

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PARAMS = {"pi": 0.3, "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
          "offset": 90.0, "height": 3000, "background": 150}
WINDOW = 5
DATA_FIELDS = ("images", "xy", "is_ontarget", "mask", "labels", "time1", "ttb", "name",
               "channels")


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """A fixture here runs the JAX CLI; put the x64 flag back when the
    module is done so that it cannot leak into another file's fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def _headless(monkeypatch):
    monkeypatch.setenv("CI", "true")


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A port fit on the CPU (6 AOIs half on target, 20 frames, 40 steps)
    with its saved stats."""
    ws = tmp_path_factory.mktemp("gui_fit")
    save(simulate("cosmos", N=6, F=20, C=1, P=14, seed=0, params=PARAMS, device="cpu"), ws)
    m = models["cosmos"](device="cpu")
    m.load(ws)
    m.init(lr=0.005, nbatch_size=6, fbatch_size=20)
    m.run(40, progress_bar=lambda it: it)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")  # no rastergram
        m.compute_stats(CI=0.95)
    return ws


@pytest.fixture
def copies(fitted, tmp_path):
    """The fitted workspace twice: the port's copy and the JAX package's."""
    return (Path(shutil.copytree(fitted, tmp_path / "port")),
            Path(shutil.copytree(fitted, tmp_path / "jax")))


def _states(copies, window=WINDOW):
    tws, jws = copies
    return (tgui.AoiViewerState(tgui._load_model_with_stats(tws, "cosmos"), window=window),
            jgui.AoiViewerState(jgui._load_model_with_stats(jws, "cosmos"), window=window))


def _jax_cli(ws, argv):
    return CliRunner().invoke(jax_app, ["--cd", str(ws), *argv])


def _assert_same_npz(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _assert_same_data(a, b):
    for k in DATA_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(a.offset.samples, b.offset.samples)
    np.testing.assert_array_equal(a.offset.weights, b.offset.weights)


def test_every_function_of_the_jax_viewer_has_a_counterpart():
    names = {n for n, obj in vars(jgui).items()
             if (inspect.isfunction(obj) or inspect.isclass(obj))
             and obj.__module__ == jgui.__name__}
    assert {"_load_model_with_stats", "_render_figure", "_run_button", "_fit_tab",
            "build_fov_state", "FovViewerState", "_write_app_notebook"} <= names
    assert names <= set(vars(tgui))
    assert tgui.__all__ == jgui.__all__
    assert tgui.APP_NOTEBOOK_CELL == jgui.APP_NOTEBOOK_CELL.replace("tapqir_tpu.",
                                                                    "tapqir_tpu_torch.")


def test_viewer_model_is_built_on_the_cpu(fitted):
    m = tgui._load_model_with_stats(fitted, "cosmos")
    assert m.device.type == "cpu" and m.name == "cosmos"
    assert "p_specific" in m.params_stats and m.data.Nt == 6


# -- the controller ------------------------------------------------------------

KEYS = ["ArrowUp", "ArrowDown", "ArrowRight", "ArrowLeft", "z", "o", "n", "e", "q"]
TOGGLES = ["zoom", "show_targets", "show_nonspecific", "show_labels"]


def _actions(seed=0, n=200, Nt=6, F=20):
    """``n`` viewer actions drawn from ``seed``: keys, jumps, shifts,
    toggles and exclusions, out of range too; the last two leave an AOI
    excluded and one kept."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n - 2):
        kind = int(rng.integers(7))
        if kind == 0:
            out.append(("handle_key", (KEYS[rng.integers(len(KEYS))],), {}))
        elif kind == 1:
            out.append(("set_aoi", (int(rng.integers(-3, Nt + 3)),), {}))
        elif kind == 2:
            out.append(("set_frame", (int(rng.integers(-5, F + 5)),), {}))
        elif kind == 3:
            out.append(("shift_aoi", (int(rng.integers(-2, 3)),), {}))
        elif kind == 4:
            out.append(("shift_frames", (int(rng.integers(-12, 13)),), {}))
        elif kind == 5:
            value = [None, True, False][rng.integers(3)]
            out.append(("toggle", (TOGGLES[rng.integers(len(TOGGLES))], value), {}))
        else:
            excluded = [None, True, False][rng.integers(3)]
            n_aoi = None if rng.random() < 0.5 else int(rng.integers(Nt))
            out.append(("toggle_exclude", (), {"excluded": excluded, "n": n_aoi}))
    out.append(("toggle_exclude", (), {"excluded": True, "n": 1}))
    out.append(("toggle_exclude", (), {"excluded": False, "n": 0}))
    return out


def _view(s):
    return (s.n, s.f1, s.span, s.f2, s.zoom, s.show_targets, s.show_nonspecific,
            s.show_labels, s.is_excluded(), s.data.mask.tolist(),
            s.excluded_aois().tolist(), s.included_aois().tolist())


def test_seeded_actions_files_and_subset_match_the_jax_viewer(copies):
    tws, jws = copies
    ts, js = _states(copies)
    assert _view(ts) == _view(js)
    actions = _actions()
    assert len(actions) == 200
    for i, (name, args, kwargs) in enumerate(actions):
        got = getattr(ts, name)(*args, **kwargs)
        want = getattr(js, name)(*args, **kwargs)
        assert got == want, (i, name, args, kwargs)
        assert _view(ts) == _view(js), (i, name, args, kwargs)
    assert ts.excluded_aois().size and ts.included_aois().size

    ts.save_data()
    js.save_data()
    _assert_same_npz(tws / "data.tpqr", jws / "data.tpqr")
    loaded = [read(ws) for read in (load, jax_load) for ws in (tws, jws)]
    for other in loaded[1:]:
        _assert_same_data(loaded[0], other)
    np.testing.assert_array_equal(loaded[0].mask, ts.data.mask)

    assert ts.write_aoi_subset().read_bytes() == js.write_aoi_subset().read_bytes()
    assert cli.main(["--cd", str(tws), "subset"]) == 0
    result = _jax_cli(jws, ["subset"])
    assert result.exit_code == 0, result.output
    _assert_same_npz(tws / "subset" / "data.tpqr", jws / "subset" / "data.tpqr")
    sub = load(tws / "subset")
    np.testing.assert_array_equal(sub.images, ts.data.images[ts.included_aois()])


def test_navigation_zoom_and_keys(copies):
    """The port's counterparts of tests/test_gui.py's controller tests."""
    s, _ = _states(copies)
    assert s.set_aoi(100) == 5 and s.set_aoi(-3) == 0 and s.shift_aoi(2) == 2
    assert s.set_frame(1000) == 20 - WINDOW and s.shift_frames(-100) == 0 and s.f2 == 5
    s.set_frame(15)
    s.toggle("zoom", True)
    assert (s.span, s.f1, s.f2) == (20, 0, 20)
    for key, check in (("ArrowUp", lambda: s.n == 3), ("ArrowDown", lambda: s.n == 2),
                       ("o", lambda: s.show_targets), ("n", lambda: not s.show_nonspecific),
                       ("e", lambda: s.is_excluded())):
        assert s.handle_key(key) and check(), key
    assert not s.handle_key("q")
    with pytest.raises(ValueError, match="no toggle"):
        s.toggle("labels")


# -- figures -------------------------------------------------------------------


def _figure_data(fig):
    """Everything the viewer draws, as plain values: axes, images with
    their limits, lines with their styles, bands' vertices, texts."""
    axes = []
    for ax in fig.axes:
        axes.append({
            "images": [(np.asarray(im.get_array()), im.get_clim()) for im in ax.images],
            "lines": [(np.asarray(ln.get_xydata()), ln.get_marker(), ln.get_color(),
                       ln.get_linestyle()) for ln in ax.lines],
            "bands": [[np.asarray(p.vertices) for p in c.get_paths()]
                      for c in ax.collections],
            "texts": (ax.get_title(), ax.get_ylabel(), ax.get_xlabel()),
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "legend": ax.get_legend() is not None,
        })
    return {"n_axes": len(fig.axes), "suptitle": fig.get_suptitle(), "axes": axes}


def _assert_equal_tree(a, b, path="fig"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _edit_params(ws, edit):
    path = ws / "cosmos_params.tpqr"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    edit(arrays)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def _specific_spots(arrays):
    """A specific spot in AOI 2's first two frames and a non-specific one
    in the next two, so that the strip draws both markers."""
    m_probs, theta = arrays["m_probs"].copy(), arrays["theta_probs"].copy()
    m_probs[0, 2, :2], theta[0, 2, :2] = 0.9, 0.9
    m_probs[1, 2, 2:4], theta[1, 2, 2:4] = 0.9, 0.05
    arrays["m_probs"], arrays["theta_probs"] = m_probs, theta


@pytest.mark.parametrize("case", ["specific_excluded", "no_theta_probs_zoomed"])
def test_figure_data_equals_the_jax_figure(copies, case):
    import matplotlib.pyplot as plt

    for ws in copies:
        if case == "specific_excluded":
            _edit_params(ws, _specific_spots)
        else:  # a params file without theta_probs falls back to m_probs
            _edit_params(ws, lambda arrays: arrays.pop("theta_probs"))
    ts, js = _states(copies)
    for s in (ts, js):
        s.set_aoi(2)
        if case == "specific_excluded":
            s.toggle("show_targets", True)
            s.toggle("show_labels", True)
            s.toggle_exclude(excluded=True)
        else:
            s.toggle("zoom", True)
            s.toggle("show_nonspecific", False)
    figs = [s.render() for s in (ts, js)]
    got, want = (_figure_data(f) for f in figs)
    for f in figs:
        plt.close(f)
    _assert_equal_tree(got, want)
    assert got["n_axes"] == WINDOW + 6  # the strip and six traces
    markers = {ln[1] for ax in got["axes"][:WINDOW] for ln in ax["lines"]}
    if case == "specific_excluded":
        assert got["suptitle"] == "cosmos: AOI 2, channel 0 [EXCLUDED]"
        assert {"o", "+", "x"} <= markers and got["axes"][WINDOW]["legend"]
    else:
        # theta_probs falls back to m_probs: every spot drawn is specific
        assert got["suptitle"] == "cosmos: AOI 2, channel 0"
        assert "+" in markers and "x" not in markers


# -- show ----------------------------------------------------------------------


def test_show_writes_the_png_of_the_jax_command(copies, caplog):
    tws, jws = copies
    assert cli.main(["--cd", str(tws), "show", "-n", "0", "--num-frames", "5"]) == 0
    assert "Saved AOI viewer figure in" in caplog.text
    result = _jax_cli(jws, ["show", "-n", "0", "--num-frames", "5"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    names = [sorted(p.name for p in ws.glob("*.png")) for ws in copies]
    assert names[0] == names[1] == ["cosmos_aoi0-channel0.png"]


def test_python_dash_m_show(fitted, tmp_path):
    ws = Path(shutil.copytree(fitted, tmp_path / "ws"))
    proc = subprocess.run(
        [sys.executable, "-m", "tapqir_tpu_torch", "--cd", str(ws), "show", "-n", "0",
         "--num-frames", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert (ws / "cosmos_aoi0-channel0.png").stat().st_size > 0


@pytest.mark.parametrize("case", ["missing_params", "cpu", "no_input", "no_matplotlib"])
def test_show_exits_as_the_jax_command(copies, caplog, monkeypatch, case):
    tws, jws = copies
    argv = ["show", "-n", "1"]
    if case == "missing_params":
        for ws in copies:
            (ws / "cosmos_params.tpqr").unlink()
        assert cli.main(["--cd", str(tws), *argv]) == 1
        assert "Failed to load parameter file" in caplog.text
        assert _jax_cli(jws, argv).exit_code == 1
    elif case in ("cpu", "no_input"):
        flag = "--cpu" if case == "cpu" else "--no-input"
        with pytest.raises(SystemExit) as err:
            cli.main(["--cd", str(tws), *argv, flag])
        assert err.value.code == 2
        result = _jax_cli(jws, [*argv, flag])
        assert result.exit_code == 2 and "No such option" in result.output
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
        assert cli.main(["--cd", str(tws), *argv]) == 1
        assert "show needs matplotlib" in caplog.text
        result = _jax_cli(jws, argv)
        assert result.exit_code == 1 and isinstance(result.exception, ModuleNotFoundError)
    assert not list(tws.glob("*.png"))


# -- the field of view ---------------------------------------------------------


@pytest.fixture(scope="module")
def fov_workspaces(tmp_path_factory):
    """tests/test_glimpse.py's raw folder through the port's and the JAX
    package's ``glimpse``, each in a workspace of its own."""
    cfg = glimpse_test_folder(tmp_path_factory.mktemp("raw"))
    ch = cfg["channels"][0]
    argv = ["glimpse", "--dataset", cfg["dataset"], "-P", str(cfg["P"]),
            "--offset-x", str(cfg["offset-x"]), "--offset-y", str(cfg["offset-y"]),
            "--offset-p", str(cfg["offset-P"]), "--bin-size", str(cfg["bin-size"])]
    for key in ("name", "glimpse-folder", "driftlist", "ontarget-aoiinfo",
                "offtarget-aoiinfo"):
        argv += [f"--{key}", ch[key]]
    argv.append("--no-input")
    port, jax_ws = tmp_path_factory.mktemp("fov_port"), tmp_path_factory.mktemp("fov_jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        assert cli.main(["--cd", str(port), *argv]) == 0
        result = _jax_cli(jax_ws, argv)
    assert result.exit_code == 0, result.output + repr(result.exception)
    return port, jax_ws


def _rectangles(state):
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    state.render(ax=ax)
    rects = [(p.get_xy(), p.get_width(), p.get_height(), p.get_edgecolor())
             for p in ax.patches]
    out = (rects, ax.get_title(), np.asarray(ax.images[0].get_array()))
    plt.close(fig)
    return out


@pytest.mark.parametrize("made_by", ["port", "jax"])
def test_fov_state_matches_the_jax_one(fov_workspaces, made_by):
    ws = fov_workspaces[made_by == "jax"]
    ts, js = tgui.build_fov_state(ws), jgui.build_fov_state(ws)
    assert ts is not None and js is not None
    assert (ts.fov.F, ts.fov.dtypes, ts.P, ts.show) == (js.fov.F, js.fov.dtypes, js.P, js.show)
    assert ts.fov.F == 6 and ts.show == {"ontarget": True, "offtarget": True, "offset": False}
    for f in (-3, 2, 100):
        assert ts.set_frame(f) == js.set_frame(f)
    ts.set_frame(3)
    js.set_frame(3)
    for dtype, value in (("offset", None), ("offtarget", False), ("ontarget", None),
                         ("ontarget", True)):
        assert ts.toggle(dtype, value) == js.toggle(dtype, value)
        assert ts.visible_dtypes == js.visible_dtypes
        got, want = _rectangles(ts), _rectangles(js)
        _assert_equal_tree(got, want)
    assert len(got[0]) == 1 + 2  # the offset region and the two on-target AOIs


def test_fov_state_is_none_where_the_jax_one_is(fov_workspaces, fitted, tmp_path, caplog):
    assert tgui.build_fov_state(fitted) is None is jgui.build_fov_state(fitted)
    # a workspace whose config.yaml has no channels (data.tpqr made otherwise)
    (tmp_path / ".tapqir").mkdir()
    (tmp_path / ".tapqir" / "config.yaml").write_text(dump_config(cli.DEFAULT_CONFIG))
    assert tgui.build_fov_state(tmp_path) is None is jgui.build_fov_state(tmp_path)
    assert tgui.build_fov_state(fov_workspaces[0], c=1) is None
    assert jgui.build_fov_state(fov_workspaces[0], c=1) is None
    # the raw files moved away
    ws = Path(shutil.copytree(fov_workspaces[0], tmp_path / "moved"))
    path = ws / ".tapqir" / "config.yaml"
    cfg = load_config(path.read_text())
    cfg["channels"][0]["glimpse-folder"] = str(tmp_path / "gone")
    path.write_text(dump_config(cfg))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert tgui.build_fov_state(ws) is None is jgui.build_fov_state(ws)
    warned = [r for r in caplog.records if r.getMessage().startswith("FOV viewer unavailable")]
    assert sorted(r.name for r in warned) == ["tapqir_tpu.gui", "tapqir_tpu_torch.gui"]
    assert warned[0].getMessage() == warned[1].getMessage()


# -- widgets -------------------------------------------------------------------


def _find(widget, pred, acc=None):
    acc = [] if acc is None else acc
    if pred(widget):
        acc.append(widget)
    for child in getattr(widget, "children", ()):
        _find(child, pred, acc)
    return acc


def _described(root, text, exact=True):
    return _find(root, lambda w: (str(getattr(w, "description", "")) == text) if exact
                 else text in str(getattr(w, "description", "")))


def test_browser_widgets_drive_the_state(copies):
    pytest.importorskip("ipywidgets")
    state, root = tgui.build_browser(copies[0], "cosmos", window=WINDOW)
    excl = _described(root, "Exclude AOI", exact=False)[0]
    n_box = _find(root, lambda w: str(getattr(w, "description", "")).startswith("AOI ("))[0]
    excl.value = True
    assert state.is_excluded(0)
    n_box.value = 3
    assert state.n == 3 and excl.value is False and not state.is_excluded(3)
    n_box.value = 0
    assert excl.value is True
    excl.value = False
    assert not state.is_excluded(0)
    _described(root, f"+{WINDOW}")[0].click()
    assert state.f1 == WINDOW
    _described(root, "Write aoi_subset.txt")[0].click()
    assert (copies[0] / "aoi_subset.txt").read_text() == "0, 1, 2, 3, 4, 5\n"


def _tab_titles(root):
    tab = root.children[1]
    return [tab.get_title(i) for i in range(len(tab.children))]


def test_app_tabs_equal_the_jax_app(copies, fov_workspaces):
    pytest.importorskip("ipywidgets")
    root = tgui.build_app(copies[0])
    assert _tab_titles(root) == _tab_titles(jgui.build_app(copies[1]))
    tb = root.children[1].children[3]
    assert _find(tb, lambda w: "tensorboard --logdir" in str(getattr(w, "value", "")))
    # a workspace whose config.yaml holds one glimpse channel: the port's
    # glimpse tab fills channel 0's fields from it and leaves the others
    # empty, where the JAX tab indexes past the list
    ws = fov_workspaces[0]
    channel = load_config((ws / ".tapqir" / "config.yaml").read_text())["channels"][0]
    root = tgui.build_app(ws)
    assert _described(root, "Header/glimpse folder")[0].value == channel["glimpse-folder"]
    assert [w.value for w in _described(root, "Name")] == [
        channel["name"], "channel1", "channel2", "channel3"]
    with pytest.raises(IndexError):
        jgui.build_app(ws)


def test_run_buttons_call_main_with_their_widgets_argv(fitted, fov_workspaces, monkeypatch):
    pytest.importorskip("ipywidgets")
    ws = fov_workspaces[0]
    calls = []

    def fake_main(argv):
        calls.append(argv)
        cli._parser().parse_args(argv)  # every command line parses
        return 0

    root = tgui.build_app(ws)
    monkeypatch.setattr(cli, "main", fake_main)
    fit_tab, post_tab = root.children[1].children[1], root.children[1].children[4]
    values = {"Model": "cosmos+hmm", "S": 2, "K": 3, "AOI batch": 4, "Frame batch": 64,
              "LR": 0.002, "Iterations": 7, "Run on CPU": True,
              "Save matlab parameters": True}
    for text, value in values.items():
        _described(fit_tab, text)[0].value = value
    _described(fit_tab, "Fit the data")[0].click()
    assert calls[-1] == [
        "--cd", str(ws), "fit", "--model", "cosmos+hmm", "-S", "2", "--cpu",
        "--nbatch-size", "4", "--fbatch-size", "64", "--learning-rate", "0.002",
        "--num-iter", "7", "--k-max", "3", "--num-restarts", "1", "--matlab",
        "--dtype", "float32", "--profile", "0", "--overwrite", "--no-input"]

    glimpse_tab = root.children[1].children[0]
    _described(glimpse_tab, "Limit frame range")[0].value = True
    _described(glimpse_tab, "Last frame")[0].value = 5
    _described(glimpse_tab, "Extract AOIs")[0].click()
    cfg = load_config((ws / ".tapqir" / "config.yaml").read_text())
    ch = cfg["channels"][0]
    assert calls[-1] == [
        "--cd", str(ws), "glimpse", "--dataset", cfg["dataset"], "-P", str(cfg["P"]),
        "--num-channels", "1", "--offset-x", str(cfg["offset-x"]),
        "--offset-y", str(cfg["offset-y"]), "--offset-p", str(cfg["offset-P"]),
        "--bin-size", str(cfg["bin-size"]), "--use-offtarget", "--no-labels",
        "--frame-start", "0", "--frame-end", "5",
        "--name", ch["name"], "--glimpse-folder", ch["glimpse-folder"],
        "--driftlist", ch["driftlist"], "--ontarget-aoiinfo", ch["ontarget-aoiinfo"],
        "--offtarget-aoiinfo", ch["offtarget-aoiinfo"], "--overwrite", "--no-input"]

    _described(post_tab, "Binary rastergram")[0].value = True
    _described(post_tab, "Time-to-first-binding analysis")[0].click()
    assert calls[-1] == ["--cd", str(ws), "ttfb", "--model", "cosmos", "--binary",
                         "--num-samples", "2000", "--num-iter", "15000"]
    _described(post_tab, "Dwell-time analysis")[0].click()
    assert calls[-1] == ["--cd", str(ws), "dwelltime", "--model", "cosmos+hmm", "-K", "3",
                         "--num-samples", "500", "--num-iter", "10000"]
    assert len(calls) == 4


def test_a_failed_command_is_logged_not_dropped(fitted, tmp_path, monkeypatch, caplog):
    pytest.importorskip("ipywidgets")
    ws = Path(shutil.copytree(fitted, tmp_path / "ws"))
    root = tgui.build_app(ws)
    post_tab, fit_tab = root.children[1].children[4], root.children[1].children[1]
    # the post tab runs on the card, as the port's commands do by default:
    # without one the command exits 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _described(post_tab, "Time-to-first-binding analysis")[0].click()
    failed = [r for r in caplog.records if r.name == "tapqir_tpu_torch.gui"]
    assert failed[-1].levelno == logging.ERROR
    assert "Time-to-first-binding analysis failed" in failed[-1].getMessage()
    assert "exited with code 1" in failed[-1].getMessage()
    # an argument error (argparse's exit 2) is logged too
    monkeypatch.setattr(cli, "main", lambda argv: sys.exit(2))
    _described(fit_tab, "Fit the data")[0].click()
    assert "Fit the data failed" in caplog.records[-1].getMessage()
    assert "exited with code 2" in caplog.records[-1].getMessage()


def test_app_entry_point_serves_the_port_notebook(monkeypatch, tmp_path):
    launched = []

    def fake_run(cmd, check):
        launched.append(cmd)
        launched.append(Path(cmd[-1]).read_text())

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.delitem(sys.modules, "tapqir_tpu_torch.gui")  # run it afresh, as -m does
    runpy.run_module("tapqir_tpu_torch.gui", run_name="__main__")
    cmd, text = launched
    assert cmd[:2] == [sys.executable, "-m"] and cmd[2] in ("voila", "notebook")
    assert json.loads(text)["cells"][0]["source"] == tgui.APP_NOTEBOOK_CELL
    assert tgui.APP_NOTEBOOK_CELL.startswith("from tapqir_tpu_torch.gui import run")
    nb = tgui._write_app_notebook(tmp_path / "app.ipynb")
    assert nb.read_text() == text

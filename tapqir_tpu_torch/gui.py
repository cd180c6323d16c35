"""The AOI viewer and the notebook app (counterpart of tapqir_tpu/gui.py).

Three layers, so that all but the last run headless:

1. :class:`AoiViewerState` - a controller holding the browser's state (the
   AOI, the frame window, the display toggles, the exclusion mask's edits)
   with no widget or display behind it. Exclusion edits the dataset's mask
   in memory; ``save_data()`` writes it to ``data.tpqr`` and
   ``write_aoi_subset()`` writes the ``aoi_subset.txt`` that ``subset``
   reads. :class:`FovViewerState` toggles the AOI overlays of a raw field of
   view.
2. Figures - :func:`render_aoi_figure` (the command ``show``) and the
   renderer the browser draws with. matplotlib is imported inside them.
3. ipywidgets - :func:`build_browser` / :func:`build_app` / :func:`app`
   (``python -m tapqir_tpu_torch.gui``: voila when it is installed, else
   jupyter notebook). The app's tabs run the port's commands through
   :func:`tapqir_tpu_torch.main.main`; ipywidgets, IPython, ipyevents, voila
   and tensorboard are imported where they are used.
"""

import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "AoiViewerState",
    "render_aoi_figure",
    "view",
    "build_browser",
    "build_app",
    "app",
    "run",
]


def _load_model_with_stats(cd, model_name):
    """The workspace's model with its data and saved statistics
    (``<model>_params.tpqr``, ``<model>_summary.csv``). It is built on the
    CPU, as the JAX viewer builds it: the viewer holds only the numpy arrays
    of those files and runs no tensor computation, so nothing on this path
    could run on the card."""
    from tapqir_tpu_torch.models import models

    m = models[model_name](device="cpu", dtype="float32")
    m.load(cd, data_only=False)
    return m


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


class AoiViewerState:
    """Headless controller of the interactive AOI browser: navigation,
    display toggles, keyboard shortcuts and AOI exclusion. The widget layer
    (:func:`build_browser`) is a thin shell over it."""

    def __init__(self, model, window=15):
        self.model = model
        self.data = model.data
        self.window = int(window)
        self.n = 0
        self.f1 = 0
        self.zoom = False
        self.show_targets = False
        self.show_nonspecific = True
        self.show_labels = False

    # -- navigation ---------------------------------------------------------
    @property
    def span(self) -> int:
        """Frames covered by the strip (4x window when zoomed out)."""
        return self.window * (4 if self.zoom else 1)

    @property
    def f2(self) -> int:
        return min(self.f1 + self.span, self.data.F)

    def set_aoi(self, n: int) -> int:
        self.n = int(np.clip(n, 0, self.data.Nt - 1))
        return self.n

    def shift_aoi(self, delta: int) -> int:
        return self.set_aoi(self.n + delta)

    def set_frame(self, f1: int) -> int:
        self.f1 = int(np.clip(f1, 0, max(0, self.data.F - self.span)))
        return self.f1

    def shift_frames(self, delta: int) -> int:
        return self.set_frame(self.f1 + delta)

    def toggle(self, name: str, value=None) -> bool:
        """Flip (or set) one of: zoom / show_targets / show_nonspecific /
        show_labels."""
        if name not in ("zoom", "show_targets", "show_nonspecific", "show_labels"):
            raise ValueError(f"no toggle named {name!r}")
        new = (not getattr(self, name)) if value is None else bool(value)
        setattr(self, name, new)
        if name == "zoom":
            self.set_frame(self.f1)  # re-clamp to the new span
        return new

    def handle_key(self, key: str) -> bool:
        """Keyboard shortcuts (the JAX browser's bindings). Returns True if
        the key was consumed."""
        actions = {
            "ArrowUp": lambda: self.shift_aoi(1),
            "ArrowDown": lambda: self.shift_aoi(-1),
            "ArrowRight": lambda: self.shift_frames(self.window),
            "ArrowLeft": lambda: self.shift_frames(-self.window),
            "z": lambda: self.toggle("zoom"),
            "o": lambda: self.toggle("show_targets"),
            "n": lambda: self.toggle("show_nonspecific"),
            "e": lambda: self.toggle_exclude(),
        }
        if key not in actions:
            return False
        actions[key]()
        return True

    # -- exclusion ----------------------------------------------------------
    def is_excluded(self, n=None) -> bool:
        return not bool(self.data.mask[self.n if n is None else n])

    def toggle_exclude(self, excluded=None, n=None) -> bool:
        """Exclude (or include) an AOI from the analysis by editing the
        dataset's mask in memory; flips it when ``excluded`` is None."""
        n = self.n if n is None else int(n)
        new_excluded = bool(self.data.mask[n]) if excluded is None else bool(excluded)
        self.data.mask[n] = not new_excluded
        return new_excluded

    def included_aois(self) -> np.ndarray:
        return np.nonzero(np.asarray(self.data.mask))[0]

    def excluded_aois(self) -> np.ndarray:
        return np.nonzero(~np.asarray(self.data.mask))[0]

    # -- persistence --------------------------------------------------------
    def save_data(self):
        """Write the (mask-edited) dataset back to ``data.tpqr``."""
        from tapqir_tpu_torch.utils.dataset import save

        save(self.data, self.model.path)
        logger.info(f"Saved data with {len(self.excluded_aois())} excluded AOIs")

    def write_aoi_subset(self, path=None) -> Path:
        """Write ``aoi_subset.txt`` listing the kept (not excluded) AOI
        indices, comma-separated on one line, as ``subset`` reads it."""
        path = Path(path) if path is not None else Path(self.model.path)
        out = path / "aoi_subset.txt" if path.is_dir() else path
        with open(out, "w") as f:
            f.write(", ".join(str(i) for i in self.included_aois()) + "\n")
        logger.info(f"Wrote {out}")
        return out

    # -- rendering ----------------------------------------------------------
    def render(self, num_frames=None):
        """The browser's figure for the current state."""
        return _render_figure(
            self.model,
            n=self.n,
            f1=self.f1,
            f2=self.f2,
            num_frames=num_frames or self.window,
            show_targets=self.show_targets,
            show_nonspecific=self.show_nonspecific,
            show_labels=self.show_labels,
            excluded=self.is_excluded(),
        )


class FovViewerState:
    """Headless controller of the field-of-view panel: one toggle per AOI
    dtype (ontarget / offtarget / offset region) says which rectangles are
    drawn on the raw frame."""

    def __init__(self, channel_config, P, c=0):
        from tapqir_tpu_torch.imscroll.glimpse_reader import GlimpseDataset

        self.fov = GlimpseDataset(c=c, **channel_config)
        self.P = int(P)
        self.show = {d: True for d in self.fov.dtypes}
        self.show["offset"] = False
        self.frame = 0

    def toggle(self, dtype: str, value=None) -> bool:
        cur = self.show[dtype]
        self.show[dtype] = (not cur) if value is None else bool(value)
        return self.show[dtype]

    @property
    def visible_dtypes(self):
        return [d for d, v in self.show.items() if v]

    def set_frame(self, f: int) -> int:
        self.frame = int(np.clip(f, 0, self.fov.F - 1))
        return self.frame

    def render(self, ax=None):
        """Draw the frame with the enabled overlays (``GlimpseDataset.plot``
        draws the rectangles; the offset region takes its own P)."""
        self.fov.plot(
            tuple(self.visible_dtypes), self.P, f=self.frame, ax=ax,
            title=f"Frame index {self.frame}",
        )


def build_fov_state(cd, c=0):
    """A :class:`FovViewerState` from the channels of the workspace's
    config.yaml, or None when the workspace has no glimpse configuration
    (a ``data.tpqr`` made otherwise) or its raw files cannot be read."""
    from tapqir_tpu_torch.utils.config import load_config

    cfg_path = Path(cd) / ".tapqir" / "config.yaml"
    if not cfg_path.is_file():
        return None
    cfg = load_config(cfg_path.read_text()) or {}
    channels = cfg.get("channels") or []
    if c >= len(channels) or not channels[c].get("glimpse-folder"):
        return None
    merged = {
        k: v
        for k, v in cfg.items()
        if k
        in ("use-offtarget", "offset-x", "offset-y", "frame-range",
            "frame-start", "frame-end", "labels")
    }
    merged.update(channels[c])
    try:
        return FovViewerState(merged, P=cfg.get("P", 14), c=c)
    except Exception as err:  # the viewer's boundary: missing or renamed raw files
        logger.warning(f"FOV viewer unavailable: {err}")
        return None


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _render_figure(m, n=0, f1=0, f2=None, num_frames=15, c=0,
                   show_targets=False, show_nonspecific=True,
                   show_labels=False, excluded=False):
    """The viewer's figure of AOI ``n``: an image strip with the spots
    marked, and the parameters' traces with their credible bands. Returns
    the matplotlib Figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = m.params_stats
    data = m.data
    f2 = data.F if f2 is None else min(f2, data.F)
    frames = np.linspace(f1, f2 - 1, min(num_frames, f2 - f1)).astype(int)

    def stat(name, field="Mean"):
        key = f"{name}/{field}"
        if key in stats:
            return np.asarray(stats[key])
        return np.asarray(stats[name])

    p_specific = stat("p_specific")  # (Nt, F, Q)
    height = stat("height")  # (K, Nt, F, Q)
    width = stat("width")
    x = stat("x")
    y = stat("y")
    background = stat("background")  # (Nt, F, C)
    m_probs = stat("m_probs")
    theta_probs = stat("theta_probs") if "theta_probs" in stats else m_probs
    K = height.shape[0]

    nrows = 7
    fig = plt.figure(figsize=(10, 12))
    gs = fig.add_gridspec(nrows, len(frames), height_ratios=[2, 1, 1, 1, 1, 1, 1])

    # -- image strip with spot overlays --------------------------------------
    vmin = float(np.percentile(data.images[n, :, c], 5))
    vmax = float(np.percentile(data.images[n, :, c], 99))
    for i, f in enumerate(frames):
        ax = fig.add_subplot(gs[0, i])
        ax.imshow(data.images[n, f, c], vmin=vmin, vmax=vmax, cmap="gray")
        if show_targets:
            ax.plot(
                data.xy[n, f, c, 0], data.xy[n, f, c, 1],
                "o", mfc="none", color="w", markersize=10, mew=0.8,
            )
        for k in range(K):
            if m_probs[k, n, f, c] <= 0.5:
                continue
            specific = theta_probs[k, n, f, c] > 0.5
            if not specific and not show_nonspecific:
                continue
            sx = data.xy[n, f, c, 0] + x[k, n, f, c]
            sy = data.xy[n, f, c, 1] + y[k, n, f, c]
            marker, color = ("+", "#AA3377") if specific else ("x", "#66CCEE")
            ax.plot(sx, sy, marker, color=color, markersize=8, mew=1.2)
        ax.set_title(f"f={f}", fontsize=7)
        ax.axis("off")

    span = slice(f1, f2)
    t = np.arange(f1, f2)
    line_colors = None if not excluded else ["C7"] * max(K, 4)

    def trace(row, values, label, lls=None, uls=None, colors=None):
        ax = fig.add_subplot(gs[row, :])
        values = np.atleast_2d(values)
        for k in range(values.shape[0]):
            color = (
                line_colors[k]
                if line_colors is not None
                else (f"C{k}" if colors is None else colors[k])
            )
            ax.plot(t, values[k][span], color=color, lw=0.8)
            if lls is not None:
                ax.fill_between(t, lls[k][span], uls[k][span], alpha=0.3, color=color)
        ax.set_ylabel(label, fontsize=8)
        ax.set_xlim(f1, max(f2 - 1, f1 + 1))
        return ax

    ax_p = trace(1, p_specific[n, :, c][None], "p(specific)", colors=["C2"])
    ax_p.set_ylim(-0.05, 1.05)
    if show_labels and data.labels is not None:
        true_z = np.asarray(data.labels["z"])
        if true_z.ndim == 2:
            true_z = true_z[..., None]
        if n < true_z.shape[0]:
            ax_p.plot(
                t, true_z[n, span, min(c, true_z.shape[-1] - 1)],
                color="k", lw=0.6, ls="--", label="label",
            )
            ax_p.legend(fontsize=6, loc="upper right")
    for row, name in ((2, "height"), (3, "width"), (4, "x"), (5, "y")):
        trace(
            row, stat(name)[:, n, :, c], name,
            stat(name, "LL")[:, n, :, c], stat(name, "UL")[:, n, :, c],
        )
    trace(
        6, background[n, :, c][None], "background",
        stat("background", "LL")[n, :, c][None],
        stat("background", "UL")[n, :, c][None],
        colors=["C3"],
    ).set_xlabel("Time (frame)")

    status = " [EXCLUDED]" if excluded else ""
    fig.suptitle(f"{m.name}: AOI {n}, channel {c}{status}", fontsize=11)
    fig.tight_layout()
    return fig


def render_aoi_figure(cd, model_name="cosmos", n=0, f1=0, f2=None,
                      num_frames=15, c=0, out_path=None):
    """Render the viewer's figure of AOI ``n`` and save it as a PNG (the
    command ``show``). Returns the PNG's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cd = Path(cd)
    m = _load_model_with_stats(cd, model_name)
    fig = _render_figure(m, n=n, f1=f1 or 0, f2=f2, num_frames=num_frames, c=c)
    out_path = out_path or cd / f"{model_name}_aoi{n}-channel{c}.png"
    fig.savefig(out_path, dpi=200)
    plt.close(fig)
    return out_path


def view(cd, model_name="cosmos", **kwargs):
    """Notebook helper: render the AOI figure and display it inline."""
    out = render_aoi_figure(cd, model_name, **kwargs)
    try:
        from IPython.display import Image, display

        display(Image(str(out)))
    except ImportError:
        pass
    return out


# ---------------------------------------------------------------------------
# widget layer
# ---------------------------------------------------------------------------


def build_browser(cd, model_name="cosmos", window=15):
    """Interactive AOI browser: navigation, zoom, overlays, exclusion.

    :return: ``(state, widget)`` - the :class:`AoiViewerState` controller and
        the root ipywidgets container.
    """
    import ipywidgets as widgets
    import matplotlib.pyplot as plt
    from IPython.display import display

    m = _load_model_with_stats(cd, model_name)
    state = AoiViewerState(m, window=window)
    data = m.data

    fig_out = widgets.Output()
    status = widgets.Label(value="")

    def redraw():
        fig = state.render()
        fig_out.outputs = ()
        with fig_out:
            display(fig)
        plt.close(fig)

    n_box = widgets.BoundedIntText(
        value=0, min=0, max=data.Nt - 1,
        description=f"AOI (0-{data.Nt - 1})",
        style={"description_width": "initial"},
        layout={"width": "170px"},
    )
    f1_slider = widgets.IntSlider(
        value=0, min=0, max=max(0, data.F - window), step=1,
        description=f"Frame (0-{data.F - 1})",
        continuous_update=False,
        style={"description_width": "initial"},
        layout={"width": "340px"},
    )
    f_back = widgets.Button(description=f"-{window}", layout=widgets.Layout(width="50px"))
    f_fwd = widgets.Button(description=f"+{window}", layout=widgets.Layout(width="50px"))
    zoom_cb = widgets.Checkbox(value=False, description="Zoom out frames ['z']", indent=False)
    targets_cb = widgets.Checkbox(
        value=False, description="Show target location ['o']", indent=False
    )
    nonspecific_cb = widgets.Checkbox(
        value=True, description="Show non-specific spots ['n']", indent=False
    )
    exclude_cb = widgets.Checkbox(
        value=state.is_excluded(),
        description="Exclude AOI from analysis ['e']",
        indent=False,
    )
    labels_cb = widgets.Checkbox(value=False, description="Show labels", indent=False)
    save_btn = widgets.Button(description="Save data")
    subset_btn = widgets.Button(description="Write aoi_subset.txt")

    updating = {"busy": False}

    def sync_widgets():
        updating["busy"] = True
        try:
            n_box.value = state.n
            f1_slider.max = max(0, data.F - state.span)
            f1_slider.value = state.f1
            zoom_cb.value = state.zoom
            targets_cb.value = state.show_targets
            nonspecific_cb.value = state.show_nonspecific
            labels_cb.value = state.show_labels
            exclude_cb.value = state.is_excluded()
        finally:
            updating["busy"] = False

    def on_change(apply):
        def cb(change):
            if updating["busy"]:
                return
            apply(change["new"])
            sync_widgets()
            redraw()

        return cb

    n_box.observe(on_change(state.set_aoi), names="value")
    f1_slider.observe(on_change(state.set_frame), names="value")
    zoom_cb.observe(on_change(lambda v: state.toggle("zoom", v)), names="value")
    targets_cb.observe(on_change(lambda v: state.toggle("show_targets", v)), names="value")
    nonspecific_cb.observe(
        on_change(lambda v: state.toggle("show_nonspecific", v)), names="value"
    )
    labels_cb.observe(on_change(lambda v: state.toggle("show_labels", v)), names="value")
    exclude_cb.observe(on_change(lambda v: state.toggle_exclude(excluded=v)), names="value")
    f_back.on_click(lambda b: (state.shift_frames(-state.window), sync_widgets(), redraw()))
    f_fwd.on_click(lambda b: (state.shift_frames(state.window), sync_widgets(), redraw()))

    def on_save(b):
        state.save_data()
        status.value = f"Saved data.tpqr ({len(state.excluded_aois())} AOIs excluded)"

    def on_subset(b):
        out = state.write_aoi_subset()
        status.value = f"Wrote {out} ({len(state.included_aois())} AOIs kept)"

    save_btn.on_click(on_save)
    subset_btn.on_click(on_subset)

    checkboxes = [zoom_cb, targets_cb, nonspecific_cb, exclude_cb]
    if data.labels is not None:
        checkboxes.append(labels_cb)
    controls = widgets.HBox(
        [
            n_box,
            widgets.HBox([f_back, f1_slider, f_fwd]),
            widgets.VBox(checkboxes, layout=widgets.Layout(width="260px")),
        ]
    )
    root = widgets.VBox([controls, widgets.HBox([save_btn, subset_btn, status]), fig_out])

    # keyboard navigation through ipyevents, when it is installed
    try:
        from ipyevents import Event
    except ImportError:
        Event = None
    if Event is not None:
        ev = Event(source=root, watched_events=["keyup"], prevent_default_action=True)

        def on_key(event):
            if state.handle_key(event.get("key", "")):
                sync_widgets()
                redraw()

        ev.on_dom_event(on_key)

    redraw()
    return state, root


def _run_button(label, out, fn):
    """A button that runs ``fn`` with its output and logs captured into
    ``out``; an exception is logged there, never dropped."""
    import ipywidgets as widgets

    btn = widgets.Button(description=label, button_style="primary")

    def cb(b):
        with out:
            try:
                fn()
            except Exception as err:  # the app's boundary: shown in its log area
                logger.exception(f"{label} failed: {err}")

    btn.on_click(cb)
    return btn


def _run_command(cd, argv):
    """``python -m tapqir_tpu_torch --cd cd <argv>`` in this process; raises
    on a non-zero exit (an argument error's included), so that the button
    logs it."""
    from tapqir_tpu_torch import main as cli

    try:
        code = cli.main(["--cd", str(cd), *argv])
    except SystemExit as err:  # argparse's usage error
        code = err.code
    if code != 0:
        raise RuntimeError(f"`{' '.join(argv)}` exited with code {code}")


def _fit_tab(out, cd, config):
    import ipywidgets as widgets

    from tapqir_tpu_torch.main import AVAIL_MODELS

    model = widgets.Dropdown(options=list(AVAIL_MODELS), value="cosmos", description="Model")
    S = widgets.BoundedIntText(value=1, min=1, max=4, description="S")
    k_max = widgets.BoundedIntText(value=2, min=1, max=4, description="K")
    nbatch = widgets.IntText(value=config.get("nbatch-size", 10), description="AOI batch")
    fbatch = widgets.IntText(value=config.get("fbatch-size", 512), description="Frame batch")
    lr = widgets.FloatText(value=config.get("learning-rate", 0.005), description="LR")
    num_iter = widgets.IntText(value=0, description="Iterations")
    cpu = widgets.Checkbox(value=False, description="Run on CPU", indent=False)
    matlab = widgets.Checkbox(value=False, description="Save matlab parameters", indent=False)

    def run_fit():
        _run_command(cd, [
            "fit", "--model", model.value, "-S", str(S.value),
            "--cpu" if cpu.value else "--cuda",
            "--nbatch-size", str(nbatch.value), "--fbatch-size", str(fbatch.value),
            "--learning-rate", str(lr.value), "--num-iter", str(num_iter.value),
            "--k-max", str(k_max.value), "--num-restarts", "1",
            *(["--matlab"] if matlab.value else []),
            "--dtype", "float32", "--profile", "0", "--overwrite", "--no-input",
        ])

    return widgets.VBox(
        [model, S, k_max, nbatch, fbatch, lr, num_iter, cpu, matlab,
         _run_button("Fit the data", out, run_fit)]
    )


# a channel's options in the glimpse tab: config key (= flag without "--"),
# field description
_CHANNEL_FIELDS = (
    ("name", "Name"),
    ("glimpse-folder", "Header/glimpse folder"),
    ("driftlist", "Driftlist file"),
    ("ontarget-aoiinfo", "On-target aoiinfo"),
    ("offtarget-aoiinfo", "Off-target aoiinfo"),
)


def _glimpse_tab(out, cd, config):
    import ipywidgets as widgets

    g = config.get
    dataset = widgets.Text(value=str(g("dataset", "dataset")), description="Dataset name")
    P = widgets.BoundedIntText(value=g("P", 14), min=5, max=50, description="AOI size")
    num_channels = widgets.BoundedIntText(value=g("num-channels", 1), min=1, max=4,
                                          description="Channels")
    offset_x = widgets.IntText(value=g("offset-x", 10), description="Offset x")
    offset_y = widgets.IntText(value=g("offset-y", 10), description="Offset y")
    offset_P = widgets.IntText(value=g("offset-P", 30), description="Offset size")
    bin_size = widgets.IntText(value=g("bin-size", 1), description="Bin size")
    use_offtarget = widgets.Checkbox(
        value=bool(g("use-offtarget", True)),
        description="Use off-target AOIs", indent=False,
    )
    frame_range = widgets.Checkbox(value=False, description="Limit frame range", indent=False)
    frame_start = widgets.IntText(value=g("frame-start") or 0, description="First frame")
    frame_end = widgets.IntText(value=g("frame-end") or 0, description="Last frame")

    channels = g("channels") or []

    def channel_form(c):
        ch = channels[c] if c < len(channels) else {}
        default = {"name": f"channel{c}"}
        return {
            key: widgets.Text(value=str(ch.get(key, default.get(key, ""))),
                              description=text)
            for key, text in _CHANNEL_FIELDS
        }

    forms = [channel_form(c) for c in range(4)]
    accordion = widgets.Accordion(children=[widgets.VBox(list(f.values())) for f in forms])
    for c in range(4):
        accordion.set_title(c, f"Channel #{c}")

    def run_glimpse():
        C = num_channels.value
        argv = [
            "glimpse", "--dataset", dataset.value, "-P", str(P.value),
            "--num-channels", str(C), "--offset-x", str(offset_x.value),
            "--offset-y", str(offset_y.value), "--offset-p", str(offset_P.value),
            "--bin-size", str(bin_size.value),
            "--use-offtarget" if use_offtarget.value else "--no-offtarget", "--no-labels",
        ]
        if frame_range.value:
            argv += ["--frame-start", str(frame_start.value),
                     "--frame-end", str(frame_end.value)]
        for c in range(C):
            for key, _ in _CHANNEL_FIELDS:
                argv += [f"--{key}", forms[c][key].value]
        _run_command(cd, [*argv, "--overwrite", "--no-input"])

    return widgets.VBox(
        [dataset, P, num_channels, offset_x, offset_y, offset_P, bin_size,
         use_offtarget, frame_range, frame_start, frame_end, accordion,
         _run_button("Extract AOIs", out, run_glimpse)]
    )


def _view_tab(out, cd):
    import ipywidgets as widgets

    from tapqir_tpu_torch.main import AVAIL_MODELS

    model = widgets.Dropdown(options=list(AVAIL_MODELS), value="cosmos", description="Model")
    holder = widgets.VBox([])

    def load():
        state, browser = build_browser(cd, model.value)
        holder.children = [browser]

    return widgets.VBox(
        [
            widgets.HBox([model, _run_button("Load results", out, load)]),
            holder,
            _fov_controls(out, cd),
        ]
    )


def _fov_controls(out, cd):
    """Field-of-view panel with one AOI-overlay toggle per dtype."""
    import ipywidgets as widgets

    fig_out = widgets.Output()
    holder = widgets.VBox([])

    def load_fov():
        state = build_fov_state(cd)
        if state is None:
            with out:
                print(
                    "No glimpse configuration in config.yaml - the FOV view needs the "
                    "raw glimpse files (the inputs of `python -m tapqir_tpu_torch "
                    "glimpse`)."
                )
            return
        frame_box = widgets.BoundedIntText(
            value=0, min=0, max=state.fov.F - 1, description="Frame"
        )
        boxes = []

        def redraw():
            import matplotlib.pyplot as plt
            from IPython.display import display

            fig_out.outputs = ()
            with fig_out:
                fig = plt.figure(figsize=(8, 8 * state.fov.height / state.fov.width))
                state.render(ax=fig.add_subplot(1, 1, 1))
                display(fig)
                plt.close(fig)

        def on_toggle(dtype):
            def cb(change):
                state.toggle(dtype, change["new"])
                redraw()

            return cb

        for dtype in state.show:
            cb_w = widgets.Checkbox(
                value=state.show[dtype], description=f"Show {dtype} AOIs", indent=False
            )
            cb_w.observe(on_toggle(dtype), names="value")
            boxes.append(cb_w)

        def on_frame(change):
            state.set_frame(change["new"])
            redraw()

        frame_box.observe(on_frame, names="value")
        holder.children = [widgets.HBox([frame_box] + boxes), fig_out]
        redraw()

    return widgets.Accordion(
        children=[widgets.VBox([_run_button("Load field of view", out, load_fov), holder])],
        titles=("Field of view (AOI overlays)",),
        selected_index=None,
    )


def _tensorboard_tab(cd):
    """TensorBoard on ``.tapqir/logs`` when the package is importable,
    otherwise the command to run by hand."""
    import ipywidgets as widgets

    logdir = Path(cd) / ".tapqir" / "logs"
    info = widgets.Label(
        value=(
            f'Manual alternative: run "tensorboard --logdir {logdir}" in a '
            "terminal and open localhost:6006"
        )
    )
    tb_out = widgets.Output()

    def launch():
        tb_out.outputs = ()
        with tb_out:
            try:
                from tensorboard import notebook

                notebook.start(f"--logdir '{logdir}'")
                notebook.display(height=800)
            except Exception as err:  # an optional embed: show the manual command
                print(f"TensorBoard embed unavailable ({err}).")
                print(f'Run "tensorboard --logdir {logdir}" manually.')

    return widgets.VBox([_run_button("Launch TensorBoard", tb_out, launch), info, tb_out])


def _post_tab(out, cd):
    import ipywidgets as widgets

    from tapqir_tpu_torch.main import AVAIL_MODELS

    # time-to-first-binding
    t_model = widgets.Dropdown(options=list(AVAIL_MODELS), value="cosmos",
                               description="Model")
    t_binary = widgets.Checkbox(value=False, description="Binary rastergram", indent=False)
    t_samples = widgets.IntText(value=2000, description="Samples")
    t_iter = widgets.IntText(value=15000, description="Iterations")
    ttfb_box = widgets.VBox(
        [t_model, t_binary, t_samples, t_iter,
         _run_button(
             "Time-to-first-binding analysis", out,
             lambda: _run_command(cd, [
                 "ttfb", "--model", t_model.value,
                 "--binary" if t_binary.value else "--probabilistic",
                 "--num-samples", str(t_samples.value), "--num-iter", str(t_iter.value),
             ]),
         )]
    )
    # dwell time
    d_model = widgets.Dropdown(options=list(AVAIL_MODELS), value="cosmos+hmm",
                               description="Model")
    d_K = widgets.BoundedIntText(value=3, min=1, max=5, description="Exponentials")
    d_samples = widgets.IntText(value=500, description="Samples")
    d_iter = widgets.IntText(value=10000, description="Iterations")
    dwell_box = widgets.VBox(
        [d_model, d_K, d_samples, d_iter,
         _run_button(
             "Dwell-time analysis", out,
             lambda: _run_command(cd, [
                 "dwelltime", "--model", d_model.value, "-K", str(d_K.value),
                 "--num-samples", str(d_samples.value), "--num-iter", str(d_iter.value),
             ]),
         )]
    )
    tab = widgets.Tab(children=[ttfb_box, dwell_box])
    tab.set_title(0, "Time-to-first binding")
    tab.set_title(1, "Dwell time")
    return tab


def _log_tab(cd):
    import ipywidgets as widgets

    log_view = widgets.Output(layout={"max_height": "600px", "overflow": "auto"})
    reload_btn = widgets.Button(description="(Re)-load logs")

    def cb(b):
        log_view.outputs = ()
        log_file = Path(cd) / ".tapqir" / "loginfo"
        with log_view:
            if log_file.is_file():
                print(log_file.read_text())
            else:
                print("no log file yet")

    reload_btn.on_click(cb)
    return widgets.VBox([reload_btn, log_view])


def build_app(cd):
    """The tabbed app of one working directory: Extract AOIs / Fit the data
    / View results / Tensorboard / Post analysis / View logs."""
    import ipywidgets as widgets

    from tapqir_tpu_torch.main import init_workspace

    cd = Path(cd)
    config = init_workspace(cd)
    out = widgets.Output(layout={"max_height": "300px", "overflow": "auto"})
    tab = widgets.Tab(
        children=[
            _glimpse_tab(out, cd, config),
            _fit_tab(out, cd, config),
            _view_tab(out, cd),
            _tensorboard_tab(cd),
            _post_tab(out, cd),
            _log_tab(cd),
        ]
    )
    for i, title in enumerate(
        ["Extract AOIs", "Fit the data", "View results", "Tensorboard",
         "Post analysis", "View logs"]
    ):
        tab.set_title(i, title)
    wd = widgets.Label(value=f"Working directory: {cd}")
    return widgets.VBox([wd, tab, out])


def run():
    """Notebook entry: a working-directory chooser, then the tabbed app."""
    import ipywidgets as widgets
    from IPython.display import display

    container = widgets.VBox()
    path_box = widgets.Text(
        value=str(Path.cwd()), description="Working directory",
        style={"description_width": "initial"},
        layout={"width": "500px"},
    )
    go = widgets.Button(description="Open", button_style="primary")

    def cb(b):
        container.children = [build_app(path_box.value)]

    go.on_click(cb)
    container.children = [widgets.HBox([path_box, go])]
    display(container)


APP_NOTEBOOK_CELL = "from tapqir_tpu_torch.gui import run\nrun()\n"


def _write_app_notebook(path: Path) -> Path:
    nb = {
        "cells": [
            {
                "cell_type": "code",
                "execution_count": None,
                "metadata": {},
                "outputs": [],
                "source": APP_NOTEBOOK_CELL,
            }
        ],
        "metadata": {
            "kernelspec": {
                "display_name": "Python 3",
                "language": "python",
                "name": "python3",
            }
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }
    path.write_text(json.dumps(nb))
    return path


def app():
    """``python -m tapqir_tpu_torch.gui``: serve the notebook app with voila
    when it is installed, else with jupyter notebook. The launcher notebook
    is written to a private temporary directory and the server runs as a
    child process, so shell metacharacters in paths are inert and Ctrl-C
    reaches it."""
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tapqir-gui-") as td:
        nbpath = _write_app_notebook(Path(td) / "tapqir-gui.ipynb")
        try:
            import voila  # noqa: F401

            cmd = [sys.executable, "-m", "voila", str(nbpath)]
        except ImportError:
            cmd = [sys.executable, "-m", "notebook", str(nbpath)]
        logger.info(f"Launching GUI: {' '.join(cmd)}")
        try:
            subprocess.run(cmd, check=False)
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    app()

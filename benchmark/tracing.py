"""Spans set on the program from outside, the profiled stretch, and the
reading of its trace.

A span names a call into one of the program's layers. A metric file lists
the spans it reads (``SPANS``); each is one of

* ``{"method": name}`` - a method of the model object;
* ``{"function": name, "modules": [...]}`` - a function as the named
  modules look it up (``torch.autograd`` for ``grad``);
* ``{"backward_of": span}`` - the autograd nodes that the calls of another
  span leave, timed as they run in the backward pass.

The span ``step`` is always the step the cell's entry drives (its
``SPANS``, set over the readers'; ``core.span_specs``): readers list only
the spans they add, and read ``step`` as whatever step that is.

Every span keeps the host seconds of each call. While the profiler runs, a
span is also a ``record_function`` range named ``span::<name>``, and a
device event (kernel, copy, fill) belongs to a span when the host call that
launched it started inside one of the span's ranges, on any thread.

The profiler records a short steady stretch of the window: it starts at the
step the entry names (the middle of the window's middle checkpoint chunk,
away from the checkpoints), runs ``profile["warmup"]`` steps unrecorded and
records ``profile["steps"]``.
The card is synchronized before and after, and that stretch is left out of
the rate that ``step_mfu`` reads.
"""

import bisect
import importlib
import json
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    def __init__(self, specs, workdir, profile):
        self.specs = specs
        self.workdir = workdir
        self.profile = profile
        self.host = defaultdict(list)  # span -> host seconds per call
        self.restore = []
        self.prof = None
        self.recording = False
        self.step_index = 0
        self.start_step = None
        self.stop_step = None
        self.prof_wall = 0.0
        self.prof_steps = 0
        self.trace_path = None
        self.backward = {s["backward_of"]: name for name, s in specs.items() if "backward_of" in s}

    # -- installing ------------------------------------------------------------------
    def install(self, model, start_step):
        self.start_step = start_step
        self.stop_step = start_step + self.profile["warmup"] + self.profile["steps"]
        for name, spec in self.specs.items():
            if "method" in spec:
                orig = getattr(model, spec["method"])
                setattr(model, spec["method"], self._wrap(name, orig))
                self.restore.append((model, spec["method"], None))
            elif "function" in spec:
                for modname in spec["modules"]:
                    mod = importlib.import_module(modname)
                    orig = getattr(mod, spec["function"])
                    setattr(mod, spec["function"], self._wrap(name, orig))
                    self.restore.append((mod, spec["function"], orig))

    def uninstall(self):
        for obj, attr, orig in reversed(self.restore):
            if orig is None:
                delattr(obj, attr)  # the instance attribute over the class's method
            else:
                setattr(obj, attr, orig)
        self.restore = []

    def _wrap(self, name, fn):
        is_step = name == "step"
        bwd = self.backward.get(name)

        def wrapped(*args, **kwargs):
            if is_step:
                self._before_step()
            t0 = time.perf_counter()
            if self.recording:
                with torch.profiler.record_function(f"span::{name}"):
                    out = fn(*args, **kwargs)
                if bwd is not None:
                    _range_backward(out, args, kwargs, f"span::{bwd}")
            else:
                out = fn(*args, **kwargs)
            self.host[name].append(time.perf_counter() - t0)
            if is_step:
                self._after_step()
            return out

        return wrapped

    # -- the profiled stretch ------------------------------------------------------------
    def _before_step(self):
        if self.step_index != self.start_step:
            return
        _sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.trace_path = self.workdir / "trace.json"
        sched = torch.profiler.schedule(wait=0, warmup=self.profile["warmup"],
                                        active=self.profile["steps"], repeat=1)
        self.prof = torch.profiler.profile(
            activities=acts, schedule=sched,
            on_trace_ready=lambda p: p.export_chrome_trace(str(self.trace_path)))
        self._t_prof = time.perf_counter()
        self.prof.__enter__()
        self.recording = True

    def _after_step(self):
        self.step_index += 1
        if self.prof is None:
            return
        self.prof.step()
        if self.step_index == self.stop_step:
            self.prof.__exit__(None, None, None)
            _sync()
            self.recording = False
            self.prof = None
            self.prof_wall = time.perf_counter() - self._t_prof
            self.prof_steps = self.stop_step - self.start_step

    # -- reading -------------------------------------------------------------------------
    def view(self, cell, problem, data, window, device):
        trace = None
        if self.trace_path is not None and self.trace_path.exists():
            trace = Trace(self.trace_path)
            if not trace.device:
                trace = None
        return View(self, trace, cell, problem, data, window, device)


def _range_backward(out, args, kwargs, label):
    """Open a ``record_function`` range around every autograd node that a
    call made: the nodes between its output and the grad_fn of its tensor
    inputs (found from the output backwards)."""
    if not isinstance(out, torch.Tensor) or out.grad_fn is None:
        return
    stop = {a.grad_fn for a in list(args) + list(kwargs.values())
            if isinstance(a, torch.Tensor) and a.grad_fn is not None}
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen or node in stop:
            continue
        if type(node).__name__ == "AccumulateGrad":
            continue
        seen.add(node)
        todo.extend(nxt for nxt, _ in node.next_functions)
    for node in seen:
        rng = {}

        def pre(grad_outputs, rng=rng):
            rng["r"] = torch.profiler.record_function(label)
            rng["r"].__enter__()

        def post(grad_inputs, grad_outputs, rng=rng):
            if "r" in rng:
                rng.pop("r").__exit__(None, None, None)

        node.register_prehook(pre)
        node.register_hook(post)


class Trace:
    """Device events and span ranges of an exported Chrome trace."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.spans = defaultdict(list)
        launch = {}
        device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat == "user_annotation" and e["name"].startswith("span::"):
                self.spans[e["name"][6:]].append((ts, ts + dur))
            elif cat in DEVICE_CATS:
                device.append((e["name"], ts, ts + dur, e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                launch[e.get("args", {}).get("correlation")] = ts
        for v in self.spans.values():
            v.sort()
        # (name, start, end, launch time on the host or None), by start
        self.device = sorted(((n, s, t, launch.get(c)) for n, s, t, c in device),
                             key=lambda e: (e[1], e[2]))
        steps = self.spans.get("step", [])
        self.n_steps = len(steps)
        if steps:
            first = steps[0][0]
            launched = [t for _, _, t, lt in self.device if lt is not None and lt >= first]
            self.t0, self.t1 = first, max([steps[-1][1]] + launched)
        else:
            self.t0 = min((s for _, s, _, _ in self.device), default=0.0)
            self.t1 = max((t for _, _, t, _ in self.device), default=0.0)
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.union = self._union()
        self.busy_s = sum(t - s for s, t in self.union) * 1e-6

    def _union(self):
        out = []
        for _, s, t, _ in self.device:
            s, t = max(s, self.t0), min(t, self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    def in_span(self, name):
        """Device events launched inside a range of span ``name``."""
        merged = []
        for s, t in self.spans.get(name, []):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        starts = [s for s, _ in merged]
        out = []
        for ev in self.device:
            lt = ev[3]
            if lt is None:
                continue
            i = bisect.bisect_right(starts, lt) - 1
            if i >= 0 and merged[i][1] >= lt:
                out.append(ev)
        return out

    @staticmethod
    def seconds(events):
        return sum(t - s for _, s, t, _ in events) * 1e-6

    def breakdown(self, top=10):
        """The device operations that took most time, and the device's idle
        time between its events grouped by the innermost span the host was
        in at the middle of each gap."""
        ops = defaultdict(float)
        for n, s, t, _ in self.device:
            ops[n] += (t - s) * 1e-6
        ranges = sorted((s, t, name) for name, rs in self.spans.items() for s, t in rs)
        starts = [r[0] for r in ranges]
        gaps = defaultdict(float)
        edges = [self.t0] + [x for iv in self.union for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            label = "host outside spans"
            # the innermost span: the latest start whose range holds the gap
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                s, t, name = ranges[j]
                if t >= mid:
                    label = f"host in {name}"
                    break
            gaps[label] += (b - a) * 1e-6
        return {
            "device_ops": [[n, v] for n, v in sorted(ops.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
        }


class View:
    """What a per-layer metric's reader reads: the trace of the profiled
    stretch (None without device events), the host seconds of every span
    over the whole window, the window's steps and times, the cell and its
    data."""

    def __init__(self, tracer, trace, cell, problem, data, window, device):
        self.trace = trace
        self.host = tracer.host
        self.cell = cell
        self.problem = problem
        self.data = data
        self.window = window
        self.device = device
        self.prof_wall = tracer.prof_wall
        self.prof_steps = tracer.prof_steps
        self._live = None

    def peaks(self):
        """This device's row of ``peaks.json``, or None."""
        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
        with open(self.cell.dir / "peaks.json") as f:
            return json.load(f).get(kind)

    def steps_per_s_unprofiled(self):
        """The window's rate over its steps and time outside the profiled
        stretch."""
        steps = self.window["steps"] - self.prof_steps
        wall = self.window["wall_s"] - self.prof_wall
        return steps / wall if wall > 0 else None

    def live_fraction(self):
        """The share of (pixel, offset bin) pairs of the cell's data with
        the pixel above the bin, which the likelihood has to evaluate."""
        if self._live is None:
            g = torch.as_tensor(sorted(self.problem["offset_samples"]), dtype=torch.float32,
                                device=self.device)
            x = torch.as_tensor(self.data["images"]).to(self.device).reshape(-1)
            below = torch.searchsorted(g, x, side="left")  # bins under each pixel
            self._live = float(below.double().sum()) / (x.numel() * g.numel())
            del x, below
        return self._live

    def likelihood_count(self):
        """Operations and bytes of one step's likelihood (forward and
        backward), from the frozen count and the cell's shapes."""
        cfg = self.cell.cfg
        M, nb = self.cell.reference.likelihood_shape(cfg)
        geo = cfg["geometry"]
        count = self.cell.count("offset_gamma")
        return count.forward_backward(M, nb, geo["P"] ** 2, geo["offset_bins"],
                                      self.live_fraction())

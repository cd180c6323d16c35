"""The fit entry: a window of ``Model.run``, the SVI loop users run.

Set-up builds the model the program's way (``models[name]()``, the data on
``model.data`` in memory, ``Model.init``), starts the program's seed stream
from ``--seed``, and drives its first steps through ``Model.run`` on the
window's own route: the program draws each step's batch
(``_draw_batch``) and its standard-Gamma draws (``std_gamma_sample_packed``
as the model modules call it) itself. Each step's batch and draws are read
back as the step returns, with its loss, the Adam moments after the first
step and the parameters before and after; the reference takes the same
batches and draws and judges them. A short stretch of ``_run_chunk`` then
warms up. The window is one ``Model.run(num_iter)`` call of a fixed number
of whole checkpoint chunks (``--seconds`` at the cell's ``window``
rate), checkpoints included as the program makes them, timed by the host
clock up to a synchronize.
"""

import importlib
import time
import warnings

import numpy as np
import torch

# the span that marks a step (the profiled stretch counts these)
SPANS = {"step": {"method": "_sparse_step"}}
# the modules whose calls of the packed standard-Gamma draw are read back
DRAW_MODULES = ("tapqir_tpu_torch.models.cosmos", "tapqir_tpu_torch.models.hmm")
DRAW_FUNCTION = "std_gamma_sample_packed"


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def end_to_end(window):
    """The window's end-to-end metrics: every step completed over all its
    time."""
    return {"fit_steps_per_s": window["steps"] / window["wall_s"]}


class Run:
    def __init__(self, cell, data, seed, workdir, device, log=lambda msg: None):
        self.cell, self.data, self.seed = cell, data, seed
        self.workdir, self.device, self.log = workdir, device, log
        self.model = None
        self.num_iter = None

    def program_model(self):
        """The name of the program's model: the configuration's ``model``,
        which also names its reference."""
        return self.cell.cfg["model"]

    def build(self):
        from tapqir_tpu_torch.models import models
        from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

        from benchmark import simulate

        cfg, traffic = self.cell.cfg, self.cell.traffic
        geo, fit = cfg["geometry"], cfg["fit"]
        d = self.data
        dataset = CosmosDataset(images=d["images"], xy=d["xy"], is_ontarget=d["is_ontarget"],
                                offset=OffsetData(d["offset_samples"], d["offset_weights"]),
                                name=self.cell.config_entry["name"])
        model = models[self.program_model()](S=geo["S"], K=geo["K"], device=self.device,
                                             dtype=fit["dtype"])
        model.data = dataset
        model.path = self.workdir
        model.run_path = self.workdir / ".tapqir"
        model.frame_sampling = fit["frame_sampling"]
        if "checkpoint_interval" in traffic:
            model.checkpoint_interval = traffic["checkpoint_interval"]
        with warnings.catch_warnings():  # the benchmark's arrays are read-only
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            model.init(lr=fit["lr"], nbatch_size=fit["nbatch"], fbatch_size=fit["fbatch"])
        model._seed = simulate.chunk_seed(self.seed, 0, "program")
        self.model = model
        return model

    def checked_steps(self):
        """Drive the first steps through ``Model.run`` on the window's route
        and read back each step's batch and draws; returns the program's
        state for the comparison."""
        model, n_steps = self.model, self.cell.traffic["checked_steps"]
        F = self.data["images"].shape[1]
        state = {"losses": [], "mu1": None, "p0": _host(model.params), "batches": [],
                 "draws": []}
        made = {}  # the latest batch and draw the program made

        def draw_batch(*args, **kwargs):
            made["batch"] = out = orig_batch(*args, **kwargs)
            return out

        def record_draw(orig):
            def packed(*args, **kwargs):
                made["draws"] = out = orig(*args, **kwargs)
                return out
            return packed

        def step(generator, batch=None, draws=None):
            loss = orig_step(generator, batch=batch, draws=draws)
            if "batch" not in made or "draws" not in made:
                raise RuntimeError("a checked step made no batch through _draw_batch or no "
                                   f"draw through {DRAW_FUNCTION} of {', '.join(DRAW_MODULES)}")
            ndx, fidx, _ = made["batch"]
            fidx = torch.arange(F) if fidx is None else fidx
            state["batches"].append((ndx.cpu().numpy().astype(np.int64),
                                     fidx.cpu().numpy().astype(np.int64)))
            state["draws"].append(torch.cat([a.detach().reshape(-1).double()
                                             for a in made["draws"]]).cpu().numpy())
            state["losses"].append(float(loss))
            if len(state["losses"]) == 1:
                state["mu1"] = _host(model.opt_state["mu"])
            return loss

        orig_step, orig_batch = model._sparse_step, model._draw_batch
        mods = [importlib.import_module(m) for m in DRAW_MODULES]
        origs = [getattr(m, DRAW_FUNCTION) for m in mods]
        model._sparse_step, model._draw_batch = step, draw_batch
        for m, o in zip(mods, origs):
            setattr(m, DRAW_FUNCTION, record_draw(o))
        try:
            model.run(n_steps)
        finally:
            del model._sparse_step, model._draw_batch
            for m, o in zip(mods, origs):
                setattr(m, DRAW_FUNCTION, o)
        if len(state["losses"]) != n_steps:
            raise RuntimeError(f"Model.run({n_steps}) took {len(state['losses'])} steps "
                               "through _sparse_step")
        state["p_end"] = _host(model.params)
        return state

    def setup(self, seconds):
        """Build, the checked steps, warm-up; sizes the window: the whole
        chunks nearest to ``seconds`` at the cell's window rate, the same
        work in every run of the cell."""
        t = time.perf_counter()
        self.build()
        t1 = time.perf_counter()
        state = self.checked_steps()
        t2 = time.perf_counter()
        n = self.cell.traffic["warmup_steps"]
        _sync(self.device)
        t0 = time.perf_counter()
        self.warm_up(n)
        _sync(self.device)
        rate = n / (time.perf_counter() - t0)
        chunk = self.chunk()
        per_s = self.cell.window["steps_per_s"]
        self.num_iter = chunk * max(1, round(seconds * per_s / chunk))
        self.log(f"[{self.cell.name}] Model.init {t1 - t:.3f} s; checked steps "
                 f"{t2 - t1:.3f} s; warm-up {n} steps at {rate:.3f} "
                 f"steps/s; window of {self.num_iter} steps")
        return state

    def chunk(self):
        """Steps between the window's host reads: a checkpoint chunk."""
        return self.cell.traffic["checkpoint_interval"]

    def warm_up(self, num_steps):
        self.model._run_chunk(num_steps)

    def drive(self, num_iter):
        """The window's one call of the program."""
        self.model.run(num_iter)

    def profile_start(self):
        """The window step at which the profiled stretch starts: the middle
        of the middle chunk."""
        chunk = self.chunk()
        p = self.cell.traffic["profile"]
        start = chunk * (self.num_iter // chunk // 2) + chunk // 2
        if start + p["warmup"] + p["steps"] > self.num_iter:
            raise ValueError(f"a window of {self.num_iter} steps cannot hold the profiled stretch")
        return start

    def window(self):
        model, dev = self.model, self.device
        _sync(dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        it0 = model.iter
        t0 = time.perf_counter()
        self.drive(self.num_iter)
        _sync(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
        return {"steps": model.iter - it0, "attempted": self.num_iter, "wall_s": wall,
                "memory_peak_bytes": int(peak)}

    def close(self):
        self.model = None


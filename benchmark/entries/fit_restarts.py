"""The restarts entry: a window of ``fit_restarts``, the batched random
restarts that ``tapqir fit -R`` runs before the fit.

Set-up builds the model as the fit entry does (``entries/fit.py``, with the
configuration's ``restarts["model"]`` as the program's model) and drives
the first steps through one ``fit_restarts`` call on the window's route:
the program draws each chain's batch (``_draw_batch(chains=R)``) and its
standard-Gamma draws itself. A wrapper around ``Model._restart_step`` reads
back each chain's batch and packed draw vector, its loss, the (R, ...) Adam
moments mu after step 1 and the (R, ...) parameters before step 1 and
after the last; the harness gets one batch and one draw vector per chain
and step, step-major, which the reference takes and judges. A short
``fit_restarts`` call then warms up. The window is one ``fit_restarts``
call of a fixed number of whole 200-step chunks (``--seconds`` at the
cell's ``window`` rate), its one host read of the losses a chunk and the
hand-over of the best chain included, timed by the host clock up to a
synchronize. Each call is seeded from ``--seed`` (``fit_restarts(seed=)``).
"""

import importlib
from pathlib import Path

import numpy as np
import torch

from benchmark import core, simulate

_fit = core.load_module(Path(__file__).with_name("fit.py"))

# the span that marks a step (the profiled stretch counts these)
SPANS = {"step": {"method": "_restart_step"}}
DRAW_MODULES, DRAW_FUNCTION = _fit.DRAW_MODULES, _fit.DRAW_FUNCTION
_host, end_to_end = _fit._host, _fit.end_to_end


class Run(_fit.Run):
    def program_model(self):
        return self.cell.cfg["restarts"]["model"]

    def _restarts(self, num_iter, call):
        """One ``fit_restarts`` call of ``num_iter`` steps, the ``call``-th
        of the run, seeded from ``--seed``."""
        from tapqir_tpu_torch.parallel.restarts import fit_restarts

        r = self.cell.cfg["restarts"]
        return fit_restarts(self.model, r["num_restarts"], num_iter,
                            perturb=r["perturb"], chunk=self.chunk(),
                            seed=simulate.chunk_seed(self.seed, call, "restarts"))

    def checked_steps(self):
        """Drive the first steps through ``fit_restarts`` on the window's
        route and read back each chain's batch and draws; returns the
        program's state for the comparison."""
        model, n_steps = self.model, self.cell.traffic["checked_steps"]
        F = self.data["images"].shape[1]
        state = {"losses": [], "mu1": None, "p0": None, "p_end": None, "batches": [],
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

        def step(params, mu, nu, *args, **kwargs):
            if state["p0"] is None:
                state["p0"] = _host(params)
            made.clear()
            losses = orig_step(params, mu, nu, *args, **kwargs)
            if "batch" not in made or "draws" not in made:
                raise RuntimeError("a checked step made no batch through _draw_batch or no "
                                   f"draw through {DRAW_FUNCTION} of {', '.join(DRAW_MODULES)}")
            ndx, fidx, _ = made["batch"]  # (R, n), (R, f) or None
            R = ndx.shape[0]
            packed = torch.cat([a.detach().reshape(R, -1).double() for a in made["draws"]],
                               -1).cpu().numpy()
            for c in range(R):
                frames = torch.arange(F) if fidx is None else fidx[c]
                state["batches"].append((ndx[c].cpu().numpy().astype(np.int64),
                                         frames.cpu().numpy().astype(np.int64)))
                state["draws"].append(packed[c])
                state["losses"].append(float(losses[c]))
            if state["mu1"] is None:
                state["mu1"] = _host(mu)
            made["params"] = params
            return losses

        orig_step, orig_batch = model._restart_step, model._draw_batch
        mods = [importlib.import_module(m) for m in DRAW_MODULES]
        origs = [getattr(m, DRAW_FUNCTION) for m in mods]
        model._restart_step, model._draw_batch = step, draw_batch
        for m, o in zip(mods, origs):
            setattr(m, DRAW_FUNCTION, record_draw(o))
        try:
            self._restarts(n_steps, 0)
        finally:
            del model._restart_step, model._draw_batch
            for m, o in zip(mods, origs):
                setattr(m, DRAW_FUNCTION, o)
        R = self.cell.cfg["restarts"]["num_restarts"]
        if len(state["losses"]) != n_steps * R:
            raise RuntimeError(f"fit_restarts({R}, {n_steps}) took "
                               f"{len(state['losses'])} chain steps through _restart_step")
        state["p_end"] = _host(made["params"])  # after the last step, updated in place
        return state

    def chunk(self):
        return self.cell.traffic["chunk"]

    def warm_up(self, num_steps):
        self._restarts(num_steps, 1)

    def drive(self, num_iter):
        self._restarts(num_iter, 2)

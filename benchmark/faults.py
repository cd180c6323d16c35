"""Faults planted in the program's timed path, for the check's own tests and
for ``calibrate.py``: each is a context manager that patches the port while
it is open and restores it after. They break the step under the harness,
which then has to read ``correct`` false.

* ``frozen`` - a step that returns its state unchanged;
* ``half_batch`` - half of the batch left out, the mean taken over the rest;
* ``mean_draws`` - every standard-Gamma draw returns its concentration (the
  draw's mean) instead of a random variate;
* ``reused_draws`` - every step takes the first step's draws again;
* ``reused_batch`` - every step takes the first step's batch again.
"""

import contextlib

import torch

COSMOS = "tapqir_tpu_torch.models.cosmos"


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _cosmos():
    import importlib

    return importlib.import_module(COSMOS)


def _restoring(trees_of):
    """A step that restores, after each call, the trees ``trees_of(self,
    *args)`` names to what they held before it."""
    def make(orig):
        def step(self, *args, **kwargs):
            trees = trees_of(self, *args)
            saved = [{k: v.clone() for k, v in t.items()} for t in trees]
            out = orig(self, *args, **kwargs)
            with torch.no_grad():
                for t, old in zip(trees, saved):
                    for k, v in t.items():
                        v.copy_(old[k])
            return out
        return step
    return make


@contextlib.contextmanager
def frozen():
    """Both steps of the program frozen: the fit's ``_sparse_step`` (the
    model's parameters and Adam moments) and the restarts'
    ``_restart_step`` (the (R, ...) ``params``, ``mu`` and ``nu`` it is
    handed)."""
    from tapqir_tpu_torch.models.model import Model

    sparse = _restoring(lambda self, *a: [self.params, self.opt_state["mu"],
                                          self.opt_state["nu"]])
    restart = _restoring(lambda self, params, mu, nu, *a: [params, mu, nu])
    with _patched(Model, "_sparse_step", sparse), _patched(Model, "_restart_step", restart):
        yield


def half_batch():
    cls = _cosmos().cosmos

    def make(orig):
        def terms(self, win, generator, ndx, fidx, f_b, data, draws=None):
            keep = torch.zeros_like(data["mask"])
            keep[ndx[..., : ndx.shape[-1] // 2]] = 1
            local, aoi, glob = orig(self, win, generator, ndx, fidx, f_b,
                                    dict(data, mask=data["mask"] * keep), draws)
            return 2 * local, 2 * aoi, glob  # the mean over the half that is left
        return terms

    return _patched(cls, "_elbo_terms", make)


def mean_draws():
    def make(orig):
        def packed(concs, generator=None, draws=None, batch_dims=0):
            lead = tuple(concs[0].shape[:batch_dims])
            dt = min((c.dtype for c in concs), key=lambda d: torch.finfo(d).bits)
            mean = torch.cat([c.detach().reshape(lead + (-1,)).to(dt) for c in concs], -1)
            return orig(concs, generator, mean, batch_dims)
        return packed

    return _patched(_cosmos(), "std_gamma_sample_packed", make)


def reused_draws():
    first = []

    def make(orig):
        def packed(concs, generator=None, draws=None, batch_dims=0):
            if first:
                return orig(concs, generator, first[0], batch_dims)
            out = orig(concs, generator, draws, batch_dims)
            lead = tuple(concs[0].shape[:batch_dims])
            first.append(torch.cat([a.detach().reshape(lead + (-1,)) for a in out], -1))
            return out
        return packed

    return _patched(_cosmos(), "std_gamma_sample_packed", make)


def reused_batch():
    cls = _cosmos().cosmos
    first = []

    def make(orig):
        def draw_batch(self, generator, chains=None, row_generator=None):
            out = orig(self, generator, chains, row_generator)
            if not first:
                first.append(out)
            return first[0]
        return draw_batch

    return _patched(cls, "_draw_batch", make)


FAULTS = {"frozen": frozen, "half_batch": half_batch, "mean_draws": mean_draws,
          "reused_draws": reused_draws, "reused_batch": reused_batch}

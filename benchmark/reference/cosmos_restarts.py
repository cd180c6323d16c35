"""Plain reference of the first SVI steps of a cosmos fit's batched random
restarts (``tapqir fit -R``).

R chains start from the one set of initial values (``perturb`` 0, the
default of the program's restarts; no other is covered here) and step
together. Each chain takes its own batch of AOI rows and frames and its own
standard-Gamma draws, read back from the program as ``cosmos.py`` reads one
chain's; its -ELBO and window gradient are ``cosmos.py``'s, and the window
gradient is scattered into full-size zeros. Every chain is then updated by
optax's dense Adam over the whole (R, ...) parameters: mu and nu decay on
every element, rows outside the window included, one step count ``t`` for
every element and bias corrections 1 - b^t, with the gradients taken as
they are (no zeroing of non-finite values), as the program's
``_restart_step`` documents.

Where it departs from the program:

* the chains are scored one after another, one AOI row at a time
  (``cosmos.py``'s blocks), where the program scores every chain's window
  in one pass;
* the reference runs in float64 and computes its bias corrections in
  float64 as the program does (Python floats), so there is no per-row
  float32 step count to differ by, as in the sparse step.

The harness hands the steps in step-major order: step s of chain c is
``steps[s * R + c]``.
"""

import numpy as np
import torch

from benchmark.reference import cosmos as base

Spec, draw_moments = base.Spec, base.draw_moments


def num_restarts(cfg):
    return cfg["restarts"]["num_restarts"]


def dense_adam(params, grads, mu, nu, t, lr):
    """optax's ``adam(lr, b1=0.9, b2=0.999, eps=1e-8)`` at step count ``t``
    on every element, in place."""
    c1, c2 = 1.0 - base.B1**t, 1.0 - base.B2**t
    for k, p in params.items():
        g = grads[k]
        mu[k].mul_(base.B1).add_((1.0 - base.B1) * g)
        nu[k].mul_(base.B2).add_((1.0 - base.B2) * g * g)
        p.sub_(lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + base.ADAM_EPS))


def _host(tree):
    return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in tree.items()}


def run_steps(cfg, problem, steps, local="float64", glob="float64", device="cuda",
              fault=None):
    """The first ``len(steps) // R`` restart steps of R chains from the
    initial values: per chain and step the losses (step-major), the (R,
    ...) Adam moments mu after step 1 and the (R, ...) parameters before
    and after the steps (host float64 arrays, by leaf name), the batches
    and draws it took, and in the float64 run without a fault each step's
    :func:`cosmos.draw_moments` over every chain's draws (``draw_z``).

    ``steps`` as ``cosmos.run_steps`` takes them, R a step, in step-major
    order. ``fault`` ("half_batch" or "frozen") plants a fault."""
    R = num_restarts(cfg)
    if cfg["restarts"].get("perturb", 0.0) != 0.0:
        raise ValueError("the reference covers restarts from one init (perturb 0) only")
    if len(steps) % R:
        raise ValueError(f"{len(steps)} chain steps for {R} chains")
    spec = Spec(cfg, problem["Nt"], problem["F"], problem["C"])
    pdt = base.DTYPES["float64" if local == "float64" else "float32"]
    init = base.init_params(spec, problem["bg0"], pdt, device)
    params = {k: v.unsqueeze(0).repeat((R,) + (1,) * v.dim()).contiguous()
              for k, v in init.items()}
    p0 = _host(params)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    moments = local == glob == "float64" and fault is None
    offsets = torch.as_tensor(problem["offset_samples"], device=device)
    logits = torch.as_tensor(problem["offset_logits"], device=device)
    losses, mu1, draw_z = [], None, []
    for s in range(len(steps) // R):
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        pairs = []
        for c in range(R):
            st = steps[s * R + c]
            ndx = torch.as_tensor(st["ndx"], device=device)
            fidx = torch.as_tensor(st["fidx"], device=device)
            gdraws, ldraws = spec.unpack(torch.as_tensor(st["packed"], device=device),
                                         len(st["ndx"]), len(st["fidx"]))
            data = {
                "obs": torch.as_tensor(st["obs"], device=device),
                "xy": torch.as_tensor(st["xy"], device=device),
                "ont": torch.as_tensor(st["ont"], device=device).long(),
                "mask": torch.as_tensor(st["mask"], device=device),
                "offsets": offsets, "logits": logits, "gdraws": gdraws, "draws": ldraws,
            }
            chain = {k: v[c] for k, v in params.items()}
            base._PAIRS = [] if moments else None
            try:
                loss, wgrads, _ = base.loss_and_grads(spec, chain, {"ndx": ndx, "fidx": fidx},
                                                      data, local, glob,
                                                      half_batch=fault == "half_batch")
                if moments:
                    pairs += base._PAIRS
            finally:
                base._PAIRS = None
            losses.append(loss)
            for k, g in wgrads.items():  # the window's gradient in full-size zeros
                base.scatter(spec, k, grads[k][c], g.to(pdt), ndx, fidx)
        if moments:
            draw_z.append(base.draw_moments(pairs))
        if fault != "frozen":
            with torch.no_grad():
                dense_adam(params, grads, mu, nu, s + 1, cfg["fit"]["lr"])
        if s == 0:
            mu1 = _host(mu)  # zeros where the step changed nothing
    out = {"losses": losses, "mu1": mu1, "p0": p0, "p_end": _host(params),
           "batches": [(np.asarray(st["ndx"]), np.asarray(st["fidx"])) for st in steps],
           "draws": [np.asarray(st["packed"]) for st in steps]}
    if moments:
        out["draw_z"] = draw_z
    return out


def likelihood_shape(cfg):
    """(configs M, images nb) of one restart step's likelihood call: every
    chain's batch in one call, R x nbatch x fbatch x C images."""
    M, nb = base.likelihood_shape(cfg)
    return M, num_restarts(cfg) * nb


def param_leaves(cfg, Nt, F, C):
    """Every (R, ...) parameter leaf of the restarts as (shape, dtype name):
    the configuration's sizes (``Spec.init_values``), R chains, stored in
    the fit's dtype."""
    spec = Spec(cfg, Nt, F, C)
    R = num_restarts(cfg)
    values = spec.init_values(np.ones((C,)))
    return {k: ((R,) + tuple(np.shape(v)), cfg["fit"]["dtype"]) for k, v in values.items()}

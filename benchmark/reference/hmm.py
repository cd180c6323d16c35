"""Plain reference of a cosmos+hmm fit's first SVI steps.

The hidden Markov colocalization model of tapqir (``cosmos+hmm``,
github.com/gelles-brandeis/tapqir, ``tapqir/models/hmm.py``) on the cosmos
model of Ordabayev et al., eLife 2022 (doi 10.7554/eLife.73860), as the
port fits it. The target-specific state z follows a Markov chain over the
frames of each AOI and channel, with Dirichlet priors on its start
(``init``) and its transition matrix (``trans``); everything else is
cosmos's (``cosmos.py`` beside this file, whose helpers this file uses).
The guide over the chain is an inhomogeneous Markov chain q(z_f | z_{f-1})
with parameter ``z_trans`` (Nt, F, C, 1+S, 1+S); the spots' presence m has
one Bernoulli guide per state of z (``m_probs`` (1+S, K, Nt, F, C)), and
theta and m are summed out given z.

The ELBO is taken in closed form over the guide's chain: the start term,
the transition terms weighted by the pairwise marginals gamma_{f-1}(i)
A_f(i, j), and the per-frame cosmos terms weighted by the marginals
gamma_f(s). The marginals come from a left-to-right recursion over the
frames, gamma_f = gamma_{f-1} A_f (:func:`chain_marginals`), one frame at
a time in probability space: independent of the log-space prefix scan
that the program runs. A step takes every frame of its AOI rows (the chain
couples them), so the local terms are scaled by Nt / n only.

Departures from the upstream model's funsor ELBO, which the port makes
too:

* q(m | z) is restricted to the configurations feasible given z and
  renormalised: given z > 0 the model gives the configuration with no spot
  zero probability (theta points at a present spot), and upstream's
  unrestricted q(m | z) would give that configuration weight and the
  ELBO -inf;
* the ELBO is exact over z, theta and m (no enumeration by message
  passing, the same sum); the continuous sites take the program's
  reparameterized standard-Gamma draws (Beta and Dirichlet sites from
  Gamma pairs and sets), the global ones in float64.

Precision, faults, the row-by-row evaluation and the sparse Adam with its
per-row step counts are those of ``cosmos.py``. TF32 is off in every
matrix product but in the ``"tf32"`` variant. A configuration names the
model ``"hmm"``, the port's registry key for cosmos+hmm that is also this
file's name.
"""

import numpy as np
import torch

from benchmark.reference import cosmos as base
from benchmark.reference.cosmos import (
    DTYPES,
    affine_beta_concs,
    affine_beta_lp,
    beta_from_pair,
    dirichlet_from,
    dirichlet_lp,
    draw,
    exponential_lp,
    forward,
    gamma_lp,
    halfnormal_lp,
    log_probs_m,
    log_probs_theta,
    log_probs_z,
    m_configs,
)


class Spec(base.Spec):
    """Sizes, priors, constraints and draw layout of a cosmos+hmm
    configuration."""

    def constraints(self):
        c = super().constraints()
        del c["pi_mean"], c["pi_size"]
        c.update(init_mean=("simplex",), init_size=("positive",), trans_mean=("simplex",),
                 trans_size=("positive",), z_trans=("simplex",))
        return c

    def init_values(self, bg0):
        v = super().init_values(bg0)
        del v["pi_mean"], v["pi_size"]
        K, Q, S1, Nt, F, C = self.K, self.Q, self.S + 1, self.Nt, self.F, self.C
        v.update(
            init_mean=np.ones((Q, S1)) / S1, init_size=np.full((Q, 1), 2.0),
            trans_mean=np.ones((Q, S1, S1)) / S1, trans_size=np.full((Q, S1, 1), 2.0),
            z_trans=np.full((Nt, F, C, S1, S1), 1.0 / S1),
            m_probs=np.full((S1, K, Nt, F, C), 0.5),
        )
        return v

    @staticmethod
    def group(name):
        if name == "z_trans":  # (Nt, F, C, 1+S, 1+S)
            return "af", 0
        if name == "m_probs":  # (1+S, K, Nt, F, C)
            return "af", 2
        return base.Spec.group(name)

    def global_draw_shapes(self):
        """gain, lamda, init, trans, proximity c1, proximity c0: the order
        of hmm's packed draw."""
        Q, S1 = self.Q, self.S + 1
        return {"gain": (1,), "lamda": (Q,), "init": (Q * S1,), "trans": (Q * S1 * S1,),
                "pg1": (1,), "pg0": (1,)}


# -- the chain -------------------------------------------------------------------------

def chain_marginals(A):
    """q(z_f) of the guide's chain from its transition matrices ``A``
    (..., F, C, 1+S, 1+S), rows q(z_f | z_{f-1}), the chain starting from
    row 0 of the first: gamma_0 = A_0[0] and gamma_f = gamma_{f-1} A_f,
    one frame after another. Returns (..., F, C, 1+S)."""
    gamma = [A[..., 0, :, 0, :]]
    for f in range(1, A.shape[-4]):
        gamma.append((gamma[-1][..., :, None] * A[..., f, :, :, :]).sum(-2))
    return torch.stack(gamma, -3)


def chain_term(A, gamma, lp_init, lp_trans):
    """E_q[log p(z) - log q(z)] of one chain per AOI row, (n,): the start
    term over q(z_0) = A_0[0] and each transition term over the pairwise
    marginals gamma_{f-1}(i) A_f(i, j). ``A`` (n, F, C, 1+S, 1+S), ``gamma``
    (n, F, C, 1+S), ``lp_init`` (n, C, 1+S), ``lp_trans`` (n, C, 1+S, 1+S)."""
    q0 = A[:, 0, :, 0, :]
    start = (q0 * (lp_init - torch.log(q0))).sum((-2, -1))
    pairs = gamma[:, :-1, :, :, None] * A[:, 1:]
    steps = (pairs * (lp_trans[:, None] - torch.log(A[:, 1:]))).sum((-4, -3, -2, -1))
    return start + steps


def log_probs_trans(trans, ont):
    """(n, Q, 1+S, 1+S): log trans for on-target AOIs; off-target AOIs
    stay in z = 0 (every row [1, 0, ...])."""
    off = torch.zeros_like(trans)
    off[..., 0] = 1.0
    on_l, off_l = (torch.log(torch.clamp(t, min=1e-30)) for t in (trans, off))
    return torch.where((ont == 1)[:, None, None, None], on_l[None], off_l[None])


# -- the ELBO --------------------------------------------------------------------------

def global_sites(spec, gw, gdraws):
    """Constrained global parameters and their samples, in the dtype of
    ``gw`` (the global windows)."""
    cons = spec.constraints()
    g = {k: forward(cons[k], v) for k, v in gw.items()}
    pc1, pc0 = affine_beta_concs(g["proximity_loc"], g["proximity_size"], 0.0, spec.prox_high)
    init_conc = g["init_mean"] * g["init_size"]
    trans_conc = g["trans_mean"] * g["trans_size"]
    sites = {
        "gain": draw((g["gain_loc"] * g["gain_beta"]).reshape(1), gdraws["gain"])[0]
        / g["gain_beta"],
        "lamda": draw(g["lamda_loc"] * g["lamda_beta"], gdraws["lamda"]) / g["lamda_beta"],
        "init": dirichlet_from(draw(init_conc.reshape(-1), gdraws["init"])
                               .reshape(init_conc.shape)),
        "trans": dirichlet_from(draw(trans_conc.reshape(-1), gdraws["trans"])
                                .reshape(trans_conc.shape)),
        "proximity": spec.prox_high * beta_from_pair(draw(pc1.reshape(1), gdraws["pg1"])[0],
                                                     draw(pc0.reshape(1), gdraws["pg0"])[0]),
    }
    return g, sites


def global_term(spec, g, sites):
    pri = spec.priors
    gain, lamda, prox = sites["gain"], sites["lamda"], sites["proximity"]
    init, trans = sites["init"], sites["trans"]
    out = (halfnormal_lp(gain, pri["gain_std"])
           - gamma_lp(gain, g["gain_loc"] * g["gain_beta"], g["gain_beta"])
           + (exponential_lp(lamda, pri["lamda_rate"])
              - gamma_lp(lamda, g["lamda_loc"] * g["lamda_beta"], g["lamda_beta"])).sum()
           + exponential_lp(prox, pri["proximity_rate"])
           - affine_beta_lp(prox, g["proximity_loc"], g["proximity_size"], 0.0, spec.prox_high))
    flat = 1.0 / (spec.S + 1)
    out = out + (dirichlet_lp(init, torch.full_like(init, flat))
                 - dirichlet_lp(init, g["init_mean"] * g["init_size"])).sum()
    return out + (dirichlet_lp(trans, torch.full_like(trans, flat))
                  - dirichlet_lp(trans, g["trans_mean"] * g["trans_size"])).sum()


def state_tables(spec, ont, lamda, prox, h, w, xs, ys, lw):
    """Per-frame tables given z = s, spot tensors (n, f, Q, K): ``inner``
    (M, 1+S, n, f, Q), the logsumexp over theta of the model's discrete
    joint of (m, theta) given z; ``term_hw`` and ``term_q`` (M, n, f, Q),
    the spots' prior and guide terms of each configuration; and q(m | z)
    restricted to the configurations feasible given z, as log and weight
    (M, 1+S, n, f, Q), the weight exactly 0 where infeasible. ``lw`` holds
    the constrained local windows, ``m_probs`` as (1+S, n, f, Q, K)."""
    K, S, P, lim = spec.K, spec.S, spec.P, spec.lim
    pri = spec.priors
    wmin, wmax = pri["width_min"], pri["width_max"]
    dt, dev = h.dtype, h.device
    mtab = torch.as_tensor(m_configs(K), dtype=dt, device=dev)  # (M, K)
    lpt = log_probs_theta(K, S, dt, dev)  # (1+S, 1+K)
    lpm1, lpm0 = log_probs_m(lamda, K)  # (Q, 1+K, K)
    log_pm = (torch.einsum("mk,qtk->mtq", mtab, lpm1)
              + torch.einsum("mk,qtk->mtq", 1.0 - mtab, lpm0))  # (M, 1+K, Q)
    size_sp = ((P + 1) / (2 * prox)) ** 2 - 1.0
    lpxy_ns = affine_beta_lp(xs, 0.0, 2.0, -lim, lim) + affine_beta_lp(ys, 0.0, 2.0, -lim, lim)
    lpxy_sp = (affine_beta_lp(xs, 0.0, size_sp, -lim, lim)
               + affine_beta_lp(ys, 0.0, size_sp, -lim, lim))  # (n, f, Q, K)
    spec_tk = torch.as_tensor(np.arange(1 + K)[:, None] == 1 + np.arange(K), device=dev)
    lpxy_t = torch.where(spec_tk[:, None, None, None, :], lpxy_sp[None], lpxy_ns[None])
    term_xy = torch.einsum("mk,tnfqk->mtnfq", mtab, lpxy_t)  # (M, 1+K, n, f, Q)
    T = (lpt[None, :, :, None, None, None]  # (1, Z, T, 1, 1, 1)
         + log_pm[:, None, :, None, None, :]  # (M, 1, T, 1, 1, Q)
         + term_xy[:, None])  # (M, 1, T, n, f, Q)
    inner = torch.logsumexp(T, dim=2)  # (M, Z, n, f, Q)
    term_hw = torch.einsum("mk,nfqk->mnfq", mtab,
                           halfnormal_lp(h, pri["height_std"])
                           + affine_beta_lp(w, 1.5, 2.0, wmin, wmax))
    lq = (gamma_lp(h, lw["h_loc"] * lw["h_beta"], lw["h_beta"])
          + affine_beta_lp(w, lw["w_mean"], lw["w_size"], wmin, wmax)
          + affine_beta_lp(xs, lw["x_mean"], lw["size"], -lim, lim)
          + affine_beta_lp(ys, lw["y_mean"], lw["size"], -lim, lim))
    term_q = torch.einsum("mk,nfqk->mnfq", mtab, lq)
    # q(m | z = s) of the independent Bernoulli guide, then restricted: for
    # z > 0 the configuration with no spot is left out and the rest divided
    # by 1 - q(no spot | z = s)
    qm = lw["m_probs"]  # (1+S, n, f, Q, K)
    log_qm = (torch.einsum("mk,snfqk->msnfq", mtab, torch.log(qm))
              + torch.einsum("mk,snfqk->msnfq", 1.0 - mtab, torch.log1p(-qm)))
    feasible = torch.ones((1 << K, S + 1), dtype=dt, device=dev)
    feasible[0, 1:] = 0.0
    none = torch.log1p(-qm).sum(-1)  # (1+S, n, f, Q): log q(no spot | z = s)
    norm = torch.cat([torch.zeros_like(none[:1]),
                      torch.log(-torch.expm1(none[1:]))])  # log of the feasible mass
    feasible = feasible[:, :, None, None, None]
    log_qm = (log_qm - norm[None]) * feasible
    return inner, term_hw, term_q, log_qm, torch.exp(log_qm) * feasible


def local_sum(spec, win, sites, rows, data, local_dtype):
    """The masked sum of the local ELBO terms (the frames' terms and the
    chain's) over the AOI rows ``rows`` of the window, in
    ``local_dtype``."""
    dt = local_dtype
    cons = spec.constraints()
    lw = {k: forward(cons[k], win[k][rows].to(dt)) for k in ("b_loc", "b_beta", "z_trans")}
    bm = forward(cons["background_mean_loc"], win["background_mean_loc"][rows].to(dt))[:, 0]
    bs = forward(cons["background_std_loc"], win["background_std_loc"][rows].to(dt))[:, 0]
    for k in ("h_loc", "h_beta", "w_mean", "w_size", "x_mean", "y_mean", "size"):
        # (K, n, f, Q) -> (n, f, Q, K)
        lw[k] = forward(cons[k], torch.movedim(win[k][:, rows].to(dt), 0, -1))
    # (1+S, K, n, f, C) -> (1+S, n, f, C, K)
    lw["m_probs"] = forward(cons["m_probs"], torch.movedim(win["m_probs"][:, :, rows].to(dt),
                                                           1, -1))
    d = {k: v[rows] for k, v in data["draws"].items()}
    wmin, wmax = spec.priors["width_min"], spec.priors["width_max"]
    lim = spec.lim
    b = draw(lw["b_loc"] * lw["b_beta"], d["b"]) / lw["b_beta"]
    h = draw(lw["h_loc"] * lw["h_beta"], d["h"]) / lw["h_beta"]
    wc1, wc0 = affine_beta_concs(lw["w_mean"], lw["w_size"], wmin, wmax)
    xc1, xc0 = affine_beta_concs(lw["x_mean"], lw["size"], -lim, lim)
    yc1, yc0 = affine_beta_concs(lw["y_mean"], lw["size"], -lim, lim)
    w = wmin + (wmax - wmin) * beta_from_pair(draw(wc1, d["wc1"]), draw(wc0, d["wc0"]))
    xs = -lim + 2 * lim * beta_from_pair(draw(xc1, d["xc1"]), draw(xc0, d["xc0"]))
    ys = -lim + 2 * lim * beta_from_pair(draw(yc1, d["yc1"]), draw(yc0, d["yc0"]))
    gain, lamda, init, trans, prox = (sites[k].to(dt) for k in
                                      ("gain", "lamda", "init", "trans", "proximity"))
    obs = data["obs"][rows].to(dt)
    target = data["xy"][rows].to(dt)
    ont = data["ont"][rows]
    mask = data["mask"][rows].to(dt)
    offsets = data["offsets"].to(dt)
    logits = data["logits"].to(dt)

    A = lw["z_trans"]  # (n, F, C, 1+S, 1+S)
    gamma = chain_marginals(A)  # (n, F, C, 1+S)
    chain = chain_term(A, gamma, log_probs_z(init, ont), log_probs_trans(trans, ont))

    inner, term_hw, term_q, log_qm, wq = state_tables(spec, ont, lamda, prox, h, w, xs, ys, lw)
    loglik = base.likelihood(spec, obs, b, h, w, xs, ys, target, gain, None, offsets,
                             logits)  # (M, n, f, C)
    ell = (wq * (inner + (term_hw + loglik - term_q)[:, None] - log_qm)).sum(0)  # (1+S, n, f, Q)
    frames = (torch.movedim(gamma, -1, 0) * ell).sum(0)  # (n, f, C)
    lp_b = gamma_lp(b, (bm / bs)[:, None, :] ** 2, (bm / bs**2)[:, None, :])
    lq_b = gamma_lp(b, lw["b_loc"] * lw["b_beta"], lw["b_beta"])
    return (((frames + lp_b - lq_b).sum((-2, -1)) + chain) * mask).sum()


# -- the step --------------------------------------------------------------------------

def loss_and_grads(spec, params, batch, data, local="float64", glob="float64",
                   half_batch=False):
    """-ELBO of one step and its gradient with respect to every window, one
    AOI row at a time (its chain, its frames' tables and its likelihood).
    ``half_batch`` scores the first half of the rows only and takes their
    mean in place of the whole batch's (a fault for the check's own
    test)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = local == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _loss_and_grads(spec, params, batch, data, DTYPES[local], DTYPES[glob],
                               half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _loss_and_grads(spec, params, batch, data, ldt, gdt, half_batch):
    ndx, fidx = batch["ndx"], batch["fidx"]
    win = {}
    for k, v in params.items():
        w = base.gather(spec, k, v, ndx, fidx).detach()
        win[k] = w.to(gdt if spec.group(k)[0] == "g" else ldt).requires_grad_(True)
    n = ndx.shape[0]
    rows_used = n // 2 if half_batch else n
    scale_n = spec.Nt / rows_used  # every frame: no frame scale
    gw = {k: v for k, v in win.items() if spec.group(k)[0] == "g"}
    g, sites = global_sites(spec, gw, data["gdraws"])
    head = -(global_term(spec, g, sites).to(ldt)
             + base.aoi_term(spec, {k: win[k][:rows_used] for k in
                                    ("background_mean_loc", "background_std_loc")},
                             data["mask"][:rows_used], ldt) * scale_n)
    leaves = list(win.values())
    grads = [torch.zeros_like(v) for v in leaves]

    def accumulate(term, last):  # the global subgraph is kept until the last block
        for acc, gr in zip(grads, torch.autograd.grad(term, leaves, retain_graph=not last,
                                                      allow_unused=True)):
            if gr is not None:
                acc += gr

    blocks = [slice(r, r + 1) for r in range(rows_used)]
    loss = float(head.detach())
    accumulate(head, last=not blocks)
    for j, rows in enumerate(blocks):
        term = -scale_n * local_sum(spec, win, sites, rows, data, ldt)
        loss += float(term.detach())
        accumulate(term, last=j == len(blocks) - 1)
    return loss, dict(zip(win, grads)), win


def step_data(spec, problem, st, device):
    """One step's batch and data on ``device`` from a step of
    ``core.make_steps`` (rows, frames, data and the flat draw vector)."""
    ndx = torch.as_tensor(st["ndx"], device=device)
    fidx = torch.as_tensor(st["fidx"], device=device)
    gdraws, ldraws = spec.unpack(torch.as_tensor(st["packed"], device=device),
                                 len(st["ndx"]), len(st["fidx"]))
    data = {
        "obs": torch.as_tensor(st["obs"], device=device),  # (n, f, C, P*P)
        "xy": torch.as_tensor(st["xy"], device=device),
        "ont": torch.as_tensor(st["ont"], device=device).long(),
        "mask": torch.as_tensor(st["mask"], device=device),
        "offsets": torch.as_tensor(problem["offset_samples"], device=device),
        "logits": torch.as_tensor(problem["offset_logits"], device=device),
        "gdraws": gdraws, "draws": ldraws,
    }
    return {"ndx": ndx, "fidx": fidx}, data


def run_steps(cfg, problem, steps, local="float64", glob="float64", device="cuda",
              fault=None):
    """The first ``len(steps)`` SVI steps from the initial values, as
    ``cosmos.run_steps`` returns them: losses, the Adam state after step 1,
    the parameters before and after, the batches and draws taken, and in
    the float64 run without a fault each step's ``draw_moments``
    (``draw_z``). ``fault`` ("half_batch" or "frozen") plants a fault."""
    spec = Spec(cfg, problem["Nt"], problem["F"], problem["C"])
    pdt = DTYPES["float64" if local == "float64" else "float32"]
    params = base.init_params(spec, problem["bg0"], pdt, device)
    p0 = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.items()}
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()},
           "count": {"g": torch.zeros((), dtype=torch.int32, device=device),
                     "a": torch.zeros((spec.Nt,), dtype=torch.int32, device=device),
                     "af": torch.zeros((spec.Nt, spec.F), dtype=torch.int32, device=device)}}
    moments = local == glob == "float64" and fault is None
    losses, mu1, draw_z = [], None, []
    for i, st in enumerate(steps):
        batch, data = step_data(spec, problem, st, device)
        base._PAIRS = [] if moments else None
        try:
            loss, grads, win = loss_and_grads(spec, params, batch, data, local, glob,
                                              half_batch=fault == "half_batch")
            if moments:
                draw_z.append(base.draw_moments(base._PAIRS))
        finally:
            base._PAIRS = None
        losses.append(loss)
        if fault != "frozen":
            base.adam_step(spec, params, opt, batch, win, grads, cfg["fit"]["lr"])
        if i == 0:
            if fault == "frozen":  # the moments a step that changes nothing leaves
                mu1 = {k: np.zeros(v.shape) for k, v in p0.items()}
            else:
                mu1 = {k: v.detach().cpu().numpy().astype(np.float64)
                       for k, v in opt["mu"].items()}
    p_end = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.items()}
    out = {"losses": losses, "mu1": mu1, "p0": p0, "p_end": p_end,
           "batches": [(np.asarray(st["ndx"]), np.asarray(st["fidx"])) for st in steps],
           "draws": [np.asarray(st["packed"]) for st in steps]}
    if moments:
        out["draw_z"] = draw_z
    return out


def likelihood_shape(cfg):
    """(configs M, images nb) of one step's likelihood call: 2^K configs
    over nbatch x F x C images (every frame of the batch's rows)."""
    g, fit = cfg["geometry"], cfg["fit"]
    return 1 << g["K"], min(fit["nbatch"], g["Nt"]) * g["F"] * g["C"]

"""Plain reference of a cosmos fit's first SVI steps.

The model of Ordabayev et al., eLife 2022 (doi 10.7554/eLife.73860) as the
port fits it: the mean-field guide drawn by reparameterized Gamma draws,
the discrete latents z, theta and m summed out in closed form, the
offset-marginalized Gamma image likelihood, the subsampled-plate scales,
and the minibatch-sparse Adam of the port (window rows only, per-row step
counts). Plain PyTorch, written apart from the program, which it does not
import: every tensor is made here from the benchmark's data. The batches
and the standard-Gamma draws are the program's own, read back from its
steps as a served model's tokens are, and judged here as well
(:func:`draw_moments`).

Precision is an argument: ``local`` for the per-AOI-frame tensors, ``glob``
for the global guide sites. The reference runs both in float64; the control
runs one step below what the configuration states. ``"tf32"`` is float32
with TF32 matrix products.

The likelihood is a logsumexp over the offset bins per pixel, computed one
AOI row of the batch at a time with its gradient, so that a full-size batch
fits on the card (a crosstalk row's float64 tensors are ~1.6 GB each).
"""

import math

import numpy as np
import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
EXP_CLAMP = 30.0
SIGMOID_EPS = 1e-6
NEG_INF = -1e30
F32_EPS = float(np.finfo(np.float32).eps)

DTYPES = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32,
          "bfloat16": torch.bfloat16}

# the per-AOI-frame guide sites, in the order of the program's packed draw
LOCAL_SITES = ("b", "h", "wc1", "xc1", "yc1", "wc0", "xc0", "yc0")


# -- constraints ----------------------------------------------------------------

def _bexp(u):
    return torch.exp(torch.clamp(u, -EXP_CLAMP, EXP_CLAMP))


def _bsig(u):
    return torch.clamp(torch.sigmoid(u), SIGMOID_EPS, 1.0 - SIGMOID_EPS)


def _logit(p):
    return torch.log(p) - torch.log1p(-p)


def forward(kind, u):
    """Constrained value of unconstrained ``u`` for a constraint ``kind``:
    ("positive",), ("unit",), ("interval", low, high), ("gt", bound) or
    ("simplex",)."""
    name = kind[0]
    if name == "positive":
        return _bexp(u)
    if name == "unit":
        return _bsig(u)
    if name == "interval":
        return kind[1] + (kind[2] - kind[1]) * _bsig(u)
    if name == "gt":
        return kind[1] + _bexp(u)
    if name == "simplex":
        return torch.softmax(u, dim=-1)
    raise ValueError(kind)


def inverse(kind, x):
    name = kind[0]
    if name == "positive":
        return torch.log(x)
    if name == "unit":
        return _logit(x)
    if name == "interval":
        return _logit((x - kind[1]) / (kind[2] - kind[1]))
    if name == "gt":
        return torch.log(x - kind[1])
    if name == "simplex":
        return torch.log(x / x.sum(-1, keepdim=True))
    raise ValueError(kind)


# -- distributions ----------------------------------------------------------------

def gamma_lp(x, conc, rate):
    return (torch.xlogy(conc, rate) + torch.xlogy(conc - 1.0, x) - rate * x
            - torch.lgamma(conc))


def halfnormal_lp(x, scale):
    return 0.5 * math.log(2.0 / math.pi) - math.log(scale) - 0.5 * (x / scale) ** 2


def exponential_lp(x, rate):
    return math.log(rate) - rate * x


def _lgamma(v):
    return math.lgamma(v) if isinstance(v, (int, float)) else torch.lgamma(v)


def beta_lp(u, c1, c0):
    return (torch.xlogy(c1 - 1.0, u) + torch.xlogy(c0 - 1.0, 1.0 - u)
            + _lgamma(c1 + c0) - _lgamma(c1) - _lgamma(c0))


def affine_beta_concs(mean, size, low, high):
    return size * (mean - low) / (high - low), size * (high - mean) / (high - low)


def affine_beta_lp(x, mean, size, low, high):
    c1, c0 = affine_beta_concs(mean, size, low, high)
    return beta_lp((x - low) / (high - low), c1, c0) - math.log(high - low)


def dirichlet_lp(x, conc):
    return (torch.xlogy(conc - 1.0, x).sum(-1) + torch.lgamma(conc.sum(-1))
            - torch.lgamma(conc).sum(-1))


class GammaDraw(torch.autograd.Function):
    """The given standard-Gamma draw ``z`` at concentration ``conc``, with
    the implicit reparameterization gradient dz/dconc (non-finite values
    zeroed)."""

    @staticmethod
    def forward(ctx, conc, z):
        ctx.save_for_backward(conc, z)
        return z.clone()

    @staticmethod
    def backward(ctx, grad):
        conc, z = ctx.saved_tensors
        if conc.dtype in (torch.float32, torch.float64):
            dz = torch._standard_gamma_grad(conc, z)
        else:  # no half-precision kernel: computed in float32, rounded back
            dz = torch._standard_gamma_grad(conc.float(), z.float()).to(conc.dtype)
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))
        return grad * dz, None


# (concentration, draw) pairs of the step being run, while a caller collects them
_PAIRS = None


def draw(conc, z):
    if _PAIRS is not None:
        _PAIRS.append((conc.detach().double().reshape(-1), z.detach().double().reshape(-1)))
    return GammaDraw.apply(conc, z.to(conc.dtype))


def draw_moments(pairs):
    """How far a step's standard-Gamma draws stray from Gamma(concentration,
    1): the first and second central moments, each summed over every draw
    in units of its own spread and scaled to one standard normal variate
    (a sound draw reads |z| of a few; a draw that returns its mean, or
    comes from another law, reads hundreds)."""
    a = torch.cat([c for c, _ in pairs])
    x = torch.cat([z for _, z in pairs])
    d = x - a
    n = math.sqrt(a.numel())
    z1 = float((d / torch.sqrt(a)).sum()) / n
    z2 = float(((d * d - a) / torch.sqrt(2.0 * a * a + 6.0 * a)).sum()) / n
    return z1, z2


def beta_from_pair(g1, g0):
    u = g1 / (g1 + g0)
    eps = torch.finfo(u.dtype).eps
    return torch.clamp(u, eps, 1.0 - eps)


def dirichlet_from(g):
    out = g / g.sum(-1, keepdim=True)
    out = torch.clamp(out, torch.finfo(out.dtype).eps, 1.0)
    return out / out.sum(-1, keepdim=True)


# -- the model's structure ----------------------------------------------------------

def m_configs(K):
    """(2^K, K) 0/1 table of spot-presence configurations, config m holding
    spot k when bit k of m is set."""
    return np.array([[(m >> k) & 1 for k in range(K)] for m in range(1 << K)], np.float64)


def probs_m(lamda, K):
    """p(m_k = 1 | theta), (Q, 1 + K, K), for lamda (Q,)."""
    def tpois(lam, n):  # truncated Poisson over 0..n
        k = torch.arange(n, dtype=lam.dtype, device=lam.device)
        body = torch.exp(torch.xlogy(k, lam[..., None]) - lam[..., None] - torch.lgamma(k + 1.0))
        return torch.cat([body, 1.0 - body.sum(-1, keepdim=True)], -1)

    dt, dev = lamda.dtype, lamda.device
    if K > 1:
        base = (torch.arange(1, K, dtype=dt, device=dev) * tpois(lamda, K - 1)[..., 1:K]).sum(-1) / (K - 1)
    else:
        base = torch.zeros_like(lamda)
    row0 = (torch.arange(1, K + 1, dtype=dt, device=dev) * tpois(lamda, K)[..., 1:]).sum(-1) / K
    out = torch.cat([row0[..., None, None].expand(lamda.shape + (1, K)),
                     base[..., None, None].expand(lamda.shape + (K, K))], -2)
    eye = torch.cat([torch.zeros((1, K), dtype=torch.bool, device=dev),
                     torch.eye(K, dtype=torch.bool, device=dev)])
    return torch.where(eye, torch.ones((), dtype=dt, device=dev), out)


def log_probs_m(lamda, K):
    pm = probs_m(lamda, K)
    eye = torch.cat([torch.zeros((1, K), dtype=torch.bool, device=lamda.device),
                     torch.eye(K, dtype=torch.bool, device=lamda.device)])
    safe = torch.where(eye, torch.full_like(pm, 0.5), torch.clamp(pm, 1e-30, 1.0 - 1e-7))
    log1 = torch.where(eye, torch.zeros_like(pm), torch.log(safe))
    log0 = torch.where(eye, torch.full_like(pm, NEG_INF), torch.log1p(-safe))
    return log1, log0


def log_probs_theta(K, S, dtype, device):
    tab = np.zeros((1 + S, 1 + K))
    tab[0, 0] = 1.0
    tab[1:, 1:] = 1.0 / K
    out = np.where(tab > 0, np.log(np.maximum(tab, 1e-300)), NEG_INF)
    return torch.as_tensor(out, dtype=dtype, device=device)


def log_probs_z(pi, ont):
    """(n, Q, 1 + S): log pi for on-target AOIs, z = 0 for off-target."""
    on = torch.log(torch.clamp(pi, min=1e-30))
    off = torch.zeros_like(pi)
    off[..., 0] = 1.0
    off = torch.log(torch.clamp(off, min=1e-30))
    return torch.where((ont == 1)[:, None, None], on[None], off[None])


def gaussian_spots(h, w, x, y, target, P):
    """Spots on the P x P grid, flat (idx = row * P + column): h, w, x, y
    (..., K) against target (..., 2) broadcast over K; returns (..., K,
    P * P)."""
    dt = h.dtype
    idx = torch.arange(P * P, device=h.device)
    gy = torch.div(idx, P, rounding_mode="floor").to(dt)
    gx = (idx % P).to(dt)
    sx = x + target[..., 0][..., None]
    sy = y + target[..., 1][..., None]
    var = w**2
    d2 = (gx - sx[..., None]) ** 2 + (gy - sy[..., None]) ** 2
    return h[..., None] * torch.exp(-d2 / (2.0 * var[..., None])
                                    - torch.log(2.0 * math.pi * var)[..., None])


def offset_gamma_lp(x, conc, rate, offsets, logits):
    """Per-pixel log sum_j w_j Gamma(x - g_j; conc, rate) over the bins
    with x > g_j. ``x`` (..., px) broadcasts against ``conc`` (M, ...,
    px)."""
    d = x[..., None] - offsets
    ok = d > 0
    d_safe = torch.where(ok, d, torch.ones_like(d))
    inner = (conc[..., None] - 1.0) * torch.log(d_safe) - rate * d_safe + logits
    inner = torch.where(ok, inner, torch.full_like(inner, -torch.inf))
    return conc * torch.log(rate) - torch.lgamma(conc) + torch.logsumexp(inner, -1)


# -- the configuration ---------------------------------------------------------------

class Spec:
    """Sizes, priors and constraints of one configuration."""

    PRIORS = {"background_mean_std": 1000.0, "background_std_std": 100.0,
              "lamda_rate": 1.0, "height_std": 10000.0, "width_min": 0.75,
              "width_max": 2.25, "proximity_rate": 1.0, "gain_std": 50.0}

    def __init__(self, cfg, Nt, F, C):
        g = cfg["geometry"]
        self.K, self.S, self.P = g["K"], g["S"], g["P"]
        self.Nt, self.F, self.C, self.Q = Nt, F, C, C
        self.priors = dict(self.PRIORS)
        self.lim = (self.P + 1) / 2
        self.prox_high = (self.P + 1) / math.sqrt(12)
        self.crosstalk = cfg["model"] == "crosstalk"

    def constraints(self):
        wmin, wmax = self.priors["width_min"], self.priors["width_max"]
        lim, eps = self.lim, F32_EPS
        c = {
            "pi_mean": ("simplex",), "pi_size": ("positive",), "m_probs": ("unit",),
            "proximity_loc": ("interval", 0.0, self.prox_high - eps),
            "proximity_size": ("gt", 2.0), "lamda_loc": ("positive",),
            "lamda_beta": ("positive",), "gain_loc": ("positive",),
            "gain_beta": ("positive",), "background_mean_loc": ("positive",),
            "background_std_loc": ("positive",), "b_loc": ("positive",),
            "b_beta": ("positive",), "h_loc": ("positive",), "h_beta": ("positive",),
            "w_mean": ("interval", wmin + eps, wmax - eps), "w_size": ("gt", 2.0),
            "x_mean": ("interval", -lim + eps, lim - eps),
            "y_mean": ("interval", -lim + eps, lim - eps), "size": ("gt", 2.0),
        }
        if self.crosstalk:
            c.update(alpha_mean=("simplex",), alpha_size=("positive",))
        return c

    def alpha_prior(self):
        return np.ones((self.Q, self.C)) + np.eye(self.Q, self.C) * 9.0

    def init_values(self, bg0):
        """Constrained initial values; ``bg0`` (C,) = max(median pixel -
        mean offset, 1) per channel."""
        K, Q, S, Nt, F, C = self.K, self.Q, self.S, self.Nt, self.F, self.C
        kq = (K, Nt, F, Q)
        v = {
            "pi_mean": np.ones((Q, S + 1)) / (S + 1), "pi_size": np.full((Q, 1), 2.0),
            "m_probs": np.full(kq, 0.5), "proximity_loc": np.array(0.5),
            "proximity_size": np.array(100.0), "lamda_loc": np.full((Q,), 0.5),
            "lamda_beta": np.full((Q,), 100.0), "gain_loc": np.array(5.0),
            "gain_beta": np.array(100.0),
            "background_mean_loc": np.broadcast_to(bg0[None, None, :], (Nt, 1, C)),
            "background_std_loc": np.ones((Nt, 1, C)),
            "b_loc": np.broadcast_to(bg0[None, None, :], (Nt, F, C)),
            "b_beta": np.ones((Nt, F, C)), "h_loc": np.full(kq, 2000.0),
            "h_beta": np.full(kq, 0.001), "w_mean": np.full(kq, 1.5),
            "w_size": np.full(kq, 100.0), "x_mean": np.zeros(kq), "y_mean": np.zeros(kq),
            "size": np.full(kq, 200.0),
        }
        if self.crosstalk:
            a = self.alpha_prior()
            v.update(alpha_mean=a / a.sum(-1, keepdims=True), alpha_size=np.full((Q, 1), 2.0))
        return v

    @staticmethod
    def group(name):
        """("g", None) global, ("a", 0) per AOI, ("af", aoi axis) per AOI and
        frame (the frame axis follows the AOI axis)."""
        if name in ("b_loc", "b_beta"):
            return "af", 0
        if name in ("background_mean_loc", "background_std_loc"):
            return "a", 0
        if name in ("m_probs", "h_loc", "h_beta", "w_mean", "w_size", "x_mean",
                    "y_mean", "size"):
            return "af", 1
        return "g", None

    def global_draw_shapes(self):
        Q, S = self.Q, self.S
        out = {"gain": (1,), "lamda": (Q,), "pi": (Q * (S + 1),), "pg1": (1,), "pg0": (1,)}
        if self.crosstalk:
            out["alpha"] = (Q * self.C,)
        return out

    def local_draw_shapes(self, n, f):
        kq = (n, f, self.Q, self.K)
        return {"b": (n, f, self.C), "h": kq, "wc1": kq, "xc1": kq, "yc1": kq,
                "wc0": kq, "xc0": kq, "yc0": kq}

    def unpack(self, packed, n, f):
        """The global and local draws of a flat draw vector (the inverse of
        :meth:`pack`), by site name."""
        shapes = list(self.global_draw_shapes().items())
        loc = self.local_draw_shapes(n, f)
        shapes += [(k, loc[k]) for k in LOCAL_SITES]
        out, o = {}, 0
        for k, shp in shapes:
            size = math.prod(shp)
            out[k] = packed[o:o + size].reshape(shp)
            o += size
        if o != packed.numel():
            raise ValueError(f"a draw vector of {packed.numel()} for {o} draws")
        return ({k: out[k] for k in self.global_draw_shapes()},
                {k: out[k] for k in LOCAL_SITES})

    def pack(self, glob, loc):
        """The flat draw vector in the order of the program's draw seam:
        gain, lamda, pi, proximity c1, proximity c0, alpha (crosstalk), then
        background, height, width c1, x c1, y c1, width c0, x c0, y c0, each
        flattened row-major."""
        names = list(self.global_draw_shapes())
        return torch.cat([glob[k].reshape(-1) for k in names]
                         + [loc[k].reshape(-1) for k in LOCAL_SITES])


# -- the ELBO ------------------------------------------------------------------------

def global_sites(spec, gw, gdraws):
    """Constrained global parameters and their samples, in the dtype of
    ``gw`` (the global windows)."""
    cons = spec.constraints()
    g = {k: forward(cons[k], v) for k, v in gw.items()}
    pc1, pc0 = affine_beta_concs(g["proximity_loc"], g["proximity_size"], 0.0, spec.prox_high)
    pi_conc = g["pi_mean"] * g["pi_size"]
    gain = draw((g["gain_loc"] * g["gain_beta"]).reshape(1), gdraws["gain"])[0] / g["gain_beta"]
    lamda = draw(g["lamda_loc"] * g["lamda_beta"], gdraws["lamda"]) / g["lamda_beta"]
    pi = dirichlet_from(draw(pi_conc.reshape(-1), gdraws["pi"]).reshape(pi_conc.shape))
    prox = spec.prox_high * beta_from_pair(draw(pc1.reshape(1), gdraws["pg1"])[0],
                                           draw(pc0.reshape(1), gdraws["pg0"])[0])
    sites = {"gain": gain, "lamda": lamda, "pi": pi, "proximity": prox}
    if spec.crosstalk:
        a_conc = g["alpha_mean"] * g["alpha_size"]
        sites["alpha"] = dirichlet_from(draw(a_conc.reshape(-1), gdraws["alpha"]).reshape(a_conc.shape))
    return g, sites


def global_term(spec, g, sites):
    pri = spec.priors
    gain, lamda, prox, pi = sites["gain"], sites["lamda"], sites["proximity"], sites["pi"]
    out = (halfnormal_lp(gain, pri["gain_std"])
           - gamma_lp(gain, g["gain_loc"] * g["gain_beta"], g["gain_beta"])
           + (exponential_lp(lamda, pri["lamda_rate"])
              - gamma_lp(lamda, g["lamda_loc"] * g["lamda_beta"], g["lamda_beta"])).sum()
           + exponential_lp(prox, pri["proximity_rate"])
           - affine_beta_lp(prox, g["proximity_loc"], g["proximity_size"], 0.0, spec.prox_high))
    pi_prior = torch.full_like(pi, 1.0 / (spec.S + 1))
    out = out + (dirichlet_lp(pi, pi_prior) - dirichlet_lp(pi, g["pi_mean"] * g["pi_size"])).sum()
    if spec.crosstalk:
        alpha = sites["alpha"]
        prior = torch.as_tensor(spec.alpha_prior(), dtype=alpha.dtype, device=alpha.device)
        out = out + (dirichlet_lp(alpha, prior)
                     - dirichlet_lp(alpha, g["alpha_mean"] * g["alpha_size"])).sum()
    return out


def dye_tables(spec, ont, pi, lamda, prox, h, w, xs, ys, lw):
    """Per-dye tables (M, n, f, Q): the logsumexp over (z, theta) of the
    discrete joint, the spots' prior terms, log q(m) and the spots' guide
    terms. Spot tensors are (n, f, Q, K); ``lw`` the constrained local
    windows (n, f, Q, K)."""
    K, S, P, lim = spec.K, spec.S, spec.P, spec.lim
    pri = spec.priors
    wmin, wmax = pri["width_min"], pri["width_max"]
    dt, dev = h.dtype, h.device
    mtab = torch.as_tensor(m_configs(K), dtype=dt, device=dev)  # (M, K)
    lpz = log_probs_z(pi, ont)  # (n, Q, 1+S)
    lpt = log_probs_theta(K, S, dt, dev)  # (1+S, 1+K)
    lpm1, lpm0 = log_probs_m(lamda, K)  # (Q, 1+K, K)
    # sum over spots of log p(m_k | theta) per config: (M, 1+K, Q)
    log_pm = (torch.einsum("mk,qtk->mtq", mtab, lpm1)
              + torch.einsum("mk,qtk->mtq", 1.0 - mtab, lpm0))
    size_sp = ((P + 1) / (2 * prox)) ** 2 - 1.0
    lpxy_ns = affine_beta_lp(xs, 0.0, 2.0, -lim, lim) + affine_beta_lp(ys, 0.0, 2.0, -lim, lim)
    lpxy_sp = (affine_beta_lp(xs, 0.0, size_sp, -lim, lim)
               + affine_beta_lp(ys, 0.0, size_sp, -lim, lim))  # (n, f, Q, K)
    spec_tk = torch.as_tensor(np.arange(1 + K)[:, None] == 1 + np.arange(K), device=dev)
    # theta = t puts spot k at the target when t == k + 1: (1+K, n, f, Q, K)
    lpxy_t = torch.where(spec_tk[:, None, None, None, :], lpxy_sp[None], lpxy_ns[None])
    term_xy = torch.einsum("mk,tnfqk->mtnfq", mtab, lpxy_t)  # (M, 1+K, n, f, Q)
    T = (lpz.permute(2, 0, 1)[None, :, None, :, None, :]  # (1, Z, 1, n, 1, Q)
         + lpt[None, :, :, None, None, None]  # (1, Z, T, 1, 1, 1)
         + log_pm[:, None, :, None, None, :]  # (M, 1, T, 1, 1, Q)
         + term_xy[:, None])  # (M, 1, T, n, f, Q)
    inner = torch.logsumexp(T, dim=(1, 2))  # (M, n, f, Q)
    lph = halfnormal_lp(h, pri["height_std"])
    lpw = affine_beta_lp(w, 1.5, 2.0, wmin, wmax)
    term_hw = torch.einsum("mk,nfqk->mnfq", mtab, lph + lpw)
    qm = lw["m_probs"]
    log_qm = (torch.einsum("mk,nfqk->mnfq", mtab, torch.log(qm))
              + torch.einsum("mk,nfqk->mnfq", 1.0 - mtab, torch.log1p(-qm)))
    lq = (gamma_lp(h, lw["h_loc"] * lw["h_beta"], lw["h_beta"])
          + affine_beta_lp(w, lw["w_mean"], lw["w_size"], wmin, wmax)
          + affine_beta_lp(xs, lw["x_mean"], lw["size"], -lim, lim)
          + affine_beta_lp(ys, lw["y_mean"], lw["size"], -lim, lim))
    term_q = torch.einsum("mk,nfqk->mnfq", mtab, lq)
    return inner, term_hw, log_qm, term_q


def likelihood(spec, obs, b, h, w, xs, ys, target, gain, alpha, offsets, logits):
    """Per-config image log-likelihood summed over the pixels: cosmos (M,
    n, f, C) with spot k of dye q in channel q; crosstalk (G, n, f, C) over
    the 2^(K*Q) global configurations, every present spot of every dye
    scaled by alpha[q, c] in channel c."""
    K, P = spec.K, spec.P
    dt, dev = b.dtype, b.device
    if not spec.crosstalk:
        mtab = torch.as_tensor(m_configs(K), dtype=dt, device=dev)
        spots = gaussian_spots(h, w, xs, ys, target, P)  # (n, f, C=Q, K, px)
        img = b[None, ..., None] + torch.einsum("mk,nfckp->mnfcp", mtab, spots)
    else:
        Q = spec.Q
        full = m_configs(K)[(np.arange((1 << K) ** Q)[:, None] // (1 << K) ** np.arange(Q))
                            % (1 << K)]  # (G, Q, K)
        mtab = torch.as_tensor(full, dtype=dt, device=dev)
        spots = gaussian_spots(h[..., None, :], w[..., None, :], xs[..., None, :],
                               ys[..., None, :], target[:, :, None, :, :], P)  # (n, f, Q, C, K, px)
        img = b[None, ..., None] + torch.einsum("gqk,qc,nfqckp->gnfcp", mtab, alpha, spots)
    lp = offset_gamma_lp(obs, img / gain, 1.0 / gain, offsets, logits)
    return lp.sum(-1)


def local_sum(spec, win, sites, rows, data, local_dtype):
    """The masked sum of the local ELBO terms over the AOI rows ``rows`` of
    the window, in ``local_dtype``."""
    dt = local_dtype
    cons = spec.constraints()
    lw = {k: forward(cons[k], win[k][rows].to(dt)) for k in ("b_loc", "b_beta")}
    bm = forward(cons["background_mean_loc"], win["background_mean_loc"][rows].to(dt))[:, 0]
    bs = forward(cons["background_std_loc"], win["background_std_loc"][rows].to(dt))[:, 0]
    for k in ("m_probs", "h_loc", "h_beta", "w_mean", "w_size", "x_mean", "y_mean", "size"):
        # (K, n, f, Q) -> (n, f, Q, K)
        lw[k] = forward(cons[k], torch.movedim(win[k][:, rows].to(dt), 0, -1))
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
    gain, pi, lamda, prox = (sites[k].to(dt) for k in ("gain", "pi", "lamda", "proximity"))
    alpha = sites["alpha"].to(dt) if spec.crosstalk else None
    obs = data["obs"][rows].to(dt)
    target = data["xy"][rows].to(dt)
    ont = data["ont"][rows]
    mask = data["mask"][rows].to(dt)
    offsets = data["offsets"].to(dt)
    logits = data["logits"].to(dt)
    inner, term_hw, log_qm, term_q = dye_tables(spec, ont, pi, lamda, prox, h, w, xs, ys, lw)
    loglik = likelihood(spec, obs, b, h, w, xs, ys, target, gain, alpha, offsets, logits)
    if spec.crosstalk:
        Mq = 1 << spec.K
        cfg_idx = (np.arange(Mq ** spec.Q)[:, None] // Mq ** np.arange(spec.Q)) % Mq
        onehot = torch.as_tensor((cfg_idx[..., None] == np.arange(Mq)).astype(np.float64),
                                 dtype=dt, device=b.device)  # (G, Q, Mq)
        inner, term_hw, log_qm, term_q = (torch.einsum("gqm,mnfq->gnf", onehot, t)
                                          for t in (inner, term_hw, log_qm, term_q))
        loc = (torch.exp(log_qm) * (inner + term_hw + loglik.sum(-1) - log_qm - term_q)).sum(0)
        loc = loc[..., None] / spec.C  # (n, f, 1), spread over the channels
    else:
        loc = (torch.exp(log_qm) * (inner + term_hw + loglik - log_qm - term_q)).sum(0)
    lp_b = gamma_lp(b, (bm / bs)[:, None, :] ** 2, (bm / bs**2)[:, None, :])
    lq_b = gamma_lp(b, lw["b_loc"] * lw["b_beta"], lw["b_beta"])
    return ((loc + lp_b - lq_b) * mask[:, None, None]).sum()


def aoi_term(spec, win, mask, dt):
    cons = spec.constraints()
    bm = forward(cons["background_mean_loc"], win["background_mean_loc"].to(dt))[:, 0]
    bs = forward(cons["background_std_loc"], win["background_std_loc"].to(dt))[:, 0]
    pri = spec.priors
    return ((halfnormal_lp(bm, pri["background_mean_std"])
             + halfnormal_lp(bs, pri["background_std_std"])) * mask.to(dt)[:, None]).sum()


# -- the step --------------------------------------------------------------------------

def gather(spec, name, v, ndx, fidx):
    grp, ax = spec.group(name)
    if grp == "g":
        return v
    v = v.index_select(ax, ndx)
    return v.index_select(ax + 1, fidx) if grp == "af" else v


def scatter(spec, name, v, w, ndx, fidx):
    grp, ax = spec.group(name)
    if grp == "g":
        v.copy_(w)
        return
    if grp == "af":
        rows = v.index_select(ax, ndx)
        rows.index_copy_(ax + 1, fidx, w)
        w = rows
    v.index_copy_(ax, ndx, w)


def loss_and_grads(spec, params, batch, data, local="float64", glob="float64",
                   half_batch=False):
    """-ELBO of one step and its gradient with respect to every window, one
    AOI row at a time. ``half_batch`` scores the first half
    of the rows only and takes their mean in place of the whole batch's (a
    fault for the check's own test)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = local == "tf32"
    try:
        return _loss_and_grads(spec, params, batch, data, DTYPES[local], DTYPES[glob],
                               half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _loss_and_grads(spec, params, batch, data, ldt, gdt, half_batch):
    ndx, fidx = batch["ndx"], batch["fidx"]
    win = {}
    for k, v in params.items():
        w = gather(spec, k, v, ndx, fidx).detach()
        win[k] = w.to(gdt if spec.group(k)[0] == "g" else ldt).requires_grad_(True)
    n, f_b = ndx.shape[0], fidx.shape[0]
    rows_used = n // 2 if half_batch else n
    scale = (spec.Nt / rows_used) * (spec.F / f_b)
    scale_n = spec.Nt / rows_used
    gw = {k: v for k, v in win.items() if spec.group(k)[0] == "g"}
    g, sites = global_sites(spec, gw, data["gdraws"])
    head = -(global_term(spec, g, sites).to(ldt)
             + aoi_term(spec, {k: win[k][:rows_used] for k in
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
    loss = float(head)
    accumulate(head, last=not blocks)
    for j, rows in enumerate(blocks):
        term = -scale * local_sum(spec, win, sites, rows, data, ldt)
        loss += float(term)
        accumulate(term, last=j == len(blocks) - 1)
    return loss, dict(zip(win, grads)), win


def adam_step(spec, params, opt, batch, win, grads, lr):
    """The port's minibatch-sparse Adam on the window rows, in place:
    non-finite gradient elements zeroed, per-row-group step counts (a
    scalar for the globals, per AOI, per AOI and frame)."""
    ndx, fidx = batch["ndx"], batch["fidx"]
    counts = opt["count"]
    counts["g"] += 1
    t_a = counts["a"].index_select(0, ndx) + 1
    counts["a"].index_copy_(0, ndx, t_a)
    rows = counts["af"].index_select(0, ndx)
    t_af = rows.index_select(1, fidx) + 1
    rows.index_copy_(1, fidx, t_af)
    counts["af"].index_copy_(0, ndx, rows)
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k].to(p.dtype)
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            mu = B1 * gather(spec, k, opt["mu"][k], ndx, fidx) + (1.0 - B1) * g
            nu = B2 * gather(spec, k, opt["nu"][k], ndx, fidx) + (1.0 - B2) * g * g
            grp, ax = spec.group(k)
            if grp == "g":
                t = counts["g"].to(p.dtype)
            else:
                t = (t_a if grp == "a" else t_af).to(p.dtype)
                shape = [1] * p.ndim
                shape[ax] = t.shape[0]
                if grp == "af":
                    shape[ax + 1] = t.shape[1]
                t = t.reshape(shape)
            c1, c2 = 1.0 - B1**t, 1.0 - B2**t
            new = gather(spec, k, p, ndx, fidx) - lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
            scatter(spec, k, p, new, ndx, fidx)
            scatter(spec, k, opt["mu"][k], mu, ndx, fidx)
            scatter(spec, k, opt["nu"][k], nu, ndx, fidx)


def init_params(spec, bg0, dtype, device):
    """Unconstrained initial parameters, from the constrained values in
    float64, then rounded to ``dtype``."""
    cons = spec.constraints()
    return {k: inverse(cons[k], torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float64))
            .to(device=device, dtype=dtype).contiguous()
            for k, v in spec.init_values(bg0).items()}


def run_steps(cfg, problem, steps, local="float64", glob="float64", device="cuda",
              fault=None):
    """The first ``len(steps)`` SVI steps from the initial values: the
    losses, the Adam state after step 1 and the parameters before and after
    the steps (host float64 arrays, by leaf name), the batches and draws it
    took, and in the float64 run without a fault each step's
    :func:`draw_moments` (``draw_z``).

    ``problem`` holds the benchmark's host data (``Nt``, ``F``, ``C``,
    ``bg0``, the offsets) and ``steps`` each step's batch rows, frames and
    data, and its flat draw vector (``packed``, in :meth:`Spec.pack`'s
    order). ``fault`` ("half_batch" or "frozen") plants a fault."""
    global _PAIRS
    spec = Spec(cfg, problem["Nt"], problem["F"], problem["C"])
    pdt = DTYPES["float64" if local == "float64" else "float32"]
    params = init_params(spec, problem["bg0"], pdt, device)
    p0 = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.items()}
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()},
           "count": {"g": torch.zeros((), dtype=torch.int32, device=device),
                     "a": torch.zeros((spec.Nt,), dtype=torch.int32, device=device),
                     "af": torch.zeros((spec.Nt, spec.F), dtype=torch.int32, device=device)}}
    moments = local == glob == "float64" and fault is None
    losses, mu1, draw_z = [], None, []
    for i, st in enumerate(steps):
        ndx = torch.as_tensor(st["ndx"], device=device)
        fidx = torch.as_tensor(st["fidx"], device=device)
        batch = {"ndx": ndx, "fidx": fidx}
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
        _PAIRS = [] if moments else None
        try:
            loss, grads, win = loss_and_grads(spec, params, batch, data, local, glob,
                                              half_batch=fault == "half_batch")
            if moments:
                draw_z.append(draw_moments(_PAIRS))
        finally:
            _PAIRS = None
        losses.append(loss)
        if fault != "frozen":
            adam_step(spec, params, opt, batch, win, grads, cfg["fit"]["lr"])
        if i == 0:
            if fault == "frozen":  # the moments a step that changes nothing leaves
                mu1 = {k: np.zeros(v.shape) for k, v in p0.items()}
            else:
                mu1 = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in opt["mu"].items()}
    p_end = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.items()}
    out = {"losses": losses, "mu1": mu1, "p0": p0, "p_end": p_end,
           "batches": [(np.asarray(st["ndx"]), np.asarray(st["fidx"])) for st in steps],
           "draws": [np.asarray(st["packed"]) for st in steps]}
    if moments:
        out["draw_z"] = draw_z
    return out


def likelihood_shape(cfg):
    """(configs M, images nb) of one step's likelihood call: 2^K configs for
    cosmos, 2^(K*Q) global ones for crosstalk (Q = C dyes), over nbatch x
    fbatch x C images."""
    g, fit = cfg["geometry"], cfg["fit"]
    n, f = min(fit["nbatch"], g["Nt"]), min(fit["fbatch"], g["F"])
    spots = g["K"] * (g["C"] if cfg["model"] == "crosstalk" else 1)
    return 1 << spots, n * f * g["C"]

"""cosmos: multi-color time-independent colocalization model (counterpart of
tapqir_tpu/models/cosmos.py).

The generative model, the mean-field guide and the marginalized ELBO are the
JAX package's: the discrete latents z, theta and m are summed out with dense
tables and logsumexp, every guide site is drawn in ONE packed standard-Gamma
draw, and the image likelihood is the event-summed offset-Gamma kernel
(dense by default; the factored kernel with ``use_factored = True``).
Subsampled-plate scaling is (Nt/n)(F/f) for local terms and Nt/n for the
per-AOI terms.

Draw seams: :meth:`cosmos.elbo_from_windows` takes ``draws``, the packed
flat vector of standard-Gamma draws, in the JAX package's packing order
(gain, lamda, pi, proximity c1, proximity c0, a subclass's extra global
sites such as crosstalk's alpha, background, height, width c1, x c1, y c1,
width c0, x c0, y c0); :meth:`cosmos._probs_batch` takes the
sampled pi, lamda, proximity, x and y with a leading particle axis. Tests
feed the JAX package's draws through both.

Chains: every ELBO function also takes a leading chain axis R written out
(``vmap`` of the JAX package's restarts as a batch dimension): windows
(R, ...), batch rows (R, n) and frames (R, f) from ``_draw_batch(generator,
chains=R)``, the packed draw (R, N), discrete tables (M, R, ...), one
kernel launch for all R chains with per-chain rates 1/gain (R,), and the
ELBO of each chain, (R,). Without the chain axis every shape and every
random stream is the single-chain one.

After the fit, :meth:`cosmos.compute_probs_arrays` gives the posterior
marginals of z and theta, and :meth:`cosmos.compute_params` the credible
intervals that ``utils/stats.py`` writes out.
"""

import math

import numpy as np
import torch

from tapqir_tpu_torch import constraints, tracing
from tapqir_tpu_torch.distributions.core import (
    affine_beta_concentrations,
    affine_beta_log_prob,
    affine_beta_sample,
    beta_from_gamma_pair,
    categorical_sample,
    dirichlet_from_gammas,
    dirichlet_log_prob,
    dirichlet_sample,
    exponential_log_prob,
    gamma_log_prob,
    gamma_sample,
    halfnormal_log_prob,
    std_gamma_sample_packed,
)
from tapqir_tpu_torch.distributions.ksmogn import (
    offset_gamma_factored_summed,
    offset_gamma_log_prob_summed,
)
from tapqir_tpu_torch.distributions.util import expand_offtarget, gaussian_spots_flat
from tapqir_tpu_torch.infer.discrete import (
    log_probs_m,
    log_probs_theta,
    log_probs_z,
    m_configs,
    safe_log,
)
from tapqir_tpu_torch.models.model import Model
from tapqir_tpu_torch.ops.spot_render import spot_concentration
from tapqir_tpu_torch.ops.spot_tables import spot_tables
from tapqir_tpu_torch.parallel import sharding

DEFAULT_PRIORS = {
    "background_mean_std": 1000.0,
    "background_std_std": 100.0,
    "lamda_rate": 1.0,
    "height_std": 10000.0,
    "width_min": 0.75,
    "width_max": 2.25,
    "proximity_rate": 1.0,
    "gain_std": 50.0,
}


# the device bytes of one chunk of z_sample's Gumbel noise: 2000 samples at
# 856 AOIs x 790 frames x 2 channels would take ~21.6 GB in float64 at once
Z_SAMPLE_CHUNK_BYTES = 1 << 28


def _per_chain(a, gain, nd):
    """``a`` divided by each chain's ``gain`` (R,) (or by a 0-dim one)
    broadcast over ``a``'s last ``nd`` dims."""
    return a / gain.reshape(gain.shape + (1,) * nd)


def _chain_perms(R, n, generator, device):
    """(R, n): a uniform random permutation of range(n) per chain, from one
    (R, n) uniform draw."""
    return torch.rand((R, n), generator=generator, device=device).argsort(-1)


class cosmos(Model):
    r"""Multi-Color Time-Independent Colocalization Model.

    Reference: Ordabayev YA, Friedman LJ, Gelles J, Theobald DL. Bayesian
    machine learning analysis of single-molecule fluorescence colocalization
    images. eLife. 2022. doi: 10.7554/eLife.73860.
    """

    name = "cosmos"

    def __init__(self, S=1, K=2, Q=None, device=None, dtype="float32",
                 priors=None):
        merged = dict(DEFAULT_PRIORS)
        merged.update(priors or {})
        super().__init__(S=S, K=K, Q=Q, device=device, dtype=dtype,
                         priors=merged)
        self._global_params = ["gain", "proximity", "lamda", "pi"]
        self.conv_params = ["-ELBO", "proximity_loc", "gain_loc", "lamda_loc"]
        self.ci_params = [
            "gain", "pi", "lamda", "proximity",
            "background", "height", "width", "x", "y",
        ]

    # -- variational parameters -------------------------------------------------
    def param_spec(self):
        data = self.data
        K, Q, S = self.K, self.Q, self.S
        Nt, F, C, P = data.Nt, data.F, data.C, data.P
        eps = float(np.finfo(np.float32).eps)
        lim = (P + 1) / 2
        wmin, wmax = self.priors["width_min"], self.priors["width_max"]
        bg0 = np.maximum(data.median - data.offset.mean, 1.0)
        bg_init = np.broadcast_to(bg0[None, None, :], (Nt, 1, C))
        b_init = np.broadcast_to(bg0[None, None, :], (Nt, F, C))
        return {
            "pi_mean": (np.ones((Q, S + 1)) / (S + 1), constraints.simplex()),
            "pi_size": (np.full((Q, 1), 2.0), constraints.positive()),
            "m_probs": (np.full((K, Nt, F, Q), 0.5), constraints.unit_interval()),
            "proximity_loc": (
                np.array(0.5),
                constraints.interval(0.0, (P + 1) / math.sqrt(12) - eps),
            ),
            "proximity_size": (np.array(100.0), constraints.greater_than(2.0)),
            "lamda_loc": (np.full((Q,), 0.5), constraints.positive()),
            "lamda_beta": (np.full((Q,), 100.0), constraints.positive()),
            "gain_loc": (np.array(5.0), constraints.positive()),
            "gain_beta": (np.array(100.0), constraints.positive()),
            "background_mean_loc": (bg_init, constraints.positive()),
            "background_std_loc": (np.ones((Nt, 1, C)), constraints.positive()),
            "b_loc": (b_init, constraints.positive()),
            "b_beta": (np.ones((Nt, F, C)), constraints.positive()),
            "h_loc": (np.full((K, Nt, F, Q), 2000.0), constraints.positive()),
            "h_beta": (np.full((K, Nt, F, Q), 0.001), constraints.positive()),
            "w_mean": (
                np.full((K, Nt, F, Q), 1.5),
                constraints.interval(wmin + eps, wmax - eps),
            ),
            "w_size": (np.full((K, Nt, F, Q), 100.0), constraints.greater_than(2.0)),
            "x_mean": (
                np.zeros((K, Nt, F, Q)),
                constraints.interval(-lim + eps, lim - eps),
            ),
            "y_mean": (
                np.zeros((K, Nt, F, Q)),
                constraints.interval(-lim + eps, lim - eps),
            ),
            "size": (np.full((K, Nt, F, Q), 200.0), constraints.greater_than(2.0)),
        }

    def param_partition(self):
        """Axis names per variational parameter: per-AOI/per-frame
        parameters carry "aoi"/"frame", globals none."""
        spec = {}
        for name in self._transforms:
            if name in ("b_loc", "b_beta"):  # (Nt, F, C)
                spec[name] = ("aoi", "frame", None)
            elif name in ("background_mean_loc", "background_std_loc"):  # (Nt, 1, C)
                spec[name] = ("aoi", None, None)
            elif name in (
                "m_probs", "h_loc", "h_beta", "w_mean", "w_size",
                "x_mean", "y_mean", "size",
            ):  # (K, Nt, F, Q)
                spec[name] = (None, "aoi", "frame", None)
            else:
                spec[name] = ()
        return spec

    def _build_constants(self):
        K, S, dt, dev = self.K, self.S, self.dtype, self.device
        M = 1 << K
        self._const = {
            "mtab": torch.as_tensor(m_configs(K), dtype=dt, device=dev),
            "lpt": log_probs_theta(K, S, dt, dev),
            "mtab_np": m_configs(K),  # host tables of spot_tables
            "spec_tk": np.arange(1 + K)[:, None] == 1 + np.arange(K),
            "pi_prior": torch.full((self.Q, S + 1), 1.0 / (S + 1), dtype=dt, device=dev),
            "M": M,
        }

    # -- ELBO -----------------------------------------------------------------
    def _draw_batch(self, generator, chains=None, row_generator=None):
        """(ndx, fidx, f): ``n`` AOI rows without replacement and, when
        frames are subsampled, ``f`` frame indices - a sorted uniform subset
        (``frame_sampling="random"``) or a cyclic contiguous window at a
        random offset ("window"). ``fidx`` is None when f == F. Nt and F are
        those of the device data: on a mesh, the rank's block.

        ``chains`` = R draws R batches at once, each chain its own rows (R,
        n) and frames (R, f): a permutation per chain from one (R, Nt) and
        one (R, F) uniform draw. ``row_generator``, when given, draws the
        rows (on a mesh: the one the frame shards of a mesh row share)."""
        Nt, F = self._data_dev["xy"].shape[:2]
        n = min(self.nbatch_size, Nt)
        f = min(self.fbatch_size, F)
        dev = self.device
        rows = generator if row_generator is None else row_generator
        if chains is None:
            ndx = torch.randperm(Nt, generator=rows, device=dev)[:n]
        else:
            ndx = _chain_perms(chains, Nt, rows, dev)[:, :n]
        if f == F:
            return ndx, None, f
        if self.frame_sampling == "random":
            if chains is None:
                perm = torch.randperm(F, generator=generator, device=dev)
            else:
                perm = _chain_perms(chains, F, generator, dev)
            fidx = torch.sort(perm[..., :f], -1)[0]
        else:
            lead = () if chains is None else (chains,)
            f0 = torch.randint(0, F, lead + (1,), generator=generator, device=dev)
            fidx = (f0 + torch.arange(f, device=dev)) % F
        return ndx, fidx, f

    def elbo(self, params_u, generator, data, draws=None):
        """Minibatch ELBO from unconstrained parameters."""
        ndx, fidx, f = self._draw_batch(generator)
        win = self.gather_windows(params_u, ndx, fidx)
        return self.elbo_from_windows(win, generator, ndx, fidx, f, data, draws)

    def elbo_from_windows(self, win, generator, ndx, fidx, f_b, data,
                          draws=None, n_shards=1, frame_shards=1):
        """ELBO from pre-gathered unconstrained parameter windows; the
        optimizer step differentiates this function, so its gradients are
        window-shaped. With a chain axis (windows (R, ...), ``ndx`` (R, n),
        ``fidx`` (R, f)) it is each chain's ELBO, (R,).

        The plate scales take Nt and F from ``data``: on a mesh, the rank's
        padded block. There the global term is divided by ``n_shards`` so
        that the sum over the ranks counts it once, and the per-AOI term by
        ``frame_shards``, as every frame shard of a row scores it."""
        Nt, F = data["xy"].shape[:2]
        n = ndx.shape[-1]
        scale = (Nt / n) * (F / f_b)
        scale_n = Nt / n
        local, aoi_term, global_term = self._elbo_terms(
            win, generator, ndx, fidx, f_b, data, draws
        )
        return (global_term / n_shards + aoi_term * scale_n / frame_shards
                + local * scale)

    def _elbo_terms(self, win, generator, ndx, fidx, f_b, data, draws=None):
        """(sum of local per-(n,f,c) terms, sum of per-AOI terms, global
        term) for the batch, each (R,) with a chain axis."""
        priors = self.priors
        tf = self._transforms
        lead = tuple(ndx.shape[:-1])  # (R,) with a chain axis, else ()
        c = len(lead)
        F_l = data["xy"].shape[1]
        n_b = ndx.shape[-1]
        if fidx is None:
            fidx = torch.arange(F_l, device=ndx.device)
        flat_ndx = (ndx[..., :, None] * F_l + fidx[..., None, :]).reshape(-1)

        def g2a(arr):  # raw DATA (Nt, F, ...) -> (*lead, n, f, ...)
            flat = arr.reshape((arr.shape[0] * arr.shape[1],) + tuple(arr.shape[2:]))
            return flat.index_select(0, flat_ndx).reshape(
                lead + (n_b, f_b) + tuple(arr.shape[2:]))

        def pc(name):  # global parameter -> constrained
            return tf[name](win[name])

        def gk(name):  # window (*lead, K, n, f, Q) -> (*lead, n, f, Q, K), constrained
            return tf[name](torch.movedim(win[name], c, -1))

        obs = g2a(data["images"])  # (*lead, n, f, C, EVP)
        target_locs = g2a(data["xy"])  # (*lead, n, f, C, 2)
        ont = data["is_ontarget"][ndx]  # (*lead, n)
        mask = data["mask"][ndx]

        b_loc, b_beta = pc("b_loc"), pc("b_beta")
        h_loc, h_beta = gk("h_loc"), gk("h_beta")
        w_mean, w_size = gk("w_mean"), gk("w_size")
        x_mean, y_mean = gk("x_mean"), gk("y_mean")
        size = gk("size")
        qm = gk("m_probs")

        g = self._global_values(win)
        with tracing.span("elbo.sites"):
            sites, b, h, w, xs, ys = self._sample_sites(
                generator, g.__getitem__, b_loc, b_beta, h_loc, h_beta,
                w_mean, w_size, x_mean, y_mean, size, draws, c,
            )
        global_term = self._global_term(g, sites)
        # the samples enter the local terms in the model's dtype
        gain, pi, lamda, prox = (sites[k].to(self.dtype)
                                 for k in ("gain", "pi", "lamda", "proximity"))

        # per-AOI Delta sites (MAP background hyper-parameters)
        bm = pc("background_mean_loc")[..., 0, :]  # (*lead, n, C)
        bs = pc("background_std_loc")[..., 0, :]
        aoi_term = (
            (
                halfnormal_log_prob(bm, priors["background_mean_std"])
                + halfnormal_log_prob(bs, priors["background_std_std"])
            )
            * mask[..., None]
        ).sum((-2, -1))

        lp_b = gamma_log_prob(b, (bm / bs)[..., None, :] ** 2, (bm / bs**2)[..., None, :])
        lq_b = gamma_log_prob(b, b_loc * b_beta, b_beta)

        local = self._local_marginalized(
            obs, target_locs, ont, gain, pi, lamda, prox, b, h, w, xs, ys, qm,
            h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size, data,
        )
        local_sum = ((local + lp_b - lq_b) * mask[..., None, None]).sum((-3, -2, -1))
        return local_sum, aoi_term, global_term.to(self.dtype)

    def _global_values(self, win):
        """Every global parameter of the windows, constrained, in float64:
        the global sites' concentrations grow with the data (the gain
        site's reaches ~1e8 at eLife scale), and their log-densities and
        pathwise gradients cancel terms of ~c log c down to O(1), which
        float32 cannot hold."""
        tf = self._transforms
        return {k: tf[k](win[k].to(torch.float64))
                for k, axes in self.param_partition().items() if not axes}

    def _global_term(self, g, sites):
        """Prior minus guide log-density of the global sites, (R,) with a
        chain axis: ``g`` from :meth:`_global_values`, ``sites`` the float64
        samples by site name."""
        pi = sites["pi"]
        return self._gain_lamda_proximity_term(g, sites) + (
            dirichlet_log_prob(pi, self._const["pi_prior"])
            - dirichlet_log_prob(pi, g["pi_mean"] * g["pi_size"])
        ).sum(-1)

    def _gain_lamda_proximity_term(self, g, sites):
        """The gain, lamda and proximity sites' part of :meth:`_global_term`,
        which cosmos+hmm shares."""
        priors = self.priors
        prox_high = (self.data.P + 1) / math.sqrt(12)
        gain, lamda, prox = sites["gain"], sites["lamda"], sites["proximity"]
        return (
            halfnormal_log_prob(gain, priors["gain_std"])
            - gamma_log_prob(gain, g["gain_loc"] * g["gain_beta"], g["gain_beta"])
            + (
                exponential_log_prob(lamda, priors["lamda_rate"])
                - gamma_log_prob(lamda, g["lamda_loc"] * g["lamda_beta"], g["lamda_beta"])
            ).sum(-1)
            + exponential_log_prob(prox, priors["proximity_rate"])
            - affine_beta_log_prob(
                prox, g["proximity_loc"], g["proximity_size"], 0.0, prox_high
            )
        )

    def _extra_global_concs(self, pc):
        """Extra global Dirichlet sites of a subclass (crosstalk's alpha),
        folded into the packed draw: (names, concentrations with the event
        axis last). cosmos has none."""
        return [], []

    def _sample_sites(self, generator, pc, b_loc, b_beta, h_loc, h_beta,
                      w_mean, w_size, x_mean, y_mean, size, draws=None, c=0):
        """All guide-site draws in ONE packed standard-Gamma draw, in the
        JAX package's packing order, the extra global sites after the
        proximity pair; ``draws`` replaces the random vector (c = 1: a
        leading chain axis, each chain packed apart). ``pc`` gives the
        global parameters in float64 (:meth:`_global_values`), so the
        global sites are drawn in the model's dtype with the local ones and
        their samples and pathwise gradients are float64. Returns the
        global samples by site name (the extra sites' too) and the local
        samples b, h, w, xs, ys."""
        P = self.data.P
        lim = (P + 1) / 2
        wmin, wmax = self.priors["width_min"], self.priors["width_max"]
        prox_high = (P + 1) / math.sqrt(12)

        pi_conc = pc("pi_mean") * pc("pi_size")
        pg1, pg0 = affine_beta_concentrations(
            pc("proximity_loc"), pc("proximity_size"), 0.0, prox_high
        )
        extra_names, extra_concs = self._extra_global_concs(pc)
        wc1, wc0 = affine_beta_concentrations(w_mean, w_size, wmin, wmax)
        xc1, xc0 = affine_beta_concentrations(x_mean, size, -lim, lim)
        yc1, yc0 = affine_beta_concentrations(y_mean, size, -lim, lim)
        concs = [
            (pc("gain_loc") * pc("gain_beta"))[..., None],
            pc("lamda_loc") * pc("lamda_beta"),
            pi_conc.flatten(c),
            pg1[..., None],
            pg0[..., None],
            *extra_concs,
            b_loc * b_beta, h_loc * h_beta, wc1, xc1, yc1, wc0, xc0, yc0,
        ]
        if c:  # each chain packed apart
            g = std_gamma_sample_packed(concs, generator, draws, batch_dims=c)
        else:
            g = std_gamma_sample_packed(concs, generator, draws)
        n_extra = len(extra_names)
        sites = {
            "gain": g[0][..., 0] / pc("gain_beta"),
            "lamda": g[1] / pc("lamda_beta"),
            "pi": dirichlet_from_gammas(g[2].reshape(pi_conc.shape)),
            "proximity": prox_high * beta_from_gamma_pair(g[3][..., 0], g[4][..., 0]),
            **{nm: dirichlet_from_gammas(gg)
               for nm, gg in zip(extra_names, g[5:5 + n_extra])},
        }
        gb, gh, gw1, gx1, gy1, gw0, gx0, gy0 = g[5 + n_extra:]
        b = gb / b_beta
        h = gh / h_beta
        w = wmin + (wmax - wmin) * beta_from_gamma_pair(gw1, gw0)
        xs = -lim + 2 * lim * beta_from_gamma_pair(gx1, gx0)
        ys = -lim + 2 * lim * beta_from_gamma_pair(gy1, gy0)
        return sites, b, h, w, xs, ys

    def _dye_tables(self, ont, pi, lamda, prox, h, w, xs, ys, qm,
                    h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size):
        """Per-dye discrete tables, each (M=2^K, *lead, n, f, Q): ``inner``
        (the logsumexp over (z, theta) of the model's discrete joint),
        ``term_hw``, ``log_qm`` and ``term_q``; ``lead`` is a leading chain
        axis of the inputs, or none. The per-spot tables come from
        :func:`spot_tables` (on a card one kernel forward, two backward)."""
        K = self.K
        mtab = self._const["mtab"]  # (M, K)

        lpz = log_probs_z(pi, ont)  # (*lead, n, Q, 1+S)
        lpt = self._const["lpt"]  # (1+S, 1+K)
        lpm1, lpm0 = log_probs_m(lamda, K)  # (*lead, Q, 1+K, K)
        log_pm_sum = torch.einsum("mk,...qtk->m...tq", mtab, lpm1) + torch.einsum(
            "mk,...qtk->m...tq", 1.0 - mtab, lpm0
        )  # (M, *lead, 1+K, Q)
        term_xy, term_hw, term_q, log_qm = spot_tables(
            xs, ys, h, w, qm, h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size, prox,
            self._const["mtab_np"], self._const["spec_tk"], self.data.P, self.priors,
        )  # term_xy (M, *lead, 1+K, n, f, Q)

        T_full = (
            torch.movedim(lpz, -1, -3).unsqueeze(-2).unsqueeze(-4)[None]  # (1, *lead, Z, 1, n, 1, Q)
            + lpt[:, :, None, None, None]  # (Z, T, 1, 1, 1)
            + log_pm_sum.unsqueeze(-2).unsqueeze(-2).unsqueeze(-5)  # (M, *lead, 1, T, 1, 1, Q)
            + term_xy.unsqueeze(-5)  # (M, *lead, 1, T, n, f, Q)
        )
        inner = torch.logsumexp(T_full, dim=(-5, -4))  # (M, *lead, n, f, Q)
        return inner, term_hw, log_qm, term_q

    def _local_marginalized(self, obs, target_locs, ont, gain, pi, lamda, prox,
                            b, h, w, xs, ys, qm, h_loc, h_beta, w_mean, w_size,
                            x_mean, y_mean, size, data):
        """E_q(m)[ log-marginal over (z, theta) + spot priors + likelihood
        - guide terms ], per (*lead, n, f, c). Spot tensors are (*lead, n,
        f, Q, K)."""
        with tracing.span("elbo.tables"):
            inner, term_hw, log_qm, term_q = self._dye_tables(
                ont, pi, lamda, prox, h, w, xs, ys, qm,
                h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size,
            )
        wq = torch.exp(log_qm)
        with tracing.span("elbo.likelihood"):
            loglik = self._likelihood(obs, b, h, w, xs, ys, target_locs, gain, data)
        return (wq * (inner + term_hw + loglik - log_qm - term_q)).sum(0)  # (*lead, n, f, Q)

    @staticmethod
    def _spots_kernel_layout(h, w, xs, ys, target_locs, P, ev_pad):
        """Rendered spots in the factored kernel's (K, *lead, n, f, C, EVP)
        layout, made spot-major by moving the small (*lead, n, f, Q, K)
        parameters before the render instead of the rendered tensor after
        it."""

        def tr(a):  # (*lead, n, f, Q, K) -> (K, *lead, n, f, Q, 1)
            return torch.movedim(a, -1, 0)[..., None]

        g = gaussian_spots_flat(
            tr(h), tr(w), tr(xs), tr(ys), target_locs[None], P, ev_pad
        )  # (K, *lead, n, f, C, 1, EVP)
        return g[..., 0, :]

    def _likelihood(self, obs, b, h, w, xs, ys, target_locs, gain, data):
        """(M, *lead, n, f, C) event-summed KSMOGN log-likelihood on the
        flat padded pixel axis, ``lead`` a leading chain axis (gain (R,)) or
        none; all chains in one kernel launch, images chain-major, each
        chain with its rate 1 / gain.

        Default: the (M, *lead, batch, EVP) concentration of every config
        from :func:`spot_concentration` (on a card one render kernel
        forward and one backward), and the event sum in the summed kernel.
        With ``use_factored = True`` set on the model (as on the JAX
        package's): spots rendered spot-major, and the configs assembled
        inside the factored kernel from ``b / gain`` and the per-spot
        ``spots / gain``."""
        *lead, n_, f_, C_, ev_pad = obs.shape
        lead = tuple(lead)
        K = self.K
        P = self.data.P
        M = self._const["mtab"].shape[0]
        if getattr(self, "use_factored", False):
            spots = self._spots_kernel_layout(
                h, w, xs, ys, target_locs, P, ev_pad
            )  # (K, *lead, n, f, C, EVP)
            out = offset_gamma_factored_summed(
                obs.reshape(-1, ev_pad), _per_chain(b, gain, 3).reshape(-1),
                _per_chain(spots, gain, 4).reshape(K, -1, ev_pad), m_configs(K), 1.0 / gain,
                data["offset_samples"], data["offset_logits"], ev=P * P,
            )
        else:
            conc = spot_concentration(
                b, h, w, xs, ys, target_locs, gain, m_configs(K), P, ev_pad
            )  # (M, *lead, n * f * C, EVP)
            out = offset_gamma_log_prob_summed(
                obs.reshape(-1, ev_pad), conc.reshape(M, -1, ev_pad),
                1.0 / gain, data["offset_samples"], data["offset_logits"],
                event_ndims=1, ev=P * P,
            )
        return out.reshape((M,) + lead + (n_, f_, C_))

    # -- posterior probabilities ----------------------------------------------
    @staticmethod
    def _block(a, ndx, fdx):
        """(K, Nt, F, Q) -> the block (n, f, Q, K)."""
        return torch.movedim(a.index_select(1, ndx).index_select(2, fdx), 0, -1)

    def _probs_draws(self, pc, ndx, fdx, num_particles, generator=None):
        """The guide samples :meth:`_probs_batch` averages over, with a
        leading particle axis p: pi (p, Q, 1+S), lamda (p, Q), proximity
        (p,), xs and ys (p, n, f, Q, K)."""
        P = self.data.P
        lim = (P + 1) / 2
        size = self._block(pc["size"], ndx, fdx)
        p = (num_particles,)
        return {
            "pi": dirichlet_sample(pc["pi_mean"] * pc["pi_size"],
                                   p + pc["pi_mean"].shape[:-1], generator),
            "lamda": gamma_sample(pc["lamda_loc"] * pc["lamda_beta"], pc["lamda_beta"],
                                  p + pc["lamda_loc"].shape, generator),
            "proximity": affine_beta_sample(pc["proximity_loc"], pc["proximity_size"],
                                            0.0, (P + 1) / math.sqrt(12), generator, p),
            "xs": affine_beta_sample(self._block(pc["x_mean"], ndx, fdx), size, -lim,
                                     lim, generator, p + size.shape),
            "ys": affine_beta_sample(self._block(pc["y_mean"], ndx, fdx), size, -lim,
                                     lim, generator, p + size.shape),
        }

    def _particle_tables(self, lamda, prox, xs, ys):
        """The discrete tables of the posteriors for guide samples with a
        leading particle axis p, on the device and in the dtype of ``xs``:
        the config table (M, K), log p(theta | z) (1+S, 1+K), log p(m |
        theta) summed over spots (p, M, 1+K, Q) and the spots' position
        terms (p, M, 1+K, n, f, Q). ``lamda`` (p, Q), ``prox`` (p,), ``xs``
        and ``ys`` (p, n, f, Q, K)."""
        K, P = self.K, self.data.P
        lim = (P + 1) / 2
        dt, dev = xs.dtype, xs.device
        mtab = torch.as_tensor(m_configs(K), dtype=dt, device=dev)  # (M, K)
        lpt = log_probs_theta(K, self.S, dt, dev)  # (1+S, 1+K)
        spec_tk = torch.as_tensor(np.arange(1 + K)[:, None] == 1 + np.arange(K),
                                  device=dev)  # (1+K, K)
        lpm1, lpm0 = log_probs_m(lamda, K)  # (p, Q, 1+K, K)
        log_pm_sum = torch.einsum("mk,pqtk->pmtq", mtab, lpm1) + torch.einsum(
            "mk,pqtk->pmtq", 1.0 - mtab, lpm0
        )  # (p, M, 1+K, Q)
        size_sp = (((P + 1) / (2 * prox)) ** 2 - 1.0).reshape(-1, 1, 1, 1, 1)
        lpxy_ns = affine_beta_log_prob(xs, 0.0, 2.0, -lim, lim) + affine_beta_log_prob(
            ys, 0.0, 2.0, -lim, lim
        )  # (p, n, f, Q, K)
        lpxy_sp = affine_beta_log_prob(
            xs, 0.0, size_sp, -lim, lim
        ) + affine_beta_log_prob(ys, 0.0, size_sp, -lim, lim)
        lpxy_t = torch.where(
            spec_tk[:, None, None, None, :], lpxy_sp[:, None], lpxy_ns[:, None]
        )  # (p, 1+K, n, f, Q, K)
        term_xy = torch.einsum("mk,ptnfqk->pmtnfq", mtab, lpxy_t)
        return mtab, lpt, log_pm_sum, term_xy

    def _probs_batch(self, pc, ndx, fdx, data, num_particles, generator=None,
                     draws=None):
        """z and theta posterior marginals, (1+S, n, f, Q) and (K, n, f, Q),
        for one block of AOIs ``ndx`` x frames ``fdx``, averaged over
        ``num_particles`` guide samples (:meth:`_probs_draws`, from
        ``generator``). The particles are one batched computation on a
        leading particle axis. ``draws`` replaces the samples. Works on the
        device and in the dtype of ``pc``."""
        dt, dev = pc["x_mean"].dtype, pc["x_mean"].device
        ont = data["is_ontarget"].index_select(0, ndx)
        qm = self._block(pc["m_probs"], ndx, fdx)
        if draws is None:
            draws = self._probs_draws(pc, ndx, fdx, num_particles, generator)
        pi, lamda, prox, xs, ys = (
            torch.as_tensor(draws[k]).to(dtype=dt, device=dev)
            for k in ("pi", "lamda", "proximity", "xs", "ys")
        )
        mtab, lpt, log_pm_sum, term_xy = self._particle_tables(lamda, prox, xs, ys)

        # log p(z): (p, n, Q, 1+S), off-target AOIs forced into z = 0
        lpz = torch.movedim(safe_log(expand_offtarget(pi))[..., ont], -1, 1)
        T_full = (
            lpz.permute(0, 3, 1, 2)[:, None, :, None, :, None, :]  # (p, 1, Z, 1, n, 1, Q)
            + lpt[None, None, :, :, None, None, None]  # (1, 1, Z, T, 1, 1, 1)
            + log_pm_sum[:, :, None, :, None, None, :]  # (p, M, 1, T, 1, 1, Q)
            + term_xy[:, :, None]  # (p, M, 1, T, n, f, Q)
        )
        # log q(m) by selection, not by a product with the 0/1 config table:
        # at the bounds of unit_interval (float32 rounds the sigmoid to 0 or
        # 1) log(qm) or log1p(-qm) is -inf, which a product with 0 turns into
        # NaN; selected, it stays -inf and the logsumexp over m absorbs it
        log_qm = torch.where(
            mtab[:, None, None, None, :] > 0, torch.log(qm), torch.log1p(-qm)
        ).sum(-1)  # (M, n, f, Q)
        # p(z, theta | m, phi), then the expectation over q(m)
        T_norm = T_full - torch.logsumexp(T_full, dim=(2, 3), keepdim=True)
        r = torch.logsumexp(T_norm + log_qm[None, :, None, None], dim=1)  # (p, Z, T, n, f, Q)
        z_p = torch.exp(torch.logsumexp(r, dim=2))  # (p, Z, n, f, Q)
        th_p = torch.exp(torch.logsumexp(r, dim=1))[:, 1:]  # (p, K, n, f, Q)
        return z_p.mean(0), th_p.mean(0)

    def compute_probs_arrays(self, num_particles=50, generator=None, draws=None):
        """Full-dataset z_probs (Nt, F, Q, 1+S) and theta_probs (K, Nt, F, Q)
        as float64 numpy arrays.

        As in the JAX package, only the N on-target AOIs (which come first)
        are evaluated, in blocks of nbatch_size x fbatch_size, and the
        off-target rows stay 0. The last block of each axis is ragged where
        the JAX package pads it with repeated rows and drops them after; the
        result is the same. Without ``generator`` the particles come from a
        generator seeded with 0 (the JAX package's ``PRNGKey(0)``), so two
        calls return equal arrays. ``draws``, an iterable of one
        :meth:`_probs_batch` draws dict per block in block order, replaces
        the samples.

        On a mesh (collective) each rank evaluates its whole block at once
        with its own particles (a generator seeded with 1 + its rank
        unless ``generator``; ``draws``: the block's one draws dict) and
        zeroes the off-target rows, and the blocks are gathered: the first
        rank returns the arrays at the real AOI count, the others None
        (JAX: ``make_sharded_probs_fn``)."""
        if self._mesh is not None:
            return self._compute_probs_sharded(num_particles, generator, draws)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        blocks = None if draws is None else iter(draws)
        Nt, F, Q, N = self.data.Nt, self.data.F, self.Q, self.data.N
        nb, fb = self.nbatch_size, self.fbatch_size
        dev = self.device
        z_probs = torch.zeros((Nt, F, Q, 1 + self.S), dtype=self.dtype, device=dev)
        theta_probs = torch.zeros((self.K, Nt, F, Q), dtype=self.dtype, device=dev)
        with torch.no_grad():
            pc = self.constrained()
            for n0 in range(0, N, nb):
                n1 = min(n0 + nb, N)
                for f0 in range(0, F, fb):
                    f1 = min(f0 + fb, F)
                    z_p, th_p = self._probs_batch(
                        pc, torch.arange(n0, n1, device=dev),
                        torch.arange(f0, f1, device=dev), self._data_dev,
                        num_particles, generator,
                        None if blocks is None else next(blocks),
                    )
                    z_probs[n0:n1, f0:f1] = z_p.permute(1, 2, 3, 0)
                    theta_probs[:, n0:n1, f0:f1] = th_p
        return (z_probs.cpu().numpy().astype(np.float64),
                theta_probs.cpu().numpy().astype(np.float64))

    def _compute_probs_sharded(self, num_particles, generator, draws):
        mesh = self._mesh
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(1 + mesh.rank)
        data = self._data_dev
        n_l, f_l = data["xy"].shape[:2]
        dev = self.device
        with torch.no_grad():
            z_p, th_p = self._probs_batch(
                self.constrained(), torch.arange(n_l, device=dev),
                torch.arange(f_l, device=dev), data, num_particles, generator, draws)
            # off-target AOIs are never scored: zero them, as the blocks do
            ont = data["is_ontarget"].to(z_p.dtype)
            z = z_p.permute(1, 2, 3, 0) * ont[:, None, None, None]
            th = th_p * ont[None, :, None, None]
            z = sharding.gather_blocks(z, ("aoi", "frame", None, None), mesh)
            th = sharding.gather_blocks(th, (None, "aoi", "frame", None), mesh)
        if not mesh.is_main:
            return None, None
        Nt = self.data.Nt  # the mesh's AOI padding sliced off
        return (z[:Nt].cpu().numpy().astype(np.float64),
                th[:, :Nt].cpu().numpy().astype(np.float64))

    # -- posterior summaries ------------------------------------------------------
    @property
    def compute_probs(self):
        if not hasattr(self, "_probs_cache"):
            self._probs_cache = self.compute_probs_arrays()
        return self._probs_cache

    @property
    def z_probs(self):
        r"""Posterior marginal p(z), shape (Nt, F, Q, 1+S)."""
        return self.compute_probs[0]

    @property
    def theta_probs(self):
        r"""Posterior q(theta = k), shape (K, Nt, F, Q)."""
        return self.compute_probs[1]

    @property
    def m_probs(self):
        r"""Posterior spot presence q(m = 1), shape (K, Nt, F, Q)."""
        return self.param("m_probs")

    @property
    def pspecific(self):
        return self.z_probs

    @property
    def z_map(self):
        return np.argmax(self.z_probs, axis=-1)

    def z_sample(self, num_samples, generator=None):
        """z trajectories (num_samples, N, F, Q), int32 as the JAX package's,
        drawn from the saved posterior marginals ``params_stats["z_probs"]``;
        without ``generator``, from one seeded with 11 (the JAX package's
        ``PRNGKey(11)``). The samples are drawn in chunks whose Gumbel noise
        takes at most Z_SAMPLE_CHUNK_BYTES on the device, so the device
        holds a few times that at most, whatever ``num_samples``."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(11)
        probs = torch.as_tensor(
            np.asarray(self.params_stats["z_probs"][: self.data.N]), device=self.device
        ).clamp_min(1e-30)
        per = max(1, Z_SAMPLE_CHUNK_BYTES // (probs.numel() * probs.element_size()))
        z = np.empty((num_samples,) + tuple(probs.shape[:-1]), np.int32)
        for s0 in range(0, num_samples, per):
            s1 = min(s0 + per, num_samples)
            z[s0:s1] = categorical_sample(
                probs, (s1 - s0,) + tuple(probs.shape[:-1]), generator
            ).to(torch.int32).cpu().numpy()
        return z

    def compute_params(self, CI):
        """Credible intervals of ``ci_params`` from the fitted guide, with the
        posterior probability arrays and ``p_specific`` = theta_probs summed
        over spots."""
        from tapqir_tpu_torch.utils.stats import ci_from_scipy

        P = self.data.P
        lim = (P + 1) / 2
        wmin, wmax = self.priors["width_min"], self.priors["width_max"]
        p = self.param
        families = {
            "gain": lambda: ci_from_scipy(
                "gamma", CI, concentration=p("gain_loc") * p("gain_beta"),
                rate=p("gain_beta")),
            "pi": lambda: ci_from_scipy(
                "dirichlet", CI, concentration=p("pi_mean") * p("pi_size")),
            "init": lambda: ci_from_scipy(
                "dirichlet", CI, concentration=p("init_mean") * p("init_size")),
            "trans": lambda: ci_from_scipy(
                "dirichlet", CI, concentration=p("trans_mean") * p("trans_size")),
            "alpha": lambda: ci_from_scipy(
                "dirichlet", CI, concentration=p("alpha_mean") * p("alpha_size")),
            "lamda": lambda: ci_from_scipy(
                "gamma", CI, concentration=p("lamda_loc") * p("lamda_beta"),
                rate=p("lamda_beta")),
            "proximity": lambda: ci_from_scipy(
                "affine_beta", CI, mean=p("proximity_loc"),
                sample_size=p("proximity_size"), low=0.0, high=(P + 1) / math.sqrt(12)),
            "background": lambda: ci_from_scipy(
                "gamma", CI, concentration=p("b_loc") * p("b_beta"), rate=p("b_beta")),
            "height": lambda: ci_from_scipy(
                "gamma", CI, concentration=p("h_loc") * p("h_beta"), rate=p("h_beta")),
            "width": lambda: ci_from_scipy(
                "affine_beta", CI, mean=p("w_mean"), sample_size=p("w_size"),
                low=wmin, high=wmax),
            "x": lambda: ci_from_scipy(
                "affine_beta", CI, mean=p("x_mean"), sample_size=p("size"),
                low=-lim, high=lim),
            "y": lambda: ci_from_scipy(
                "affine_beta", CI, mean=p("y_mean"), sample_size=p("size"),
                low=-lim, high=lim),
        }
        params = {param: families[param]() for param in self.ci_params}
        params["m_probs"] = self.m_probs
        params["z_probs"] = self.z_probs
        params["theta_probs"] = self.theta_probs
        params["z_map"] = self.z_map
        params["p_specific"] = params["theta_probs"].sum(0)
        return params

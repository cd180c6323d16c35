"""hmm: multi-color hidden Markov colocalization model ("cosmos+hmm";
counterpart of tapqir_tpu/models/hmm.py).

z follows a Markov chain per AOI and channel with Dirichlet-prior start and
transition probabilities (``init``, ``trans``); everything else is cosmos's.
The ELBO is the JAX package's closed form:

* the guide over the z-chain is an explicit inhomogeneous Markov chain
  q(z_f | z_{f-1}) with parameter ``z_trans`` (Nt, F, C, 1+S, 1+S);
* its marginals gamma_f come from ONE prefix scan of the log-transition
  matrices over the frame axis (``ops/scan.py``), and the pairwise marginals
  are gamma_{f-1}(i) A_f(i, j);
* E_q[log p - log q] over the chain is the chain terms plus
  sum_f sum_s gamma_f(s) l_f(s), where l_f(s) is the per-frame cosmos-style
  expectation (theta summed out, m enumerated given z = s);
* a step subsamples AOIs only: the chain needs every frame.

Draw seam: :meth:`hmm.elbo_from_windows` takes ``draws``, the packed flat
vector of standard-Gamma draws, in the JAX package's packing order for hmm
(gain, lamda, init, trans, proximity c1, proximity c0, background, height,
width c1, x c1, y c1, width c0, x c0, y c0); :meth:`hmm._theta_block`
takes the sampled lamda, proximity, x and y with a leading particle axis.

After a cosmos fit in the same workspace, :meth:`hmm.warm_start_from_cosmos`
starts the chain guide from that fit (the recommended cosmos-then-hmm
workflow).
"""

import logging
import math
from pathlib import Path

import numpy as np
import torch

from tapqir_tpu_torch import constraints, tracing
from tapqir_tpu_torch.distributions.core import (
    affine_beta_concentrations,
    affine_beta_sample,
    beta_from_gamma_pair,
    categorical_sample,
    dirichlet_from_gammas,
    dirichlet_log_prob,
    gamma_log_prob,
    gamma_sample,
    halfnormal_log_prob,
    std_gamma_sample_packed,
)
from tapqir_tpu_torch.distributions.util import expand_offtarget
from tapqir_tpu_torch.infer.discrete import (
    NEG_INF,
    log_probs_m,
    log_probs_z,
    m_configs,
    safe_log,
    select_ontarget,
)
from tapqir_tpu_torch.models.cosmos import _chain_perms, cosmos
from tapqir_tpu_torch.ops.scan import cumulative_logmatmulexp, sharded_cumulative_logmatmulexp
from tapqir_tpu_torch.ops.spot_tables import spot_tables
from tapqir_tpu_torch.parallel.sharding import shift_from_previous

logger = logging.getLogger(__name__)

__all__ = ["hmm"]

_CACHES = ("_z_probs_cache", "_theta_probs_cache")


class hmm(cosmos):
    r"""Multi-Color Hidden Markov Colocalization Model."""

    name = "cosmos+hmm"
    # the z-chain couples frames: a step takes every frame of its AOIs
    frame_coupled = True
    # the posteriors come from the whole chain: compute_stats leaves a mesh
    # first, as the JAX package's hmm has no sharded posteriors
    shards_posteriors = False

    def __init__(self, S=1, K=2, device=None, dtype="float32", priors=None):
        super().__init__(S=S, K=K, Q=None, device=device, dtype=dtype,
                         priors=priors)
        self._global_params = ["gain", "proximity", "lamda", "trans"]
        self.ci_params = [
            "gain", "init", "trans", "lamda", "proximity",
            "background", "height", "width", "x", "y",
        ]

    # -- variational parameters -------------------------------------------------
    def param_spec(self):
        spec = super().param_spec()
        K, Q, S = self.K, self.Q, self.S
        Nt, F, C = self.data.Nt, self.data.F, self.data.C
        del spec["pi_mean"], spec["pi_size"]
        spec["init_mean"] = (np.ones((Q, S + 1)) / (S + 1), constraints.simplex())
        spec["init_size"] = (np.full((Q, 1), 2.0), constraints.positive())
        spec["trans_mean"] = (np.ones((Q, S + 1, S + 1)) / (S + 1), constraints.simplex())
        spec["trans_size"] = (np.full((Q, S + 1, 1), 2.0), constraints.positive())
        spec["z_trans"] = (
            np.full((Nt, F, C, S + 1, S + 1), 1.0 / (S + 1)), constraints.simplex()
        )
        spec["m_probs"] = (np.full((S + 1, K, Nt, F, C), 0.5), constraints.unit_interval())
        return spec

    def param_partition(self):
        spec = super().param_partition()
        spec["z_trans"] = ("aoi", "frame", None, None, None)
        spec["m_probs"] = (None, None, "aoi", "frame", None)
        return spec

    def _log_feasible_m(self, dtype, device):
        """(M, 1+S) log-mask of the m-configs feasible given z: z > 0 needs
        at least one spot present (theta points at a present spot)."""
        mtab = m_configs(self.K)
        feasible = np.ones((mtab.shape[0], self.S + 1))
        feasible[mtab.sum(-1) == 0, 1:] = 0.0
        return torch.as_tensor(np.where(feasible > 0, 0.0, NEG_INF), dtype=dtype,
                               device=device)

    def _build_constants(self):
        super()._build_constants()
        Q, S1, dt, dev = self.Q, self.S + 1, self.dtype, self.device
        self._const.update(
            init_prior=torch.full((Q, S1), 1.0 / S1, dtype=dt, device=dev),
            trans_prior=torch.full((Q, S1, S1), 1.0 / S1, dtype=dt, device=dev),
            log_feasible_m=self._log_feasible_m(dt, dev),
        )

    # -- ELBO -----------------------------------------------------------------
    def _draw_batch(self, generator, chains=None, row_generator=None):
        """(ndx, None, F): ``n`` AOI rows without replacement and every
        frame of the device data (on a mesh: the rank's block), the rows
        from ``row_generator`` when given (the mesh row's, so that every
        frame shard of a row takes the same AOIs); ``chains`` = R: rows (R,
        n), each chain its own."""
        Nt, F = self._data_dev["xy"].shape[:2]
        n = min(self.nbatch_size, Nt)
        rows = generator if row_generator is None else row_generator
        if chains is None:
            ndx = torch.randperm(Nt, generator=rows, device=self.device)[:n]
        else:
            ndx = _chain_perms(chains, Nt, rows, self.device)[:, :n]
        return ndx, None, F

    def _global_term(self, g, sites):
        """cosmos's gain, lamda and proximity terms, with the chain's init
        and trans sites in place of pi (float64, as in cosmos)."""
        const = self._const
        init, trans = sites["init"], sites["trans"]
        return (
            self._gain_lamda_proximity_term(g, sites)
            + (dirichlet_log_prob(init, const["init_prior"])
               - dirichlet_log_prob(init, g["init_mean"] * g["init_size"])).sum(-1)
            + (dirichlet_log_prob(trans, const["trans_prior"])
               - dirichlet_log_prob(trans, g["trans_mean"] * g["trans_size"])).sum((-2, -1))
        )

    def elbo_from_windows(self, win, generator, ndx, fidx, f_b, data,
                          draws=None, n_shards=1, frame_shards=1, frame_axis=None):
        """ELBO from pre-gathered unconstrained windows (AOI rows ``ndx``,
        every frame); local and per-AOI terms are scaled by Nt / n, Nt that
        of ``data``. With a leading chain axis (windows (R, ...), ``ndx``
        (R, n)) it is each chain's ELBO, (R,).

        On a mesh the global term is divided by ``n_shards`` and the per-AOI
        term by ``frame_shards`` (see cosmos); with the frames sharded,
        ``frame_axis`` is the mesh row: the prefix scan runs over it
        (``sharded_cumulative_logmatmulexp``), the pair of the previous
        shard's last frame and this shard's first arrives shifted by one
        shard, and only the first frame shard scores the chain's start.

        Spans (``tracing``): ``elbo.sites`` (the packed draw and the
        sites), ``elbo.chain`` (the z-chain's scan, marginals and terms),
        ``elbo.tables`` (the per-frame tables) and, inside it,
        ``elbo.likelihood``."""
        S, K = self.S, self.K
        P = self.data.P
        priors = self.priors
        lim = (P + 1) / 2
        wmin, wmax = priors["width_min"], priors["width_max"]
        prox_high = (P + 1) / math.sqrt(12)
        n = ndx.shape[-1]
        lead = tuple(ndx.shape[:-1])  # (R,) with a chain axis, else ()
        c = len(lead)
        scale_n = data["xy"].shape[0] / n
        tf = self._transforms
        const = self._const

        def pc(name):
            return tf[name](win[name])

        def gk(name):  # window (*lead, K, n, F, Q) -> (*lead, n, F, Q, K), constrained
            return tf[name](torch.movedim(win[name], c, -1))

        F_l = data["xy"].shape[1]
        flat_ndx = (ndx[..., :, None] * F_l
                    + torch.arange(F_l, device=ndx.device)).reshape(-1)

        def g2a(arr):  # raw DATA (Nt, F, ...) -> (*lead, n, F, ...)
            flat = arr.reshape((arr.shape[0] * arr.shape[1],) + tuple(arr.shape[2:]))
            return flat.index_select(0, flat_ndx).reshape(
                lead + (n, F_l) + tuple(arr.shape[2:]))

        obs = g2a(data["images"])  # (*lead, n, F, C, EVP)
        target_locs = g2a(data["xy"])
        ont = data["is_ontarget"][ndx]  # (*lead, n)
        mask = data["mask"][ndx]

        # every guide site in ONE packed standard-Gamma draw, the global
        # ones in float64 (cosmos._global_values)
        g = self._global_values(win)
        pg1, pg0 = affine_beta_concentrations(
            g["proximity_loc"], g["proximity_size"], 0.0, prox_high
        )
        b_loc, b_beta = pc("b_loc"), pc("b_beta")  # (*lead, n, F, C)
        h_loc, h_beta = gk("h_loc"), gk("h_beta")  # (*lead, n, F, Q, K)
        w_mean, w_size = gk("w_mean"), gk("w_size")
        x_mean, y_mean = gk("x_mean"), gk("y_mean")
        size = gk("size")
        wc1, wc0 = affine_beta_concentrations(w_mean, w_size, wmin, wmax)
        xc1, xc0 = affine_beta_concentrations(x_mean, size, -lim, lim)
        yc1, yc0 = affine_beta_concentrations(y_mean, size, -lim, lim)
        with tracing.span("elbo.sites"):
            concs = [(g["gain_loc"] * g["gain_beta"])[..., None],
                     g["lamda_loc"] * g["lamda_beta"],
                     g["init_mean"] * g["init_size"], g["trans_mean"] * g["trans_size"],
                     pg1[..., None], pg0[..., None], b_loc * b_beta, h_loc * h_beta,
                     wc1, xc1, yc1, wc0, xc0, yc0]
            if c:  # each chain packed apart
                packed = std_gamma_sample_packed(concs, generator, draws, batch_dims=c)
            else:
                packed = std_gamma_sample_packed(concs, generator, draws)
            (g_gain, g_lamda, g_init, g_trans, g_p1, g_p0,
             gb, gh, gw1, gx1, gy1, gw0, gx0, gy0) = packed
            sites = {
                "gain": g_gain[..., 0] / g["gain_beta"],
                "lamda": g_lamda / g["lamda_beta"],
                "init": dirichlet_from_gammas(g_init),  # (*lead, Q, 1+S)
                "trans": dirichlet_from_gammas(g_trans),  # (*lead, Q, 1+S, 1+S)
                "proximity": prox_high * beta_from_gamma_pair(g_p1[..., 0], g_p0[..., 0]),
            }
            global_term = self._global_term(g, sites).to(self.dtype) / n_shards
            # the samples enter the local terms in the model's dtype
            gain, lamda, init, trans, prox = (
                sites[k].to(self.dtype) for k in ("gain", "lamda", "init", "trans", "proximity"))
            b = gb / b_beta
            h = gh / h_beta
            w = wmin + (wmax - wmin) * beta_from_gamma_pair(gw1, gw0)
            xs = -lim + 2 * lim * beta_from_gamma_pair(gx1, gx0)
            ys = -lim + 2 * lim * beta_from_gamma_pair(gy1, gy0)

        # per-AOI Delta sites (MAP background hyper-parameters)
        bm = pc("background_mean_loc")[..., 0, :]  # (*lead, n, C)
        bs = pc("background_std_loc")[..., 0, :]
        aoi_term = (
            (halfnormal_log_prob(bm, priors["background_mean_std"])
             + halfnormal_log_prob(bs, priors["background_std_std"]))
            * mask[..., None]
        ).sum((-2, -1))

        # z-chain: marginals gamma_f from the prefix products
        with tracing.span("elbo.chain"):
            A = pc("z_trans")  # (*lead, n, F, C, 1+S, 1+S), rows q(z_f | z_{f-1})
            logA = torch.log(A)
            if frame_axis is None:
                alphas = cumulative_logmatmulexp(logA, -4)
            else:  # the global prefix products of this shard's frames
                alphas = sharded_cumulative_logmatmulexp(logA, -4, frame_axis)
            gamma = torch.exp(alphas[..., 0, :])  # (*lead, n, F, C, 1+S)
            lp_init = log_probs_z(init, ont)  # (*lead, n, Q, 1+S)
            lp_trans = select_ontarget(safe_log(expand_offtarget(trans)), ont)  # (*lead, n, Q, 1+S, 1+S)
            q0 = A[..., 0, :, 0, :]  # (*lead, n, C, 1+S): the chain's start
            init_term = (q0 * (lp_init - torch.log(q0))).sum((-2, -1))  # (*lead, n)
            xi = gamma[..., :-1, :, :, None] * A[..., 1:, :, :, :]  # (*lead, n, F-1, C, 1+S, 1+S)
            chain_term = (
                xi * (lp_trans.unsqueeze(-4) - logA[..., 1:, :, :, :])
            ).sum((-4, -3, -2, -1))
            if frame_axis is None:
                chain_term = init_term + chain_term
            else:
                # the pair (the previous shard's last frame, this shard's first);
                # every shard takes the shift, so that the collectives of the
                # backward pass match, and the first keeps the chain's start
                gamma_prev = shift_from_previous(gamma[..., -1, :, :], frame_axis)
                bxi = gamma_prev[..., None] * A[..., 0, :, :, :]  # (*lead, n, C, 1+S, 1+S)
                boundary = (bxi * (lp_trans - logA[..., 0, :, :, :])).sum((-3, -2, -1))
                first = torch.tensor(frame_axis.rank == 0, device=init_term.device)
                chain_term = torch.where(first, init_term, boundary) + chain_term

        with tracing.span("elbo.tables"):
            lp_b = gamma_log_prob(b, (bm / bs)[..., None, :] ** 2, (bm / bs**2)[..., None, :])
            lq_b = gamma_log_prob(b, b_loc * b_beta, b_beta)

            # per-frame terms conditioned on z = s
            qm = tf["m_probs"](torch.movedim(win["m_probs"], c + 1, -1))  # (*lead, 1+S, n, F, C, K)
            mtab = const["mtab"]  # (M, K)
            lpm1, lpm0 = log_probs_m(lamda, K)  # (*lead, Q, 1+K, K)
            log_pm_sum = torch.einsum("mk,...qtk->m...tq", mtab, lpm1) + torch.einsum(
                "mk,...qtk->m...tq", 1.0 - mtab, lpm0
            )  # (M, *lead, 1+K, Q)
            term_xy, term_hw, term_q, log_qm = spot_tables(
                xs, ys, h, w, qm, h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size, prox,
                const["mtab_np"], const["spec_tk"], P, priors,
            )  # term_xy (M, *lead, 1+K, n, F, Q), log_qm (M, *lead, 1+S, n, F, Q)
            # over (m, z, theta): theta summed out, z kept for the chain
            T_full = (
                const["lpt"][:, :, None, None, None]  # (1+S, 1+K, 1, 1, 1)
                + log_pm_sum.unsqueeze(-2).unsqueeze(-2).unsqueeze(-5)  # (M, *lead, 1, 1+K, 1, 1, Q)
                + term_xy.unsqueeze(-5)  # (M, *lead, 1, 1+K, n, F, Q)
            )
            inner = torch.logsumexp(T_full, dim=-4)  # (M, *lead, 1+S, n, F, Q)

            with tracing.span("elbo.likelihood"):
                loglik = self._likelihood(obs, b, h, w, xs, ys, target_locs, gain,
                                          data)  # (M, *lead, n, F, C)

            # q(m | z) restricted to the configs feasible given z and
            # renormalised: given z > 0 the all-zero m has zero model
            # probability, and the unrestricted guide would make the ELBO -inf
            # at its own init (m_probs = 0.5)
            lfm = const["log_feasible_m"]  # (M, 1+S)
            log_qm = log_qm + lfm.reshape(lfm.shape[:1] + (1,) * c + lfm.shape[1:] + (1, 1, 1))
            log_qm = log_qm - torch.logsumexp(log_qm, dim=0, keepdim=True)
            wq = torch.exp(log_qm)
            # zero-weight configs can carry -1e30 costs: neutralise them exactly
            log_qm = torch.where(wq > 0.0, log_qm, torch.zeros_like(log_qm))

            ell = (
                wq * (inner + (term_hw + loglik - term_q).unsqueeze(-4) - log_qm)
            ).sum(0)  # (*lead, 1+S, n, F, Q)
            frames_term = (torch.movedim(gamma, -1, -4) * ell).sum(-4) + lp_b - lq_b  # (*lead, n, F, C)
        local_sum = (frames_term.sum((-2, -1)) + chain_term) * mask
        return global_term + (aoi_term / frame_shards + local_sum.sum(-1)) * scale_n

    # -- posteriors ---------------------------------------------------------------
    @property
    def z_probs(self):
        r"""q(z_f) marginals from the chain's prefix products, (Nt, F, C, 1+S)."""
        if not hasattr(self, "_z_probs_cache"):
            with torch.no_grad():
                A = self._transforms["z_trans"](self.params["z_trans"])
                alphas = cumulative_logmatmulexp(torch.log(torch.clamp(A, min=1e-30)), 1)
                self._z_probs_cache = (
                    torch.exp(alphas[..., 0, :]).cpu().numpy().astype(np.float64)
                )
        return self._z_probs_cache

    @property
    def theta_probs(self):
        r"""q(theta = k, z = z_MAP), shape (K, Nt, F, Q)."""
        if not hasattr(self, "_theta_probs_cache"):
            self._theta_probs_cache = self._compute_theta_probs()
        return self._theta_probs_cache

    @property
    def compute_probs(self):
        return self.z_probs, self.theta_probs

    def compute_probs_arrays(self, num_particles=50, generator=None, draws=None):
        return self.z_probs, self._compute_theta_probs(num_particles, generator, draws)

    @property
    def m_probs(self):
        r"""q(m = 1 | z = z_MAP), shape (K, Nt, F, Q)."""
        qm = np.moveaxis(self.param("m_probs"), (0, 1), (-1, 0))  # (K, Nt, F, C, 1+S)
        return np.take_along_axis(qm, self.z_map[None, ..., None], axis=-1)[..., 0]

    def _theta_draws(self, pc, ndx, num_particles, generator=None):
        """The guide samples :meth:`_theta_block` averages over, with a
        leading particle axis p: lamda (p, Q), proximity (p,), xs and ys
        (p, n, F, Q, K)."""
        P = self.data.P
        lim = (P + 1) / 2
        p = (num_particles,)

        def block(name):  # (K, Nt, F, Q) -> (n, F, Q, K)
            return torch.movedim(pc[name].index_select(1, ndx), 0, -1)

        size = block("size")
        return {
            "lamda": gamma_sample(pc["lamda_loc"] * pc["lamda_beta"], pc["lamda_beta"],
                                  p + pc["lamda_loc"].shape, generator),
            "proximity": affine_beta_sample(pc["proximity_loc"], pc["proximity_size"],
                                            0.0, (P + 1) / math.sqrt(12), generator, p),
            "xs": affine_beta_sample(block("x_mean"), size, -lim, lim, generator,
                                     p + size.shape),
            "ys": affine_beta_sample(block("y_mean"), size, -lim, lim, generator,
                                     p + size.shape),
        }

    def _theta_block(self, pc, ndx, z_map, num_particles, generator=None, draws=None):
        """q(theta = k | z = z_map) for AOIs ``ndx`` over every frame, (K, n,
        F, Q), averaged over ``num_particles`` guide samples
        (:meth:`_theta_draws`, from ``generator``) batched on a leading
        particle axis. ``z_map`` (n, F, C); ``draws`` replaces the samples.
        Works on the device and in the dtype of ``pc``."""
        dt, dev = pc["x_mean"].dtype, pc["x_mean"].device
        qm_all = torch.movedim(pc["m_probs"].index_select(2, ndx), 1, -1)  # (1+S, n, F, C, K)
        qm = torch.take_along_dim(qm_all, z_map[None, ..., None], dim=0)[0]  # (n, F, C, K)
        if draws is None:
            draws = self._theta_draws(pc, ndx, num_particles, generator)
        lamda, prox, xs, ys = (
            torch.as_tensor(draws[k]).to(dtype=dt, device=dev)
            for k in ("lamda", "proximity", "xs", "ys")
        )
        mtab, lpt, log_pm_sum, term_xy = self._particle_tables(lamda, prox, xs, ys)
        # the joint over (m, theta) given z = z_map
        T = (
            torch.movedim(lpt[z_map], -1, 0)[None, None]  # (1, 1, 1+K, n, F, Q)
            + log_pm_sum[:, :, :, None, None, :]  # (p, M, 1+K, 1, 1, Q)
            + term_xy  # (p, M, 1+K, n, F, Q)
        )
        T_norm = T - torch.logsumexp(T, dim=2, keepdim=True)
        # log q(m | z_map) by selection (see cosmos._probs_batch), restricted
        # to the configs feasible given z_map and renormalised (see the ELBO)
        log_qm = torch.where(
            mtab[:, None, None, None, :] > 0, torch.log(qm), torch.log1p(-qm)
        ).sum(-1)  # (M, n, F, Q)
        log_qm = log_qm + self._log_feasible_m(dt, dev)[:, z_map]
        log_qm = log_qm - torch.logsumexp(log_qm, dim=0, keepdim=True)
        r = torch.logsumexp(T_norm + log_qm[None, :, None], dim=1)  # (p, 1+K, n, F, Q)
        return torch.exp(r)[:, 1:].mean(0)

    def _compute_theta_probs(self, num_particles=50, generator=None, draws=None):
        """theta_probs (K, Nt, F, Q) as float64 numpy: the N on-target AOIs
        (which come first) in blocks of nbatch_size AOIs x every frame; the
        off-target rows stay 0. The last block is ragged where the JAX
        package pads it with repeated rows; the result is the same. Without
        ``generator`` the particles come from a generator seeded with 0 (the
        JAX package's ``PRNGKey(0)``). ``draws``, an iterable of one
        :meth:`_theta_block` draws dict per block, replaces the samples."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        blocks = None if draws is None else iter(draws)
        Nt, F, Q, N, nb = self.data.Nt, self.data.F, self.Q, self.data.N, self.nbatch_size
        dev = self.device
        z_map = torch.as_tensor(self.z_map, device=dev)
        theta_probs = torch.zeros((self.K, Nt, F, Q), dtype=self.dtype, device=dev)
        with torch.no_grad():
            pc = self.constrained()
            for n0 in range(0, N, nb):
                n1 = min(n0 + nb, N)
                theta_probs[:, n0:n1] = self._theta_block(
                    pc, torch.arange(n0, n1, device=dev), z_map[n0:n1], num_particles,
                    generator, None if blocks is None else next(blocks),
                )
        return theta_probs.cpu().numpy().astype(np.float64)

    def z_sample(self, num_samples, generator=None):
        """z trajectories (num_samples, N, F, C), int32 as the JAX package's,
        drawn ancestrally from the guide's chain over the on-target AOIs;
        without ``generator``, from one seeded with 11 (the JAX package's
        ``PRNGKey(11)``)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(11)
        N, F = self.data.N, self.data.F
        with torch.no_grad():
            A = self._transforms["z_trans"](self.params["z_trans"][:N]).clamp_min(1e-30)
            z = categorical_sample(A[:, 0, :, 0, :], (num_samples,) + A[:, 0, :, 0, 0].shape,
                                   generator)  # (num_samples, N, C)
            out = [z.to(torch.int32)]
            for f in range(1, F):
                rows = torch.take_along_dim(A[None, :, f], z[..., None, None], dim=-2)
                z = categorical_sample(rows[..., 0, :], generator=generator)
                out.append(z.to(torch.int32))
        return torch.stack(out, 2).cpu().numpy()

    def compute_params(self, CI):
        params = super().compute_params(CI)
        params["z_trans"] = self.param("z_trans")
        return params

    # -- warm start from a cosmos fit ---------------------------------------------
    def warm_start_from_cosmos(self, path=None, num_particles=25, generator=None):
        """Start the guide from the cosmos fit in the same workspace (the
        JAX package's ``warm_start_from_cosmos``): the chain's marginals
        reproduce the cosmos posterior at step 0, and the chain prior is
        estimated from it.

        * ``z_trans`` rows <- the cosmos q(z_f) marginals, clipped at 1e-5
          and renormalised (from ``cosmos_params.tpqr`` when it holds them,
          else computed with ``num_particles`` particles); off-target AOIs
          sit in z = 0;
        * ``init`` / ``trans`` <- the start distribution and the expected
          transition counts (+1) of that posterior over on-target AOIs,
          with ``trans_size`` 10;
        * ``m_probs`` <- cosmos q(m), clipped to [1e-3, 1 - 1e-3], for
          every z;
        * every other parameter of the same name and shape is copied.

        The mapping runs in numpy on the host. Call after :meth:`Model.init`:
        it resets the optimizer state, the iteration and the seed stream.
        Returns self."""
        path = Path(path) if path is not None else self.path
        run_path = path / ".tapqir"
        eps = 1e-5
        cm = cosmos(S=self.S, K=self.K, device=self.device, dtype=self.dtype,
                    priors=self.priors)
        cm.data = self.data
        cm.path, cm.run_path = path, run_path
        cm._transforms = {k: t for k, (v, t) in cm.param_spec().items()}
        cm.load_checkpoint(path=run_path, param_only=True)

        Nt, F, C, N = self.data.Nt, self.data.F, self.data.C, self.data.N
        Q, S1 = self.Q, self.S + 1
        zp = None
        stats_path = path / "cosmos_params.tpqr"
        if stats_path.exists():
            with np.load(stats_path, allow_pickle=False) as z:
                if "z_probs" in z.files:
                    zp = np.asarray(z["z_probs"], np.float64)
        if zp is None or zp.shape != (Nt, F, Q, S1):
            cm.nbatch_size = self.nbatch_size or 10
            cm.fbatch_size = min(512, F)
            cm._data_dev = getattr(self, "_data_dev", None) or self._data_device_arrays()
            zp = cm.compute_probs_arrays(num_particles=num_particles,
                                         generator=generator)[0]
        zp = np.clip(zp, eps, 1.0)
        zp /= zp.sum(-1, keepdims=True)
        zp[N:] = eps  # off-target AOIs: z = 0
        zp[N:, ..., 0] = 1.0 - (S1 - 1) * eps

        self.init_parameters()
        params = self.params
        for name, v in cm.params.items():
            if name in params and v.shape == params[name].shape:
                params[name] = v.to(dtype=self.dtype).contiguous()

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(device=self.device,
                                                               dtype=self.dtype)

        # unconstrained values by the transforms' closed-form inverses:
        # logit for unit_interval, log of normalised probabilities for
        # simplex, log for positive
        qm = np.clip(np.asarray(cm.param("m_probs"), np.float64), 1e-3, 1.0 - 1e-3)
        qm = np.broadcast_to(qm, (S1,) + qm.shape)
        params["m_probs"] = dev(np.log(qm) - np.log1p(-qm))
        params["z_trans"] = dev(np.log(np.broadcast_to(zp[:, :, :, None, :],
                                                       (Nt, F, C, S1, S1))))
        on = zp[:N]  # (N, F, Q, 1+S)
        init_mean = np.clip(on[:, 0].mean(0).reshape(Q, S1), 1e-4, 1.0)
        init_mean /= init_mean.sum(-1, keepdims=True)
        T = np.einsum("nfqi,nfqj->qij", on[:, :-1], on[:, 1:]) + 1.0
        T /= T.sum(-1, keepdims=True)
        params["init_mean"] = dev(np.log(init_mean))
        params["trans_mean"] = dev(np.log(T))
        params["trans_size"] = dev(np.log(np.full((Q, S1, 1), 10.0)))

        self.iter = 0
        self.converged = False
        self._rolling = {}
        self.opt_state = self._init_opt_state()
        self._seed = 0
        for cache in _CACHES:
            self.__dict__.pop(cache, None)
        logger.info(
            "Warm-started cosmos+hmm from the cosmos fit at "
            f"{run_path / 'cosmos_model.tpqr'} (trans estimate: "
            f"{np.round(T, 4).tolist()})"
        )
        return self

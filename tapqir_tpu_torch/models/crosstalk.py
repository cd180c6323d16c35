"""crosstalk: multi-color time-independent model with spectral bleed-through
(counterpart of tapqir_tpu/models/crosstalk.py).

Q dyes bleed into C channels through a crosstalk matrix alpha (Q, C) with a
Dirichlet(1 + 9I) prior per dye. Each dye has its own discrete latents (z_q,
theta_q, m_kq), so cosmos's per-dye tables are reused; only the image
likelihood couples the dyes: the expectation over m runs over all 2^(K*Q)
global spot configurations (16 at K = Q = 2), each image the background plus
every present spot of every dye rendered at the channel's target and scaled
by alpha[q, c].

alpha joins cosmos's packed standard-Gamma draw through the hooks
:meth:`_extra_global_concs` / :meth:`_global_term`, right after the
proximity pair, so the draw seam takes the JAX package's packing order. The
likelihood is dense by default (the (16, n*f*C, EVP) concentrations by one
einsum, then the summed kernel) or, with ``use_factored = True``, the
factored kernel over Q*K spot-major deltas with alpha folded into them.
"""

import numpy as np
import torch

from tapqir_tpu_torch import constraints, tracing
from tapqir_tpu_torch.distributions.core import dirichlet_log_prob
from tapqir_tpu_torch.distributions.ksmogn import (
    offset_gamma_factored_summed,
    offset_gamma_log_prob_summed,
)
from tapqir_tpu_torch.distributions.util import gaussian_spots_flat
from tapqir_tpu_torch.infer.discrete import m_configs
from tapqir_tpu_torch.models.cosmos import _per_chain, cosmos

__all__ = ["crosstalk"]


def _global_m_configs(K, Q):
    """(2^(K*Q), Q, K) table of the global spot-presence configurations and
    its (2^(K*Q), Q, 2^K) one-hot map onto each dye's config index; config g
    has dye q in config (g // (2^K)^q) % 2^K."""
    Mq = 1 << K
    g = np.arange(Mq**Q)
    cfg_idx = (g[:, None] // Mq ** np.arange(Q)) % Mq  # (Mf, Q)
    full = m_configs(K)[cfg_idx]  # (Mf, Q, K)
    onehot = (cfg_idx[..., None] == np.arange(Mq)).astype(np.float64)
    return full, onehot


class crosstalk(cosmos):
    r"""Multi-Color Time-Independent Colocalization Model with Cross-Talk."""

    name = "crosstalk"

    def __init__(self, S=1, K=2, Q=None, device=None, dtype="float32",
                 priors=None):
        super().__init__(S=S, K=K, Q=Q, device=device, dtype=dtype, priors=priors)
        self._global_params = ["gain", "proximity", "lamda", "pi", "alpha"]
        self.ci_params = [
            "alpha", "gain", "pi", "lamda", "proximity",
            "background", "height", "width", "x", "y",
        ]

    def _alpha_prior(self):
        """The Dirichlet(1 + 9I) prior concentration of alpha, (Q, C)."""
        Q, C = self.Q, self.data.C
        return np.ones((Q, C)) + np.eye(Q, C) * 9.0

    def param_spec(self):
        spec = super().param_spec()
        alpha_init = self._alpha_prior()
        spec["alpha_mean"] = (alpha_init / alpha_init.sum(-1, keepdims=True),
                              constraints.simplex())
        spec["alpha_size"] = (np.full((self.Q, 1), 2.0), constraints.positive())
        return spec

    def _build_constants(self):
        super()._build_constants()
        dt, dev = self.dtype, self.device
        full, onehot = _global_m_configs(self.K, self.Q)
        self._const.update(
            alpha_prior=torch.as_tensor(self._alpha_prior(), dtype=dt, device=dev),
            mtab_global=torch.as_tensor(full, dtype=dt, device=dev),  # (Mf, Q, K)
            mtab_global_np=full.reshape(full.shape[0], -1),  # (Mf, Q*K)
            onehot=torch.as_tensor(onehot, dtype=dt, device=dev),  # (Mf, Q, Mq)
        )

    # -- the alpha site ----------------------------------------------------------
    def _extra_global_concs(self, pc):
        return ["alpha"], [pc("alpha_mean") * pc("alpha_size")]

    def _global_term(self, g, sites):
        """cosmos's global term plus alpha's prior minus its guide, in
        float64. The sample waits on the model for
        :meth:`_local_marginalized` of the same ELBO evaluation, which takes
        it off again, so no step's graph outlives the step."""
        alpha = sites["alpha"]  # (*lead, Q, C)
        self._alpha_sample = alpha
        return super()._global_term(g, sites) + (
            dirichlet_log_prob(alpha, self._const["alpha_prior"])
            - dirichlet_log_prob(alpha, g["alpha_mean"] * g["alpha_size"])
        ).sum(-1)

    # -- the likelihood over the global configs ---------------------------------
    @staticmethod
    def _mixed_images(b, h, w, xs, ys, target_locs, alpha, mtab, P, ev_pad):
        """Expected images, (G, *lead, n*f, C, EVP), one per config of
        ``mtab`` (G, Q, K): the background ``b`` (*lead, n, f, C) plus every
        present spot of every dye (``h``, ``w``, ``xs``, ``ys`` (*lead, n,
        f, Q, K)) rendered at each channel's target (``target_locs`` (*lead,
        n, f, C, 2)) and scaled by ``alpha`` (*lead, Q, C), on the flat
        padded pixel axis; ``lead`` a leading chain axis or none."""
        *lead, n_, f_, Q, K = h.shape
        lead = tuple(lead)
        C = target_locs.shape[-2]
        gauss = gaussian_spots_flat(
            h[..., None, :], w[..., None, :], xs[..., None, :], ys[..., None, :],
            target_locs[..., None, :, :], P, ev_pad,
        )  # (*lead, n, f, Q, C, K, EVP)
        return b.reshape(lead + (n_ * f_, C, 1)) + torch.einsum(
            "gqk,...qc,...xqckp->g...xcp", mtab, alpha,
            gauss.reshape(lead + (n_ * f_, Q, C, K, ev_pad)),
        )

    @staticmethod
    def _mixed_spots(h, w, xs, ys, target_locs, alpha, P, ev_pad):
        """The alpha-scaled spots in the factored kernel's spot-major layout,
        (Q*K, *lead, n*f*C, EVP), spot q*K + k: made spot-major by moving
        the small (*lead, n, f, Q, K) parameters before the render."""
        *lead, n_, f_, Q, K = h.shape
        C = target_locs.shape[-2]

        def qk_major(a):  # (*lead, n, f, Q, K) -> (Q, K, *lead, n, f, 1, 1)
            return torch.movedim(a, (-2, -1), (0, 1))[..., None, None]

        # alpha (*lead, Q, C) -> (Q, 1, *lead, 1, 1, C, 1)
        alpha_qk = torch.movedim(alpha, -2, 0)[:, None, ..., None, None, :, None]
        spots = gaussian_spots_flat(
            qk_major(h) * alpha_qk, qk_major(w),
            qk_major(xs), qk_major(ys), target_locs[None, None], P, ev_pad,
        )  # (Q, K, *lead, n, f, C, 1, EVP)
        return spots.reshape((Q * K,) + tuple(lead) + (n_ * f_ * C, ev_pad))

    def _local_marginalized(self, obs, target_locs, ont, gain, pi, lamda, prox,
                            b, h, w, xs, ys, qm, h_loc, h_beta, w_mean, w_size,
                            x_mean, y_mean, size, data):
        """The expectation over all 2^(K*Q) global configs, per (*lead, n,
        f), spread evenly over the C channels (the caller adds per-channel
        background terms and sums, so the sum stays exact): (*lead, n, f,
        1). All chains of a leading chain axis go through one kernel
        launch."""
        alpha = self.__dict__.pop("_alpha_sample").to(self.dtype)  # (*lead, Q, C)
        *lead, n_, f_, C, ev_pad = obs.shape
        lead = tuple(lead)
        P = self.data.P
        onehot = self._const["onehot"]
        mtab_global = self._const["mtab_global"]
        Mf = mtab_global.shape[0]

        with tracing.span("elbo.tables"):
            tables = self._dye_tables(
                ont, pi, lamda, prox, h, w, xs, ys, qm,
                h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size,
            )  # each (Mq, *lead, n, f, Q)
            inner, term_hw, log_qm, term_q = (
                torch.einsum("gqm,m...nfq->g...nf", onehot, t) for t in tables
            )  # each (Mf, *lead, n, f)

        with tracing.span("elbo.likelihood"):
            if getattr(self, "use_factored", False):
                spots = self._mixed_spots(h, w, xs, ys, target_locs, alpha, P, ev_pad)
                out = offset_gamma_factored_summed(
                    obs.reshape(-1, ev_pad), _per_chain(b, gain, 3).reshape(-1),
                    _per_chain(spots, gain, 2).reshape(spots.shape[0], -1, ev_pad),
                    self._const["mtab_global_np"], 1.0 / gain,
                    data["offset_samples"], data["offset_logits"], ev=P * P,
                )
            else:
                img = self._mixed_images(b, h, w, xs, ys, target_locs, alpha,
                                         mtab_global, P, ev_pad)  # (Mf, *lead, n*f, C, EVP)
                out = offset_gamma_log_prob_summed(
                    obs.reshape(-1, ev_pad), _per_chain(img, gain, 3).reshape(Mf, -1, ev_pad),
                    1.0 / gain, data["offset_samples"], data["offset_logits"],
                    event_ndims=1, ev=P * P,
                )
            loglik = out.reshape((Mf,) + lead + (n_, f_, C)).sum(-1)  # event dims (C, P, P)
        local = (torch.exp(log_qm) * (inner + term_hw + loglik - log_qm - term_q)).sum(0)
        return local[..., None] / C

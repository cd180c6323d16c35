"""KSMOGN: K-Spots Marginalized Offset Gamma Noise image likelihood
(counterpart of tapqir_tpu/distributions/ksmogn.py).

    mu^I    = b + sum_k mu^S_k            (per-channel image mean)
    p(D)    = sum_delta w_delta * Gamma(D - delta | mu^I / g, 1 / g)

The offset-Gamma log-pdf comes in the three forms of
:mod:`tapqir_tpu_torch.ops.offset_gamma` (a CUDA kernel each on the card,
the plain PyTorch version on the CPU): per pixel, event-summed over a
lane-padded flat axis, and event-summed with the per-config concentration
built inside the kernel from additive parts. On top of them sit the image
model, the full image log-likelihood and its sampler, and the ``KSMOGN``
object of the original Tapqir's API.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from tapqir_tpu_torch.distributions.util import gaussian_spots
from tapqir_tpu_torch.ops.offset_gamma import (
    offset_gamma_factored_summed,
    offset_gamma_log_prob,
    offset_gamma_summed,
)

__all__ = [
    "offset_gamma_log_prob",
    "offset_gamma_log_prob_summed",
    "offset_gamma_factored_summed",
    "ksmogn_image",
    "ksmogn_log_prob",
    "ksmogn_sample",
    "KSMOGN",
]


def offset_gamma_log_prob_summed(value, concentration, rate, offset_samples,
                                 offset_logits, event_ndims=2, ev=None):
    """log p summed over the trailing ``event_ndims`` dims.

    Shapes: ``concentration`` is (M,) + batch + event, ``value`` is batch +
    event (or broadcasts to it). Returns (M,) + batch.

    With ``ev`` set, the trailing axis is a lane-padded flat event axis of
    which only the first ``ev`` entries are real pixels (``event_ndims``
    must be 1): the event sum runs inside the summed kernel. Padded value
    entries must exceed every offset sample; padded concentrations must be
    positive. Without ``ev`` the per-pixel kernel scores every pixel and the
    event dims are summed after it.
    """
    if ev is None:
        lp = offset_gamma_log_prob(
            value, concentration, rate, offset_samples, offset_logits
        )
        return lp.sum(tuple(range(-event_ndims, 0)))
    if event_ndims != 1:
        raise ValueError(f"a lane-padded event axis is one axis, got event_ndims={event_ndims}")
    M = concentration.shape[0]
    batch_shape = tuple(concentration.shape[1:-1])
    ev_pad = concentration.shape[-1]
    nb = 1
    for d in batch_shape:
        nb *= d
    out = offset_gamma_summed(
        value.reshape(nb, ev_pad),
        concentration.reshape(M, nb, ev_pad),
        rate, offset_samples, offset_logits, ev,
    )
    return out.reshape((M,) + batch_shape)


def ksmogn_image(height, width, x, y, target_locs, background, P, m=None,
                 alpha=None):
    """Expected image mu^I = b + sum_spots (optionally crosstalk-mixed).

    Without crosstalk: inputs (..., K), target_locs (..., 2), background
    (...); returns (..., P, P). With crosstalk: inputs (..., Q, K), alpha
    (Q, C), target_locs (..., C, 2), background (..., C); returns
    (..., C, P, P).
    """
    if alpha is None:
        spots = gaussian_spots(height, width, x, y, target_locs, P, m)
        return background[..., None, None] + spots.sum(-3)
    h_mixed = height[..., :, None, :] * alpha[..., :, :, None]
    spots = gaussian_spots(
        h_mixed,
        width[..., :, None, :],
        x[..., :, None, :],
        y[..., :, None, :],
        target_locs[..., None, :, :],
        P,
        None if m is None else m[..., :, None, :],
    )  # (..., Q, C, K, P, P)
    return background[..., None, None] + spots.sum((-5, -3))


def ksmogn_log_prob(value, height, width, x, y, target_locs, background, gain,
                    offset_samples, offset_logits, P, m=None, alpha=None):
    """Full image log-likelihood, summed over the event dims (P, P), or
    (C, P, P) with crosstalk; per pixel through the per-pixel kernel."""
    mu = ksmogn_image(height, width, x, y, target_locs, background, P, m, alpha)
    event_axes = (-2, -1) if alpha is None else (-3, -2, -1)
    lp = offset_gamma_log_prob(
        value, mu / gain, 1.0 / gain, offset_samples, offset_logits
    )
    return lp.sum(event_axes)


def ksmogn_sample(generator, height, width, x, y, target_locs, background,
                  gain, offset_samples, offset_logits, P, m=None, alpha=None):
    """Sample images: Gamma(mu/g, 1/g) + a categorical offset per pixel."""
    mu = ksmogn_image(height, width, x, y, target_locs, background, P, m, alpha)
    concentration = mu / gain
    g = torch._standard_gamma(concentration, generator=generator)
    val = torch.clamp(g * gain, min=torch.finfo(g.dtype).tiny)
    # categorical offset index by inverse CDF of one uniform per pixel
    cdf = torch.cumsum(torch.softmax(offset_logits.to(val.dtype), -1), -1)
    u = torch.rand(val.shape, generator=generator, dtype=val.dtype,
                   device=val.device)
    odx = torch.searchsorted(cdf, u.reshape(-1), right=True)
    odx = odx.clamp(max=cdf.shape[0] - 1).reshape(val.shape)
    return val + offset_samples.to(val.dtype)[odx]


@dataclass(frozen=True)
class KSMOGN:
    """Stateless image distribution with the original Tapqir's object API
    (``log_prob`` / ``sample`` / ``mean``), for users coming from it."""

    height: torch.Tensor
    width: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    target_locs: torch.Tensor
    background: torch.Tensor
    gain: torch.Tensor
    offset_samples: torch.Tensor
    offset_logits: torch.Tensor
    P: int
    m: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None

    def _spots(self):
        return (self.height, self.width, self.x, self.y, self.target_locs,
                self.background)

    def log_prob(self, value):
        return ksmogn_log_prob(
            value, *self._spots(), self.gain, self.offset_samples,
            self.offset_logits, self.P, self.m, self.alpha,
        )

    def sample(self, generator):
        return ksmogn_sample(
            generator, *self._spots(), self.gain, self.offset_samples,
            self.offset_logits, self.P, self.m, self.alpha,
        )

    @property
    def mean(self):
        mu = ksmogn_image(*self._spots(), self.P, self.m, self.alpha)
        return mu + torch.sum(self.offset_samples * torch.exp(self.offset_logits))

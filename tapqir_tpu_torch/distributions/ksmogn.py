"""KSMOGN: K-Spots Marginalized Offset Gamma Noise image likelihood
(counterpart of tapqir_tpu/distributions/ksmogn.py).

    mu^I    = b + sum_k mu^S_k            (per-channel image mean)
    p(D)    = sum_delta w_delta * Gamma(D - delta | mu^I / g, 1 / g)

This slice ports the event-summed likelihood on its lane-padded ``ev``
branch (the CUDA kernel on the card, :mod:`tapqir_tpu_torch.ops.offset_gamma`),
the per-pixel plain path (``_offset_gamma_log_prob_xla`` in the JAX package),
and the image model and sampler the simulator needs.
"""

import torch

from tapqir_tpu_torch.distributions.util import gaussian_spots
from tapqir_tpu_torch.ops.offset_gamma import (
    offset_gamma_log_prob_plain,
    offset_gamma_summed,
)

__all__ = [
    "offset_gamma_log_prob_summed",
    "ksmogn_image",
    "ksmogn_sample",
]

# the plain per-pixel path under the JAX package's name
_offset_gamma_log_prob_xla = offset_gamma_log_prob_plain


def offset_gamma_log_prob_summed(value, concentration, rate, offset_samples,
                                 offset_logits, ev):
    """log p summed over a lane-padded flat event axis of which the first
    ``ev`` entries are real pixels.

    Shapes: ``concentration`` is (M,) + batch + (EVP,), ``value`` is batch +
    (EVP,). Returns (M,) + batch. Padded value entries must exceed every
    offset sample; padded concentrations must be positive.
    """
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

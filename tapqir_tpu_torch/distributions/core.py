"""Core distribution primitives as plain functions on tensors (counterpart of
tapqir_tpu/distributions/core.py).

Gamma-family draws are reparameterized by implicit differentiation: the
draw comes from ``torch._standard_gamma`` and its gradient with respect to
the concentration is ``torch._standard_gamma_grad`` (Knowles' three-regime
approximation - the algorithm the JAX package's ``standard_gamma_grad``
reimplements). The JAX package's fixed six-proposal sampler unroll was a
TPU workaround and has no counterpart here; its clamps do (concentration
and draw both at least the dtype's tiny).

Every draw goes through :class:`_StdGammaDraw`, which also accepts draws
made elsewhere (``draws=``): that seam lets tests feed the JAX package's
draws into the port's ELBO and compare values and gradients exactly.
"""

import math

import torch


def _log(v):
    """log of a Python number (in float64) or of a tensor."""
    if isinstance(v, (int, float)):
        return math.log(v)
    return torch.log(v)


def _lgamma(v):
    """lgamma of a Python number (in float64) or of a tensor."""
    if isinstance(v, (int, float)):
        return math.lgamma(v)
    return torch.lgamma(v)


# ---------------------------------------------------------------------------
# Standard Gamma draws (implicit reparameterization)
# ---------------------------------------------------------------------------


class _StdGammaDraw(torch.autograd.Function):
    """Returns the given draws ``z ~ Gamma(conc, 1)``; the backward is the
    pathwise gradient dz/dconc = ``torch._standard_gamma_grad(conc, z)``,
    with non-finite values zeroed as the JAX package does."""

    @staticmethod
    def forward(ctx, conc, z):
        ctx.save_for_backward(conc, z)
        return z.view_as(z)

    @staticmethod
    def backward(ctx, grad):
        conc, z = ctx.saved_tensors
        dz = torch._standard_gamma_grad(conc, z)
        dz = torch.where(torch.isfinite(dz), dz, torch.zeros_like(dz))
        return grad * dz, None


def std_gamma_sample(conc, generator=None, draws=None):
    """z ~ Gamma(conc, 1) with a pathwise gradient. ``draws`` (same shape as
    ``conc``) replaces the random draw."""
    if draws is None:
        tiny = torch.finfo(conc.dtype).tiny
        with torch.no_grad():
            z = torch._standard_gamma(
                conc.detach().clamp_min(tiny), generator=generator
            ).clamp_min(tiny)
    else:
        z = draws.to(dtype=conc.dtype, device=conc.device).reshape(conc.shape)
    return _StdGammaDraw.apply(conc, z)


def std_gamma_sample_packed(concs, generator=None, draws=None, batch_dims=0):
    """One :func:`std_gamma_sample` over several concentration tensors,
    flattened (row-major) and concatenated in the given order; returns the
    samples in matching shapes. ``draws`` is the flat packed vector.

    With ``batch_dims`` = 1 every tensor has a leading chain axis (R, ...)
    and each chain's sites are packed apart, in the same order: one draw of
    (R, N) from the one generator, and ``draws`` is (R, N).

    The draw is made in the narrowest dtype of ``concs``. Wider tensors (a
    float32 model's float64 global sites) are drawn with the rest, from
    their concentration rounded to that dtype; their samples are the draw
    (or ``draws``) in their own dtype, and their pathwise gradient is taken
    in it, in one more :class:`_StdGammaDraw` for all of them."""
    lead = tuple(concs[0].shape[:batch_dims])
    shapes = [c.shape for c in concs]
    dt = min((c.dtype for c in concs), key=lambda d: torch.finfo(d).bits)
    flats = [c.reshape(lead + (-1,)) for c in concs]
    g = std_gamma_sample(
        torch.cat([f if f.dtype == dt else f.detach().to(dt) for f in flats], -1),
        generator, draws)
    pieces, o = [], 0
    for f in flats:
        pieces.append(slice(o, o + f.shape[-1]))
        o += f.shape[-1]
    out = [g[..., s] for s in pieces]
    wide = [i for i, f in enumerate(flats) if f.dtype != dt]
    if wide:
        wdt = flats[wide[0]].dtype
        src = g.detach() if draws is None else draws.to(g.device).reshape(g.shape)
        z = torch.cat([src[..., pieces[i]] for i in wide], -1).to(wdt)
        gw = _StdGammaDraw.apply(torch.cat([flats[i] for i in wide], -1), z)
        o = 0
        for i in wide:
            n = flats[i].shape[-1]
            out[i] = gw[..., o:o + n]
            o += n
    return [a.reshape(s) for a, s in zip(out, shapes)]


def beta_from_gamma_pair(g1, g0):
    """Beta sample from its two Gamma draws, clipped strictly inside (0, 1)."""
    u = g1 / (g1 + g0)
    eps = torch.finfo(u.dtype).eps
    return torch.clamp(u, eps, 1.0 - eps)


def dirichlet_from_gammas(g):
    """Dirichlet sample from per-component Gamma draws (event axis last),
    clipped and renormalized."""
    out = g / g.sum(-1, keepdim=True)
    eps = torch.finfo(out.dtype).eps
    out = torch.clamp(out, eps, 1.0)
    return out / out.sum(-1, keepdim=True)


# ---------------------------------------------------------------------------
# Gamma (concentration/rate)
# ---------------------------------------------------------------------------


def gamma_log_prob(x, concentration, rate):
    return (
        torch.xlogy(concentration, rate)
        + torch.xlogy(concentration - 1.0, x)
        - rate * x
        - torch.lgamma(concentration)
    )


def gamma_sample(concentration, rate, shape=None, generator=None, draws=None):
    """Gamma(concentration, rate) of ``shape`` (default: the broadcast shape);
    ``draws`` are the standard-Gamma draws of that shape."""
    if shape is None:
        shape = torch.broadcast_shapes(concentration.shape, torch.as_tensor(rate).shape)
    g = std_gamma_sample(concentration.expand(shape), generator, draws)
    return g / rate


def gamma_mean(concentration, rate):
    return concentration / rate


def gamma_entropy(concentration, rate):
    return (
        concentration
        - _log(rate)
        + torch.lgamma(concentration)
        + (1.0 - concentration) * torch.digamma(concentration)
    )


# ---------------------------------------------------------------------------
# HalfNormal(scale), Exponential(rate)
# ---------------------------------------------------------------------------

_HALF_LOG_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)


def halfnormal_log_prob(x, scale):
    return _HALF_LOG_2_OVER_PI - _log(scale) - 0.5 * (x / scale) ** 2


def halfnormal_sample(scale, shape=None, generator=None, draws=None):
    """|N(0, 1)| * scale of ``shape`` (default: the scale's); ``draws`` are
    the standard normal draws of that shape."""
    scale = torch.as_tensor(scale)
    if shape is None:
        shape = scale.shape
    if draws is None:
        draws = torch.randn(shape, generator=generator, dtype=scale.dtype,
                            device=scale.device)
    else:
        draws = draws.to(dtype=scale.dtype, device=scale.device).reshape(shape)
    return torch.abs(draws) * scale


def exponential_log_prob(x, rate):
    return _log(rate) - rate * x


def exponential_sample(rate, shape=None, generator=None, draws=None):
    """Exp(1) / rate of ``shape`` (default: the rate's); ``draws`` are the
    Exp(1) draws of that shape."""
    rate = torch.as_tensor(rate)
    if shape is None:
        shape = rate.shape
    if draws is None:
        draws = torch.empty(shape, dtype=rate.dtype, device=rate.device).exponential_(
            generator=generator)
    else:
        draws = draws.to(dtype=rate.dtype, device=rate.device).reshape(shape)
    return draws / rate


# ---------------------------------------------------------------------------
# Beta(concentration1, concentration0)
# ---------------------------------------------------------------------------


def beta_log_prob(x, c1, c0):
    return (
        torch.xlogy(c1 - 1.0, x)
        + torch.xlogy(c0 - 1.0, 1.0 - x)
        + _lgamma(c1 + c0)
        - _lgamma(c1)
        - _lgamma(c0)
    )


def beta_sample(c1, c0, shape=None, generator=None, draws=None):
    """Beta(c1, c0) of ``shape`` (default: the broadcast shape) from the
    standard-Gamma pair stacked on a leading axis of 2, clipped strictly
    inside (0, 1); ``draws`` replaces that (2, *shape) pair."""
    c1, c0 = torch.as_tensor(c1), torch.as_tensor(c0)
    if shape is None:
        shape = torch.broadcast_shapes(c1.shape, c0.shape)
    dt = torch.promote_types(c1.dtype, c0.dtype)
    conc = torch.stack([c1.to(dt).expand(shape), c0.to(dt).expand(shape)])
    g = std_gamma_sample(conc, generator, draws)
    return beta_from_gamma_pair(g[0], g[1])


# ---------------------------------------------------------------------------
# AffineBeta(mean, sample_size, low, high):
#   c1 = size (mean - low) / (high - low), c0 = size (high - mean) / (high - low)
#   Y = low + (high - low) Beta(c1, c0)
# ---------------------------------------------------------------------------


def affine_beta_concentrations(mean, sample_size, low, high):
    width = high - low
    c1 = sample_size * (mean - low) / width
    c0 = sample_size * (high - mean) / width
    return c1, c0


def affine_beta_log_prob(x, mean, sample_size, low, high):
    c1, c0 = affine_beta_concentrations(mean, sample_size, low, high)
    width = high - low
    u = (x - low) / width
    return beta_log_prob(u, c1, c0) - _log(width)


def affine_beta_sample(mean, sample_size, low, high, generator=None, shape=None,
                       draws=None):
    """Sample of ``shape`` (default: the broadcast shape) with tensor
    ``sample_size``; both Beta Gammas in one draw (``draws``: the (2,
    *shape) standard-Gamma pair), the Beta clipped strictly inside (0, 1)."""
    c1, c0 = affine_beta_concentrations(mean, sample_size, low, high)
    return low + (high - low) * beta_sample(c1, c0, shape, generator, draws)


def affine_beta_mean(mean, sample_size, low, high):
    del sample_size, low, high
    return mean


def affine_beta_sample_stacked(means, sizes, lows, highs, generator=None, draws=None):
    """Several AffineBeta sites from one :func:`std_gamma_sample` call over
    the stacked (2 * n_sites, ...) concentrations: every site's c1, then
    every site's c0. ``means`` / ``sizes`` are per-site tensors of one
    shape, ``lows`` / ``highs`` per-site scalars; ``draws`` replaces the
    stacked standard-Gamma draws. Returns one sample per site, each Beta
    clipped strictly inside (0, 1)."""
    n_sites = len(means)
    c1s, c0s = [], []
    for mean, size, low, high in zip(means, sizes, lows, highs):
        c1, c0 = affine_beta_concentrations(mean, size, low, high)
        shape = torch.as_tensor(size).shape
        c1s.append(torch.as_tensor(c1).expand(shape))
        c0s.append(torch.as_tensor(c0).expand(shape))
    g = std_gamma_sample(torch.stack(c1s + c0s), generator, draws)
    return [low + (high - low) * beta_from_gamma_pair(g[i], g[i + n_sites])
            for i, (low, high) in enumerate(zip(lows, highs))]


# ---------------------------------------------------------------------------
# Dirichlet(concentration) [event along the last axis]
# ---------------------------------------------------------------------------


def dirichlet_log_prob(x, concentration):
    return (
        torch.xlogy(concentration - 1.0, x).sum(-1)
        + torch.lgamma(concentration.sum(-1))
        - torch.lgamma(concentration).sum(-1)
    )


def dirichlet_sample(concentration, shape=None, generator=None, draws=None):
    """Dirichlet draws of batch ``shape`` (default: the concentration's
    batch shape), clipped and renormalized; ``draws`` are the standard-Gamma
    draws of shape ``shape + concentration.shape[-1:]``."""
    if shape is None:
        shape = concentration.shape[:-1]
    conc = concentration.expand(tuple(shape) + concentration.shape[-1:])
    return dirichlet_from_gammas(std_gamma_sample(conc, generator, draws))


def dirichlet_mean(concentration):
    """Works on tensors and on numpy arrays."""
    return concentration / concentration.sum(-1, keepdims=True)


# ---------------------------------------------------------------------------
# Bernoulli / Categorical (enumeration only in SVI; sampled for posteriors)
# ---------------------------------------------------------------------------


def bernoulli_log_prob(value, probs):
    """log p(value) with value in {0, 1}; safe at probs in {0, 1}."""
    eps = torch.finfo(probs.dtype).tiny
    return torch.where(
        value > 0.5,
        torch.log(torch.clamp(probs, min=eps)),
        torch.log1p(-torch.clamp(probs, max=1 - eps)),
    )


def categorical_sample(probs, shape=None, generator=None, draws=None):
    """Category indices of ``shape`` (default: the batch shape of ``probs``,
    categories on the last axis) by the Gumbel-max trick, as
    ``jax.random.categorical`` draws them; ``draws`` is the standard Gumbel
    noise of shape ``shape + probs.shape[-1:]``."""
    if shape is None:
        shape = probs.shape[:-1]
    full = tuple(shape) + probs.shape[-1:]
    if draws is None:
        tiny = torch.finfo(probs.dtype).tiny
        u = torch.rand(full, generator=generator, dtype=probs.dtype,
                       device=probs.device).clamp_min(tiny)
        draws = -torch.log(-torch.log(u))
    else:
        draws = draws.to(dtype=probs.dtype, device=probs.device).reshape(full)
    return torch.argmax(torch.log(probs) + draws, dim=-1)

"""The benchmark's data: a frozen copy of the port's simulator.

A copy of ``tapqir_tpu_torch/utils/simulate.py`` (the time-independent
regimes: cosmos, and crosstalk where the truth holds ``alpha``) and of the
helpers it calls, kept here so that the data a cell runs on cannot change
with the program. The random stream is the port's: the same seed gives the
same arrays as the port's ``simulate``. Everything is made on the device
from one ``torch.Generator`` per chunk.

:func:`make_dataset` builds the eLife-scale stack in ``n_chunk`` chunks, as
``chip_smoke.make_dataset`` does: each chunk is half on-target, and the
on-target AOIs of every chunk come first.
"""

import hashlib
import math

import numpy as np
import torch


def chunk_seed(seed, index, tag="data"):
    """A 63-bit generator seed for part ``index`` of a run's ``seed``."""
    digest = hashlib.sha256(f"{tag}:{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def offset_histogram(n_offsets, center=90.0, sigma=8.0):
    """Empirical-offset histogram: ``n_offsets`` integer bins around
    ``center`` with Gaussian weights (``chip_smoke.offset_histogram``)."""
    half = n_offsets // 2
    centers = np.arange(center - half, center + half + 1, dtype=np.float64)
    w = np.exp(-0.5 * ((centers - center) / sigma) ** 2)
    return centers, w / w.sum()


def _truncated_poisson_probs(lamda, K):
    kdx = torch.arange(K, dtype=lamda.dtype, device=lamda.device)
    lam = lamda[..., None]
    body = torch.exp(torch.xlogy(kdx, lam) - lam - torch.lgamma(kdx + 1.0))
    last = 1.0 - body.sum(-1, keepdim=True)
    return torch.cat([body, last], dim=-1)


def _probs_m(lamda, K):
    """p(m_k = 1 | theta, lambda), (..., 1 + K, K)."""
    dt, dev = lamda.dtype, lamda.device
    if K > 1:
        tp_km1 = _truncated_poisson_probs(lamda, K - 1)
        l_km1 = torch.arange(1, K, dtype=dt, device=dev)
        base = (l_km1 * tp_km1[..., 1:K]).sum(-1) / (K - 1)
    else:
        base = torch.zeros_like(lamda)
    tp_k = _truncated_poisson_probs(lamda, K)
    l_k = torch.arange(1, K + 1, dtype=dt, device=dev)
    row0 = (l_k * tp_k[..., 1:]).sum(-1) / K
    shape = tuple(lamda.shape)
    rest = base[..., None, None].expand(shape + (K, K))
    first = row0[..., None, None].expand(shape + (1, K))
    out = torch.cat([first, rest], dim=-2)
    eye_rows = torch.cat([torch.zeros((1, K), dtype=torch.bool, device=dev),
                          torch.eye(K, dtype=torch.bool, device=dev)], dim=0)
    return torch.where(eye_rows, torch.ones((), dtype=dt, device=dev), out)


def _affine_beta_sample(sample_size, lim, gen):
    """AffineBeta(0, sample_size, -lim, lim): both Gammas in one draw."""
    c1 = sample_size * lim / (2 * lim)
    c0 = sample_size * lim / (2 * lim)
    conc = torch.stack([c1, c0])
    tiny = torch.finfo(conc.dtype).tiny
    g = torch._standard_gamma(conc.clamp_min(tiny), generator=gen).clamp_min(tiny)
    u = g[0] / (g[0] + g[1])
    eps = torch.finfo(u.dtype).eps
    return -lim + 2 * lim * torch.clamp(u, eps, 1.0 - eps)


def _gaussian_spots(height, width, x, y, target_locs, P, m):
    dtype = torch.result_type(height, width)
    grid = torch.arange(P, dtype=dtype, device=height.device)
    spot_x = x + target_locs[..., 0][..., None]
    spot_y = y + target_locs[..., 1][..., None]
    var = width**2
    dx2 = (grid - spot_x[..., None]) ** 2
    dy2 = (grid - spot_y[..., None]) ** 2
    log_norm = torch.log(2.0 * math.pi * var)
    g = torch.exp(-(dy2[..., :, None] + dx2[..., None, :]) / (2.0 * var[..., None, None])
                  - log_norm[..., None, None])
    return (m * height)[..., None, None] * g


def _image_sample(gen, h, w, x, y, target_locs, b, gain, offset_samples,
                  offset_logits, P, m, alpha):
    if alpha is None:
        spots = _gaussian_spots(h, w, x, y, target_locs, P, m)
        mu = b[..., None, None] + spots.sum(-3)
    else:
        spots = _gaussian_spots(
            h[..., :, None, :] * alpha[..., :, :, None], w[..., :, None, :],
            x[..., :, None, :], y[..., :, None, :], target_locs[..., None, :, :], P,
            m[..., :, None, :])
        mu = b[..., None, None] + spots.sum((-5, -3))
    g = torch._standard_gamma(mu / gain, generator=gen)
    val = torch.clamp(g * gain, min=torch.finfo(g.dtype).tiny)
    cdf = torch.cumsum(torch.softmax(offset_logits.to(val.dtype), -1), -1)
    u = torch.rand(val.shape, generator=gen, dtype=val.dtype, device=val.device)
    odx = torch.searchsorted(cdf, u.reshape(-1), right=True)
    odx = odx.clamp(max=cdf.shape[0] - 1).reshape(val.shape)
    return val + offset_samples.to(val.dtype)[odx]


@torch.no_grad()
def simulate(N, F, C, P, seed, truth, K, device):
    """One chunk: images (N, F, C, P, P) float32 and is_ontarget (N,) bool,
    on ``device``; the first N // 2 AOIs are on-target."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    Q = C
    f32 = torch.float32
    ont = torch.zeros((N,), dtype=torch.bool, device=device)
    ont[: N // 2] = True
    gain = float(truth["gain"])
    lamda = torch.full((Q,), float(truth["lamda"]), dtype=f32, device=device)
    proximity = float(truth["proximity"])
    p = torch.full((N, F, Q), float(truth["pi"]), device=device)
    z = torch.where(ont[:, None, None], torch.bernoulli(p, generator=gen).long(), 0)
    theta_pos = 1 + torch.randint(0, K, (N, F, Q), generator=gen, device=device)
    theta = torch.where(z > 0, theta_pos, 0)
    pm_table = _probs_m(lamda, K)
    qdx = torch.arange(Q, device=device)
    kdx = torch.arange(K, device=device)
    pm = pm_table[qdx[None, None, :, None], theta[..., None], kdx]
    m = torch.bernoulli(pm, generator=gen)
    size_sp = ((P + 1) / (2 * proximity)) ** 2 - 1
    spec = theta[..., None] == 1 + kdx
    size = torch.where(spec, torch.tensor(size_sp, dtype=f32, device=device),
                       torch.tensor(2.0, dtype=f32, device=device))
    lim = (P + 1) / 2
    x = _affine_beta_sample(size, lim, gen)
    y = _affine_beta_sample(size, lim, gen)
    h = torch.full((N, F, Q, K), float(truth["height"]), dtype=f32, device=device)
    w = torch.full((N, F, Q, K), float(truth["width"]), dtype=f32, device=device)
    b = torch.full((N, F, C), float(truth["background"]), dtype=f32, device=device)
    target_locs = torch.full((N, F, C, 2), (P - 1) / 2, dtype=f32, device=device)
    offset_samples = torch.full((3,), float(truth["offset"]), dtype=f32, device=device)
    offset_logits = torch.log(torch.ones(3, dtype=f32, device=device) / 3)
    alpha = None
    if "alpha" in truth:
        alpha = torch.as_tensor(np.asarray(truth["alpha"]), dtype=f32,
                                device=device).reshape(Q, C)
    images = _image_sample(gen, h, w, x, y, target_locs, b, gain, offset_samples,
                           offset_logits, P, m, alpha)
    return torch.floor(images), ont, target_locs


def make_dataset(geometry, truth, seed, device):
    """The cell's data from the run's seed: images (Nt, F, C, P, P)
    float32, xy (Nt, F, C, 2) float32 and is_ontarget (Nt,) bool on
    ``device``, and the offset histogram (samples, weights) as float64
    host arrays. Simulated in ``n_chunk`` chunks, each from a seed of its
    own."""
    Nt, F, C, P = geometry["Nt"], geometry["F"], geometry["C"], geometry["P"]
    n_chunk = geometry["n_chunk"]
    if Nt % n_chunk:
        raise ValueError(f"Nt={Nt} is not a whole number of {n_chunk} chunks")
    per = Nt // n_chunk
    parts = [simulate(per, F, C, P, chunk_seed(seed, i), truth, geometry["K"], device)
             for i in range(n_chunk)]

    def cat(index):  # on-target AOIs of every chunk, then the off-target ones
        return torch.cat([p[index][p[1]] for p in parts] + [p[index][~p[1]] for p in parts])

    samples, weights = offset_histogram(geometry["offset_bins"])
    return {"images": cat(0), "xy": cat(2), "is_ontarget": cat(1),
            "offset_samples": samples, "offset_weights": weights}

"""Model-structure utility functions (counterpart of
tapqir_tpu/distributions/util.py). Same math, shapes and coordinate
convention; plain functions on tensors."""

import math

import torch


def gaussian_spots(height, width, x, y, target_locs, P, m=None):
    r"""Render K ideal 2D-Gaussian spots on a P x P pixel grid.

    mu^S[..., k, i, j] = m*h / (2 pi w^2)
        * exp(-((j - x - x_target)^2 + (i - y - y_target)^2) / (2 w^2))

    The column index is the x-coordinate and the row index the y-coordinate.

    :param height, width, x, y: (..., K).
    :param target_locs: (..., 2), broadcast against the K axis.
    :return: (..., K, P, P) rendered spots.
    """
    dtype = torch.result_type(height, width)
    grid = torch.arange(P, dtype=dtype, device=height.device)
    spot_x = x + target_locs[..., 0][..., None]  # (..., K)
    spot_y = y + target_locs[..., 1][..., None]
    var = width**2
    dx2 = (grid - spot_x[..., None]) ** 2  # (..., K, P) over columns
    dy2 = (grid - spot_y[..., None]) ** 2  # (..., K, P) over rows
    log_norm = torch.log(2.0 * math.pi * var)
    g = torch.exp(
        -(dy2[..., :, None] + dx2[..., None, :]) / (2.0 * var[..., None, None])
        - log_norm[..., None, None]
    )
    if m is not None:
        height = m * height
    return height[..., None, None] * g


def gaussian_spots_flat(height, width, x, y, target_locs, P, ev_pad, m=None):
    r"""Render K spots on a flat pixel axis (idx = i * P + j) padded with
    zeros to ``ev_pad``; same math as :func:`gaussian_spots`.

    :return: (..., K, ev_pad) rendered spots; entries at idx >= P*P are 0.
    """
    dtype = torch.result_type(height, width)
    idx = torch.arange(ev_pad, device=height.device)
    grid_y = torch.div(idx, P, rounding_mode="floor").to(dtype)  # row = y
    grid_x = (idx % P).to(dtype)  # column = x
    valid = (idx < P * P).to(dtype)

    spot_x = x + target_locs[..., 0][..., None]  # (..., K)
    spot_y = y + target_locs[..., 1][..., None]
    var = width**2
    d2 = (grid_x - spot_x[..., None]) ** 2 + (grid_y - spot_y[..., None]) ** 2
    g = torch.exp(
        -d2 / (2.0 * var[..., None]) - torch.log(2.0 * math.pi * var)[..., None]
    )
    if m is not None:
        height = m * height
    return height[..., None] * g * valid


def truncated_poisson_probs(lamda, K):
    r"""TruncatedPoisson(k; lambda, K) for k = 0..K: lambda^k e^-lambda / k!
    for k < K, and 1 - sum of those for k = K.

    :param lamda: (...,) rate.
    :return: (..., K + 1) probabilities.
    """
    kdx = torch.arange(K, dtype=lamda.dtype, device=lamda.device)
    lam = lamda[..., None]
    body = torch.exp(torch.xlogy(kdx, lam) - lam - torch.lgamma(kdx + 1.0))
    last = 1.0 - body.sum(-1, keepdim=True)
    return torch.cat([body, last], dim=-1)


def probs_m(lamda, K):
    r"""Prior spot presence probability p(m_k = 1 | theta, lambda), shape
    (..., 1 + K, K): 1 if theta == k + 1; the truncated-Poisson mean over K
    spots divided by K if theta == 0; over K - 1 spots otherwise.
    """
    dt, dev = lamda.dtype, lamda.device
    if K > 1:
        tp_km1 = truncated_poisson_probs(lamda, K - 1)  # (..., K)
        l_km1 = torch.arange(1, K, dtype=dt, device=dev)
        base = (l_km1 * tp_km1[..., 1:K]).sum(-1) / (K - 1)
    else:
        base = torch.zeros_like(lamda)
    tp_k = truncated_poisson_probs(lamda, K)  # (..., K+1)
    l_k = torch.arange(1, K + 1, dtype=dt, device=dev)
    row0 = (l_k * tp_k[..., 1:]).sum(-1) / K

    shape = tuple(lamda.shape)
    rest = base[..., None, None].expand(shape + (K, K))
    first = row0[..., None, None].expand(shape + (1, K))
    out = torch.cat([first, rest], dim=-2)
    eye_rows = torch.cat(
        [
            torch.zeros((1, K), dtype=torch.bool, device=dev),
            torch.eye(K, dtype=torch.bool, device=dev),
        ],
        dim=0,
    )
    return torch.where(eye_rows, torch.ones((), dtype=dt, device=dev), out)


def expand_offtarget(probs):
    r"""Off-target AOIs are forced into state 0 with probability one.

    :param probs: (..., 1 + S) on-target state probabilities.
    :return: (..., 1 + S, 2) indexed [..., state, is_ontarget].
    """
    offtarget = torch.zeros_like(probs)
    offtarget[..., 0] = 1.0
    return torch.stack([offtarget, probs], dim=-1)


def probs_theta(K, dtype=torch.float32, device=None):
    r"""Prior table p(theta | z) of shape (2, 1 + K): z = 0 -> theta = 0;
    z > 0 -> theta uniform over {1..K}."""
    out = torch.zeros((2, 1 + K), dtype=dtype, device=device)
    out[0, 0] = 1.0
    out[1, 1:] = 1.0 / K
    return out

"""Prefix products of log-transition matrices for the hmm chain (counterpart
of tapqir_tpu/ops/scan.py).

The JAX package's ``jax.lax.associative_scan`` becomes a Hillis-Steele
doubling scan: ceil(log2 F) levels, each ONE batched ``logmatmulexp`` over
every frame at once, so F=790 frames cost 10 levels of whole-tensor ops and
no loop over frames. Every level is out of place, so autograd differentiates
it like any other op.
"""

import torch

__all__ = ["logmatmulexp", "cumulative_logmatmulexp"]


def logmatmulexp(a, b):
    """(..., i, j) @ (..., j, k) in log space, numerically stable."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def cumulative_logmatmulexp(log_mats, axis):
    """All prefix products A_0, A_0@A_1, ..., A_0@...@A_{F-1} in log space
    along ``axis`` (the matrices are the last two axes)."""
    x = torch.movedim(log_mats, axis, 0)
    F = x.shape[0]
    d = 1
    while d < F:
        # x[f] holds the product of frames (f - d, f]; combined with
        # x[f - d] it holds (f - 2d, f]
        x = torch.cat([x[:d], logmatmulexp(x[:-d], x[d:])], 0)
        d *= 2
    return torch.movedim(x, 0, axis)

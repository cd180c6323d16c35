"""Prefix products of log-transition matrices for the hmm chain (counterpart
of tapqir_tpu/ops/scan.py).

:func:`cumulative_logmatmulexp` takes a CUDA tensor through the two kernels
of ``ops/chain_scan.py`` (one launch forward, one backward) and a CPU
tensor through :func:`doubling_cumulative_logmatmulexp`, the plain version:
the JAX package's ``jax.lax.associative_scan`` as a Hillis-Steele doubling
scan, ceil(log2 F) levels, each ONE batched ``logmatmulexp`` over every
frame at once, so F=790 frames cost 10 levels of whole-tensor ops and no
loop over frames. Every level is out of place, so autograd differentiates
it like any other op. There is no fallback from one to the other.

With the frame axis sharded over a mesh row,
:func:`sharded_cumulative_logmatmulexp` promotes each shard's local prefix
products to the global ones: a local scan, the gather of the shards' block
totals, and the product of the totals before the shard.
"""

import torch

from tapqir_tpu_torch.ops.chain_scan import chain_scan, logmatmulexp
from tapqir_tpu_torch.parallel.sharding import all_gather

__all__ = ["logmatmulexp", "cumulative_logmatmulexp", "doubling_cumulative_logmatmulexp",
           "sharded_cumulative_logmatmulexp"]


def cumulative_logmatmulexp(log_mats, axis):
    """All prefix products A_0, A_0@A_1, ..., A_0@...@A_{F-1} in log space
    along ``axis`` (the matrices are the last two axes): the kernels on a
    CUDA tensor, the doubling scan on a CPU tensor."""
    if log_mats.device.type == "cpu":
        return doubling_cumulative_logmatmulexp(log_mats, axis)
    return chain_scan(log_mats, axis)


def doubling_cumulative_logmatmulexp(log_mats, axis):
    """:func:`cumulative_logmatmulexp` as the doubling scan, level by level."""
    x = torch.movedim(log_mats, axis, 0)
    F = x.shape[0]
    d = 1
    while d < F:
        # x[f] holds the product of frames (f - d, f]; combined with
        # x[f - d] it holds (f - 2d, f]
        x = torch.cat([x[:d], logmatmulexp(x[:-d], x[d:])], 0)
        d *= 2
    return torch.movedim(x, 0, axis)


def sharded_cumulative_logmatmulexp(log_mats_local, axis, frame_axis):
    """The global prefix products of a frame axis sharded over the ranks of
    ``frame_axis`` (a mesh row of ``parallel/sharding.py``), each rank
    passing its local (..., F_local, ..., S, S) slice along ``axis`` and
    receiving its local slice of the global products (JAX:
    ``sharded_cumulative_logmatmulexp``): the local scan, the gather of
    every shard's block total, the product of the totals of the shards
    before this one (the identity on the first, as log(I + tiny)), and that
    product times each local prefix. Differentiable: the gather's backward
    sums the other shards' cotangents of this shard's total."""
    local = cumulative_logmatmulexp(log_mats_local, axis)
    total = local.select(axis, -1)
    totals = all_gather(total, frame_axis)
    S = log_mats_local.shape[-1]
    dt = log_mats_local.dtype
    eye = torch.eye(S, dtype=dt, device=log_mats_local.device)
    prefix = torch.log(eye + torch.finfo(dt).tiny).expand(total.shape)
    # every shard takes every total (the later ones with weight zero), so
    # that the gather's backward runs, and its collective meets, on every one
    for k in range(frame_axis.size - 1):
        before = torch.tensor(k < frame_axis.rank, device=prefix.device)
        prefix = torch.where(before, logmatmulexp(prefix, totals[k]), prefix)
    return logmatmulexp(prefix.unsqueeze(axis), local)

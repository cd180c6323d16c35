"""The prefix products of cosmos+hmm's z-chain on the card: two CUDA kernels
(``csrc/chain_scan.cu``), and the plain frame-by-frame recursions they
compute.

For log-transition matrices A_f (the last two axes, S x S) along a frame
axis, :func:`chain_scan` returns every prefix product in the log semiring,

    P_0 = A_0,  P_f[i, k] = log sum_j exp(P_{f-1}[i, j] + A_f[j, k]),

in the layout of its input, as ``ops/scan.py``'s ``cumulative_logmatmulexp``
returns them. Its backward takes, with w_f[i, j, k] = exp(P_{f-1}[i, j] +
A_f[j, k] - P_f[i, k]) (0 where P_f[i, k] = -inf), the cotangent G_f of P_f
from the last frame back,

    G_{F-1} = gP_{F-1},  G_f[i, j] = gP_f[i, j] + sum_k G_{f+1}[i, k] w_{f+1}[i, j, k],

and returns dA_f[j, k] = sum_i G_f[i, k] w_f[i, j, k] (f >= 1), dA_0 = G_0.

On CUDA tensors the forward is one launch of ``scan`` and the backward one
launch of ``scan_grad``, as one autograd node; their launch counts are on
those launchers. :func:`chain_scan_plain` and :func:`chain_scan_grad_plain`
are the two recursions frame by frame, for the tests; the CPU's scan is
``ops/scan.py``'s doubling scan.
"""

import ctypes
import math

import torch

from tapqir_tpu_torch.csrc import native

__all__ = ["logmatmulexp", "chain_scan", "chain_scan_plain", "chain_scan_grad_plain"]


def logmatmulexp(a, b):
    """(..., i, j) @ (..., j, k) in log space, numerically stable."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def _weights(p_prev, a, p):
    """w[..., i, j, k] = exp(p_prev[i, j] + a[j, k] - p[i, k]), 0 where
    p[i, k] = -inf."""
    w = torch.exp(p_prev[..., :, :, None] + a[..., None, :, :] - p[..., :, None, :])
    return torch.where(p[..., :, None, :] == -math.inf, torch.zeros_like(w), w)


def chain_scan_plain(log_mats, axis):
    """The prefix products of ``log_mats`` along ``axis``, folded left one
    frame after another."""
    x = torch.movedim(log_mats, axis, 0)
    out = [x[0]]
    for f in range(1, x.shape[0]):
        out.append(logmatmulexp(out[-1], x[f]))
    return torch.movedim(torch.stack(out), 0, axis)


def chain_scan_grad_plain(log_mats, prods, grad, axis):
    """The gradient of the prefix products ``prods`` of ``log_mats`` along
    ``axis`` for their cotangent ``grad``, one frame after another from the
    last."""
    a, p, gp = (torch.movedim(t, axis, 0) for t in (log_mats, prods, grad))
    out = torch.empty_like(a)
    g = gp[-1]
    for f in range(a.shape[0] - 1, 0, -1):
        gw = g[..., :, None, :] * _weights(p[f - 1], a[f], p[f])  # (..., i, j, k)
        out[f] = gw.sum(-3)
        g = gp[f - 1] + gw.sum(-1)
    out[0] = g
    return torch.movedim(out, 0, axis)


# ---------------------------------------------------------------------------
# the library and its launchers
# ---------------------------------------------------------------------------

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SHAPE = [_i64, _i64, _i64, _i32]  # outer, F, inner, S
library = native.Library(
    "chain_scan.cu", "chain_scan",
    {"cs_scan": [_ptr, _ptr] + _SHAPE + [_ptr],  # a, p, shape, stream
     "cs_scan_grad": [_ptr, _ptr, _ptr, _ptr] + _SHAPE + [_ptr]},  # a, p, gp, ga, shape, stream
    probes=("cs_max_states",),
)


def _layout(t, axis):
    """(outer, F, inner, S) of ``t`` with its frame axis at ``axis``."""
    axis = axis % t.dim()
    if not 0 <= axis < t.dim() - 2:
        raise ValueError(f"the frame axis {axis} of a tensor of shape {tuple(t.shape)} lies "
                         "among the matrices' two axes")
    S = t.shape[-1]
    if t.shape[-2] != S:
        raise ValueError(f"matrices of shape {tuple(t.shape[-2:])} are not square")
    return (math.prod(t.shape[:axis]), t.shape[axis], math.prod(t.shape[axis + 1:-2]), S)


class _Launcher(native.Kernel):
    """One of the two kernels: the scan, or with ``grad`` its gradient."""

    def __init__(self, name, entry, grad):
        super().__init__(name, library, entry)
        self.grad = grad

    def __call__(self, a, axis, p, gp=None, ga=None):
        """Launch over ``a`` with its frames along ``axis``: the forward
        writes the prefix products ``p``; the backward reads them and their
        cotangent ``gp`` and writes ``a``'s gradient ``ga``. All of
        ``a``'s shape, contiguous."""
        fn = self.function(a)
        outer, F, inner, S = shape = _layout(a, axis)
        max_states = library.limits["cs_max_states"]
        if not 1 <= S <= max_states:
            raise ValueError(f"{S} states: the kernel takes at most {max_states}")
        if outer * inner >= 1 << 31:
            raise ValueError(f"{outer * inner} chains: the kernel takes fewer than 2^31")
        tensors = [a, p] + ([gp, ga] if self.grad else [])
        native.check_tensors(tensors, a, [a.shape] * len(tensors))
        if a.numel() == 0:
            return
        self.launch(fn, a, *(t.data_ptr() for t in tensors), *shape)


scan = _Launcher("chain_scan", "cs_scan", grad=False)  # the prefix products
scan_grad = _Launcher("chain_scan_grad", "cs_scan_grad", grad=True)  # their gradient


class _ChainScanFunction(torch.autograd.Function):
    """The two kernels as one autograd node; the backward reads the saved
    input and products."""

    @staticmethod
    def forward(ctx, a, axis):
        p = torch.empty_like(a)
        scan(a, axis, p)
        ctx.save_for_backward(a, p)
        ctx.axis = axis
        return p

    @staticmethod
    def backward(ctx, gp):
        a, p = ctx.saved_tensors
        ga = torch.empty_like(a)
        scan_grad(a, ctx.axis, p, gp=gp.contiguous(), ga=ga)
        return ga, None


def chain_scan(log_mats, axis):
    """All prefix products A_0, A_0 (x) A_1, ... of the log-matrices (the last
    two axes) along ``axis``, in the layout of ``log_mats``: two kernels on
    a CUDA tensor (float32 or float64, at most ``cs_max_states`` states),
    differentiable."""
    return _ChainScanFunction.apply(log_mats.contiguous(), axis)

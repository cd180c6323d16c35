"""The z-chain's prefix scan on the CPU (``tapqir_tpu_torch/ops/chain_scan.py``):
the plain frame-by-frame recursions that the two CUDA kernels compute,
forward and backward, against the doubling scan of ``ops/scan.py`` and its
autograd gradient in float64, at the layouts the port scans (hmm's ELBO on
axis -4 with and without a leading chain axis, the posterior on axis 1),
and the dispatcher: a CPU tensor takes the doubling scan and launches
nothing, and the kernels' path takes no CPU tensor.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import math

import pytest
import torch

from tapqir_tpu_torch.csrc import native
from tapqir_tpu_torch.ops import chain_scan as cs
from tapqir_tpu_torch.ops.scan import cumulative_logmatmulexp, doubling_cumulative_logmatmulexp

torch.set_num_threads(1)

# (shape without the frame axis's length, frame axis): hmm's ELBO (*lead, n,
# F, C, S, S) on axis -4 with a restart step's chain axis, and the
# posterior's (Nt, F, C, S, S) on axis 1
LAYOUTS = {
    "elbo-chains": ((2, 3, None, 1), -4),
    "posterior": ((4, None, 2), 1),
}


def _case(layout, F, S, seed=0):
    """Row-stochastic log-transition matrices of ``layout`` with F frames
    and S states, and a cotangent of their prefix products, in float64."""
    lead, axis = LAYOUTS[layout]
    shape = tuple(F if d is None else d for d in lead) + (S, S)
    g = torch.Generator().manual_seed(seed + 31 * F + S)
    log_mats = torch.log_softmax(2.0 * torch.randn(shape, generator=g, dtype=torch.float64), -1)
    grad = torch.randn(shape, generator=g, dtype=torch.float64)
    return log_mats, grad, axis


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("F", [1, 2, 3, 7, 790])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_forward_recursion_matches_the_doubling_scan(layout, F, S):
    log_mats, _, axis = _case(layout, F, S)
    got = cs.chain_scan_plain(log_mats, axis)
    want = doubling_cumulative_logmatmulexp(log_mats, axis)
    assert got.shape == log_mats.shape and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # the first frame is the first matrix, exactly
    assert torch.equal(got.select(axis, 0), log_mats.select(axis, 0))


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("F", [1, 2, 3, 7, 790])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_backward_recursion_matches_autograd_of_the_doubling_scan(layout, F, S):
    log_mats, grad, axis = _case(layout, F, S)
    x = log_mats.clone().requires_grad_()
    (want,) = torch.autograd.grad(doubling_cumulative_logmatmulexp(x, axis), x, grad)
    got = cs.chain_scan_grad_plain(log_mats, cs.chain_scan_plain(log_mats, axis), grad, axis)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_plain_backward_passes_nothing_through_an_unreachable_state():
    """A transition of probability 0 (log -inf) leaves states unreachable
    (P = -inf): autograd of the doubling scan reads NaN from them, the
    recursion passes them no gradient and agrees wherever autograd is
    finite."""
    log_mats, grad, axis = _case("posterior", 9, 2)
    log_mats[..., 0, 1] = -math.inf  # from state 0 never to state 1
    x = log_mats.clone().requires_grad_()
    (auto,) = torch.autograd.grad(doubling_cumulative_logmatmulexp(x, axis), x, grad)
    prods = cs.chain_scan_plain(log_mats, axis)
    assert torch.isinf(prods).any()
    got = cs.chain_scan_grad_plain(log_mats, prods, grad, axis)
    assert torch.isfinite(got).all() and torch.isnan(auto).any()
    seen = torch.isfinite(auto)
    torch.testing.assert_close(got[seen], auto[seen], rtol=1e-10, atol=1e-12)


def test_cpu_tensors_take_the_doubling_scan_and_launch_nothing():
    log_mats, grad, axis = _case("elbo-chains", 33, 2)
    x = log_mats.clone().requires_grad_()
    before = native.launch_counts()
    got = cumulative_logmatmulexp(x, axis)
    (g,) = torch.autograd.grad(got, x, grad)
    assert native.launch_counts() == before
    y = log_mats.clone().requires_grad_()
    want = doubling_cumulative_logmatmulexp(y, axis)
    assert torch.equal(got, want)
    assert torch.equal(g, torch.autograd.grad(want, y, grad)[0])
    # the kernels' path takes no CPU tensor: no fallback
    with pytest.raises(ValueError, match="CUDA tensors"):
        cs.chain_scan(log_mats, axis)
    assert native.launch_counts() == before

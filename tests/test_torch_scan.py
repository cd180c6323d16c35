"""The port's prefix scan of log-transition matrices (``ops/scan.py``) on the
CPU in float64: against the reference's own Blelloch scan
(``tests/golden/reference_scan_ci.npz``, keys ``scan_a``-``scan_d``) at
rtol/atol 1e-12, against the JAX package's ``cumulative_logmatmulexp`` and
its ``jax.grad`` at rtol 1e-10, and against a loop over frames at the
hmm step's frame count (F=790, 10 levels)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapqir_tpu.ops.scan import cumulative_logmatmulexp as jax_scan
from tapqir_tpu.ops.scan import logmatmulexp as jax_logmatmulexp
from tapqir_tpu_torch.ops.scan import cumulative_logmatmulexp, logmatmulexp

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "golden" / "reference_scan_ci.npz"


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)  # conftest restores it


@pytest.mark.parametrize("case", ["scan_a", "scan_b", "scan_c", "scan_d"])
def test_scan_matches_the_reference_golden(case):
    with np.load(GOLDEN) as z:
        logits, alphas = z[f"{case}_logits"], z[f"{case}_alphas"]
    # the time axis is -4 in the reference's layout (..., T, C, S, S)
    got = cumulative_logmatmulexp(torch.as_tensor(logits), axis=logits.ndim - 4)
    assert got.dtype == torch.float64 and got.shape == alphas.shape
    np.testing.assert_allclose(got.numpy(), alphas, rtol=1e-12, atol=1e-12)


def test_logmatmulexp_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 5, 3, 3)) * 4
    got = logmatmulexp(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_logmatmulexp(a, b)),
                               rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.log(np.exp(a) @ np.exp(b)), rtol=1e-12)


@pytest.mark.parametrize("F", [1, 2, 7, 33])
def test_scan_and_its_gradient_match_jax(F):
    """The hmm layout (n, F, C, S1, S1) scanned on axis 1, and the gradient
    of a weighted sum of the marginals (the ELBO's use) against jax.grad."""
    rng = np.random.default_rng(F)
    logA = rng.normal(size=(3, F, 2, 3, 3))
    wts = rng.normal(size=(3, F, 2, 3))

    def jax_loss(x):
        return (jnp.exp(jax_scan(x, axis=1)[..., 0, :]) * wts).sum()

    x = torch.as_tensor(logA).requires_grad_(True)
    got = cumulative_logmatmulexp(x, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_scan(logA, axis=1)),
                               rtol=1e-10)
    (g,) = torch.autograd.grad((torch.exp(got[..., 0, :]) * torch.as_tensor(wts)).sum(), x)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jax_loss)(logA)),
                               rtol=1e-10, atol=1e-14)


def test_scan_at_the_hmm_frame_count_matches_a_loop():
    """F=790 frames of a (2, 2) chain, 10 doubling levels, against the
    left-to-right product over frames."""
    rng = np.random.default_rng(1)
    logA = torch.log(torch.as_tensor(rng.dirichlet(np.ones(2), size=(2, 790, 1, 2))))
    got = cumulative_logmatmulexp(logA, 1)
    want = [logA[:, 0]]
    for f in range(1, 790):
        want.append(logmatmulexp(want[-1], logA[:, f]))
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(), rtol=1e-10,
                               atol=1e-12)
    # rows of a product of stochastic matrices stay normalised
    np.testing.assert_allclose(torch.logsumexp(got, -1).numpy(), 0.0, atol=1e-12)

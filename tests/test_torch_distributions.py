"""The distribution layer's helpers of the PyTorch port against the JAX
package in float64: ``gamma_entropy``, ``affine_beta_mean`` and
``constraints.identity`` at rtol 1e-6; ``halfnormal_sample``,
``exponential_sample`` and ``affine_beta_sample_stacked`` with the JAX
package's draws fed through their seams at rtol 1e-6; every sampler in
distribution against scipy (Kolmogorov-Smirnov); and the names the two
packages' ``distributions`` export."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import tapqir_tpu.constraints as jc
import tapqir_tpu.distributions as jdist
import tapqir_tpu.distributions.core as jcore
import tapqir_tpu_torch.constraints as tc
import tapqir_tpu_torch.distributions as tdist
import tapqir_tpu_torch.distributions.core as tcore

torch.set_num_threads(1)
RTOL = 1e-6
N_DRAWS = 4000
KS_PVALUE = 1e-3


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    yield


def T(x):
    return torch.tensor(np.asarray(x, np.float64))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=0)


def test_exports_include_every_name_of_the_jax_package():
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")}

    assert {"halfnormal_sample", "exponential_sample", "gamma_sample", "beta_sample",
            "dirichlet_sample"} <= public(jdist)
    assert public(jdist) <= public(tdist)


def test_gamma_entropy_and_affine_beta_mean():
    rng = np.random.default_rng(0)
    conc, rate = rng.uniform(0.2, 50.0, 64), rng.uniform(0.01, 5.0, 64)
    close(tcore.gamma_entropy(T(conc), T(rate)), jcore.gamma_entropy(jnp.asarray(conc),
                                                                     jnp.asarray(rate)))
    close(tcore.gamma_entropy(T(conc), 0.25), jcore.gamma_entropy(jnp.asarray(conc), 0.25))
    mean, size = rng.uniform(0.8, 2.2, 16), rng.uniform(2.0, 200.0, 16)
    close(tcore.affine_beta_mean(T(mean), T(size), 0.75, 2.25),
          jcore.affine_beta_mean(jnp.asarray(mean), jnp.asarray(size), 0.75, 2.25))


def test_identity_transform():
    x = np.random.default_rng(1).normal(size=(5, 3)) * 40
    t, j = tc.identity(), jc.identity()
    assert t.name == j.name == "identity"
    close(t(T(x)), j(jnp.asarray(x)))
    close(t.inverse(T(x)), j.inverse(jnp.asarray(x)))


def test_halfnormal_and_exponential_with_the_jax_draws():
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(3)
    scale = rng.uniform(0.1, 30.0, (4, 5))
    want = jcore.halfnormal_sample(key, jnp.asarray(scale))
    draws = jax.random.normal(key, scale.shape)  # the JAX sampler's own draw
    close(tcore.halfnormal_sample(T(scale), draws=T(draws)), want)
    rate = rng.uniform(0.05, 8.0, (3, 7))
    want = jcore.exponential_sample(key, jnp.asarray(rate))
    draws = jax.random.exponential(key, rate.shape)
    close(tcore.exponential_sample(T(rate), draws=T(draws)), want)
    # an explicit shape broadcasts a scalar parameter
    got = tcore.exponential_sample(torch.tensor(2.0, dtype=torch.float64), shape=(6,),
                                   draws=T(np.arange(1.0, 7.0)))
    close(got, np.arange(1.0, 7.0) / 2.0)


def test_affine_beta_sample_stacked_with_the_jax_draws():
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(5)
    lows, highs = [0.75, -1.0, 0.0], [2.25, 1.0, 10.0]
    shape = (6, 4)
    means = [rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), shape)
             for lo, hi in zip(lows, highs)]
    sizes = [rng.uniform(2.0, 500.0, shape) for _ in lows]
    want = jcore.affine_beta_sample_stacked(key, [jnp.asarray(m) for m in means],
                                            [jnp.asarray(s) for s in sizes], lows, highs)
    # the JAX sampler's one standard-Gamma draw over the stacked c1s, then c0s
    c1s, c0s = zip(*(jcore.affine_beta_concentrations(jnp.asarray(m), jnp.asarray(s), lo, hi)
                     for m, s, lo, hi in zip(means, sizes, lows, highs)))
    draws = jcore.std_gamma_sample(key, jnp.stack(list(c1s) + list(c0s)))
    got = tcore.affine_beta_sample_stacked([T(m) for m in means], [T(s) for s in sizes],
                                           lows, highs, draws=T(draws))
    assert len(got) == len(want) == 3
    for g, w, lo, hi in zip(got, want, lows, highs):
        assert g.shape == shape and bool(((g > lo) & (g < hi)).all())
        close(g, w)


def test_affine_beta_sample_stacked_gradient_flows_to_every_site():
    means = [T(np.full(3, 1.5)).requires_grad_(True), T(np.full(3, 0.2)).requires_grad_(True)]
    sizes = [T(np.full(3, 20.0)), T(np.full(3, 5.0))]
    out = tcore.affine_beta_sample_stacked(means, sizes, [0.75, -1.0], [2.25, 1.0],
                                           generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(sum(o.sum() for o in out), means)
    assert all(bool(torch.isfinite(g).all()) and bool((g != 0).any()) for g in grads)


def _ks(samples, cdf):
    samples = np.asarray(samples.detach(), np.float64).ravel()
    return st.kstest(samples, cdf).pvalue


SAMPLERS = {
    "gamma": (lambda gen: tcore.gamma_sample(T(np.full(N_DRAWS, 2.5)), 0.5, generator=gen),
              st.gamma(2.5, scale=2.0).cdf),
    "beta": (lambda gen: tcore.beta_sample(T(np.full(N_DRAWS, 2.0)), T(np.full(N_DRAWS, 5.0)),
                                           generator=gen),
             st.beta(2.0, 5.0).cdf),
    "dirichlet": (lambda gen: tcore.dirichlet_sample(T(np.tile([1.5, 3.0, 0.5], (N_DRAWS, 1))),
                                                     generator=gen)[:, 0],
                  st.beta(1.5, 3.5).cdf),  # the first component's marginal
    "halfnormal": (lambda gen: tcore.halfnormal_sample(T(np.full(N_DRAWS, 3.0)),
                                                       generator=gen),
                   st.halfnorm(scale=3.0).cdf),
    "exponential": (lambda gen: tcore.exponential_sample(T(np.full(N_DRAWS, 0.4)),
                                                         generator=gen),
                    st.expon(scale=2.5).cdf),
    # c1 = 30 (1.2 - 0.75) / 1.5 = 9, c0 = 30 (2.25 - 1.2) / 1.5 = 21
    "affine_beta_stacked": (
        lambda gen: tcore.affine_beta_sample_stacked(
            [T(np.full(N_DRAWS, 1.2))], [T(np.full(N_DRAWS, 30.0))], [0.75], [2.25],
            generator=gen)[0],
        st.beta(9.0, 21.0, loc=0.75, scale=1.5).cdf),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_scipy_in_distribution(name):
    draw, cdf = SAMPLERS[name]
    samples = draw(torch.Generator().manual_seed(7))
    assert samples.shape == (N_DRAWS,) and samples.dtype == torch.float64
    assert _ks(samples, cdf) > KS_PVALUE

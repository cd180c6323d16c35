"""Building blocks of the PyTorch port against the JAX package in float64:
constraint transforms, log-probs, spot rendering, discrete tables, the
reference-code goldens, the standard-Gamma seam gradient, and the sampler
in distribution against scipy. Deterministic functions agree at rtol 1e-6
or tighter (the goldens keep tests/test_reference_goldens.py's tolerances).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import tapqir_tpu.constraints as jc
import tapqir_tpu.distributions.core as jcore
import tapqir_tpu.distributions.util as jutil
import tapqir_tpu.infer.discrete as jdisc
import tapqir_tpu_torch.constraints as tc
import tapqir_tpu_torch.distributions.core as tcore
import tapqir_tpu_torch.distributions.util as tutil
import tapqir_tpu_torch.infer.discrete as tdisc

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "golden" / "reference_goldens.npz"
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    yield


def T(x):
    return torch.tensor(np.asarray(x, np.float64))


def J(x):
    return jnp.asarray(np.asarray(x, np.float64))


def close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64),
        np.asarray(want, np.float64), rtol=rtol, atol=atol,
    )


TRANSFORMS = [
    ("positive", (), np.linspace(-40, 40, 41)),
    ("unit_interval", (), np.linspace(-20, 20, 41)),
    ("interval", (-3.0, 7.5), np.linspace(-20, 20, 41)),
    ("greater_than", (2.0,), np.linspace(-40, 40, 41)),
    ("simplex", (), np.random.default_rng(0).normal(size=(5, 3))),
]


@pytest.mark.parametrize("name,args,u", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
def test_constraints_forward_and_inverse_match_jax(name, args, u):
    tt, jt = getattr(tc, name)(*args), getattr(jc, name)(*args)
    y = tt(T(u))
    close(y, jt(J(u)))
    close(tt.inverse(y), jt.inverse(J(np.asarray(y))))


def test_log_probs_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0.05, 3.0, 20)
    c1 = rng.uniform(0.5, 20, 20)
    c0 = rng.uniform(0.5, 20, 20)
    u = rng.uniform(0.01, 0.99, 20)
    dirx = rng.dirichlet(np.ones(3), 20)
    dirc = rng.uniform(0.3, 5, (20, 3))
    cases = [
        (tcore.gamma_log_prob, jcore.gamma_log_prob, (x, c1, c0)),
        (tcore.halfnormal_log_prob, jcore.halfnormal_log_prob, (x, 50.0)),
        (tcore.exponential_log_prob, jcore.exponential_log_prob, (x, 1.5)),
        (tcore.beta_log_prob, jcore.beta_log_prob, (u, c1, c0)),
        (tcore.affine_beta_log_prob, jcore.affine_beta_log_prob, (x, 1.5, c1 + 2, 0.0, 3.5)),
        (tcore.affine_beta_log_prob, jcore.affine_beta_log_prob, (u * 2 - 1, 0.0, 2.0, -1.0, 1.0)),
        (tcore.dirichlet_log_prob, jcore.dirichlet_log_prob, (dirx, dirc)),
        (tcore.bernoulli_log_prob, jcore.bernoulli_log_prob, (u > 0.5, u)),
    ]
    for tf, jf, args in cases:
        t_args = [T(a) if isinstance(a, np.ndarray) else a for a in args]
        j_args = [J(a) if isinstance(a, np.ndarray) else a for a in args]
        close(tf(*t_args), jf(*j_args), rtol=1e-12)


def test_gamma_pair_helpers_match_jax():
    rng = np.random.default_rng(2)
    g1, g0 = rng.gamma(2.0, size=10), rng.gamma(3.0, size=10)
    g = rng.gamma(1.0, size=(4, 3))
    close(tcore.beta_from_gamma_pair(T(g1), T(g0)), jcore.beta_from_gamma_pair(J(g1), J(g0)))
    close(tcore.dirichlet_from_gammas(T(g)), jcore.dirichlet_from_gammas(J(g)))
    c1, c0 = tcore.affine_beta_concentrations(T(g1), T(g0), -2.0, 5.0)
    d1, d0 = jcore.affine_beta_concentrations(J(g1), J(g0), -2.0, 5.0)
    close(c1, d1)
    close(c0, d0)


def test_spots_match_jax():
    rng = np.random.default_rng(5)
    P, K, ev_pad = 14, 2, 256
    sh = (3, 4, 1, K)
    h, w = rng.uniform(500, 3000, sh), rng.uniform(1.0, 2.0, sh)
    x, y = rng.uniform(-2, 2, sh), rng.uniform(-2, 2, sh)
    t = rng.uniform(5, 9, sh[:-1] + (2,))
    m = (rng.random(sh) < 0.5).astype(np.float64)
    close(tutil.gaussian_spots(T(h), T(w), T(x), T(y), T(t), P, T(m)),
          jutil.gaussian_spots(J(h), J(w), J(x), J(y), J(t), P, J(m)))
    flat = tutil.gaussian_spots_flat(T(h), T(w), T(x), T(y), T(t), P, ev_pad)
    close(flat, jutil.gaussian_spots_flat(J(h), J(w), J(x), J(y), J(t), P, ev_pad))
    assert torch.equal(flat[..., P * P:], torch.zeros_like(flat[..., P * P:]))


@pytest.mark.parametrize("K", [1, 2, 3])
def test_discrete_tables_match_jax(K):
    rng = np.random.default_rng(K)
    lam = rng.uniform(0.01, 2.0, (3,))
    pi = rng.dirichlet(np.ones(2), 3)
    ont = np.array([1, 0, 1, 1])
    close(tutil.truncated_poisson_probs(T(lam), K), jutil.truncated_poisson_probs(J(lam), K))
    close(tutil.probs_m(T(lam), K), jutil.probs_m(J(lam), K))
    close(tutil.probs_theta(K, torch.float64), jutil.probs_theta(K, jnp.float64))
    close(tutil.expand_offtarget(T(pi)), jutil.expand_offtarget(J(pi)))
    np.testing.assert_array_equal(tdisc.m_configs(K), jdisc.m_configs(K))
    close(tdisc.log_probs_theta(K, 1, torch.float64), jdisc.log_probs_theta(K, 1, jnp.float64))
    close(tdisc.log_probs_z(T(pi), torch.tensor(ont)), jdisc.log_probs_z(J(pi), jnp.asarray(ont)))
    for a, b in zip(tdisc.log_probs_m(T(lam), K), jdisc.log_probs_m(J(lam), K)):
        close(a, b)
    assert tdisc.NEG_INF == jdisc.NEG_INF == -1e30
    close(tdisc.safe_log(T([0.0, 1e-40, 0.5])), jdisc.safe_log(J([0.0, 1e-40, 0.5])))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def test_reference_goldens(golden):
    g = golden
    gs = tutil.gaussian_spots(
        T(g["gs_height"]), T(g["gs_width"]), T(g["gs_x"]), T(g["gs_y"]),
        T(g["gs_target_locs"][..., 0, :]), int(g["gs_P"]),
    )
    np.testing.assert_allclose(gs.numpy(), g["gaussian_spots"], rtol=1e-10, atol=1e-300)
    for K in (2, 3):
        np.testing.assert_allclose(
            tutil.truncated_poisson_probs(T(g["lamda"]), K).numpy(), g[f"tpois_K{K}"],
            rtol=1e-12, atol=1e-15,
        )
        np.testing.assert_allclose(
            tutil.probs_m(T(g["lamda"]), K).numpy(), g[f"probs_m_K{K}"],
            rtol=1e-12, atol=1e-15,
        )
        np.testing.assert_allclose(
            tutil.probs_theta(K, torch.float64).numpy(), g[f"probs_theta_K{K}"]
        )
    np.testing.assert_allclose(
        tutil.expand_offtarget(T(g["pi"])).numpy(), g["expand_offtarget"]
    )


def test_std_gamma_seam_gradient_matches_jax():
    """The seam's backward (torch._standard_gamma_grad) against the JAX
    package's standard_gamma_grad on the same (concentration, draw) pairs,
    across the three regimes (x < 0.8, alpha > 8, rational)."""
    rng = np.random.default_rng(7)
    alpha = np.concatenate([rng.uniform(0.05, 1, 40), rng.uniform(1, 8, 40),
                            rng.uniform(8, 500, 40)])
    z = st.gamma.rvs(alpha, random_state=rng)
    conc = T(alpha).requires_grad_(True)
    out = tcore.std_gamma_sample(conc, draws=T(z))
    assert torch.equal(out.detach(), T(z))
    (got,) = torch.autograd.grad(out.sum(), conc)
    want = jcore.standard_gamma_grad(J(alpha), J(z))
    close(got, want, rtol=1e-6, atol=1e-9)


def test_packed_draw_layout_and_gradient():
    rng = np.random.default_rng(8)
    concs = [T(rng.uniform(0.5, 5, s)).requires_grad_(True) for s in [(1,), (2, 3), (4,)]]
    flat = np.concatenate([rng.gamma(1.0, size=n) for n in (1, 6, 4)])
    outs = tcore.std_gamma_sample_packed(concs, draws=T(flat))
    assert [tuple(o.shape) for o in outs] == [(1,), (2, 3), (4,)]
    close(torch.cat([o.reshape(-1) for o in outs]), flat, rtol=0, atol=0)
    grads = torch.autograd.grad(sum(o.sum() for o in outs), concs)
    want = jcore.standard_gamma_grad(
        J(np.concatenate([c.detach().numpy().ravel() for c in concs])), J(flat)
    )
    close(torch.cat([g.reshape(-1) for g in grads]), want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("conc", [0.3, 1.0, 4.0, 60.0])
def test_std_gamma_sampler_matches_scipy_in_distribution(conc):
    gen = torch.Generator().manual_seed(int(conc * 10))
    z = tcore.std_gamma_sample(torch.full((4000,), conc, dtype=torch.float64), gen)
    assert (z > 0).all()
    assert st.kstest(z.detach().numpy(), st.gamma(conc).cdf).pvalue > 1e-3

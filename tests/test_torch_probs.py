"""The port's cosmos posteriors against the JAX package on the CPU, in
float64: ``_probs_batch`` and ``compute_probs_arrays`` fed the JAX
package's draws (the same key splits and samplers), ``compute_params``,
``z_map`` and ``p_specific`` on the same probabilities, ``z_sample`` in
distribution and ``categorical_sample`` with the JAX package's Gumbel
noise, and the posteriors of a float32 fit whose q(m) sits at the bounds
of its constraint."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from _torch_port_data import jax_particle_draws, numpy_dataset, perturbed_params
from tapqir_tpu.distributions.core import (
    affine_beta_sample as jax_affine_beta_sample,
    beta_sample as jax_beta_sample,
    dirichlet_sample as jax_dirichlet_sample,
    gamma_sample as jax_gamma_sample,
    std_gamma_sample as jax_std_gamma_sample,
)
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.utils.dataset import save as jax_save
from tapqir_tpu_torch.convert import params_from_jax
from tapqir_tpu_torch.distributions.core import (
    affine_beta_concentrations,
    affine_beta_sample,
    beta_sample,
    categorical_sample,
    dirichlet_sample,
    gamma_sample,
)
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
RTOL = dict(rtol=1e-6, atol=1e-12)
# 3 on-target and 4 off-target AOIs, 7 frames; blocks of 2 AOIs x 3 frames
# leave a ragged last block on both axes
NT, F, NB, FB = 7, 7, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The module-scoped fixtures here build float64 JAX models, which turn
    x64 on before conftest's per-test fixture records the flag; put the flag
    back when the module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A JAX float64 cosmos model and the port's at the same perturbed
    parameters, on one workspace."""
    ws = tmp_path_factory.mktemp("probs")
    jax_save(numpy_dataset(CosmosDataset, OffsetData, Nt=NT, F=F, seed=4), ws)
    jm = jax_models["cosmos"](dtype="double")
    jm.load(ws)
    jm.init(lr=0.005, nbatch_size=NB, fbatch_size=FB)
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()}, seed=5,
                            scale=0.5)
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    tm = models["cosmos"](device="cpu", dtype="double")
    tm.load(ws)
    tm.init(lr=0.005, nbatch_size=NB, fbatch_size=FB)
    tm.params = params_from_jax(p_np, "cpu", torch.float64)
    assert tm.data.N == 3 and tm.data.Nt == NT
    return jm, tm


@pytest.fixture(scope="module")
def probs(fitted):
    """JAX ``compute_probs_arrays(num_particles=3)`` and the port's with the
    JAX package's block draws injected block by block (the JAX package pads
    a ragged block with repeated rows; its draws are cut to the block)."""
    jax.config.update("jax_enable_x64", True)
    jm, tm = fitted
    want = jm.compute_probs_arrays(num_particles=3)
    pc = jm.constrained()
    key = jax.random.PRNGKey(0)
    blocks = []
    for n0 in range(0, jm.data.N, NB):
        ndx = np.arange(n0, min(n0 + NB, jm.data.N))
        for f0 in range(0, F, FB):
            fdx = np.arange(f0, min(f0 + FB, F))
            key, sub = jax.random.split(key)
            d = jax_particle_draws(
                jm, pc, sub, jnp.asarray(np.pad(ndx, (0, NB - len(ndx)), mode="edge")),
                jnp.asarray(np.pad(fdx, (0, FB - len(fdx)), mode="edge")), 3)
            for k in ("xs", "ys"):
                d[k] = d[k][:, : len(ndx), : len(fdx)]
            blocks.append(d)
    got = tm.compute_probs_arrays(num_particles=3, draws=blocks)
    return want, got


def test_probs_batch_matches_jax_with_its_draws(fitted):
    jm, tm = fitted
    pc_j = jm.constrained()
    ndx, fdx = np.array([1, 4, 2]), np.array([0, 2, 5, 6])  # AOI 4 is off target
    key = jax.random.PRNGKey(3)
    z_j, th_j = jm._probs_batch(pc_j, key, jnp.asarray(ndx), jnp.asarray(fdx),
                                jm._data_dev, 4)
    draws = jax_particle_draws(jm, pc_j, key, jnp.asarray(ndx), jnp.asarray(fdx), 4)
    with torch.no_grad():
        z_t, th_t = tm._probs_batch(tm.constrained(), torch.as_tensor(ndx),
                                    torch.as_tensor(fdx), tm._data_dev, 4, draws=draws)
    assert z_t.shape == (2, 3, 4, 1) and th_t.shape == (2, 3, 4, 1)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **RTOL)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), **RTOL)
    np.testing.assert_allclose(z_t.numpy()[0, 1], 1.0, rtol=1e-12)  # off target: z = 0


def test_compute_probs_arrays_matches_jax_block_by_block(fitted, probs):
    (z_j, th_j), (z_t, th_t) = probs
    assert z_t.dtype == th_t.dtype == np.float64
    assert z_t.shape == (NT, F, 1, 2) and th_t.shape == (2, NT, F, 1)
    np.testing.assert_allclose(z_t, z_j, **RTOL)
    np.testing.assert_allclose(th_t, th_j, **RTOL)
    N = fitted[1].data.N
    assert not z_t[N:].any() and not th_t[:, N:].any()  # off-target rows stay 0
    np.testing.assert_allclose(z_t[:N].sum(-1), 1.0, rtol=1e-12)


def test_compute_params_z_map_and_p_specific_match_jax(fitted, probs):
    jm, tm = fitted
    jm._probs_cache, tm._probs_cache = probs
    want, got = jm.compute_params(0.95), tm.compute_params(0.95)
    assert set(got) == set(want)
    for name in tm.ci_params:
        assert set(got[name]) == {"Mean", "LL", "UL"}
        for stat in ("Mean", "LL", "UL"):
            np.testing.assert_allclose(got[name][stat], want[name][stat], **RTOL,
                                       err_msg=f"{name}/{stat}")
    for name in ("m_probs", "z_probs", "theta_probs", "p_specific"):
        np.testing.assert_allclose(got[name], want[name], **RTOL, err_msg=name)
    np.testing.assert_array_equal(got["z_map"], want["z_map"])
    np.testing.assert_array_equal(tm.z_map, np.argmax(probs[1][0], -1))
    np.testing.assert_allclose(got["p_specific"], probs[1][1].sum(0), rtol=1e-15)


def test_compute_probs_arrays_repeats_with_the_default_seed(fitted):
    _, tm = fitted
    a, b = tm.compute_probs_arrays(num_particles=2), tm.compute_probs_arrays(num_particles=2)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    gen = torch.Generator().manual_seed(1)
    assert not np.array_equal(tm.compute_probs_arrays(2, generator=gen)[0], a[0])


def test_categorical_sample_matches_jax_with_its_gumbel_noise():
    probs = np.random.default_rng(0).dirichlet(np.ones(3), size=(4, 5))
    key = jax.random.PRNGKey(11)
    shape = (6, 4, 5)
    want = jax.random.categorical(key, jnp.log(probs), shape=shape)
    noise = jax.random.gumbel(key, shape + (3,), jnp.float64)
    got = categorical_sample(torch.as_tensor(probs), shape, draws=torch.as_tensor(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sampler", ["gamma", "beta", "affine_beta", "dirichlet"])
def test_sampler_draw_seams_match_jax(sampler):
    """Each sampler fed the standard-Gamma draws that the JAX sampler makes
    for its key (the JAX ``std_gamma_sample`` of the same key on the same
    stacked concentrations) returns the JAX sampler's values."""
    rng = np.random.default_rng(12)
    key = jax.random.PRNGKey(13)
    a, b = rng.uniform(0.5, 5.0, (2, 3, 4))
    mean = rng.uniform(-2.0, 2.0, (3, 4))

    def draws(conc):
        return torch.as_tensor(np.array(jax_std_gamma_sample(key, jnp.asarray(conc))))

    T = torch.as_tensor
    if sampler == "gamma":
        want = jax_gamma_sample(key, a, b)
        got = gamma_sample(T(a), T(b), draws=draws(a))
    elif sampler == "beta":
        want = jax_beta_sample(key, a, b)
        got = beta_sample(T(a), T(b), draws=draws(np.stack([a, b])))
    elif sampler == "affine_beta":
        want = jax_affine_beta_sample(key, mean, a, -3.0, 3.0)
        c1, c0 = affine_beta_concentrations(T(mean), T(a), -3.0, 3.0)
        got = affine_beta_sample(T(mean), T(a), -3.0, 3.0,
                                 draws=draws(torch.stack([c1, c0]).numpy()))
    else:
        want = jax_dirichlet_sample(key, a)
        got = dirichlet_sample(T(a), draws=draws(a))
    assert got.dtype == torch.float64 and got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_z_sample_follows_the_marginals(fitted, probs):
    """Counts of z = 1 per (AOI, frame) over 4000 draws against the
    marginals: a chi-square test over all cells with a fixed seed."""
    _, tm = fitted
    tm.params_stats = {"z_probs": probs[1][0]}
    n = 4000
    z = tm.z_sample(n, generator=torch.Generator().manual_seed(7))
    N = tm.data.N
    assert z.shape == (n, N, F, 1)
    p1 = probs[1][0][:N, ..., 1]
    k1 = (z == 1).sum(0)
    chi2 = (((k1 - n * p1) ** 2) / (n * p1 * (1 - p1))).sum()
    assert st.chi2.sf(chi2, p1.size) > 1e-3
    assert np.array_equal(tm.z_sample(5), tm.z_sample(5))  # default seed
    assert z.dtype == np.int32  # as jax.random.categorical's


def test_z_sample_in_chunks_follows_the_marginals(fitted, probs):
    """Drawn in chunks of 7 samples (a noise budget of 7 samples' worth of
    bytes): 4000 samples of the right shape whose counts pass the same
    chi-square test."""
    _, tm = fitted
    tm.params_stats = {"z_probs": probs[1][0]}
    N = tm.data.N
    one = N * F * 1 * 2 * 8  # bytes of one sample's float64 noise
    n = 4000
    calls = []
    orig = categorical_sample

    def counted(*args, **kwargs):
        calls.append(args[1][0])
        return orig(*args, **kwargs)

    # the module, not the class the package's __init__ binds to the same name
    port_cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cosmos_module, "categorical_sample", counted)
        mp.setattr(port_cosmos_module, "Z_SAMPLE_CHUNK_BYTES", 7 * one)
        z = tm.z_sample(n, generator=torch.Generator().manual_seed(8))
    assert z.shape == (n, N, F, 1) and z.dtype == np.int32
    assert calls == [7] * (n // 7) + [n % 7]
    p1 = probs[1][0][:N, ..., 1]
    k1 = (z == 1).sum(0)
    chi2 = (((k1 - n * p1) ** 2) / (n * p1 * (1 - p1))).sum()
    assert st.chi2.sf(chi2, p1.size) > 1e-3


def test_probs_at_the_bounds_of_q_m_stay_finite_in_float32(tmp_path):
    """q(m) at the bounds of its constraint (1e-6 and 1 - 1e-6) in a float32
    fit gives finite, normalised marginals; so does q(m) rounded to exactly
    0 and 1, where log q(m) is -inf for some spot configurations (a product
    with the 0/1 config table would make that NaN)."""
    jax_save(numpy_dataset(CosmosDataset, OffsetData, Nt=4, F=5, seed=6), tmp_path)
    tm = models["cosmos"](device="cpu")
    tm.load(tmp_path)
    tm.init(lr=0.005, nbatch_size=2, fbatch_size=5)
    m_u = torch.full_like(tm.params["m_probs"], 200.0)
    m_u[1, :, ::2] = -200.0
    tm.params["m_probs"] = m_u
    qm = tm.param("m_probs")
    assert qm.dtype == np.float32
    np.testing.assert_array_equal(np.unique(qm), np.float32([1e-6, 1 - 1e-6]))
    z, th = tm.compute_probs_arrays(num_particles=5)
    N = tm.data.N
    assert np.isfinite(z).all() and np.isfinite(th).all()
    np.testing.assert_allclose(z[:N].sum(-1), 1.0, rtol=1e-5)
    assert (th[:, :N].sum(0) <= 1.0 + 1e-5).all()

    pc = tm.constrained()
    pc["m_probs"] = torch.round(pc["m_probs"])
    with torch.no_grad():
        z_b, th_b = tm._probs_batch(pc, torch.arange(N), torch.arange(5), tm._data_dev, 5,
                                    torch.Generator().manual_seed(0))
    assert torch.isfinite(z_b).all() and torch.isfinite(th_b).all()
    torch.testing.assert_close(z_b.sum(0), torch.ones_like(z_b[0]))

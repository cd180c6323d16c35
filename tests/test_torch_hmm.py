"""The port's cosmos+hmm model against the JAX package on the CPU, in
float64.

The JAX package's packed standard-Gamma draws (hmm's own packing order) are
recorded and fed through the port's draw seam, so both sides score the same
samples: the ELBO, every window gradient and one sparse-Adam step
(parameters, moments and per-row step counts) agree at rtol 1e-6, for
subsampled and full AOI batches and for the dense and the factored
likelihood. Gradient and moment comparisons add an absolute floor of 1e-6
times the array's largest magnitude, for entries that are zero up to
round-off. The posteriors (``z_probs``, ``m_probs``, ``_compute_theta_probs``
with the JAX block draws), ``compute_params`` and the warm start from a
cosmos fit agree at rtol 1e-6; ``z_sample`` is checked in distribution.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats as st
import torch

from _torch_port_data import (
    assert_close_scaled,
    counted,
    numpy_dataset,
    perturbed_params,
)
from tapqir_tpu.distributions.core import (
    affine_beta_sample as jax_affine_beta_sample,
    gamma_sample as jax_gamma_sample,
)
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.utils.dataset import CosmosDataset as JaxDataset
from tapqir_tpu.utils.dataset import OffsetData as JaxOffset
from tapqir_tpu.utils.dataset import save as jax_save
from tapqir_tpu_torch.convert import opt_state_from_jax, params_from_jax
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
RTOL = 1e-6
PROB_TOL = dict(rtol=1e-6, atol=1e-12)
jax_hmm_module = importlib.import_module("tapqir_tpu.models.hmm")
jax_cosmos_module = importlib.import_module("tapqir_tpu.models.cosmos")
port_cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")


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


def _models(nbatch, Nt=4, F=6, seed=3):
    """A JAX float64 hmm model and the port's at the same perturbed
    parameters, on the same numpy dataset."""
    jax.config.update("jax_enable_x64", True)
    jm = jax_models["cosmos+hmm"](dtype="double")
    jm.data = numpy_dataset(JaxDataset, JaxOffset, Nt=Nt, F=F, seed=seed)
    jm.nbatch_size, jm.fbatch_size = nbatch, F
    jm.init_parameters()
    jm._data_dev = jm._data_device_arrays()
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()})
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}

    tm = models["cosmos+hmm"](device="cpu", dtype="double")
    tm.data = numpy_dataset(CosmosDataset, OffsetData, Nt=Nt, F=F, seed=seed)
    tm.nbatch_size, tm.fbatch_size = nbatch, F
    tm.init_parameters()
    tm._data_dev = tm._data_device_arrays()
    tm._build_constants()
    tm.params = params_from_jax(p_np, "cpu", torch.float64)
    return jm, tm


def _jax_loss_draws(jm, key, monkeypatch, grad):
    """The JAX step's AOI batch, its loss (and window gradients), and its
    packed standard-Gamma draws, recorded inside one jitted call."""
    data = jm._data_dev
    ndx, f0, f_b, kg, kl = jm._draw_batch(key, data)
    assert f0 is None and f_b is None  # every frame
    orig = jax_hmm_module.std_gamma_sample_packed

    def loss_and_draws(w):
        rec = []

        def recording(k, concs):
            out = orig(k, concs)
            rec.append(out)
            return out

        monkeypatch.setattr(jax_hmm_module, "std_gamma_sample_packed", recording)
        loss = -jm.elbo_from_windows(w, kg, kl, ndx, None, None, data)
        monkeypatch.setattr(jax_hmm_module, "std_gamma_sample_packed", orig)
        flat = jnp.concatenate([jnp.reshape(a, (-1,)) for a in rec[0]])
        return loss, jax.lax.stop_gradient(flat)

    win = jm.gather_windows(jm.params, ndx, None, None)
    if grad:
        (loss, draws), grads = jax.jit(
            jax.value_and_grad(loss_and_draws, has_aux=True)
        )(win)
    else:
        (loss, draws), grads = jax.jit(loss_and_draws)(win), None
    return np.asarray(ndx), float(loss), np.asarray(draws), grads


@pytest.mark.parametrize(
    "nbatch,seed,factored",
    [(2, 0, False), (4, 1, False), (2, 3, True)],
    ids=["subsampled-aois", "full-batch", "factored-likelihood"],
)
def test_elbo_and_window_gradients_match_jax(nbatch, seed, factored, monkeypatch):
    jm, tm = _models(nbatch)
    calls = {"jax": 0, "port": 0}
    if factored:  # both packages select the factored route the same way
        jm.use_factored = tm.use_factored = True
        for side, mod in (("jax", jax_cosmos_module), ("port", port_cosmos_module)):
            monkeypatch.setattr(mod, "offset_gamma_factored_summed",
                                counted(calls, side, mod.offset_gamma_factored_summed))
    ndx, j_loss, draws, j_grads = _jax_loss_draws(
        jm, jax.random.PRNGKey(seed), monkeypatch, grad=True
    )
    assert len(ndx) == nbatch
    t_ndx = torch.tensor(ndx, dtype=torch.long)
    t_win = {
        k: v.detach().clone().requires_grad_(True)
        for k, v in tm.gather_windows(tm.params, t_ndx, None).items()
    }
    assert t_win["z_trans"].shape == (nbatch, 6, 1, 2, 2)
    assert t_win["m_probs"].shape == (2, 2, nbatch, 6, 1)
    t_loss = -tm.elbo_from_windows(t_win, None, t_ndx, None, 6, tm._data_dev,
                                   draws=torch.tensor(draws))
    t_grads = torch.autograd.grad(t_loss, list(t_win.values()))
    np.testing.assert_allclose(t_loss.item(), j_loss, rtol=RTOL)
    assert calls == {"jax": int(factored), "port": int(factored)}
    assert set(t_win) == set(j_grads)
    for name, g in zip(t_win, t_grads):
        assert_close_scaled(g.numpy(), j_grads[name], name)


def test_sparse_adam_step_matches_jax(monkeypatch):
    jm, tm = _models(2, Nt=5, F=6)
    rng = np.random.default_rng(11)
    # a mid-run Adam state: random moments and per-row step counts
    mu = {k: 0.01 * rng.standard_normal(np.shape(v)) for k, v in jm.params.items()}
    nu = {k: 1e-3 * rng.random(np.shape(v)) for k, v in jm.params.items()}
    Nt, F = jm.data.Nt, jm.data.F
    counts = {
        "g": np.asarray(7, np.int32),
        "a": rng.integers(0, 9, Nt).astype(np.int32),
        "af": rng.integers(0, 9, Nt * F).astype(np.int32),
    }
    jm.lr = 0.005
    jm.tx = optax.adam(0.005, b1=0.9, b2=0.999, eps=1e-8)
    base = jm.tx.init(jm.params)
    adam = base[0]._replace(
        count={k: jnp.asarray(v) for k, v in counts.items()},
        mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()},
    )
    jm.opt_state = (adam,) + tuple(base[1:])
    jm._jit = False
    jm._build_step()

    key = jax.random.PRNGKey(4)
    step_key = jax.random.split(key, 1)[0]  # the key the 1-step scan uses
    ndx, _, draws, _ = _jax_loss_draws(jm, step_key, monkeypatch, grad=False)
    j_params, j_opt, j_losses = jm._run_chunk(jm.params, jm.opt_state, key, 1)

    tm.lr = 0.005
    tm.opt_state = opt_state_from_jax(mu, nu, counts, "cpu", torch.float64)
    assert set(tm._row_groups().values()) >= {("af", 0), ("af", 2), ("a", 0), ("g", None)}
    t_loss = tm._sparse_step(None, batch=(torch.tensor(ndx), None, F),
                             draws=torch.tensor(draws))
    np.testing.assert_allclose(float(t_loss), float(j_losses[0]), rtol=RTOL)
    j_adam = j_opt[0]
    for name in tm.params:
        assert_close_scaled(tm.params[name].numpy(), j_params[name], f"param {name}")
        assert_close_scaled(tm.opt_state["mu"][name].numpy(), j_adam.mu[name], f"mu {name}")
        assert_close_scaled(tm.opt_state["nu"][name].numpy(), j_adam.nu[name], f"nu {name}")
    for k, v in tm.opt_state["count"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_adam.count[k]), err_msg=k)
    # every frame of the batch's AOIs stepped once
    af = tm.opt_state["count"]["af"].view(Nt, F).numpy()
    np.testing.assert_array_equal(af[ndx], counts["af"].reshape(Nt, F)[ndx] + 1)


@pytest.mark.parametrize("dtype", ["double", "float32"])
def test_gradients_finite_at_the_reference_init(dtype):
    """At the reference's own init (m_probs = 0.5, uniform z_trans) the
    unrestricted Bernoulli q(m | z) gives the all-zero m weight where z > 0;
    the feasibility renormalisation keeps the loss and every gradient
    finite."""
    tm = models["cosmos+hmm"](device="cpu", dtype=dtype)
    tm.data = numpy_dataset(CosmosDataset, OffsetData, Nt=4, F=6, seed=5)
    tm.nbatch_size, tm.fbatch_size = 4, 6
    tm.init_parameters()
    tm._data_dev = tm._data_device_arrays()
    tm._build_constants()
    np.testing.assert_array_equal(tm.param("m_probs"), 0.5)
    np.testing.assert_allclose(tm.param("z_trans"), 0.5)
    gen = torch.Generator().manual_seed(0)
    ndx = torch.arange(4)
    win = {k: v.detach().clone().requires_grad_(True)
           for k, v in tm.gather_windows(tm.params, ndx, None).items()}
    loss = -tm.elbo_from_windows(win, gen, ndx, None, 6, tm._data_dev)
    grads = torch.autograd.grad(loss, list(win.values()))
    assert torch.isfinite(loss)
    for name, g in zip(win, grads):
        assert torch.isfinite(g).all(), name
    assert (grads[list(win).index("z_trans")] != 0).any()


# -- posteriors ---------------------------------------------------------------------

NT, F, NB = 7, 7, 2  # 3 on-target AOIs: blocks of 2 leave a ragged last block


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A JAX float64 hmm model and the port's at the same perturbed
    parameters, on one workspace."""
    jax.config.update("jax_enable_x64", True)
    ws = tmp_path_factory.mktemp("hmm_probs")
    jax_save(numpy_dataset(CosmosDataset, OffsetData, Nt=NT, F=F, seed=4), ws)
    jm = jax_models["cosmos+hmm"](dtype="double")
    jm.load(ws)
    jm.init(lr=0.005, nbatch_size=NB, fbatch_size=F)
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()}, seed=5,
                            scale=0.5)
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    tm = models["cosmos+hmm"](device="cpu", dtype="double")
    tm.load(ws)
    tm.init(lr=0.005, nbatch_size=NB, fbatch_size=F)
    tm.params = params_from_jax(p_np, "cpu", torch.float64)
    assert tm.data.N == 3 and tm.data.Nt == NT
    return jm, tm


def jax_theta_draws(jm, pc, key, ndx, num_particles):
    """The draws of the JAX package's ``_compute_theta_probs`` block for
    ``key``: one key per particle, split four ways (lamda, proximity, x,
    y)."""
    P = jm.data.P
    lim = (P + 1) / 2

    def gk(a):
        return jnp.moveaxis(jnp.take(a, ndx, 1), 0, -1)

    size = gk(pc["size"])
    out = {k: [] for k in ("lamda", "proximity", "xs", "ys")}
    for k in jax.random.split(key, num_particles):
        ks = jax.random.split(k, 4)
        out["lamda"].append(jax_gamma_sample(
            ks[0], pc["lamda_loc"] * pc["lamda_beta"], pc["lamda_beta"]))
        out["proximity"].append(jax_affine_beta_sample(
            ks[1], pc["proximity_loc"], pc["proximity_size"], 0.0,
            (P + 1) / math.sqrt(12)))
        out["xs"].append(jax_affine_beta_sample(ks[2], gk(pc["x_mean"]), size, -lim, lim))
        out["ys"].append(jax_affine_beta_sample(ks[3], gk(pc["y_mean"]), size, -lim, lim))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items()}


@pytest.fixture(scope="module")
def theta(fitted):
    """JAX ``_compute_theta_probs(num_particles=3)`` and the port's with the
    JAX block draws injected block by block (the JAX package pads a ragged
    block with repeated rows; its draws are cut to the block)."""
    jax.config.update("jax_enable_x64", True)
    jm, tm = fitted
    want = jm._compute_theta_probs(num_particles=3)
    pc = jm.constrained()
    key = jax.random.PRNGKey(0)
    blocks = []
    for n0 in range(0, jm.data.N, NB):
        ndx = np.arange(n0, min(n0 + NB, jm.data.N))
        key, sub = jax.random.split(key)
        d = jax_theta_draws(jm, pc, sub,
                            jnp.asarray(np.pad(ndx, (0, NB - len(ndx)), mode="edge")), 3)
        for k in ("xs", "ys"):
            d[k] = d[k][:, : len(ndx)]
        blocks.append(d)
    got = tm._compute_theta_probs(num_particles=3, draws=blocks)
    return want, got


def test_z_probs_and_m_probs_match_jax(fitted):
    jm, tm = fitted
    z_j, z_t = np.asarray(jm.z_probs), tm.z_probs
    assert z_t.dtype == np.float64 and z_t.shape == (NT, F, 1, 2)
    np.testing.assert_allclose(z_t, z_j, **PROB_TOL)
    np.testing.assert_allclose(z_t.sum(-1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(tm.z_map, np.asarray(jm.z_map))
    np.testing.assert_allclose(tm.m_probs, np.asarray(jm.m_probs), **PROB_TOL)
    assert tm.m_probs.shape == (2, NT, F, 1)
    assert tm.pspecific is tm.z_probs


def test_theta_probs_match_jax_block_by_block(fitted, theta):
    want, got = theta
    N = fitted[1].data.N
    assert got.dtype == np.float64 and got.shape == (2, NT, F, 1)
    np.testing.assert_allclose(got, np.asarray(want), **PROB_TOL)
    assert not got[:, N:].any()  # off-target rows stay 0
    assert (got[:, :N].sum(0) <= 1.0 + 1e-12).all()
    # the default seed repeats; another generator draws other particles
    a = fitted[1]._compute_theta_probs(num_particles=2)
    np.testing.assert_array_equal(a, fitted[1]._compute_theta_probs(num_particles=2))
    gen = torch.Generator().manual_seed(1)
    assert not np.array_equal(fitted[1]._compute_theta_probs(2, gen), a)


def test_compute_params_match_jax(fitted, theta):
    jm, tm = fitted
    jm._theta_probs_cache, tm._theta_probs_cache = np.asarray(theta[0]), theta[1]
    want, got = jm.compute_params(0.95), tm.compute_params(0.95)
    assert set(got) == set(want)
    assert {"init", "trans", "z_trans"} <= set(got) and "pi" not in got
    for name in tm.ci_params:
        assert set(got[name]) == {"Mean", "LL", "UL"}
        for stat in ("Mean", "LL", "UL"):
            np.testing.assert_allclose(got[name][stat], want[name][stat], **PROB_TOL,
                                       err_msg=f"{name}/{stat}")
    assert got["trans"]["Mean"].shape == (1, 2, 2)
    for name in ("m_probs", "z_probs", "theta_probs", "p_specific", "z_trans"):
        np.testing.assert_allclose(got[name], want[name], **PROB_TOL, err_msg=name)
    np.testing.assert_array_equal(got["z_map"], want["z_map"])


def test_params_from_jax_carries_a_jax_hmm_across(fitted):
    jm, _ = fitted
    tm = models["cosmos+hmm"](device="cpu", dtype="double")
    tm.data = jm.data
    tm._transforms = {k: t for k, (v, t) in tm.param_spec().items()}
    tm.params = params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    assert set(tm.params) == set(jm.params) and "z_trans" in tm.params
    for name in tm.params:
        np.testing.assert_allclose(tm.param(name), np.asarray(jm.param(name)),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(tm.z_probs, np.asarray(jm.z_probs), **PROB_TOL)


def test_z_sample_follows_the_chain(fitted):
    """Start states and transitions of 4000 trajectories against the guide's
    chain: a chi-square test over the start cells and one over every
    (AOI, frame, previous state) row of transitions, with a fixed seed."""
    _, tm = fitted
    n = 4000
    z = tm.z_sample(n, generator=torch.Generator().manual_seed(7))
    N = tm.data.N
    assert z.shape == (n, N, F, 1) and set(np.unique(z)) <= {0, 1}
    A = tm.param("z_trans")[:N, :, 0]  # (N, F, 2, 2)
    p0 = A[:, 0, 0, 1]
    k0 = (z[:, :, 0, 0] == 1).sum(0)
    chi2 = (((k0 - n * p0) ** 2) / (n * p0 * (1 - p0))).sum()
    assert st.chi2.sf(chi2, N) > 1e-3
    prev, cur = z[:, :, :-1, 0], z[:, :, 1:, 0]  # (n, N, F-1)
    chi2, dof = 0.0, 0
    for i in (0, 1):
        m = (prev == i).sum(0)  # transitions out of state i per (AOI, frame)
        k = ((prev == i) & (cur == 1)).sum(0)
        p = A[:, 1:, i, 1]
        ok = m > 0
        chi2 += (((k - m * p) ** 2) / (m * p * (1 - p)))[ok].sum()
        dof += int(ok.sum())
    assert st.chi2.sf(chi2, dof) > 1e-3
    assert np.array_equal(tm.z_sample(5), tm.z_sample(5))  # default seed


# -- warm start from cosmos ---------------------------------------------------------


@pytest.fixture(scope="module")
def cosmos_ws(tmp_path_factory):
    """A workspace with a float64 JAX cosmos checkpoint at perturbed
    parameters and a ``cosmos_params.tpqr`` holding its z_probs."""
    jax.config.update("jax_enable_x64", True)
    ws = tmp_path_factory.mktemp("hmm_warm")
    jax_save(numpy_dataset(CosmosDataset, OffsetData, Nt=6, F=8, seed=6), ws)
    cm = jax_models["cosmos"](dtype="double")
    cm.load(ws)
    cm.init(lr=0.005, nbatch_size=3, fbatch_size=8)
    p_np = perturbed_params({k: np.asarray(v) for k, v in cm.params.items()}, seed=8,
                            scale=0.5)
    cm.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    cm.iter, cm.iter_loss, cm._rolling = 300, 100.0, {"-ELBO": [100.0]}
    cm.save_checkpoint()
    rng = np.random.default_rng(9)
    zp = rng.dirichlet(np.ones(2), size=(6, 8, 1))
    zp[3:] = 0.0  # off target, as compute_probs leaves them
    zp[0, :2, 0] = [1.0, 0.0]  # clipped to eps
    with open(ws / "cosmos_params.tpqr", "wb") as f:  # a path would gain ".npz"
        np.savez_compressed(f, z_probs=zp)
    return ws, zp


def _warm(ws, side, **kwargs):
    if side == "jax":
        m = jax_models["cosmos+hmm"](dtype="double")
    else:
        m = models["cosmos+hmm"](device="cpu", dtype="double")
    m.load(ws)
    m.init(lr=0.005, nbatch_size=3, fbatch_size=8)
    return m.warm_start_from_cosmos(**kwargs)


def test_warm_start_matches_jax(cosmos_ws):
    ws, zp = cosmos_ws
    jm, tm = _warm(ws, "jax"), _warm(ws, "port")
    assert set(tm.params) == set(jm.params)
    for name in tm.params:
        np.testing.assert_allclose(tm.params[name].numpy(), np.asarray(jm.params[name]),
                                   rtol=1e-6, atol=1e-12, err_msg=name)
    assert tm.iter == 0 and tm._rolling == {} and tm._seed == 0
    assert all(not v.any() for v in tm.opt_state["count"].values())
    # the chain's marginals reproduce the cosmos posterior within the clip
    N = tm.data.N
    np.testing.assert_allclose(tm.z_probs[:N], zp[:N], atol=2e-5)
    np.testing.assert_allclose(tm.z_probs[N:, ..., 0], 1.0 - 1e-5, rtol=1e-12)
    np.testing.assert_allclose(tm.param("trans_mean").sum(-1), 1.0, rtol=1e-12)


def test_warm_start_without_saved_stats_computes_them(cosmos_ws, tmp_path):
    """Without ``cosmos_params.tpqr`` the warm start computes the cosmos
    posterior itself (the port's seed), and the chain reproduces it."""
    import shutil

    from tapqir_tpu_torch.models.cosmos import cosmos

    ws = shutil.copytree(cosmos_ws[0], tmp_path / "ws")
    (ws / "cosmos_params.tpqr").unlink()
    tm = _warm(ws, "port", num_particles=4)
    cm = cosmos(device="cpu", dtype="double")
    cm.load(ws)
    cm.init(lr=0.005, nbatch_size=3, fbatch_size=8)
    zp = np.clip(cm.compute_probs_arrays(num_particles=4)[0], 1e-5, 1.0)
    zp /= zp.sum(-1, keepdims=True)
    N = tm.data.N
    np.testing.assert_allclose(tm.z_probs[:N], zp[:N], rtol=1e-10)
    tm.run(2)
    assert tm.iter == 2 and (ws / ".tapqir" / "cosmos+hmm_model.tpqr").exists()

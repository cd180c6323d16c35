"""The port's crosstalk model against the JAX package on the CPU, in float64.

Two dyes in two channels (Q = C = 2, K = 2: 16 global spot configs). The
JAX package's packed standard-Gamma draws are recorded and fed through the
port's draw seam, after checking that both packages pack the same
concentrations in the same order (alpha right after the proximity pair), so
both sides score the same samples: the ELBO, every window gradient and one
sparse-Adam step agree at rtol 1e-6, for the dense and the factored
likelihood. Gradient and moment comparisons add an absolute floor of 1e-6
times the array's largest magnitude, for entries that are zero up to
round-off. The posteriors (``_probs_batch``, ``compute_probs_arrays`` with
the JAX block draws) and ``compute_params`` with the ``alpha`` family agree
at rtol 1e-6; the model's alpha-mixed images, dense and spot-major, give the
``xtalk_*`` reference goldens.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_data import (
    assert_close_scaled,
    counted,
    jax_particle_draws,
    numpy_crosstalk_dataset,
    perturbed_params,
)
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.utils.dataset import CosmosDataset as JaxDataset
from tapqir_tpu.utils.dataset import OffsetData as JaxOffset
from tapqir_tpu.utils.dataset import save as jax_save
from tapqir_tpu_torch.convert import opt_state_from_jax, params_from_jax
from tapqir_tpu_torch.distributions import (
    ksmogn_image,
    ksmogn_log_prob,
    offset_gamma_factored_summed,
    offset_gamma_log_prob_summed,
)
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
RTOL = 1e-6
PROB_TOL = dict(rtol=1e-6, atol=1e-12)
GOLDEN = Path(__file__).resolve().parent / "golden" / "reference_goldens.npz"
jax_cosmos_module = importlib.import_module("tapqir_tpu.models.cosmos")
jax_xtalk_module = importlib.import_module("tapqir_tpu.models.crosstalk")
port_cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")
port_xtalk_module = importlib.import_module("tapqir_tpu_torch.models.crosstalk")


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


@pytest.mark.parametrize("K, Q", [(2, 2), (1, 3), (3, 1), (2, 3)])
def test_global_m_configs_match_jax(K, Q):
    got = port_xtalk_module._global_m_configs(K, Q)
    want = jax_xtalk_module._global_m_configs(K, Q)
    assert got[0].shape == (1 << (K * Q), Q, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _models(nbatch, fbatch, Nt=4, F=6, seed=3):
    """A JAX float64 crosstalk model and the port's at the same perturbed
    parameters, on the same numpy dataset."""
    jax.config.update("jax_enable_x64", True)
    jm = jax_models["crosstalk"](dtype="double")
    jm.data = numpy_crosstalk_dataset(JaxDataset, JaxOffset, Nt=Nt, F=F, seed=seed)
    jm.nbatch_size, jm.fbatch_size = nbatch, fbatch
    jm.init_parameters()
    jm._data_dev = jm._data_device_arrays()
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()})
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}

    tm = models["crosstalk"](device="cpu", dtype="double")
    tm.data = numpy_crosstalk_dataset(CosmosDataset, OffsetData, Nt=Nt, F=F, seed=seed)
    tm.nbatch_size, tm.fbatch_size = nbatch, fbatch
    tm.init_parameters()
    tm._data_dev = tm._data_device_arrays()
    tm._build_constants()
    tm.params = params_from_jax(p_np, "cpu", torch.float64)
    assert tm.Q == tm.data.C == 2
    return jm, tm


def _jax_loss_draws(jm, key, monkeypatch, grad):
    """The JAX step's batch, its loss (and window gradients), the packed
    standard-Gamma draws and the concentrations packed for them, recorded
    inside one jitted call."""
    data = jm._data_dev
    ndx, fsel, f, kg, kl = jm._draw_batch(key, data)
    orig = jax_cosmos_module.std_gamma_sample_packed

    def loss_and_draws(w):
        rec = []

        def recording(k, concs):
            out = orig(k, concs)
            rec.append((out, concs))
            return out

        monkeypatch.setattr(jax_cosmos_module, "std_gamma_sample_packed", recording)
        loss = -jm.elbo_from_windows(w, kg, kl, ndx, fsel, f, data)
        monkeypatch.setattr(jax_cosmos_module, "std_gamma_sample_packed", orig)
        (out, concs), = rec
        flat = jnp.concatenate([jnp.reshape(a, (-1,)) for a in out])
        return loss, jax.lax.stop_gradient((flat, list(concs)))

    win = jm.gather_windows(jm.params, ndx, fsel, f)
    if grad:
        (loss, (draws, concs)), grads = jax.jit(
            jax.value_and_grad(loss_and_draws, has_aux=True)
        )(win)
    else:
        (loss, (draws, concs)), grads = jax.jit(loss_and_draws)(win), None
    F = jm.data.F
    fidx = None if f == F else np.asarray(fsel)
    return (np.asarray(ndx), fidx, f, float(loss), np.asarray(draws),
            [np.asarray(c) for c in concs], grads)


def _port_window(tm, ndx, fidx):
    t_ndx = torch.tensor(ndx, dtype=torch.long)
    t_fidx = None if fidx is None else torch.tensor(fidx, dtype=torch.long)
    win = {k: v.detach().clone().requires_grad_(True)
           for k, v in tm.gather_windows(tm.params, t_ndx, t_fidx).items()}
    return t_ndx, t_fidx, win


@pytest.mark.parametrize(
    "nbatch,fbatch,seed,factored",
    [(2, 4, 0, False), (4, 6, 1, False), (2, 4, 3, True)],
    ids=["subsampled-random-frames", "full-batch", "factored-likelihood"],
)
def test_elbo_and_window_gradients_match_jax(nbatch, fbatch, seed, factored,
                                              monkeypatch):
    jm, tm = _models(nbatch, fbatch)
    calls = {"jax": 0, "port": 0}
    route = "offset_gamma_factored_summed" if factored else "offset_gamma_log_prob_summed"
    if factored:  # both packages select the factored route the same way
        jm.use_factored = tm.use_factored = True
    for side, mod in (("jax", jax_xtalk_module), ("port", port_xtalk_module)):
        monkeypatch.setattr(mod, route, counted(calls, side, getattr(mod, route)))
    ndx, fidx, f, j_loss, draws, j_concs, j_grads = _jax_loss_draws(
        jm, jax.random.PRNGKey(seed), monkeypatch, grad=True
    )
    assert (fidx is None) == (fbatch == jm.data.F)

    # the port packs the same concentrations in the same order
    t_concs = []
    packed = port_cosmos_module.std_gamma_sample_packed

    def recording(concs, generator=None, draws=None):
        t_concs.extend(c.detach() for c in concs)
        return packed(concs, generator, draws)

    monkeypatch.setattr(port_cosmos_module, "std_gamma_sample_packed", recording)
    t_ndx, t_fidx, t_win = _port_window(tm, ndx, fidx)
    t_loss = -tm.elbo_from_windows(t_win, None, t_ndx, t_fidx, f, tm._data_dev,
                                   draws=torch.tensor(draws))
    t_grads = torch.autograd.grad(t_loss, list(t_win.values()))
    assert len(t_concs) == len(j_concs) == 14  # cosmos's 13 sites and alpha
    assert t_concs[5].shape == (2, 2)  # alpha (Q, C), after the proximity pair
    for i, (got, want) in enumerate(zip(t_concs, j_concs)):
        np.testing.assert_allclose(got.numpy().reshape(-1), want.reshape(-1),
                                   rtol=1e-12, err_msg=f"packed concentration {i}")
    assert not hasattr(tm, "_alpha_sample")  # the stash does not outlive the ELBO
    np.testing.assert_allclose(t_loss.item(), j_loss, rtol=RTOL)
    assert calls == {"jax": 1, "port": 1}
    assert set(t_win) == set(j_grads) and {"alpha_mean", "alpha_size"} <= set(t_win)
    for name, g in zip(t_win, t_grads):
        assert_close_scaled(g.numpy(), j_grads[name], name)


def test_sparse_adam_step_matches_jax(monkeypatch):
    jm, tm = _models(2, 4, Nt=5, F=6)
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
    ndx, fidx, f, _, draws, _, _ = _jax_loss_draws(jm, step_key, monkeypatch, grad=False)
    j_params, j_opt, j_losses = jm._run_chunk(jm.params, jm.opt_state, key, 1)

    tm.lr = 0.005
    tm.opt_state = opt_state_from_jax(mu, nu, counts, "cpu", torch.float64)
    t_ndx, t_fidx, _ = _port_window(tm, ndx, fidx)
    t_loss = tm._sparse_step(None, batch=(t_ndx, t_fidx, f), draws=torch.tensor(draws))
    np.testing.assert_allclose(float(t_loss), float(j_losses[0]), rtol=RTOL)
    j_adam = j_opt[0]
    for name in tm.params:
        assert_close_scaled(tm.params[name].numpy(), j_params[name], f"param {name}")
        assert_close_scaled(tm.opt_state["mu"][name].numpy(), j_adam.mu[name], f"mu {name}")
        assert_close_scaled(tm.opt_state["nu"][name].numpy(), j_adam.nu[name], f"nu {name}")
    for k, v in tm.opt_state["count"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_adam.count[k]), err_msg=k)
    np.testing.assert_allclose(tm.param("alpha_mean").sum(-1), 1.0, rtol=1e-12)


# -- posteriors ---------------------------------------------------------------------

# 3 on-target and 4 off-target AOIs, 7 frames; blocks of 2 AOIs x 3 frames
# leave a ragged last block on both axes
NT, F, NB, FB = 7, 7, 2, 3


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """A JAX float64 crosstalk model and the port's at the same perturbed
    parameters, on one workspace."""
    jax.config.update("jax_enable_x64", True)
    ws = tmp_path_factory.mktemp("xtalk_probs")
    jax_save(numpy_crosstalk_dataset(CosmosDataset, OffsetData, Nt=NT, F=F, seed=4), ws)
    jm = jax_models["crosstalk"](dtype="double")
    jm.load(ws)
    jm.init(lr=0.005, nbatch_size=NB, fbatch_size=FB)
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()}, seed=5,
                            scale=0.5)
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    tm = models["crosstalk"](device="cpu", dtype="double")
    tm.load(ws)
    tm.init(lr=0.005, nbatch_size=NB, fbatch_size=FB)
    tm.params = params_from_jax(p_np, "cpu", torch.float64)
    assert tm.data.N == 3 and tm.data.Nt == NT and tm.Q == 2
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
    assert z_t.shape == (2, 3, 4, 2) and th_t.shape == (2, 3, 4, 2)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), **PROB_TOL)
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), **PROB_TOL)
    np.testing.assert_allclose(z_t.numpy()[0, 1], 1.0, rtol=1e-12)  # off target: z = 0


def test_compute_probs_arrays_matches_jax_block_by_block(fitted, probs):
    (z_j, th_j), (z_t, th_t) = probs
    assert z_t.shape == (NT, F, 2, 2) and th_t.shape == (2, NT, F, 2)
    np.testing.assert_allclose(z_t, z_j, **PROB_TOL)
    np.testing.assert_allclose(th_t, th_j, **PROB_TOL)
    N = fitted[1].data.N
    assert not z_t[N:].any() and not th_t[:, N:].any()  # off-target rows stay 0
    np.testing.assert_allclose(z_t[:N].sum(-1), 1.0, rtol=1e-12)


def test_compute_params_with_alpha_matches_jax(fitted, probs):
    jm, tm = fitted
    jm._probs_cache, tm._probs_cache = probs
    want, got = jm.compute_params(0.95), tm.compute_params(0.95)
    assert set(got) == set(want)
    assert tm.ci_params[0] == "alpha" and tm._global_params[-1] == "alpha"
    assert got["alpha"]["Mean"].shape == (2, 2)
    for name in tm.ci_params:
        for stat in ("Mean", "LL", "UL"):
            np.testing.assert_allclose(got[name][stat], want[name][stat], **PROB_TOL,
                                       err_msg=f"{name}/{stat}")
    for name in ("m_probs", "z_probs", "theta_probs", "p_specific"):
        np.testing.assert_allclose(got[name], want[name], **PROB_TOL, err_msg=name)
    np.testing.assert_array_equal(got["z_map"], want["z_map"])
    np.testing.assert_allclose(tm.param("alpha_mean"), np.asarray(jm.param("alpha_mean")),
                               rtol=1e-12)


# -- the reference goldens ---------------------------------------------------------


@pytest.fixture(scope="module")
def xtalk():
    with np.load(GOLDEN) as z:
        return {k[len("xtalk_"):]: torch.tensor(z[k]) for k in z.files
                if k.startswith("xtalk_")}


def test_ksmogn_with_alpha_matches_reference_goldens(xtalk):
    g = xtalk
    P = g["value"].shape[-1]
    spots = tuple(g[k] for k in ("height", "width", "x", "y", "target_locs", "background"))
    img = ksmogn_image(*spots, P, g["m"], g["alpha"])
    np.testing.assert_allclose(img.numpy(), g["image"].numpy(), rtol=1e-10, atol=1e-10)
    lp = ksmogn_log_prob(g["value"], *spots, g["gain"], g["offset_samples"],
                         g["offset_logits"], P, g["m"], g["alpha"])
    np.testing.assert_allclose(lp.numpy(), g["log_prob"].numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("route", ["dense", "factored"])
def test_model_images_and_likelihood_match_reference_goldens(xtalk, route):
    """The model's alpha-mixed images (dense: one per config; factored: the
    spot-major spots over a per-channel base) for the golden images' own
    spot configs, and their summed likelihood, give the golden image and
    log-likelihood."""
    g = xtalk
    n, f, Q, K = g["height"].shape
    C, P = g["target_locs"].shape[-2], g["value"].shape[-1]
    ev, ev_pad = P * P, 256
    nf = n * f
    args = (g["height"], g["width"], g["x"], g["y"], g["target_locs"])
    m = g["m"].reshape(nf, Q, K)
    cfg = (m.reshape(nf, Q * K) * 2 ** torch.arange(Q * K)).sum(-1).long()  # global config
    mtab = port_xtalk_module._global_m_configs(K, Q)[0]
    np.testing.assert_array_equal(mtab[cfg.numpy()], m.numpy())
    if route == "dense":
        img = port_xtalk_module.crosstalk._mixed_images(
            g["background"], *args, g["alpha"], m, P, ev_pad)  # (nf, nf, C, EVP)
        img = img[torch.arange(nf), torch.arange(nf)]  # each image in its own config
    else:
        spots = port_xtalk_module.crosstalk._mixed_spots(*args, g["alpha"], P, ev_pad)
        img = g["background"].reshape(nf, C, 1) + torch.einsum(
            "xj,jxcp->xcp", m.reshape(nf, Q * K), spots.reshape(Q * K, nf, C, ev_pad))
    assert not img[..., ev:].sub(g["background"].reshape(nf, C, 1)).any()  # padding
    np.testing.assert_allclose(img[..., :ev].reshape(n, f, C, P, P).numpy(),
                               g["image"].numpy(), rtol=1e-10, atol=1e-10)

    gain, off, logits = g["gain"], g["offset_samples"], g["offset_logits"]
    val = torch.cat([g["value"].reshape(nf * C, ev),
                     torch.full((nf * C, ev_pad - ev), float(off.max()) + 1.0,
                                dtype=torch.float64)], -1)
    if route == "dense":
        lp = offset_gamma_log_prob_summed(val, img.reshape(1, nf * C, ev_pad) / gain,
                                          1.0 / gain, off, logits, event_ndims=1, ev=ev)[0]
    else:
        lp_all = offset_gamma_factored_summed(
            val, g["background"].reshape(-1) / gain, spots / gain,
            mtab.reshape(-1, Q * K), 1.0 / gain, off, logits, ev=ev)  # (16, nf*C)
        lp = lp_all.reshape(-1, nf, C)[cfg, torch.arange(nf)].reshape(-1)
    np.testing.assert_allclose(lp.reshape(n, f, C).sum(-1).numpy(),
                               g["log_prob"].numpy(), rtol=1e-9, atol=1e-9)

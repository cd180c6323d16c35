"""The port's cosmos ELBO and sparse-Adam step against the JAX package.

The JAX package's packed standard-Gamma draws are recorded and fed through
the port's draw seam, so both sides score the same samples: in float64 the
loss, every window gradient, and one optimizer step (parameters, Adam
moments and per-row step counts) agree at rtol 1e-6. Gradient and moment
comparisons add an absolute floor of 1e-6 times the array's largest
magnitude, for entries that are zero up to round-off.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_data import (
    assert_close_scaled,
    counted,
    numpy_dataset,
    perturbed_params,
)
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.utils.dataset import CosmosDataset as JaxDataset
from tapqir_tpu.utils.dataset import OffsetData as JaxOffset
from tapqir_tpu_torch.convert import opt_state_from_jax, params_from_jax
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
RTOL = 1e-6
WINDOW_SEED = 2  # a JAX key whose frame window wraps past the last frame
# the module, not the class the package's __init__ binds to the same name
jax_cosmos_module = importlib.import_module("tapqir_tpu.models.cosmos")
port_cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")


def _models(nbatch, fbatch, Nt=4, F=6, sampling="random"):
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    jdata = numpy_dataset(JaxDataset, JaxOffset, Nt=Nt, F=F, seed=3)
    tdata = numpy_dataset(CosmosDataset, OffsetData, Nt=Nt, F=F, seed=3)
    jm = jax_models["cosmos"](dtype="double")
    jm.data = jdata
    jm.nbatch_size, jm.fbatch_size = nbatch, fbatch
    jm.frame_sampling = sampling
    jm.init_parameters()
    jm._data_dev = jm._data_device_arrays()
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()})
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}

    tm = models["cosmos"](device="cpu", dtype="double")
    tm.data = tdata
    tm.nbatch_size, tm.fbatch_size = nbatch, fbatch
    tm.frame_sampling = sampling
    tm.init_parameters()
    tm._data_dev = tm._data_device_arrays()
    tm._build_constants()
    tm.params = params_from_jax(p_np, "cpu", torch.float64)
    return jm, tm


def _jax_loss_draws(jm, key, monkeypatch, grad):
    """The JAX step's batch, its loss (and window gradients), and its packed
    standard-Gamma draws, recorded inside one jitted call."""
    data = jm._data_dev
    ndx, fsel, f, kg, kl = jm._draw_batch(key, data)
    orig = jax_cosmos_module.std_gamma_sample_packed

    def loss_and_draws(w):
        rec = []

        def recording(k, concs):
            out = orig(k, concs)
            rec.append(out)
            return out

        monkeypatch.setattr(jax_cosmos_module, "std_gamma_sample_packed", recording)
        loss = -jm.elbo_from_windows(w, kg, kl, ndx, fsel, f, data)
        monkeypatch.setattr(jax_cosmos_module, "std_gamma_sample_packed", orig)
        flat = jnp.concatenate([jnp.reshape(a, (-1,)) for a in rec[0]])
        return loss, jax.lax.stop_gradient(flat)

    win = jm.gather_windows(jm.params, ndx, fsel, f)
    if grad:
        (loss, draws), grads = jax.jit(
            jax.value_and_grad(loss_and_draws, has_aux=True)
        )(win)
    else:
        (loss, draws), grads = jax.jit(loss_and_draws)(win), None
    F = jm.data.F
    if f == F:
        fidx = None
    elif np.ndim(fsel) == 0:  # "window": the cyclic window at offset fsel
        fidx = (int(fsel) + np.arange(f)) % F
    else:
        fidx = np.asarray(fsel)
    return np.asarray(ndx), fidx, f, float(loss), np.asarray(draws), grads


def _torch_batch(ndx, fidx, f):
    t_ndx = torch.tensor(ndx, dtype=torch.long)
    t_fidx = None if fidx is None else torch.tensor(fidx, dtype=torch.long)
    return t_ndx, t_fidx, f


@pytest.mark.parametrize(
    "nbatch,fbatch,seed,sampling,factored",
    [(2, 4, 0, "random", False), (2, 4, WINDOW_SEED, "window", False),
     (4, 6, 1, "random", False), (2, 4, 3, "random", True)],
    ids=["subsampled-random-frames", "subsampled-wrapping-window", "full-batch",
         "factored-likelihood"],
)
def test_elbo_and_window_gradients_match_jax(nbatch, fbatch, seed, sampling,
                                              factored, monkeypatch):
    jm, tm = _models(nbatch, fbatch, sampling=sampling)
    calls = {"jax": 0, "port": 0}
    if factored:  # both packages select the factored route the same way
        jm.use_factored = tm.use_factored = True
        for side, mod in (("jax", jax_cosmos_module), ("port", port_cosmos_module)):
            monkeypatch.setattr(mod, "offset_gamma_factored_summed",
                                counted(calls, side, mod.offset_gamma_factored_summed))
    ndx_np, fidx_np, f, j_loss, draws, j_grads = _jax_loss_draws(
        jm, jax.random.PRNGKey(seed), monkeypatch, grad=True
    )
    if fbatch < jm.data.F:
        assert fidx_np is not None and len(fidx_np) == fbatch
    if sampling == "window":
        assert fidx_np[-1] < fidx_np[0]  # the window wraps past the last frame
        # the port's own window draw: a cyclic window of f frames
        _, t_f, _ = tm._draw_batch(torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(t_f.numpy(), (int(t_f[0]) + np.arange(f)) % jm.data.F)

    t_ndx, t_fidx, _ = _torch_batch(ndx_np, fidx_np, f)
    t_win = {
        k: v.detach().clone().requires_grad_(True)
        for k, v in tm.gather_windows(tm.params, t_ndx, t_fidx).items()
    }
    t_loss = -tm.elbo_from_windows(
        t_win, None, t_ndx, t_fidx, f, tm._data_dev,
        draws=torch.tensor(draws),
    )
    t_grads = torch.autograd.grad(t_loss, list(t_win.values()))
    np.testing.assert_allclose(t_loss.item(), j_loss, rtol=RTOL)
    assert calls == {"jax": int(factored), "port": int(factored)}
    assert set(t_win) == set(j_grads)
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
    ndx_np, fidx_np, _, _, draws, _ = _jax_loss_draws(
        jm, step_key, monkeypatch, grad=False
    )
    j_params, j_opt, j_losses = jm._run_chunk(jm.params, jm.opt_state, key, 1)

    tm.lr = 0.005
    tm.opt_state = opt_state_from_jax(mu, nu, counts, "cpu", torch.float64)
    t_loss = tm._sparse_step(
        None, batch=_torch_batch(ndx_np, fidx_np, 4),
        draws=torch.tensor(draws),
    )
    np.testing.assert_allclose(float(t_loss), float(j_losses[0]), rtol=RTOL)
    j_adam = j_opt[0]
    for name in tm.params:
        assert_close_scaled(tm.params[name].numpy(), j_params[name], f"param {name}")
        assert_close_scaled(tm.opt_state["mu"][name].numpy(), j_adam.mu[name], f"mu {name}")
        assert_close_scaled(tm.opt_state["nu"][name].numpy(), j_adam.nu[name], f"nu {name}")
    for k, v in tm.opt_state["count"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_adam.count[k]), err_msg=k)

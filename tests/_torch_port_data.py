"""Shared inputs and checks for the tests of the PyTorch port
(tests/test_torch_*.py): small datasets and parameter points made with
numpy from a seed, handed to both packages as numpy arrays, and the JAX
package's posterior draws for the port's draw seams."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from tapqir_tpu.distributions.core import (
    affine_beta_sample as jax_affine_beta_sample,
    dirichlet_sample as jax_dirichlet_sample,
    gamma_sample as jax_gamma_sample,
)

PARAMS = {
    "pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
    "offset": 90.0, "height": 3000, "background": 150,
}


def offset_histogram(J=5, center=90.0, spread=2.0):
    """J integer offset bins around ``center`` with Gaussian weights."""
    g = center + spread * (np.arange(J) - J // 2)
    w = np.exp(-0.5 * ((g - center) / (spread * 1.5)) ** 2)
    return g.astype(np.float64), w / w.sum()


def numpy_dataset(cls_dataset, cls_offset, Nt=4, F=6, P=14, J=5, seed=0):
    """A cosmos dataset drawn with numpy: background + one Gaussian spot in
    some frames, camera Gamma noise with gain 7, and a J-bin offset."""
    rng = np.random.default_rng(seed)
    g, w = offset_histogram(J)
    yy, xx = np.mgrid[0:P, 0:P]
    c = (P - 1) / 2
    spot = 3000.0 / (2 * np.pi * 1.4**2) * np.exp(
        -((xx - c) ** 2 + (yy - c) ** 2) / (2 * 1.4**2)
    )
    present = rng.random((Nt, F, 1)) < 0.3
    mu = 150.0 + present[..., None, None] * spot  # (Nt, F, 1, P, P)
    gain = 7.0
    images = rng.gamma(mu / gain, gain) + rng.choice(g, size=mu.shape, p=w)
    is_ontarget = np.zeros(Nt, bool)
    is_ontarget[: Nt // 2] = True
    return cls_dataset(
        images=np.floor(images).astype(np.float32),
        xy=np.full((Nt, F, 1, 2), c, np.float32),
        is_ontarget=is_ontarget,
        offset=cls_offset(g, w),
        name="numpy-test",
    )


ALPHA = [[0.85, 0.15], [0.1, 0.9]]


def numpy_crosstalk_dataset(cls_dataset, cls_offset, Nt=4, F=6, P=14, J=5, seed=0,
                            alpha=ALPHA):
    """A two-dye, two-channel crosstalk dataset drawn with numpy: in channel
    c, background + alpha[q, c] times a Gaussian spot of each dye q present
    in that frame, camera Gamma noise with gain 7, and a J-bin offset."""
    rng = np.random.default_rng(seed)
    g, w = offset_histogram(J)
    yy, xx = np.mgrid[0:P, 0:P]
    c = (P - 1) / 2
    spot = 3000.0 / (2 * np.pi * 1.4**2) * np.exp(
        -((xx - c) ** 2 + (yy - c) ** 2) / (2 * 1.4**2)
    )
    present = (rng.random((Nt, F, 2)) < 0.3).astype(np.float64)  # (Nt, F, Q)
    mu = 150.0 + np.einsum("nfq,qc->nfc", present, np.asarray(alpha))[..., None, None] * spot
    images = rng.gamma(mu / 7.0, 7.0) + rng.choice(g, size=mu.shape, p=w)
    is_ontarget = np.zeros(Nt, bool)
    is_ontarget[: Nt // 2] = True
    return cls_dataset(
        images=np.floor(images).astype(np.float32),
        xy=np.full((Nt, F, 2, 2), c, np.float32),
        is_ontarget=is_ontarget,
        offset=cls_offset(g, w),
        name="numpy-crosstalk-test",
    )


def perturbed_params(params_np, seed=1, scale=0.2):
    """The unconstrained init plus numpy noise, so gradients are generic."""
    rng = np.random.default_rng(seed)
    return {
        k: np.asarray(v, np.float64) + scale * rng.standard_normal(np.shape(v))
        for k, v in params_np.items()
    }


def assert_close_scaled(got, want, what, rtol=1e-6):
    """rtol, plus an absolute floor of rtol times the largest magnitude of
    ``want``, for entries that are zero up to round-off."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = rtol * max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def counted(calls, side, fn):
    """``fn`` that adds one to ``calls[side]`` per call."""

    def wrapped(*args, **kwargs):
        calls[side] += 1
        return fn(*args, **kwargs)

    return wrapped


def jax_particle_draws(jm, pc, key, ndx, fdx, num_particles):
    """The draws of the JAX package's ``_probs_batch`` for ``key``: one key
    per particle, split five ways (pi, lamda, proximity, x, y)."""
    P = jm.data.P
    lim = (P + 1) / 2

    def gk(a):
        return jnp.moveaxis(jnp.take(jnp.take(a, ndx, 1), fdx, 2), 0, -1)

    size = gk(pc["size"])
    out = {k: [] for k in ("pi", "lamda", "proximity", "xs", "ys")}
    for k in jax.random.split(key, num_particles):
        ks = jax.random.split(k, 5)
        out["pi"].append(jax_dirichlet_sample(ks[0], pc["pi_mean"] * pc["pi_size"]))
        out["lamda"].append(jax_gamma_sample(
            ks[1], pc["lamda_loc"] * pc["lamda_beta"], pc["lamda_beta"]))
        out["proximity"].append(jax_affine_beta_sample(
            ks[2], pc["proximity_loc"], pc["proximity_size"], 0.0,
            (P + 1) / math.sqrt(12)))
        out["xs"].append(jax_affine_beta_sample(ks[3], gk(pc["x_mean"]), size, -lim, lim))
        out["ys"].append(jax_affine_beta_sample(ks[4], gk(pc["y_mean"]), size, -lim, lim))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items()}


def jax_restart_inputs(jm, R, num_iter, perturb, chunk, record):
    """What JAX ``fit_restarts(jm, R, num_iter, perturb=perturb,
    chunk=chunk)`` starts from and draws, in its own key order
    (restarts.py:45-99): the (R, ...) perturbed initial parameters, and per
    step and chain the batch and the packed standard-Gamma draws that
    ``record(jm, key)`` -> (ndx, fidx or None, f, draws) reads from the
    chain's parameters at that step. The draws depend on the parameters,
    so each chain is stepped here as ``one_step`` steps it (value_and_grad
    of -elbo, then ``optax.adam``)."""
    import zlib

    import optax

    data = jm._data_dev
    tx = optax.adam(jm.lr, b1=0.9, b2=0.999, eps=1e-8)
    k_perturb, k_run = jax.random.split(jax.random.PRNGKey(0))
    init = {}
    for name, v in jm.params.items():
        v = np.asarray(v)
        base = np.broadcast_to(v, (R,) + v.shape)
        noise = np.array(perturb * jax.random.normal(
            jax.random.fold_in(k_perturb, zlib.crc32(name.encode()) % (2**31)),
            base.shape, v.dtype))
        noise[0] = 0.0  # chain 0 keeps the unperturbed init
        init[name] = base + noise

    @jax.jit
    def one_step(params, opt_state, key):
        grads = jax.grad(lambda q: -jm.elbo(q, key, data))(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state

    base_params = jm.params
    state = []
    for r in range(R):
        p = {k: jnp.asarray(v[r]) for k, v in init.items()}
        state.append((p, tx.init(p)))
    steps = []
    done = 0
    while done < num_iter:
        n = min(chunk, num_iter - done)
        k_run, sub = jax.random.split(k_run)
        keys_r = jax.random.split(sub, R)
        chunk_steps = [[None] * R for _ in range(n)]
        for r in range(R):
            p, opt = state[r]
            for i, key in enumerate(jax.random.split(keys_r[r], n)):
                jm.params = p
                chunk_steps[i][r] = record(jm, key)
                p, opt = one_step(p, opt, key)
            state[r] = (p, opt)
        steps.extend(chunk_steps)
        done += n
    jm.params = base_params
    return init, steps


def port_restart_args(init, steps, device="cpu", dtype=None):
    """``fit_restarts``' seams from :func:`jax_restart_inputs`: the initial
    (R, ...) parameters, and per step the chains' batch (ndx (R, n), fidx
    (R, f) or None, f) and draws (R, N)."""
    import torch

    params = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in init.items()}
    batches, draws = [], []
    for chains in steps:
        ndx = torch.tensor(np.stack([c[0] for c in chains]), device=device)
        fidx = (None if chains[0][1] is None else
                torch.tensor(np.stack([c[1] for c in chains]), device=device))
        batches.append((ndx, fidx, chains[0][2]))
        draws.append(torch.tensor(np.stack([c[3] for c in chains]), device=device,
                                  dtype=dtype))
    return params, batches, draws


def assert_restarts_match(tm, t_losses, t_best, jm, j_losses, j_best, rtol=1e-6):
    """The port's ``fit_restarts`` result against the JAX package's: the
    (R, T) losses, the best chain, the winner's parameters, Adam moments
    and step counts, the iteration and the last loss."""
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=rtol)
    assert t_best == j_best
    adam = jm.opt_state[0]
    assert set(tm.params) == set(jm.params)
    for name in tm.params:
        assert_close_scaled(tm.params[name].numpy(), jm.params[name], f"param {name}", rtol)
        assert_close_scaled(tm.opt_state["mu"][name].numpy(), adam.mu[name], f"mu {name}", rtol)
        assert_close_scaled(tm.opt_state["nu"][name].numpy(), adam.nu[name], f"nu {name}", rtol)
    count = int(np.asarray(adam.count))
    assert count == t_losses.shape[1]
    for k, v in tm.opt_state["count"].items():
        assert (v.numpy() == count).all(), k
    assert tm.iter == jm.iter
    np.testing.assert_allclose(tm.iter_loss, jm.iter_loss, rtol=rtol)

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

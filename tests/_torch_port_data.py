"""Shared inputs and checks for the tests of the PyTorch port
(tests/test_torch_*.py): small datasets and parameter points made with
numpy from a seed, handed to both packages as numpy arrays."""

import numpy as np

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

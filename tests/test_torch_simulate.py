"""The port's simulator against the JAX package's, in distribution: the two
use different random streams, so each regime (cosmos, crosstalk, kinetic
kon/koff, kinetic init/trans) is compared by its array layout, the share of
on-target frames with a bound molecule (z > 0), the kinetic chain's
off->on transition rate, and the mean image per channel. Tolerances are
about five standard deviations of each statistic at this size."""

import numpy as np
import pytest
import torch

from tapqir_tpu.utils.simulate import simulate as jax_simulate
from tapqir_tpu_torch.utils.simulate import simulate

torch.set_num_threads(1)
BASE = {"width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
        "offset": 90.0, "height": 3000, "background": 150}
REGIMES = {
    "cosmos": (1, {"pi": 0.3}),
    "crosstalk": (2, {"pi": 0.3, "alpha": [[1.0, 0.2], [0.1, 1.0]]}),
    "kinetic-kon-koff": (1, {"kon": 0.2, "koff": 0.3}),
    "kinetic-init-trans": (1, {"init": [0.6, 0.4], "trans": [[0.85, 0.15], [0.25, 0.75]]}),
}


def _stats(d):
    z = np.asarray(d.labels["z"])  # (N/2, F, Q) on-target labels
    on = (z > 0).astype(float)
    off_prev = on[:, :-1] == 0
    rate_on = (on[:, 1:][off_prev]).mean()
    mean_img = np.asarray(d.images, np.float64).mean(axis=(0, 1, 3, 4))
    return on.mean(), rate_on, mean_img


@pytest.mark.parametrize("regime", list(REGIMES))
def test_simulator_matches_jax_in_distribution(regime):
    C, extra = REGIMES[regime]
    params = dict(BASE, **extra)
    N, F = 40, 60
    got = simulate(regime, N=N, F=F, C=C, P=14, seed=1, params=params, device="cpu")
    want = jax_simulate(regime, N=N, F=F, C=C, P=14, seed=1, params=params)

    for name in ("images", "xy", "is_ontarget", "mask"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
    assert got.labels.dtype.names == want.labels.dtype.names
    assert got.labels.shape == want.labels.shape
    np.testing.assert_array_equal(got.is_ontarget, want.is_ontarget)
    assert np.isfinite(got.images).all()
    np.testing.assert_array_equal(got.images, np.floor(got.images))

    p_g, r_g, img_g = _stats(got)
    p_w, r_w, img_w = _stats(want)
    n = N // 2 * F * C
    assert abs(p_g - p_w) < 5 * np.sqrt(2 * p_w * (1 - p_w) / n)
    if regime.startswith("kinetic"):
        assert abs(r_g - r_w) < 0.08
    np.testing.assert_allclose(img_g, img_w, rtol=0.02)

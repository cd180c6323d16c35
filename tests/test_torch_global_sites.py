"""The global guide sites' gradients in float32 against float64.

A global site's concentration grows with the data it summarises: the gain
site's ``gain_loc * gain_beta`` reached ~1.2e8 in an eLife-scale cosmos fit.
There its guide log-density, ``xlogy(c, rate) + xlogy(c - 1, x) - rate * x
- lgamma(c)``, is a sum of terms of ~c log c that cancel to O(1), and its
derivative in c, ``log(rate) + log(x) - digamma(c)``, three terms of ~log c
that cancel to ~1/c; the chain rule multiplies what float32 leaves of that
(~1e-6) by c. The Dirichlet (pi, alpha, init, trans) and affine-Beta
(proximity) sites cancel the same way. The port's ELBOs therefore form every
global site - its concentrations, its sample from the packed draw, the
sample's pathwise gradient, its prior and guide log-densities - in float64,
whatever the model's dtype, and hand the samples to the local terms in the
model's dtype.

Each case sets every global site of a small model at one concentration and
takes the gradient of the ELBO's global term with respect to the
unconstrained global parameters, in a float32 and in a float64 model with
the same parameters (float32 values), batch and injected draws. The global
term is the ELBO with every AOI row masked out (``mask = 0`` zeroes the
local and per-AOI terms and their gradients), so the cases run the ELBO as
the fit runs it, single-chain and chain-batched (the restart path's leading
chain axis). Tolerance: ``|g32 - g64| <= TOL * max(|g64|, 1)`` per entry.

Measured on the JAX package, which keeps these sites in float32
(:func:`test_jax_gain_site_float32_error_is_recorded`; not asserted - the
JAX package is the reference and is not edited): d log q / d log(gain_beta)
of its gain site with one numpy draw held, loc 8.4, at concentrations
8.4e3, 8.4e5, 8.4e6 and 1.23e8 (the eLife fit's at its divergence), is
0.50043 / 0.50005 / 0.50001 / 0.50000 in float64 and 0.49844 / 0.96164 /
5.1576 / -125.67 in float32: the same float32 form as the port had.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_data import numpy_crosstalk_dataset, numpy_dataset, perturbed_params
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
CONCS = [1e4, 1e6, 1e8, 1e9]
TOL = 1e-4
R = 2  # chains of the chain-batched case


def _chip_smoke():
    """chip_smoke.py, whose phase 27 helpers (the global values at a
    concentration, the global term's gradients) these tests share."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


cs = _chip_smoke()


def _model(name, dtype, Nt=4, F=5):
    crosstalk = name == "crosstalk"
    make = numpy_crosstalk_dataset if crosstalk else numpy_dataset
    m = models[name](device="cpu", dtype=dtype)
    m.data = make(CosmosDataset, OffsetData, Nt=Nt, F=F, seed=3)
    m.nbatch_size = 2
    m.fbatch_size = F if name == "cosmos+hmm" else 4
    m.init_parameters()
    m._data_dev = m._data_device_arrays()
    m._build_constants()
    return m


def _params(m, name, c, seed=1):
    """Perturbed local parameters (numpy noise from ``seed``) and every
    global one at concentration ``c``, unconstrained, rounded to float32
    (numpy float64 arrays)."""
    p = perturbed_params({k: v.numpy() for k, v in m.params.items()}, seed=seed, scale=0.1)
    values = cs.global_site_values(name, c, m.Q)
    assert {k for k, axes in m.param_partition().items() if not axes} == set(values)
    for k, val in values.items():
        p[k] = m._transforms[k].inverse(torch.as_tensor(val, dtype=torch.float64)).numpy()
    return {k: np.asarray(v, np.float32).astype(np.float64) for k, v in p.items()}


@pytest.mark.parametrize("chains", [None, R], ids=["single-chain", "chain-batched"])
@pytest.mark.parametrize("conc", CONCS, ids=[f"c{c:.0e}" for c in CONCS])
@pytest.mark.parametrize("name", ["cosmos", "crosstalk", "cosmos+hmm"])
def test_global_site_gradients_float32_match_float64(name, conc, chains):
    m64, m32 = _model(name, "double"), _model(name, "float")
    params = _params(m64, name, conc)
    if chains is not None:  # each chain its own local noise, the same globals
        stacked = _params(m64, name, conc, seed=2)
        params = {k: np.stack([v, stacked[k]]) for k, v in params.items()}
    gen = torch.Generator().manual_seed(7)
    batch = m64._draw_batch(gen, chains=chains)
    g64, draws = cs.global_term_grads(m64, params, batch, chains, generator=gen)
    g32, _ = cs.global_term_grads(m32, params, batch, chains, draws=draws)
    report = {}
    for k, want in g64.items():
        err = np.abs(g32[k] - want) / np.maximum(np.abs(want), 1.0)
        report[k] = (float(err.max()), want.ravel()[:3].tolist(), g32[k].ravel()[:3].tolist())
    bad = {k: v for k, v in report.items() if v[0] > TOL}
    assert not bad, f"{name} at concentration {conc:.0e}: (max error, float64, float32) {bad}"


def _jax_gain_dlogbeta(z, loc, log_beta, dtype):
    """d log q(gain) / d log(gain_beta) of the JAX package's gain site with
    the standard-Gamma draw ``z`` held: gain = z(c) / beta, c = loc * beta,
    z's pathwise gradient the package's ``standard_gamma_grad``."""
    from tapqir_tpu.distributions.core import gamma_log_prob, standard_gamma_grad

    z0 = jnp.asarray(z, dtype)

    def log_q(lb):
        beta = jnp.exp(lb)
        c = jnp.asarray(loc, dtype) * beta
        dz = jax.lax.stop_gradient(standard_gamma_grad(c, z0))
        zc = z0 + (c - jax.lax.stop_gradient(c)) * dz
        return gamma_log_prob(zc / beta, c, beta)

    return float(jax.grad(log_q)(jnp.asarray(log_beta, dtype)))


def test_jax_gain_site_float32_error_is_recorded():
    """The JAX package's gain site in float32 against float64 on the same
    draws (the numbers of the module docstring). Recorded, not asserted on:
    the JAX package is the reference and keeps these sites in float32."""
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    loc = 8.4
    rows = []
    for c in (8.4e3, 8.4e5, 8.4e6, 1.23e8):
        z = float(np.random.default_rng(0).gamma(c))  # one draw at c, held
        lb = math.log(c / loc)
        rows.append((c, _jax_gain_dlogbeta(z, loc, lb, jnp.float64),
                     _jax_gain_dlogbeta(z, loc, lb, jnp.float32)))
    print("JAX gain site, d log q / d log(gain_beta): (concentration, float64, float32)",
          rows)
    for c, g64, g32 in rows:  # the harness itself: float64 is the exact ~0.5
        assert abs(g64 - 0.5) < 0.1, (c, g64)
        assert np.isfinite(g32)


def test_chip_smoke_global_sites_phase_tiny_on_cpu():
    """chip_smoke.py's phase 27 with the float32 side on the CPU: every case
    of the three models within the phase's tolerance (this test's TOL)."""
    assert cs.GLOBAL_SITE_TOL == TOL and set(cs.GLOBAL_SITE_CONCS) <= set(CONCS)
    res = cs.run_global_sites("cpu")
    assert len(res) == 3 * len(cs.GLOBAL_SITE_CONCS) * 2
    assert all(r["max_err"] <= TOL for r in res.values()), res

"""The port's factored event-summed likelihood (per-config concentration
a_m = base + sum_k mtab[m, k] delta_k) against the JAX package's
``offset_gamma_factored_summed``: the Pallas factored kernel in interpret
mode (float32, tests/test_pallas.py's tolerances: forward rtol 3e-5 / atol
1e-2, base, delta and rate gradients rtol 2e-3 / atol 2e-3), including
base < 1, and its XLA path in float64 (rtol 1e-10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapqir_tpu.distributions.ksmogn import (
    offset_gamma_factored_summed as jax_factored,
)
from tapqir_tpu_torch.distributions import offset_gamma_factored_summed
from tapqir_tpu_torch.ops.offset_gamma import config_masks

torch.set_num_threads(1)


def _case(Kf=2, nb=8, ev=196, ev_pad=256, J=7, seed=9, dtype=np.float32):
    """tests/test_pallas.py's factored inputs (crosstalk-like magnitudes,
    some near-zero deltas), in a (2, nb/2) batch."""
    rng = np.random.default_rng(seed)
    value = rng.integers(95, 3000, size=(nb, ev)).astype(dtype)
    base = rng.uniform(10.0, 40.0, size=(nb,)).astype(dtype)
    deltas = rng.uniform(0.0, 300.0, size=(Kf, nb, ev)).astype(dtype)
    deltas[:, :, rng.integers(0, ev, size=ev // 2)] *= 1e-3
    g = np.sort(rng.integers(80, 95, size=J)).astype(dtype)
    w = np.log(rng.dirichlet(np.ones(J))).astype(dtype)
    value_p = np.concatenate([value, np.full((nb, ev_pad - ev), g.max() + 1.0, dtype)], -1)
    deltas_p = np.concatenate([deltas, np.zeros((Kf, nb, ev_pad - ev), dtype)], -1)
    mtab = np.stack(np.meshgrid(*([np.arange(2)] * Kf), indexing="ij"), -1).reshape(-1, Kf)
    batch = (2, nb // 2)
    cot = rng.normal(size=(mtab.shape[0],) + batch).astype(dtype)
    return dict(value=value_p.reshape(batch + (ev_pad,)), base=base.reshape(batch),
                deltas=deltas_p.reshape((Kf,) + batch + (ev_pad,)), mtab=mtab,
                rate=dtype(1.0 / 7.0), g=g, w=w, ev=ev, cot=cot)


def _torch_run(c):
    b = torch.tensor(c["base"], requires_grad=True)
    d = torch.tensor(c["deltas"], requires_grad=True)
    r = torch.tensor(c["rate"], requires_grad=True)
    out = offset_gamma_factored_summed(
        torch.tensor(c["value"]), b, d, c["mtab"], r, torch.tensor(c["g"]),
        torch.tensor(c["w"]), ev=c["ev"],
    )
    grads = torch.autograd.grad((out * torch.tensor(c["cot"])).sum(), (b, d, r))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _jax_run(c, use_pallas):
    def loss(b, d, r):
        out = jax_factored(jnp.asarray(c["value"]), b, d, c["mtab"], r,
                           jnp.asarray(c["g"]), jnp.asarray(c["w"]), ev=c["ev"],
                           use_pallas=use_pallas)
        return (out * jnp.asarray(c["cot"])).sum(), out

    (_, out), grads = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
    )(jnp.asarray(c["base"]), jnp.asarray(c["deltas"]), jnp.asarray(c["rate"]))
    return np.asarray(out), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("small_base", [False, True], ids=["kf2", "base-below-one"])
def test_plain_factored_matches_pallas_interpret(monkeypatch, small_base):
    monkeypatch.setenv("TAPQIR_PALLAS_INTERPRET", "1")
    c = _case()
    if small_base:  # flips the Pallas kernel's base-factor shift to Lmin
        c["base"] = np.full_like(c["base"], 0.05)
    got, g_grads = _torch_run(c)
    want, w_grads = _jax_run(c, use_pallas=True)
    assert got.shape == want.shape == (4, 2, 4)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-2)
    for name, a, b in zip(("base", "deltas", "rate"), g_grads, w_grads):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3, err_msg=name)
    # padded pixels get no delta gradient
    np.testing.assert_array_equal(g_grads[1][..., c["ev"]:], 0.0)


@pytest.mark.parametrize("Kf", [2, 3])
def test_plain_factored_matches_xla_path_float64(Kf):
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    c = _case(Kf=Kf, nb=6, ev=30, ev_pad=40, seed=Kf, dtype=np.float64)
    got, g_grads = _torch_run(c)
    want, w_grads = _jax_run(c, use_pallas=False)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for name, a, b in zip(("base", "deltas", "rate"), g_grads, w_grads):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12, err_msg=name)


def test_config_masks():
    mtab = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 1], [1, 1, 1]])
    assert config_masks(mtab, 3) == (0, 1, 6, 7)
    with pytest.raises(ValueError):
        config_masks(mtab, 2)
    with pytest.raises(ValueError):
        config_masks(mtab * 2, 3)

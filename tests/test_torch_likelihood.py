"""The port's plain event-summed likelihood against the JAX package: the
Pallas summed kernel run in interpret mode (float32, tests/test_pallas.py's
tolerances: forward rtol 3e-5 / atol 1e-2, concentration gradient rtol 2e-4
/ atol 1e-4, rate gradient rtol 1e-3) and the XLA oracle
``_offset_gamma_log_prob_xla`` (float64, rtol 1e-10), including pixels below
every offset bin and padded event lanes; plus the image model against the
reference-code goldens."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapqir_tpu.distributions.ksmogn import (
    _offset_gamma_log_prob_xla,
    ksmogn_image as jax_ksmogn_image,
)
from tapqir_tpu.ops.offset_gamma import offset_gamma_summed_pallas
from tapqir_tpu_torch.distributions.ksmogn import (
    ksmogn_image,
    ksmogn_sample,
    offset_gamma_log_prob_summed,
)
from tapqir_tpu_torch.ops.offset_gamma import (
    offset_gamma_log_prob_plain,
    offset_gamma_summed,
)

torch.set_num_threads(1)
GOLDEN = Path(__file__).resolve().parent / "golden" / "reference_goldens.npz"


def _case(M=4, nb=12, ev=196, ev_pad=256, J=7, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    value = rng.integers(95, 400, size=(nb, ev)).astype(dtype)
    conc = rng.uniform(10.0, 80.0, size=(M, nb, ev)).astype(dtype)
    g = np.sort(rng.integers(80, 95, size=J)).astype(dtype)
    w = np.log(rng.dirichlet(np.ones(J))).astype(dtype)
    rate = dtype(1.0 / 7.0)
    value_p = np.concatenate(
        [value, np.full((nb, ev_pad - ev), g.max() + 1.0, dtype)], -1
    )
    conc_p = np.concatenate([conc, np.ones((M, nb, ev_pad - ev), dtype)], -1)
    cot = rng.uniform(-1.0, 1.0, size=(M, nb)).astype(dtype)
    return value_p, conc_p, rate, g, w, ev, cot


def _torch_run(value, conc, rate, g, w, ev, cot):
    a = torch.tensor(conc, requires_grad=True)
    r = torch.tensor(rate, requires_grad=True)
    out = offset_gamma_summed(torch.tensor(value), a, r, torch.tensor(g),
                              torch.tensor(w), ev)
    ga, gr = torch.autograd.grad((out * torch.tensor(cot)).sum(), (a, r))
    return out.detach().numpy(), ga.numpy(), float(gr)


@pytest.mark.parametrize("nb,below", [(12, False), (20, True)], ids=["plain", "below-every-bin"])
def test_plain_summed_matches_pallas_interpret(monkeypatch, nb, below):
    monkeypatch.setenv("TAPQIR_PALLAS_INTERPRET", "1")
    value, conc, rate, g, w, ev, cot = _case(nb=nb, seed=nb)
    keep = np.ones(nb, bool)
    if below:
        value[3, :4] = g.min() - 5.0  # pixels below every offset bin
        keep[3] = False
        cot[:, 3] = 0.0
    got, ga, gr = _torch_run(value, conc, rate, g, w, ev, cot)

    def jloss(a, r):
        out = offset_gamma_summed_pallas(
            jnp.asarray(value), a, r, jnp.asarray(g), jnp.asarray(w), ev
        )
        return (out * jnp.asarray(cot)).sum(), out

    (_, want), (wa, wr) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(conc), jnp.asarray(rate)
    )
    want, wa = np.asarray(want), np.asarray(wa)
    np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=3e-5, atol=1e-2)
    if below:  # the plain path is exactly -inf there, the kernel ~ -1e30
        assert np.isneginf(got[:, 3]).all() and (want[:, 3] < -1e29).all()
    np.testing.assert_allclose(ga[:, keep, :ev], wa[:, keep, :ev], rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(ga[..., ev:], 0.0)
    np.testing.assert_allclose(gr, float(wr), rtol=1e-3)


def test_plain_summed_matches_xla_oracle_float64():
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    value, conc, rate, g, w, ev, cot = _case(seed=4, dtype=np.float64, ev_pad=200)
    got, ga, gr = _torch_run(value, conc, rate, g, w, ev, cot)

    def jloss(a, r):
        lp = _offset_gamma_log_prob_xla(
            jnp.asarray(value[:, :ev]), a[..., :ev], r, jnp.asarray(g), jnp.asarray(w)
        ).sum(-1)
        return (lp * jnp.asarray(cot)).sum(), lp

    (_, want), (wa, wr) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(conc), jnp.asarray(rate)
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(ga, np.asarray(wa), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gr, float(wr), rtol=1e-10)
    # per pixel, including a pixel below every bin (-inf in both)
    v = value.copy()
    v[0, 0] = g.min() - 1.0
    pp = offset_gamma_log_prob_plain(
        torch.tensor(v), torch.tensor(conc), torch.tensor(rate), torch.tensor(g),
        torch.tensor(w),
    ).numpy()
    pj = np.asarray(_offset_gamma_log_prob_xla(
        jnp.asarray(v), jnp.asarray(conc), jnp.asarray(rate), jnp.asarray(g),
        jnp.asarray(w),
    ))
    assert np.isneginf(pp[:, 0, 0]).all() and np.isneginf(pj[:, 0, 0]).all()
    fin = np.isfinite(pj)
    np.testing.assert_allclose(pp[fin], pj[fin], rtol=1e-12)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("which", ["cosmos", "xtalk"])
def test_image_model_and_summed_likelihood_match_reference_goldens(golden, which):
    g = {k[len(which) + 1:]: v for k, v in golden.items() if k.startswith(which + "_")}
    t = {k: torch.tensor(v) for k, v in g.items()}
    P = g["value"].shape[-1]
    alpha = t.get("alpha")
    img = ksmogn_image(t["height"], t["width"], t["x"], t["y"], t["target_locs"],
                       t["background"], P, t["m"], alpha)
    np.testing.assert_allclose(img.numpy(), g["image"], rtol=1e-10, atol=1e-10)
    jax.config.update("jax_enable_x64", True)
    jimg = jax_ksmogn_image(*(jnp.asarray(g[k]) for k in (
        "height", "width", "x", "y", "target_locs", "background")), P,
        jnp.asarray(g["m"]), None if alpha is None else jnp.asarray(g["alpha"]))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-12)

    # the event-summed likelihood on a lane-padded flat layout
    ev = P * P
    ev_pad = 256
    batch = img.shape[:-2]
    off = t["offset_samples"]
    val = torch.cat([t["value"].reshape(batch + (ev,)),
                     torch.full(batch + (ev_pad - ev,), float(off.max()) + 1.0,
                                dtype=torch.float64)], -1)
    conc = torch.cat([(img / t["gain"]).reshape(batch + (ev,)),
                      torch.ones(batch + (ev_pad - ev,), dtype=torch.float64)], -1)
    lp = offset_gamma_log_prob_summed(
        val, conc[None], 1.0 / t["gain"], off, t["offset_logits"], event_ndims=1,
        ev=ev,
    )[0]
    if alpha is not None:  # crosstalk: summed over channels too
        lp = lp.sum(-1)
    np.testing.assert_allclose(lp.numpy(), g["log_prob"], rtol=1e-9, atol=1e-9)


def test_ksmogn_sample_mean():
    gen = torch.Generator().manual_seed(0)
    sh = (400, 1, 2)
    h = torch.full(sh, 3000.0)
    w = torch.full(sh, 1.4)
    z = torch.zeros(sh)
    tl = torch.full((400, 1, 2), 6.5)
    b = torch.full((400, 1), 150.0)
    off = torch.tensor([88.0, 90.0, 92.0])
    logits = torch.log(torch.tensor([0.2, 0.5, 0.3]))
    x = ksmogn_sample(gen, h, w, z, z, tl, b, 7.0, off, logits, 14)
    mu = ksmogn_image(h, w, z, z, tl, b, 14) + float((off * logits.exp()).sum())
    assert x.shape == (400, 1, 14, 14)
    np.testing.assert_allclose(x.mean(0).numpy(), mu.mean(0).numpy(), rtol=0.03)

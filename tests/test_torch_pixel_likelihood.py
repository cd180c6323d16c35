"""The port's per-pixel offset-Gamma likelihood and the KSMOGN image
log-likelihood against the JAX package: the per-pixel Pallas kernel in
interpret mode (float32, tests/test_pallas.py's tolerances: forward rtol
2e-5 / atol 2e-5, concentration gradient rtol 2e-3 / atol 1e-3, rate
gradient rtol 1e-3), the XLA oracle ``_offset_gamma_log_prob_xla`` and the
JAX ``ksmogn_log_prob`` / ``KSMOGN`` in float64 (rtol 1e-10), and the
reference-code goldens (rtol 1e-9)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tapqir_tpu.distributions.ksmogn import KSMOGN as JaxKSMOGN
from tapqir_tpu.distributions.ksmogn import (
    _offset_gamma_log_prob_xla,
)
from tapqir_tpu.distributions.ksmogn import (
    offset_gamma_log_prob_summed as jax_summed,
)
from tapqir_tpu.ops.offset_gamma import offset_gamma_log_prob_pallas
from tapqir_tpu_torch.distributions import (
    KSMOGN,
    ksmogn_log_prob,
    offset_gamma_log_prob,
    offset_gamma_log_prob_summed,
)
from tapqir_tpu_torch.ops.offset_gamma import (
    offset_gamma_log_prob_plain,
    pixel_layout,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "reference_goldens.npz"


def _case(M=4, n_px=500, J=7, seed=0, dtype=np.float32):
    """tests/test_pallas.py's per-pixel inputs."""
    rng = np.random.default_rng(seed)
    value = rng.integers(95, 400, size=(n_px,)).astype(dtype)
    conc = rng.uniform(10.0, 80.0, size=(M, n_px)).astype(dtype)
    rate = dtype(1.0 / 7.0)
    g = np.sort(rng.integers(80, 95, size=J)).astype(dtype)
    w = np.log(rng.dirichlet(np.ones(J))).astype(dtype)
    return value, conc, rate, g, w


def _torch_run(value, conc, rate, g, w, cot):
    a = torch.tensor(conc, requires_grad=True)
    r = torch.tensor(rate, requires_grad=True)
    out = offset_gamma_log_prob(torch.tensor(value), a, r, torch.tensor(g),
                                torch.tensor(w))
    ga, gr = torch.autograd.grad((out * torch.tensor(cot)).sum(), (a, r))
    return out.detach().numpy(), ga.numpy(), float(gr)


def _jax_run(fn, value, conc, rate, g, w, cot):
    def loss(a, r):
        out = fn(jnp.asarray(value), a, r, jnp.asarray(g), jnp.asarray(w))
        return (out * jnp.asarray(cot)).sum(), out

    (_, out), (ga, gr) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    )(jnp.asarray(conc), jnp.asarray(rate))
    return np.asarray(out), np.asarray(ga), float(gr)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_case(M, n_px, J, variant, seed=6):
    """chip_smoke.py's per-pixel inputs (the kernel's edge cases on the
    card), in float32."""
    x, a, rate, g, w = _chip_smoke().pixel_arrays(M, n_px, J, seed, variant)
    return (x.astype(np.float32), a.astype(np.float32), np.float32(rate),
            g.astype(np.float32), w.astype(np.float32))


@pytest.mark.parametrize(
    "M,n_px,below,squeeze,card",
    [(2, 260, False, False, None), (4, 130, True, False, None),
     (1, 140, False, True, None),
     *((4, 150, False, False, (J, None)) for J in (1, 64, 65)),
     *((4, 200, False, False, (61, v)) for v in ("masked-tiles", "spread", "small-d")),
     (1, 200, False, False, (61, None)), (3, 200, False, False, (61, None))],
    ids=["forward-and-gradients", "below-every-bin", "M1-squeeze", "J1", "J64", "J65",
         "masked-tiles", "spread", "small-d-a-below-one", "M1", "M3"],
)
def test_plain_per_pixel_matches_pallas_interpret(monkeypatch, M, n_px, below,
                                                  squeeze, card):
    monkeypatch.setenv("TAPQIR_PALLAS_INTERPRET", "1")
    if card is None:
        value, conc, rate, g, w = _case(M=M, n_px=n_px)
    else:
        value, conc, rate, g, w = _card_case(M, n_px, *card)
    if below:
        value[:5] = 50.0  # below every offset bin
    if squeeze:
        conc = conc[0]
    cot = np.random.default_rng(1).normal(size=conc.shape).astype(np.float32)
    keep = np.ones(n_px, bool)
    keep[:5] = not below
    cot[..., ~keep] = 0.0
    got, ga, gr = _torch_run(value, conc, rate, g, w, cot)
    want, wa, wr = _jax_run(offset_gamma_log_prob_pallas, value, conc, rate, g,
                            w, cot)
    assert got.shape == want.shape == conc.shape
    np.testing.assert_allclose(got[..., keep], want[..., keep], rtol=2e-5, atol=2e-5)
    if below:  # the plain path is exactly -inf there, the kernel ~ -1e30
        assert np.isneginf(got[:, :5]).all() and (want[:, :5] < -1e29).all()
    np.testing.assert_allclose(ga[..., keep], wa[..., keep], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(gr, wr, rtol=1e-3)


def test_plain_per_pixel_matches_xla_oracle_float64():
    jax.config.update("jax_enable_x64", True)  # conftest restores it
    value, conc, rate, g, w = _case(M=3, n_px=300, seed=2, dtype=np.float64)
    cot = np.random.default_rng(3).normal(size=conc.shape)
    got, ga, gr = _torch_run(value, conc, rate, g, w, cot)
    want, wa, wr = _jax_run(_offset_gamma_log_prob_xla, value, conc, rate, g, w, cot)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(ga, wa, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gr, wr, rtol=1e-10)


def test_plain_per_pixel_matches_xla_oracle_float64_J1024():
    """The kernel's widest histogram (1024 bins, chip_smoke.py's inputs),
    which the Pallas kernel cannot stage (``_pick_tile_rows`` gives None)."""
    jax.config.update("jax_enable_x64", True)
    value, conc, rate, g, w = _chip_smoke().pixel_arrays(3, 200, 1024, 7)
    cot = np.random.default_rng(8).normal(size=conc.shape)
    got, ga, gr = _torch_run(value, conc, np.float64(rate), g, w, cot)
    want, wa, wr = _jax_run(_offset_gamma_log_prob_xla, value, conc, rate, g, w, cot)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(ga, wa, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gr, wr, rtol=1e-10)


@pytest.mark.parametrize(
    "vshape,cshape",
    [((6, 5), (6, 5)), ((6, 5), (3, 6, 5)), ((1, 5), (3, 6, 5)),
     ((6, 5), (3, 1, 5)), ((2, 3, 6, 5), (3, 6, 1))],
    ids=["equal", "configs-leading", "value-broadcasts", "concentration-broadcasts",
         "value-carries-more"],
)
def test_pixel_layout_is_a_broadcast(vshape, cshape):
    """The kernel's flat layout of a call scores exactly what broadcasting
    value against concentration does."""
    rng = np.random.default_rng(4)
    value = torch.tensor(rng.integers(95, 300, vshape), dtype=torch.float64)
    conc = torch.tensor(rng.uniform(10, 50, cshape))
    g, w = torch.tensor([86.0, 88.0, 90.0]), torch.log(torch.tensor([0.2, 0.5, 0.3]))
    rate = torch.tensor(1 / 7.0, dtype=torch.float64)
    x, a2, shape = pixel_layout(value, conc)
    assert x.dim() == 1 and a2.shape == (a2.shape[0], x.shape[0])
    flat = offset_gamma_log_prob_plain(x, a2, rate, g, w).reshape(shape)
    want = offset_gamma_log_prob_plain(value, conc, rate, g, w)
    assert flat.shape == want.shape
    np.testing.assert_array_equal(flat.numpy(), want.numpy())


def test_non_ev_summed_branch_matches_jax_float64():
    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(5)
    M, batch, P = 4, (3, 2, 1), 14
    value = rng.integers(95, 400, size=batch + (P, P)).astype(np.float64)
    conc = rng.uniform(10.0, 80.0, size=(M,) + batch + (P, P))
    g = np.sort(rng.integers(80, 95, size=7)).astype(np.float64)
    w = np.log(rng.dirichlet(np.ones(7)))
    rate = 1.0 / 7.0
    cot = rng.normal(size=(M,) + batch)

    def fn_t(v, a, r, g_, w_):
        return offset_gamma_log_prob_summed(v, a, r, g_, w_, event_ndims=2)

    def fn_j(v, a, r, g_, w_):
        return jax_summed(v, a, r, g_, w_, event_ndims=2, use_pallas=False)

    a = torch.tensor(conc, requires_grad=True)
    r = torch.tensor(rate, dtype=torch.float64, requires_grad=True)
    got = fn_t(torch.tensor(value), a, r, torch.tensor(g), torch.tensor(w))
    ga, gr = torch.autograd.grad((got * torch.tensor(cot)).sum(), (a, r))
    want, wa, wr = _jax_run(fn_j, value, conc, rate, g, w, cot)
    assert got.shape == (M,) + batch
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(ga.numpy(), wa, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(gr), wr, rtol=1e-10)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


_FIELDS = ("height", "width", "x", "y", "target_locs", "background", "gain",
           "offset_samples", "offset_logits")


@pytest.mark.parametrize("which", ["cosmos", "xtalk"])
def test_ksmogn_log_prob_matches_reference_goldens_and_jax(golden, which):
    jax.config.update("jax_enable_x64", True)
    g = {k[len(which) + 1:]: v for k, v in golden.items() if k.startswith(which + "_")}
    P = g["value"].shape[-1]
    alpha = g.get("alpha")
    t = {k: torch.tensor(g[k]) for k in _FIELDS}
    t_alpha = None if alpha is None else torch.tensor(alpha)
    lp = ksmogn_log_prob(torch.tensor(g["value"]), *(t[k] for k in _FIELDS), P,
                         torch.tensor(g["m"]), t_alpha)
    np.testing.assert_allclose(lp.numpy(), g["log_prob"], rtol=1e-9, atol=1e-9)

    # the object API against the JAX package's
    d = KSMOGN(*(t[k] for k in _FIELDS), P, torch.tensor(g["m"]), t_alpha)
    jd = JaxKSMOGN(*(jnp.asarray(g[k]) for k in _FIELDS), P, jnp.asarray(g["m"]),
                   None if alpha is None else jnp.asarray(alpha))
    j_lp, j_mean = jax.jit(lambda v: (jd.log_prob(v, use_pallas=False), jd.mean))(
        jnp.asarray(g["value"])
    )
    np.testing.assert_allclose(d.log_prob(torch.tensor(g["value"])).numpy(),
                               np.asarray(j_lp), rtol=1e-10)
    np.testing.assert_allclose(d.mean.numpy(), np.asarray(j_mean), rtol=1e-12)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([d.sample(gen) for _ in range(200)])
    assert draws.shape == (200,) + g["value"].shape
    # 200 images per pixel: the sample mean is within ~5 standard errors
    se = draws.std(0) / np.sqrt(200)
    assert ((draws.mean(0) - d.mean).abs() < 5 * se + 1e-9).float().mean() > 0.99

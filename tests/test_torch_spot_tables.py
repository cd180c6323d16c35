"""The ELBO's per-spot dye tables (``tapqir_tpu_torch/ops/spot_tables.py``)
on the CPU: the plain ``spot_tables`` against the composition it replaced
in ``cosmos._dye_tables`` and in cosmos+hmm's per-frame tables, values and
gradients bitwise; the kernels' arithmetic (the closed-form gradients that
the CUDA backward takes, the digamma terms included, written out in
float64) against autograd of the plain version; the launchers refusing CPU
tensors; and cosmos, crosstalk and cosmos+hmm calling the op once per ELBO,
in the sparse step and in the restart step.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tapqir_tpu_torch.distributions.core import (
    affine_beta_log_prob,
    gamma_log_prob,
    halfnormal_log_prob,
)
from tapqir_tpu_torch.infer.discrete import m_configs
from tapqir_tpu_torch.ops import spot_tables as st

ROOT = Path(__file__).resolve().parent.parent
cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")
hmm_module = importlib.import_module("tapqir_tpu_torch.models.hmm")

# (R, n, f, Q, Z, K): chains (None: no chain axis), spot groups, q(m)'s z
# axis (None: none), spots
CASES = {
    "K2": (None, 3, 5, 1, None, 2),
    "K1": (None, 3, 5, 1, None, 1),
    "K3": (None, 2, 4, 1, None, 3),
    "Q2-crosstalk": (None, 3, 4, 2, None, 2),
    "chains-R2": (2, 3, 4, 1, None, 2),
    "chains-R4-Q2": (4, 2, 3, 2, None, 2),
    "hmm-z2": (None, 3, 6, 1, 2, 2),
    "hmm-z2-chains-R2-K3": (2, 2, 5, 1, 2, 3),
}
P = 14


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(cs, name, dtype=torch.float64):
    R, n, f, Q, Z, K = CASES[name]
    inputs, prox, gos = cs.spot_tables_case(R, n, f, Q, Z, K, P, dtype=dtype, seed=3)
    return inputs, prox, gos, K


def _composition(xs, ys, h, w, qm, h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size, prox,
                 mtab, spec_tk, P, priors):
    """The per-spot tables as ``cosmos._dye_tables`` and cosmos+hmm's
    per-frame tables computed them before the op."""
    mtab = torch.as_tensor(mtab, dtype=xs.dtype)
    spec_tk = torch.as_tensor(spec_tk)
    lim = (P + 1) / 2
    wmin, wmax = priors["width_min"], priors["width_max"]
    size_sp = ((P + 1) / (2 * prox)) ** 2 - 1.0
    size_sp = size_sp.reshape(size_sp.shape + (1,) * 4)
    lpxy_ns = affine_beta_log_prob(xs, 0.0, 2.0, -lim, lim) + affine_beta_log_prob(
        ys, 0.0, 2.0, -lim, lim)
    lpxy_sp = affine_beta_log_prob(xs, 0.0, size_sp, -lim, lim) + affine_beta_log_prob(
        ys, 0.0, size_sp, -lim, lim)
    lpxy_t = torch.where(spec_tk[:, None, None, None, :], lpxy_sp.unsqueeze(-5),
                         lpxy_ns.unsqueeze(-5))
    term_xy = torch.einsum("mk,...tnfqk->m...tnfq", mtab, lpxy_t)
    lph = halfnormal_log_prob(h, priors["height_std"])
    lpw = affine_beta_log_prob(w, 1.5, 2.0, wmin, wmax)
    term_hw = torch.einsum("mk,...nfqk->m...nfq", mtab, lph + lpw)
    if qm.dim() > xs.dim():  # cosmos+hmm's q(m | z)
        log_qm = torch.einsum("mk,...snfqk->m...snfq", mtab, torch.log(qm)) + torch.einsum(
            "mk,...snfqk->m...snfq", 1.0 - mtab, torch.log1p(-qm))
    else:
        log_qm = torch.einsum("mk,...nfqk->m...nfq", mtab, torch.log(qm)) + torch.einsum(
            "mk,...nfqk->m...nfq", 1.0 - mtab, torch.log1p(-qm))
    lqh = gamma_log_prob(h, h_loc * h_beta, h_beta)
    lqw = affine_beta_log_prob(w, w_mean, w_size, wmin, wmax)
    lqx = affine_beta_log_prob(xs, x_mean, size, -lim, lim)
    lqy = affine_beta_log_prob(ys, y_mean, size, -lim, lim)
    term_q = torch.einsum("mk,...nfqk->m...nfq", mtab, lqh + lqw + lqx + lqy)
    return term_xy, term_hw, term_q, log_qm


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_composition(cs, case, dtype):
    inputs, prox, gos, K = _case(cs, case, dtype)
    outs, grads = cs.spot_tables_grads(st.spot_tables_plain, inputs, prox, gos, P)
    want, want_grads = cs.spot_tables_grads(_composition, inputs, prox, gos, P)
    R, n, f, Q, Z, _ = CASES[case]
    lead, z = () if R is None else (R,), () if Z is None else (Z,)
    M = 1 << K
    assert [tuple(o.shape) for o in outs] == [
        (M,) + lead + (1 + K, n, f, Q), (M,) + lead + (n, f, Q), (M,) + lead + (n, f, Q),
        (M,) + lead + z + (n, f, Q)]
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert want_grads.keys() == set(st.INPUTS) | {"prox"}
    for k in want_grads:
        assert torch.equal(grads[k], want_grads[k]), k


def _xlogy(a, u):
    return torch.where(a == 0, torch.zeros_like(u), a * torch.log(u))


def _xlogy_da(a, u):
    """The factor of xlogy's gradient in a, as autograd takes it: log u,
    also at a = 0 (but 0 where a = 0 and u <= 0)."""
    return torch.where((a == 0) & (u <= 0), torch.zeros_like(u), torch.log(u))


def _beta_lp(u, c1, c0, log_width):
    return (_xlogy(c1 - 1, u) + _xlogy(c0 - 1, 1 - u) + torch.lgamma(c1 + c0)
            - torch.lgamma(c1) - torch.lgamma(c0) - log_width)


def _beta_grad(u, c1, c0):
    """d/du, d/dc1, d/dc0 of :func:`_beta_lp`."""
    psi = torch.digamma(c1 + c0)
    return ((c1 - 1) / u - (c0 - 1) / (1 - u), _xlogy_da(c1 - 1, u) + psi - torch.digamma(c1),
            _xlogy_da(c0 - 1, 1 - u) + psi - torch.digamma(c0))


def _kernel_arithmetic(inputs, prox, mtab, spec, P, priors, gos):
    """The four tables and every gradient as ``csrc/spot_tables.cu`` takes
    them, on whole tensors in float64: the log-densities in closed form,
    the spots' weights summed from the tables' gradients over the configs,
    the concentrations' gradients through the digamma function, and the
    proximity's from d/d size of the specific prior."""
    x, y, h, w, qm, hl, hb, wm, wsz, xm, ym, size = (inputs[k] for k in st.INPUTS)
    lim = (P + 1) / 2
    low, high, width = -lim, lim, P + 1.0
    logw = math.log(width)
    wlow, whigh = priors["width_min"], priors["width_max"]
    wwidth, scale = whigh - wlow, priors["height_std"]
    pw1, pw0 = 2.0 * (1.5 - wlow) / wwidth, 2.0 * (whigh - 1.5) / wwidth
    pw_norm = math.lgamma(pw1 + pw0) - math.lgamma(pw1) - math.lgamma(pw0) - math.log(wwidth)
    lead = tuple(prox.shape)
    pa = ((P + 1) / (2 * prox)).reshape(lead + (1,) * 4)
    s1 = (pa * pa - 1) * (0 - low) / width
    s0 = (pa * pa - 1) * (high - 0) / width
    ux, uy, uw = (x - low) / width, (y - low) / width, (w - wlow) / wwidth
    cx1, cx0 = size * (xm - low) / width, size * (high - xm) / width
    cy1, cy0 = size * (ym - low) / width, size * (high - ym) / width
    cw1, cw0 = wsz * (wm - wlow) / wwidth, wsz * (whigh - wm) / wwidth
    conc = hl * hb

    sp = _beta_lp(ux, s1, s0, logw) + _beta_lp(uy, s1, s0, logw)
    ns = torch.full_like(sp, -logw - logw)
    hw = (0.5 * math.log(2 / math.pi) - math.log(scale) - 0.5 * (h / scale) ** 2
          + _xlogy(torch.tensor(pw1 - 1.0), uw) + _xlogy(torch.tensor(pw0 - 1.0), 1 - uw)
          + pw_norm)
    q = ((_xlogy(conc, hb) + _xlogy(conc - 1, h) - hb * h - torch.lgamma(conc))
         + _beta_lp(uw, cw1, cw0, math.log(wwidth)) + _beta_lp(ux, cx1, cx0, logw)
         + _beta_lp(uy, cy1, cy0, logw))
    bits = torch.as_tensor(mtab, dtype=torch.float64)
    spec = torch.as_tensor(spec)
    z = "s" if qm.dim() > x.dim() else ""
    outs = (
        torch.einsum("mk,...tnfqk->m...tnfq", bits, torch.where(
            spec[:, None, None, None, :], sp.unsqueeze(-5), ns.unsqueeze(-5))),
        torch.einsum("mk,...nfqk->m...nfq", bits, hw),
        torch.einsum("mk,...nfqk->m...nfq", bits, q),
        torch.einsum(f"mk,...{z}nfqk->m...{z}nfq", bits, torch.log(qm))
        + torch.einsum(f"mk,...{z}nfqk->m...{z}nfq", 1 - bits, torch.log1p(-qm)),
    )

    gxy, ghw, gq, glq = gos
    wsp = torch.einsum("mk,tk,m...tnfq->...nfqk", bits, spec.double(), gxy)
    whw = torch.einsum("mk,m...nfq->...nfqk", bits, ghw)
    wq = torch.einsum("mk,m...nfq->...nfqk", bits, gq)
    sx, sy = _beta_grad(ux, s1, s0), _beta_grad(uy, s1, s0)
    bx, by, bw = _beta_grad(ux, cx1, cx0), _beta_grad(uy, cy1, cy0), _beta_grad(uw, cw1, cw0)
    dconc = _xlogy_da(conc, hb) + _xlogy_da(conc - 1, h) - torch.digamma(conc)
    x1, x0, y1, y0 = (wq * d / width for d in (bx[1], bx[2], by[1], by[2]))
    w1, w0 = wq * bw[1] / wwidth, wq * bw[2] / wwidth
    grads = {
        "xs": (wsp * sx[0] + wq * bx[0]) / width,
        "ys": (wsp * sy[0] + wq * by[0]) / width,
        "h": whw * -(h / scale / scale) + wq * ((conc - 1) / h - hb),
        "w": (whw * ((pw1 - 1) / uw - (pw0 - 1) / (1 - uw)) + wq * bw[0]) / wwidth,
        "qm": (torch.einsum(f"mk,m...{z}nfq->...{z}nfqk", bits, glq) / qm
               - torch.einsum(f"mk,m...{z}nfq->...{z}nfqk", 1 - bits, glq) / (1 - qm)),
        "h_loc": wq * dconc * hb,
        "h_beta": wq * (dconc * hl + (conc / hb - h)),
        "w_mean": (w1 - w0) * wsz,
        "w_size": w1 * (wm - wlow) + w0 * (whigh - wm),
        "x_mean": (x1 - x0) * size,
        "y_mean": (y1 - y0) * size,
        "size": x1 * (xm - low) + x0 * (high - xm) + y1 * (ym - low) + y0 * (high - ym),
    }
    d_size = (wsp * ((sx[1] + sy[1]) / width * (0 - low) + (sx[2] + sy[2]) / width * (high - 0))
              ).sum((-4, -3, -2, -1))
    den = 2 * prox
    grads["prox"] = 2 * (-(d_size * 2 * (P + 1) / den) * (P + 1) / (den * den))
    return outs, grads


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_arithmetic_matches_autograd(cs, case):
    inputs, prox, gos, K = _case(cs, case)
    # c1 - 1 = 0 exactly in some guide densities: xlogy's zero and its gradient
    inputs["x_mean"].data[..., 0, 0, 0, :] = 0.0
    inputs["size"].data[..., 0, 0, 0, :] = 2.0
    outs, grads = cs.spot_tables_grads(st.spot_tables_plain, inputs, prox, gos, P)
    spec = np.arange(1 + K)[:, None] == 1 + np.arange(K)
    k_outs, k_grads = _kernel_arithmetic(inputs, prox, m_configs(K), spec, P, cs.ST_PRIORS,
                                         gos)
    for a, b in zip(k_outs, outs):
        assert cs.scaled_err(a, b) <= cs.ST_F64_TOL
    assert k_grads.keys() == grads.keys()
    for k in grads:
        assert cs.scaled_err(k_grads[k], grads[k]) <= cs.ST_F64_TOL, k


def test_kernel_arithmetic_keeps_log1p_at_qm_one(cs):
    """At qm = 1 the plain version's log_qm is -inf in the configs without
    the spot and NaN in those with it (0 * -inf in the einsum); the
    kernels' arithmetic gives the same."""
    inputs, prox, gos, K = _case(cs, "hmm-z2")
    inputs["qm"].data[..., 0, 0, 0, 0] = 1.0
    outs, _ = cs.spot_tables_grads(st.spot_tables_plain, inputs, prox, gos, P)
    spec = np.arange(1 + K)[:, None] == 1 + np.arange(K)
    k_outs, _ = _kernel_arithmetic(inputs, prox, m_configs(K), spec, P, cs.ST_PRIORS, gos)
    assert torch.isneginf(outs[3][0, :, 0, 0, 0]).all()
    assert torch.isnan(outs[3][1, :, 0, 0, 0]).all()
    torch.testing.assert_close(k_outs[3], outs[3], rtol=1e-14, atol=0, equal_nan=True)


def test_cpu_tensors_take_the_plain_version(cs):
    inputs, prox, gos, K = _case(cs, "hmm-z2-chains-R2-K3")
    n = [k.launches for k in (st.tables, st.tables_grad, st.prox_sum)]
    outs, grads = cs.spot_tables_grads(st.spot_tables, inputs, prox, gos, P)
    want, want_grads = cs.spot_tables_grads(st.spot_tables_plain, inputs, prox, gos, P)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert all(torch.equal(grads[k], want_grads[k]) for k in want_grads)
    assert [k.launches for k in (st.tables, st.tables_grad, st.prox_sum)] == n


def test_launchers_refuse_cpu_tensors(cs):
    inputs, prox, gos, K = _case(cs, "chains-R2", torch.float32)
    R, n_, f, Q, _, _ = CASES["chains-R2"]
    G, M = n_ * f * Q, 1 << K
    views = [inputs[k].reshape(R, 1, G, K) for k in st.INPUTS]
    spec = (0, 1, 2)
    consts = st._constants(P, 0.75, 2.25, 10000.0)
    n = [k.launches for k in (st.tables, st.tables_grad, st.prox_sum)]
    outs = (torch.empty(M, R, 1 + K, G), torch.empty(M, R, G), torch.empty(M, R, G),
            torch.empty(M, R, 1, G))
    with pytest.raises(ValueError, match="CUDA"):
        st.tables(views, prox, (0, 1, 2, 3), spec, consts, outs=outs)
    with pytest.raises(ValueError, match="CUDA"):
        st.tables_grad(views, prox, (0, 1, 2, 3), spec, consts, gos=outs,
                       grads=[torch.empty_like(v) for v in views])
    with pytest.raises(ValueError, match="CUDA"):
        st.prox_sum(torch.zeros(R, 1), prox, P)
    assert [k.launches for k in (st.tables, st.tables_grad, st.prox_sum)] == n


def _cpu_model(cs, name, tmp_path):
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.utils.dataset import save
    from tapqir_tpu_torch.utils.simulate import simulate

    sim, C, params = (("crosstalk", 2, cs.XTALK_PARAMS) if name == "crosstalk"
                      else ("cosmos", 1, cs.SIM_PARAMS))
    save(simulate(sim, N=5, F=6, C=C, P=P, seed=1, params=params, device="cpu"), tmp_path)
    model = models[name](device="cpu", dtype="double")
    model.load(tmp_path)
    model.init(lr=0.005, nbatch_size=3, fbatch_size=4)
    return model


@pytest.mark.parametrize("name", ["cosmos", "crosstalk", "cosmos+hmm"])
@pytest.mark.parametrize("chains", [None, 2])
def test_models_call_the_op_once_per_elbo(cs, tmp_path, monkeypatch, name, chains):
    """cosmos's and crosstalk's ``_dye_tables`` and cosmos+hmm's per-frame
    tables compute the per-spot tables through ``spot_tables``, once per
    ELBO, for a single chain (the sparse step) and for a chain axis with a
    proximity per chain (the restart step)."""
    from tapqir_tpu_torch.parallel.restarts import fit_restarts

    model = _cpu_model(cs, name, tmp_path)
    calls = []

    def counting(*args):
        outs = st.spot_tables(*args)
        calls.append((tuple(args[12].shape), tuple(outs[0].shape), tuple(outs[3].shape)))
        return outs

    monkeypatch.setattr(cosmos_module, "spot_tables", counting)
    monkeypatch.setattr(hmm_module, "spot_tables", counting)
    if chains is None:
        gen = torch.Generator()
        gen.manual_seed(0)
        assert np.isfinite(float(model._sparse_step(gen)))
        lead = ()
    else:
        fit_restarts(model, num_restarts=chains, num_iter=1, chunk=1)
        lead = (chains,)
    Q = 2 if name == "crosstalk" else 1
    group = (3, 6 if name == "cosmos+hmm" else 4, Q)
    z = (2,) if name == "cosmos+hmm" else ()
    assert calls == [(lead, (4,) + lead + (3,) + group, (4,) + lead + z + group)]

"""Cosmos's spot render and config assembly (``tapqir_tpu_torch/ops/
spot_render.py``) on the CPU: the plain ``spot_concentration`` against the
composition it replaced in ``cosmos._likelihood`` (``gaussian_spots_flat``,
the einsum over the config table, the division by each chain's gain),
value and gradients bitwise; the kernels' arithmetic (the sums the CUDA
backward takes, written out in float64) against autograd of the plain
version; and the models' likelihood calling the op once per ELBO, with and
without a chain axis.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import importlib
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tapqir_tpu_torch.distributions.util import gaussian_spots_flat
from tapqir_tpu_torch.infer.discrete import m_configs
from tapqir_tpu_torch.models.cosmos import _per_chain
from tapqir_tpu_torch.ops import spot_render as sr
from tapqir_tpu_torch.ops.offset_gamma import config_masks

ROOT = Path(__file__).resolve().parent.parent
cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")

CASES = {
    "K2-P14": dict(nb=13, K=2, P=14, EVP=256),
    "K1-P14": dict(nb=13, K=1, P=14, EVP=256),
    "K2-odd-P-padded": dict(nb=11, K=2, P=7, EVP=64),
    "K2-chains-R4": dict(nb=6, R=4, K=2, P=14, EVP=256),
    "K3-odd-P-chains-R2": dict(nb=5, R=2, K=3, P=9, EVP=96),
}


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(cs, name, dtype=torch.float64):
    c = dict(CASES[name])
    inputs, go = cs.spot_render_case(c.pop("nb"), c.pop("R", None), dtype=dtype, seed=3, **c)
    return inputs, go, c["K"], c["P"], c["EVP"]


def _composition(b, h, w, xs, ys, target_locs, gain, mtab, P, ev_pad):
    """The default branch of ``cosmos._likelihood`` before the op."""
    lead = tuple(b.shape[:-3])
    nfc = math.prod(b.shape[-3:])
    K = h.shape[-1]
    mtab = torch.as_tensor(mtab, dtype=h.dtype)
    gauss = gaussian_spots_flat(h, w, xs, ys, target_locs, P, ev_pad)
    gauss_flat = gauss.reshape(lead + (nfc, K, ev_pad))
    img_flat = b.reshape(lead + (nfc, 1)) + torch.einsum("mk,...xkp->m...xp", mtab,
                                                         gauss_flat)
    return _per_chain(img_flat, gain, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_composition(cs, case, dtype):
    inputs, go, K, P, EVP = _case(cs, case, dtype)
    out, grads = cs.spot_render_grads(sr.spot_concentration_plain, inputs, go, P, EVP)
    want, want_grads = cs.spot_render_grads(_composition, inputs, go, P, EVP)
    b = inputs["b"]  # (*lead, nb, 1, 1)
    assert out.shape == (1 << K,) + tuple(b.shape[:-3]) + (b.shape[-3], EVP)
    assert torch.equal(out, want)
    for k in cs.SR_GRADS:
        assert torch.equal(grads[k], want_grads[k]), k
    # lanes past the image hold b / gain, for every config
    gain = inputs["gain"].reshape(inputs["gain"].shape + (1, 1, 1))
    pad = (b / gain).reshape(b.shape[:-2])
    assert torch.equal(out[..., P * P:], pad[None, ..., None].expand_as(out[..., P * P:]))


def _kernel_arithmetic(b, h, w, xs, ys, target_locs, gain, mtab, P, EVP, go):
    """The forward and the backward's sums as ``csrc/spot_render.cu``
    takes them, image by image over (nb, ...) flat inputs, in float64."""
    nb, K = h.shape[-2:]
    R = gain.numel()
    chain = torch.arange(nb) // (nb // R)
    p = torch.arange(EVP)
    live = p < P * P
    px, py = (p % P).double(), (p // P).double()
    sx = xs + target_locs[:, :1]
    sy = ys + target_locs[:, 1:]
    dx = px - sx[..., None]  # (nb, K, EVP)
    dy = py - sy[..., None]
    var = (w * w)[..., None]
    d2 = dx * dx + dy * dy
    g = torch.exp(-d2 / (2 * var) - torch.log(2 * math.pi * var)) * live
    s = h[..., None] * g
    masks = config_masks(mtab, K)
    bits = torch.tensor([[(m >> k) & 1 for k in range(K)] for m in masks]).double()
    num = b[None, :, None] + torch.einsum("mk,nkp->mnp", bits, s)
    out = num / gain[chain][None, :, None]
    S = torch.einsum("mk,mnp->nkp", bits, go)
    u = S * g
    gn = gain[chain][:, None]
    grads = {
        "b": go.sum((0, 2)) / gain[chain],
        "h": u.sum(-1) / gn,
        "w": (u * (d2 / var - 2)).sum(-1) * (h / w) / gn,
        "xs": (u * dx).sum(-1) * (h / (w * w)) / gn,
        "ys": (u * dy).sum(-1) * (h / (w * w)) / gn,
    }
    part = (go * num).sum((0, 2))
    grads["gain"] = -torch.zeros(R, dtype=part.dtype).index_add(0, chain, part) / gain**2
    return out, grads


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_arithmetic_matches_autograd(cs, case):
    inputs, go, K, P, EVP = _case(cs, case)
    out, grads = cs.spot_render_grads(sr.spot_concentration_plain, inputs, go, P, EVP)
    M = 1 << K
    nb = inputs["b"].numel()
    flat = {k: v.reshape(nb, -1) for k, v in inputs.items() if k not in ("b", "gain")}
    k_out, k_grads = _kernel_arithmetic(
        inputs["b"].reshape(nb), flat["h"], flat["w"], flat["xs"], flat["ys"],
        flat["target_locs"], inputs["gain"].reshape(-1), m_configs(K), P, EVP,
        go.reshape(M, nb, EVP))
    assert cs.scaled_err(k_out, out.reshape(M, nb, EVP)) <= cs.SR_F64_TOL
    for k in cs.SR_GRADS:
        want = grads[k].reshape(k_grads[k].shape)
        assert cs.scaled_err(k_grads[k], want) <= cs.SR_F64_TOL, k


def test_cpu_tensors_take_the_plain_version(cs):
    inputs, go, K, P, EVP = _case(cs, "K2-chains-R4")
    n = (sr.render.launches, sr.render_grad.launches)
    out, grads = cs.spot_render_grads(sr.spot_concentration, inputs, go, P, EVP)
    want, want_grads = cs.spot_render_grads(sr.spot_concentration_plain, inputs, go, P, EVP)
    assert torch.equal(out, want)
    assert all(torch.equal(grads[k], want_grads[k]) for k in cs.SR_GRADS)
    assert (sr.render.launches, sr.render_grad.launches) == n


def test_render_launcher_refuses_cpu_tensors(cs):
    inputs, _, K, P, EVP = _case(cs, "K2-P14", torch.float32)
    nb = inputs["b"].numel()
    args = [inputs["b"].reshape(nb)] + [inputs[k].reshape(nb, -1) for k in
                                         ("h", "w", "xs", "ys", "target_locs")]
    args.append(inputs["gain"].reshape(1))
    out = torch.empty((1 << K, nb, EVP))
    n = sr.render.launches
    with pytest.raises(ValueError, match="CUDA"):
        sr.render(args, config_masks(m_configs(K), K), P, EVP, out=out)
    assert sr.render.launches == n


def _cpu_model(cs, name, tmp_path):
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.utils.dataset import save
    from tapqir_tpu_torch.utils.simulate import simulate

    save(simulate("cosmos", N=5, F=6, C=1, P=14, seed=1, params=cs.SIM_PARAMS,
                  device="cpu"), tmp_path)
    model = models[name](device="cpu", dtype="double")
    model.load(tmp_path)
    model.init(lr=0.005, nbatch_size=3, fbatch_size=4)
    return model


@pytest.mark.parametrize("name", ["cosmos", "cosmos+hmm"])
@pytest.mark.parametrize("chains", [None, 2])
def test_likelihood_calls_the_op_once_per_elbo(cs, tmp_path, monkeypatch, name, chains):
    """cosmos's and cosmos+hmm's default likelihood computes the
    concentration through ``spot_concentration``, once per ELBO, for a
    single chain (the sparse step) and for a chain axis with a gain per
    chain (the restart step)."""
    from tapqir_tpu_torch.parallel.restarts import fit_restarts

    model = _cpu_model(cs, name, tmp_path)
    calls = []

    def counting(b, h, w, xs, ys, target_locs, gain, mtab, P, ev_pad):
        out = sr.spot_concentration(b, h, w, xs, ys, target_locs, gain, mtab, P, ev_pad)
        calls.append((tuple(gain.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(cosmos_module, "spot_concentration", counting)
    if chains is None:
        gen = torch.Generator()
        gen.manual_seed(0)
        loss = model._sparse_step(gen)
        assert np.isfinite(float(loss))
        lead = ()
    else:
        fit_restarts(model, num_restarts=chains, num_iter=1, chunk=1)
        lead = (chains,)
    n, f = 3, (4 if name == "cosmos" else 6)
    assert calls == [(lead, (4,) + lead + (n * f, 256))]

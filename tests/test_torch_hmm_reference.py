"""The port's cosmos+hmm model against the benchmark's plain reference
(``benchmark/reference/hmm.py``) on the CPU, in float64, at a tiny size:
6 AOIs (2 on-target) x 13 frames (odd, so the doubling scan's last level
is uneven), P=5, K=2, S=1, at seeded random unconstrained parameters.

Both sides score the port's own batch and packed standard-Gamma draws. The
reference computes the chain's marginals frame by frame in probability
space and q(m | z) by its own restriction, so agreement to rounding checks
the port's log-space prefix scan and its tables, not a copy of them.

Tolerances:

* the ELBO and each leaf's window gradient agree to 1e-10 relative (the
  leaf's norm of the difference over its norm): the two sides sum the
  same float64 terms in other orders, and the largest terms (~1e5, the
  likelihood's) cancel to the ELBO's ~1e5 with no loss of digits, so
  rounding stays near 1e-14;
* over three sparse steps the first loss agrees as the ELBO does; each
  leaf's change agrees to 1e-4 relative (over the larger of its norm and
  the median leaf's), and the later losses to 1e-6: the port keeps the JAX
  package's float32 bias correction of the per-row step counts, 1 - 0.999
  in float32 is 2.3e-5 off, and the reference's is float64
  (``benchmark/tests/test_benchmark_reference.py``), so a step's update
  differs by ~1.2e-5 of itself, ~6e-8 an element at lr 5e-3, and a later
  step's loss by its gradient times that: at these random parameters the
  loss is ~2e6 and steep, and the gap reads ~2e-7 of it;
* the frame-by-frame marginals match the scan's to 1e-12 (a few float64
  ulps per frame over 13 frames).
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import cosmos as ref_base
from benchmark.reference import hmm as ref
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
port_hmm = importlib.import_module("tapqir_tpu_torch.models.hmm")
NT, F, P, K, S, N_ON = 6, 13, 5, 2, 1, 2
LR = 0.005
CFG = {"model": "hmm", "geometry": {"K": K, "S": S, "P": P}, "fit": {"lr": LR}}
ELBO_RTOL = 1e-10
STEP_LOSS_RTOL, STEP_CHANGE_RTOL = 1e-6, 1e-4
SCAN_RTOL = 1e-12


def _dataset(seed=0):
    """Background + one Gaussian spot in some frames, camera Gamma noise at
    gain 7 and a 5-bin offset; the first ``N_ON`` AOIs on-target."""
    rng = np.random.default_rng(seed)
    g = 90.0 + 2.0 * (np.arange(5) - 2)
    w = np.exp(-0.5 * ((g - 90.0) / 3.0) ** 2)
    w /= w.sum()
    yy, xx = np.mgrid[0:P, 0:P]
    c = (P - 1) / 2
    spot = 3000.0 / (2 * np.pi * 1.4**2) * np.exp(-((xx - c) ** 2 + (yy - c) ** 2) / (2 * 1.4**2))
    present = rng.random((NT, F, 1)) < 0.3
    mu = 150.0 + present[..., None, None] * spot
    images = rng.gamma(mu / 7.0, 7.0) + rng.choice(g, size=mu.shape, p=w)
    ont = np.zeros(NT, bool)
    ont[:N_ON] = True
    return CosmosDataset(images=np.floor(images).astype(np.float32),
                         xy=np.full((NT, F, 1, 2), c, np.float32), is_ontarget=ont,
                         offset=OffsetData(g, w), name="hmm-reference-test")


@pytest.fixture
def setup(tmp_path):
    """The port's float64 hmm model at seeded random unconstrained
    parameters (the init values plus N(0, 0.5) noise), and the reference's
    spec and problem for the same data."""
    data = _dataset()
    tm = models["cosmos+hmm"](device="cpu", dtype="double")
    tm.data = data
    tm.path, tm.run_path = tmp_path, tmp_path / ".tapqir"
    tm.init(lr=LR, nbatch_size=4, fbatch_size=F)
    gen = torch.Generator().manual_seed(20261018)
    with torch.no_grad():
        for v in tm.params.values():
            v.add_(0.5 * torch.randn(v.shape, generator=gen, dtype=v.dtype))
    spec = ref.Spec(CFG, NT, F, 1)
    w = np.clip(data.offset.weights, np.finfo(np.float64).tiny, None)
    problem = {"Nt": NT, "F": F, "C": 1, "offset_samples": data.offset.samples,
               "offset_logits": np.log(w / w.sum())}
    return tm, spec, problem


def _draw_and_loss(tm, monkeypatch, seed, ndx=None):
    """The port's batch rows (or ``ndx``), its packed draw (recorded from
    ``std_gamma_sample_packed`` as ``models/hmm.py`` calls it), and its
    -ELBO and window gradients there."""
    gen = torch.Generator().manual_seed(seed)
    if ndx is None:
        ndx = tm._draw_batch(gen)[0]
    made = []
    orig = port_hmm.std_gamma_sample_packed

    def record(*args, **kwargs):
        made.append(orig(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(port_hmm, "std_gamma_sample_packed", record)
    win = {k: v.detach().clone().requires_grad_(True)
           for k, v in tm.gather_windows(tm.params, ndx, None).items()}
    loss = -tm.elbo_from_windows(win, gen, ndx, None, F, tm._data_dev)
    monkeypatch.setattr(port_hmm, "std_gamma_sample_packed", orig)
    grads = dict(zip(win, torch.autograd.grad(loss, list(win.values()))))
    packed = torch.cat([a.detach().reshape(-1) for a in made[0]])
    return ndx, packed, float(loss.detach()), grads


def _step(tm, ndx, packed):
    """A ``core.make_steps`` step of the reference from the port's data."""
    d = tm.data
    ndx = ndx.numpy()
    imgs = np.asarray(d.images)[ndx]
    return {"ndx": ndx, "fidx": np.arange(F), "obs": imgs.reshape(imgs.shape[:3] + (-1,)),
            "xy": np.asarray(d.xy)[ndx], "ont": np.asarray(d.is_ontarget)[ndx].astype(np.int64),
            "mask": np.ones(len(ndx), np.float32), "packed": packed.numpy()}


def _ref_params(tm):
    return {k: v.detach().clone() for k, v in tm.params.items()}


def _rel(got, want):
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.parametrize("seed", [1, 2])
def test_elbo_and_window_gradients_match_the_reference(setup, monkeypatch, seed):
    tm, spec, problem = setup
    ndx, packed, loss, grads = _draw_and_loss(tm, monkeypatch, seed)
    batch, data = ref.step_data(spec, problem, _step(tm, ndx, packed), "cpu")
    r_loss, r_grads, _ = ref.loss_and_grads(spec, _ref_params(tm), batch, data)
    assert abs(loss - r_loss) / abs(r_loss) <= ELBO_RTOL
    assert set(grads) == set(r_grads)
    for k, g in grads.items():
        assert torch.count_nonzero(r_grads[k]) > 0, k
        assert _rel(g, r_grads[k]) <= ELBO_RTOL, k


def test_three_sparse_steps_match_the_reference(setup, monkeypatch):
    """Three ``_sparse_step``s on the port's batches (rows 0-3, then rows
    that a later step draws again) and draws, against the reference's
    steps with its window Adam and per-row step counts."""
    tm, spec, problem = setup
    params = _ref_params(tm)
    p0 = _ref_params(tm)
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()},
           "count": {"g": torch.zeros((), dtype=torch.int32),
                     "a": torch.zeros((NT,), dtype=torch.int32),
                     "af": torch.zeros((NT, F), dtype=torch.int32)}}
    for i, rows in enumerate(([0, 1, 2, 3], [2, 3, 4, 5], [0, 5, 1, 4])):
        ndx = torch.tensor(rows)
        _, packed, _, _ = _draw_and_loss(tm, monkeypatch, 10 + i, ndx)
        loss = float(tm._sparse_step(torch.Generator(), batch=(ndx, None, F), draws=packed))
        batch, data = ref.step_data(spec, problem, _step(tm, ndx, packed), "cpu")
        r_loss, r_grads, win = ref.loss_and_grads(spec, params, batch, data)
        ref_base.adam_step(spec, params, opt, batch, win, r_grads, LR)
        assert abs(loss - r_loss) / abs(r_loss) <= (STEP_LOSS_RTOL if i else ELBO_RTOL), i
    change = {k: torch.linalg.vector_norm(params[k] - p0[k]) for k in params}
    med = float(np.median([float(v) for v in change.values()]))
    for k, v in tm.params.items():
        gap = float(torch.linalg.vector_norm((v - p0[k]) - (params[k] - p0[k])))
        assert gap / max(float(change[k]), med) <= STEP_CHANGE_RTOL, k
        assert float(change[k]) > 0, k


@pytest.mark.parametrize("frames", [1, 2, 13, 16])
@pytest.mark.parametrize("states", [2, 3])
def test_frame_by_frame_marginals_match_the_scan(frames, states):
    """The reference's recursion against the port's prefix scan (as
    ``models/hmm.py`` binds it) on random transition matrices."""
    gen = torch.Generator().manual_seed(frames * 10 + states)
    A = torch.softmax(2.0 * torch.randn((NT, frames, 1, states, states), generator=gen,
                                        dtype=torch.float64), -1)
    scan = torch.exp(port_hmm.cumulative_logmatmulexp(torch.log(A), -4)[..., 0, :])
    chain = ref.chain_marginals(A)
    assert chain.shape == (NT, frames, 1, states)
    torch.testing.assert_close(chain, scan, rtol=SCAN_RTOL, atol=0.0)
    torch.testing.assert_close(chain.sum(-1), torch.ones_like(chain[..., 0]), rtol=1e-13,
                               atol=0.0)


def test_a_broken_chain_is_seen(setup, monkeypatch):
    """``z_trans``'s rows permuted in one frame (the reference's chain then
    differs from the port's) moves the ELBO and the chain's gradient far
    past the tolerance."""
    tm, spec, problem = setup
    ndx, packed, loss, grads = _draw_and_loss(tm, monkeypatch, 3)
    batch, data = ref.step_data(spec, problem, _step(tm, ndx, packed), "cpu")
    broken = _ref_params(tm)
    broken["z_trans"][:, 6] = broken["z_trans"][:, 6].flip(-2)
    r_loss, r_grads, _ = ref.loss_and_grads(spec, broken, batch, data)
    assert abs(loss - r_loss) / abs(r_loss) > 1e4 * ELBO_RTOL
    assert _rel(grads["z_trans"], r_grads["z_trans"]) > 1e4 * ELBO_RTOL


def test_the_configuration_names_the_model_and_its_reference():
    """The benchmark's cosmos+hmm configuration names the model by a key of
    the port's registry that is also the name of its reference file."""
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "benchmark/configs/hmm-elife.json").read_text())
    assert models[cfg["model"]] is models["cosmos+hmm"] is port_hmm.hmm
    assert (root / "benchmark/reference" / f"{cfg['model']}.py").is_file()
    assert cfg["fit"]["fbatch"] == cfg["geometry"]["F"]

"""Tests of the port's CUDA kernels; they need the card and skip without one
(a CUDA kernel has no CPU mode - the plain versions are tested on the CPU in
test_torch_likelihood.py, test_torch_pixel_likelihood.py and
test_torch_factored.py). Run them on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version at the tolerances
stated in chip_smoke.py (those of tests/test_pallas.py in float32; 1e-9 and
1e-6 in float64). The cases cover the shared bin loop's tiles of 8 bins (J
around multiples of 8, whole tiles masked, a bin term spread over more than
100 log units, a < 1 with d just above 0), the summed kernel's blocks of
several images (nb not a multiple of them, ev < EVP), the pixel kernel's
config chunks of 1, 2 and 4 (M = 1, 2, 3, 4, 5, 16), and launch each kernel
twice on the same inputs, requiring bitwise-equal outputs. A launch over R
chains' images with a rate per chain (the restart step's) must equal R
single-chain launches bitwise.

The sparse step's two kernels (``ops/sparse_adam.py``: the window gather
and the window Adam) are held against their plain versions at the cosmos,
crosstalk and cosmos+hmm layouts (the plain versions are tested on the CPU
in test_torch_sparse_adam.py), and a cosmos fit launches each once a step.

The spot render's two kernels (``ops/spot_render.py``) are held against
the plain render in float64 at the cosmos, hmm and R=4 restart windows (the
plain version is tested on the CPU in test_torch_spot_render.py), and one
cosmos or cosmos+hmm ELBO launches each once and matches the plain route.

The dye tables' three kernels (``ops/spot_tables.py``) are held against
the plain tables in float64 at the cosmos, hmm, crosstalk and R=4 restart
windows, every gradient with prox's (the plain version is tested on the
CPU in test_torch_spot_tables.py); one cosmos, cosmos+hmm or crosstalk
ELBO launches each once and matches the plain route, and
``native.launch_counts()`` shows one forward and two backward launches a
step.

The z-chain scan's two kernels (``ops/chain_scan.py``) are held against
the plain recursions in float32 and float64 at hmm's ELBO, the R=4 restart
step's and the posterior's inputs at eLife DatasetA, at F = 1025 and at
three states (the plain recursions are tested on the CPU in
test_torch_chain_scan.py); one cosmos+hmm ELBO launches each once and
matches the doubling scan, and ``native.launch_counts()`` shows one forward
and one backward launch a step.

A mesh launched on the card finds every CUDA library built in the process
that launched it (``csrc/native.py``'s registry), before its ranks start.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.cuda


@pytest.fixture
def cs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = {
    "small": dict(M=4, nb=20, EVP=256, ev=196, J=7, dtype=torch.float32),
    "below-every-bin": dict(M=4, nb=16, EVP=256, ev=196, J=61, dtype=torch.float32,
                            below=True),
    "ev-masked": dict(M=4, nb=16, EVP=256, ev=130, J=61, dtype=torch.float32),
    "ragged-nb": dict(M=4, nb=37, EVP=256, ev=196, J=61, dtype=torch.float32),
    "M16": dict(M=16, nb=24, EVP=256, ev=196, J=61, dtype=torch.float32),
    "float64": dict(M=4, nb=12, EVP=256, ev=196, J=7, dtype=torch.float64),
    **{f"J{J}": dict(M=4, nb=13 if J < 1024 else 5, EVP=256, ev=196, J=J,
                     dtype=torch.float32) for J in (1, 7, 61, 64, 65, 1024)},
    "masked-tiles": dict(M=4, nb=16, EVP=256, ev=196, J=61, dtype=torch.float32,
                         variant="masked-tiles"),
    "spread": dict(M=4, nb=16, EVP=256, ev=196, J=61, dtype=torch.float32,
                   variant="spread"),
    "small-d-a-below-one": dict(M=4, nb=16, EVP=256, ev=196, J=61, dtype=torch.float32,
                                variant="small-d"),
    "ragged-nb-ev-masked": dict(M=4, nb=7, EVP=256, ev=77, J=65, dtype=torch.float32),
    "float64-J65": dict(M=5, nb=6, EVP=256, ev=196, J=65, dtype=torch.float64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cs, case):
    c = dict(CASES[case])
    f64 = c["dtype"] == torch.float64
    errs = cs.compare(
        c["M"], c["nb"], c["EVP"], c["ev"], c["J"], c["dtype"], 3,
        cs.F64_TOL if f64 else cs.FWD_TOL, cs.F64_GRAD_TOL if f64 else cs.GRAD_TOL,
        below=c.get("below", False), variant=c.get("variant"),
    )
    assert all(np.isfinite(v) for v in errs.values())


def test_launcher_checks_its_inputs(cs):
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = cs.kernel_inputs(2, 4, 256, 196, 7, torch.float32, 0, "cuda")
    r1 = rate.reshape(1)
    with pytest.raises(TypeError):
        og.summed_fwd(x.double(), a, r1, g, w, 196)
    with pytest.raises(ValueError):
        og.summed_fwd(x, a.transpose(1, 2), r1, g, w, 196)
    with pytest.raises(ValueError):
        og.summed_fwd(x, a, r1, g, w, 300)
    big = torch.linspace(0, 50, 2000, device="cuda")
    with pytest.raises(ValueError):
        og.summed_fwd(x, a, r1, big, big, 196)
    n = og.summed_fwd.launches
    og.summed_fwd(x, a, r1, g, w, 196)
    assert og.summed_fwd.launches == n + 1


def test_cosmos_fit_on_the_card(cs, tmp_path):
    res = cs.run_main_path(tmp_path, Nt=16, F=40, P=14, J=11, nbatch=4, fbatch=16,
                           num_iter=20, device="cuda", n_chunk=2)
    cs.check_main_path(res, 20)
    assert res["launches"]["summed_stats"] == 20 and res["launches"]["summed_fwd"] == 1


PIXEL_CASES = {
    "M4": dict(M=4, n_px=5000, J=61, dtype=torch.float32),
    "M1-squeeze": dict(M=1, n_px=3000, J=61, dtype=torch.float32, squeeze=True),
    "below-every-bin": dict(M=4, n_px=2000, J=61, dtype=torch.float32, below=True),
    "ragged-n_px": dict(M=5, n_px=70001, J=11, dtype=torch.float32),
    "float64": dict(M=4, n_px=3000, J=7, dtype=torch.float64),
    **{f"J{J}": dict(M=4, n_px=3000 if J < 1024 else 700, J=J, dtype=torch.float32)
       for J in (1, 7, 64, 65, 1024)},
    "masked-tiles": dict(M=4, n_px=3000, J=61, dtype=torch.float32, variant="masked-tiles"),
    "spread": dict(M=4, n_px=3000, J=61, dtype=torch.float32, variant="spread"),
    "small-d-a-below-one": dict(M=4, n_px=3000, J=61, dtype=torch.float32,
                                variant="small-d"),
    **{f"M{M}": dict(M=M, n_px=3001, J=61, dtype=torch.float32) for M in (2, 3, 5, 16)},
    "float64-M2-J65": dict(M=2, n_px=1000, J=65, dtype=torch.float64),
}


@pytest.mark.parametrize("case", list(PIXEL_CASES))
def test_pixel_kernel_matches_plain(cs, case):
    c = dict(PIXEL_CASES[case])
    f64 = c["dtype"] == torch.float64
    errs = cs.compare_pixel(
        c["M"], c["n_px"], c["J"], c["dtype"], 5,
        cs.F64_TOL if f64 else cs.PIXEL_FWD_TOL,
        cs.F64_GRAD_TOL if f64 else cs.PIXEL_GRAD_TOL,
        below=c.get("below", False), squeeze=c.get("squeeze", False),
        variant=c.get("variant"),
    )
    assert all(np.isfinite(v) for v in errs.values())


FACTORED_CASES = {
    "kf2": dict(Kf=2, nb=40, J=61, dtype=torch.float32),
    "base-below-one": dict(Kf=2, nb=16, J=61, dtype=torch.float32, small_base=True),
    "below-every-bin": dict(Kf=2, nb=16, J=61, dtype=torch.float32, below=True),
    "ragged-nb": dict(Kf=2, nb=37, J=61, dtype=torch.float32),
    "kf4": dict(Kf=4, nb=24, J=61, dtype=torch.float32),
    "float64": dict(Kf=3, nb=12, J=7, dtype=torch.float64),
    **{f"J{J}": dict(Kf=2, nb=9 if J < 1024 else 3, J=J, dtype=torch.float32)
       for J in (1, 64, 65, 1024)},
    "masked-tiles": dict(Kf=2, nb=16, J=61, dtype=torch.float32, variant="masked-tiles"),
    "spread": dict(Kf=2, nb=16, J=61, dtype=torch.float32, variant="spread"),
    "small-d-base-below-one": dict(Kf=2, nb=16, J=61, dtype=torch.float32,
                                   variant="small-d"),
    "ev-masked": dict(Kf=2, nb=11, J=61, ev=130, dtype=torch.float32),
    "float64-J65": dict(Kf=2, nb=6, J=65, dtype=torch.float64),
}


@pytest.mark.parametrize("case", list(FACTORED_CASES))
def test_factored_kernel_matches_plain(cs, case):
    c = dict(FACTORED_CASES[case])
    f64 = c["dtype"] == torch.float64
    errs = cs.compare_factored(
        c["Kf"], c["nb"], 256, c.get("ev", 196), c["J"], c["dtype"], 7,
        cs.F64_TOL if f64 else cs.FACT_FWD_TOL,
        cs.F64_GRAD_TOL if f64 else cs.FACT_GRAD_TOL,
        below=c.get("below", False), small_base=c.get("small_base", False),
        variant=c.get("variant"),
    )
    assert all(np.isfinite(v) for v in errs.values())


def test_pixel_and_factored_launchers_check_their_inputs(cs):
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = cs.pixel_inputs(2, 300, 7, torch.float32, 0, "cuda")
    r1 = rate.reshape(1)
    with pytest.raises(TypeError):
        og.pixel_fwd(x.double(), a, r1, g, w)
    with pytest.raises(ValueError):
        og.pixel_fwd(x[:10], a, r1, g, w)
    with pytest.raises(ValueError):  # the kernel takes a scalar rate only
        og.offset_gamma_log_prob(x, a, torch.full((300,), 0.1, device="cuda"), g, w)
    n = og.pixel_fwd.launches
    og.pixel_fwd(x, a, r1, g, w)
    assert og.pixel_fwd.launches == n + 1

    xf, base, deltas, mtab, rate, g, w = cs.factored_inputs(2, 4, 256, 196, 7,
                                                           torch.float32, 0, "cuda")
    r1 = rate.reshape(1)
    with pytest.raises(ValueError):  # config 4 names a third spot
        og.factored_stats(xf, base, deltas, (0, 1, 2, 4), r1, g, w, 196)
    with pytest.raises(ValueError):
        og.factored_stats(xf, base[:3], deltas, (0, 1, 2, 3), r1, g, w, 196)
    with pytest.raises(ValueError):  # seven spot factors: one beyond the kernel's
        og.offset_gamma_factored_summed(xf, base, deltas[:1].expand(7, 4, 256),
                                        np.ones((2, 7)), rate, g, w, 196)
    n = og.factored_stats.launches
    og.factored_stats(xf, base, deltas, (0, 1, 2, 3), r1, g, w, 196)
    assert og.factored_stats.launches == n + 1


def test_factored_fit_and_pixel_path_on_the_card(cs, tmp_path):
    cs.prepare_dataset(tmp_path, Nt=16, F=40, P=14, J=11, device="cuda", n_chunk=2)
    res, model = cs.run_factored_path(tmp_path, nbatch=4, fbatch=16, num_iter=20,
                                      device="cuda")
    cs.check_main_path(res, 20)
    assert res["launches"]["factored_stats"] == 21
    assert res["launches"]["summed_stats"] == res["launches"]["summed_fwd"] == 0
    pixel = cs.run_pixel_path(model.data, n_aoi=4, n_frames=16, device="cuda")
    assert pixel["launches"]["pixel_fwd"] == 1 and pixel["launches"]["pixel_stats"] == 2


CHAIN_CASES = {
    "summed-R3": dict(form="summed", R=3, nb=7, M=4, Kf=2),
    "summed-R4-M16": dict(form="summed", R=4, nb=9, M=16, Kf=4),
    "factored-R3": dict(form="factored", R=3, nb=7, M=4, Kf=2),
    "factored-R2-Kf4": dict(form="factored", R=2, nb=13, M=16, Kf=4),
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_chain_batched_launch_matches_single_chain_launches(cs, case):
    """One launch over R runs of images with a rate per run (the restart
    step's chains) is bitwise equal, image for image, to R single-chain
    launches; each chain's rate gradient agrees within 1e-6 relative, and
    everything with the float64 plain version (chip_smoke.compare_chains)."""
    c = CHAIN_CASES[case]
    summed = c["form"] == "summed"
    errs = cs.compare_chains(c["form"], c["R"], c["nb"], 256, 196, 61, 5,
                             cs.FWD_TOL if summed else cs.FACT_FWD_TOL,
                             cs.GRAD_TOL if summed else cs.FACT_GRAD_TOL, M=c["M"], Kf=c["Kf"])
    assert errs["rate_vs_single_rel"] <= cs.CHAIN_RATE_RTOL


def test_chain_batched_launcher_checks_its_rates(cs):
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = cs.kernel_inputs(2, 6, 256, 196, 7, torch.float32, 0, "cuda")
    with pytest.raises(ValueError):  # 4 rates cannot split 6 images
        og.summed_stats(x, a, rate.repeat(4), g, w, 196)
    with pytest.raises(ValueError):
        og.summed_fwd(x, a, rate.reshape(1, 1), g, w, 196)
    n = og.summed_fwd.launches
    og.summed_fwd(x, a, rate.repeat(3), g, w, 196)
    assert og.summed_fwd.launches == n + 1


SPARSE_ADAM_CASES = {
    "cosmos": dict(model="cosmos", f=512),
    "crosstalk": dict(model="crosstalk", f=512),
    "hmm-every-frame": dict(model="cosmos+hmm", f=None),
    "cosmos-every-frame": dict(model="cosmos", f=None, Nt=37, F=23, n=5),
    "crosstalk-ragged": dict(model="crosstalk", f=301, n=7),
    "cosmos-float64": dict(model="cosmos", f=512, dtype=torch.float64),
}


@pytest.mark.parametrize("case", list(SPARSE_ADAM_CASES))
def test_sparse_adam_kernels_match_plain(cs, case):
    """The window gather and the window Adam against their plain versions
    at the cosmos, crosstalk and cosmos+hmm layouts (eLife DatasetA's 856
    AOIs x 790 frames unless given): windows and step counts equal,
    parameters and moments within chip_smoke.SA_ULP ulps, and two launches
    on the same inputs bitwise equal (chip_smoke.compare_sparse_adam)."""
    c = dict(SPARSE_ADAM_CASES[case])
    ulps = cs.compare_sparse_adam(c.pop("model"), c.pop("dtype", torch.float32), seed=11,
                                  **c)
    assert max(ulps.values()) <= cs.SA_ULP


def test_sparse_adam_launcher_checks_its_inputs(cs):
    from tapqir_tpu_torch.ops import sparse_adam as sa

    layout, params, opt, grads, ndx, fidx = cs.sparse_adam_case("cosmos", 30, 20, 4, 8,
                                                                torch.float32, 0, "cuda")
    names = layout.names
    p = [params[k] for k in names]
    mu, nu = [opt["mu"][k] for k in names], [opt["nu"][k] for k in names]

    def launch(p=p, mu=mu, nu=nu, grads=grads, ndx=ndx, fidx=fidx, count=opt["count"]):
        sa.adam(layout, p, mu, nu, grads, ndx, fidx, count, 0.005)

    n = sa.adam.launches
    with pytest.raises(TypeError):  # a float16 parameter
        launch(p=[p[0].half()] + p[1:])
    with pytest.raises(TypeError):  # a float64 gradient
        launch(grads=[grads[0].double()] + grads[1:])
    with pytest.raises(TypeError):  # a moment on the CPU
        launch(mu=mu[:-1] + [mu[-1].cpu()])
    af = names.index("h_loc")
    with pytest.raises(ValueError):  # a transposed gradient
        bad = grads[af].transpose(1, 2).contiguous().transpose(1, 2)
        launch(grads=grads[:af] + [bad] + grads[af + 1:])
    with pytest.raises(ValueError):  # a leaf of another shape
        launch(grads=grads[:af] + [grads[af][:, :, :4]] + grads[af + 1:])
    with pytest.raises(TypeError):  # int32 rows
        launch(ndx=ndx.int())
    with pytest.raises(TypeError):  # int64 step counts
        launch(count={**opt["count"], "af": opt["count"]["af"].long()})
    with pytest.raises(ValueError):  # no per-AOI-frame counts
        launch(count={k: v for k, v in opt["count"].items() if k != "af"})
    assert sa.adam.launches == n
    launch()
    assert sa.adam.launches == n + 1


def test_cosmos_run_launches_each_sparse_adam_kernel_once_a_step(cs, tmp_path):
    """One cosmos checkpoint chunk of ``Model.run`` on the card launches
    the window gather and the window Adam once a step each, and the step
    and ELBO spans count no sync."""
    from tapqir_tpu_torch import tracing
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.ops import sparse_adam as sa
    from tapqir_tpu_torch.utils.dataset import save
    from tapqir_tpu_torch.utils.simulate import simulate

    save(simulate("cosmos", N=8, F=16, C=1, P=14, seed=0, params=cs.SIM_PARAMS,
                  device="cuda"), tmp_path)
    model = models["cosmos"](device="cuda")
    model.load(tmp_path)
    model.init(lr=0.005, nbatch_size=3, fbatch_size=8)
    model.checkpoint_interval = 5
    model._run_chunk(1)  # the kernels' builds and first launches
    torch.cuda.synchronize()
    gathers, adams = sa.gather.launches, sa.adam.launches
    tracing.reset()
    tracing.enable()
    try:
        model.run(5)
    finally:
        tracing.disable()
    spans = tracing.summary()
    tracing.reset()
    assert spans["step.batch"]["calls"] == 5
    assert (sa.gather.launches - gathers, sa.adam.launches - adams) == (5, 5)
    assert "step.scatter" not in spans
    syncs = {k: a["syncs"] for k, a in spans.items() if k.startswith(("step.", "elbo."))}
    assert sum(syncs.values()) == 0, syncs


SPOT_RENDER_CASES = {
    "cosmos": dict(nb=5120),
    "hmm": dict(nb=7900),
    "restarts-R4": dict(nb=5120, R=4),
    "cosmos-float64": dict(nb=5120, dtype=torch.float64),
    "hmm-float64": dict(nb=7900, dtype=torch.float64),
    "restarts-R4-float64": dict(nb=5120, R=4, dtype=torch.float64),
    "K1-odd-P": dict(nb=301, K=1, P=7, EVP=64),
    "K3-odd-P-float64": dict(nb=97, R=2, K=3, P=9, EVP=96, dtype=torch.float64),
}


@pytest.mark.parametrize("case", list(SPOT_RENDER_CASES))
def test_spot_render_kernels_match_plain(cs, case):
    """The spot render's forward and backward kernels against the plain
    version in float64 on the same inputs at the cosmos (10 x 512), hmm (10 x
    790) and R=4 restart windows: the concentration and the gradients of b,
    h, w, xs, ys and gain within chip_smoke.SR_F64_TOL (float64) or
    SR_F32_TOL (float32) of the largest magnitude, and two launches bitwise
    equal (chip_smoke.compare_spot_render)."""
    errs = cs.compare_spot_render(seed=5, **SPOT_RENDER_CASES[case])
    tol = cs.SR_F64_TOL if SPOT_RENDER_CASES[case].get("dtype") == torch.float64 \
        else cs.SR_F32_TOL
    assert max(v for k, v in errs.items() if k != "plain_float32") <= tol


def test_spot_render_launcher_checks_its_inputs(cs):
    from tapqir_tpu_torch.infer.discrete import m_configs
    from tapqir_tpu_torch.ops.offset_gamma import config_masks
    from tapqir_tpu_torch.ops import spot_render as sr

    inputs, go = cs.spot_render_case(40, 2, dtype=torch.float32, device="cuda")
    flat = [inputs[k].reshape(80, -1) for k in ("b", "h", "w", "xs", "ys", "target_locs")]
    args = [flat[0].reshape(80)] + flat[1:] + [inputs["gain"]]
    masks = config_masks(m_configs(2), 2)
    out = torch.empty((4, 80, 256), device="cuda")

    def launch(args=args, masks=masks, P=14, EVP=256, out=out):
        sr.render(args, masks, P, EVP, out=out)

    n = sr.render.launches
    with pytest.raises(TypeError):  # a float64 height
        launch(args=args[:1] + [args[1].double()] + args[2:])
    with pytest.raises(ValueError):  # a transposed width
        launch(args=args[:2] + [args[2].t().contiguous().t()] + args[3:])
    with pytest.raises(ValueError):  # fewer lanes than pixels
        launch(EVP=128, out=out[:, :, :128].contiguous())
    with pytest.raises(ValueError):  # 80 images in 3 chains
        launch(args=args[:6] + [torch.ones(3, device="cuda")])
    with pytest.raises(ValueError):  # an output of another shape
        launch(out=out[:2].contiguous())
    with pytest.raises(ValueError):  # 7 spots
        launch(args=args[:1] + [torch.ones(80, 7, device="cuda")] + args[2:])
    assert sr.render.launches == n
    launch()
    assert sr.render.launches == n + 1


@pytest.mark.parametrize("model", ["cosmos", "cosmos+hmm"])
def test_elbo_through_the_render_kernels(cs, model):
    """One ELBO of cosmos and of cosmos+hmm through
    ``elbo_from_windows`` on the card launches each render kernel once, and
    its loss and window gradients match the plain render's on the same
    batch and draws (float64, within chip_smoke.SR_F64_TOL)."""
    res = cs.compare_elbo_routes(model)
    assert res["launches"] == (1, 1)
    assert res["loss_rel"] <= cs.SR_F64_TOL
    assert res["grads_scaled"] <= cs.SR_F64_TOL


SPOT_TABLES_CASES = {
    "cosmos": dict(R=None, n=10, f=512),
    "hmm": dict(R=None, n=10, f=790, Z=2),
    "crosstalk": dict(R=None, n=10, f=512, Q=2),
    "restarts-R4": dict(R=4, n=10, f=512),
    "cosmos-float64": dict(R=None, n=10, f=512, dtype=torch.float64),
    "hmm-float64": dict(R=None, n=10, f=790, Z=2, dtype=torch.float64),
    "crosstalk-float64": dict(R=None, n=10, f=512, Q=2, dtype=torch.float64),
    "restarts-R4-float64": dict(R=4, n=10, f=512, dtype=torch.float64),
    "K1-ragged": dict(R=None, n=3, f=101, K=1),
    "K3-hmm-R2-float64": dict(R=2, n=3, f=77, Z=2, K=3, dtype=torch.float64),
    "K6-Q2": dict(R=None, n=2, f=33, Q=2, K=6),
}


@pytest.mark.parametrize("case", list(SPOT_TABLES_CASES))
def test_spot_tables_kernels_match_plain(cs, case):
    """The dye tables' kernels against the plain version in float64 on the
    same inputs at the cosmos (10 x 512), hmm (10 x 790, q(m | z)),
    crosstalk (Q = 2) and R=4 restart windows: the four tables and the
    gradients of the 12 per-spot inputs and of prox within
    chip_smoke.ST_F64_TOL (float64) or ST_F32_TOL (float32) of the largest
    magnitude, and two launches bitwise equal
    (chip_smoke.compare_spot_tables)."""
    c = dict(SPOT_TABLES_CASES[case])
    errs = cs.compare_spot_tables(c.pop("R"), c.pop("n"), c.pop("f"), seed=7, **c)
    tol = cs.ST_F64_TOL if c.get("dtype") == torch.float64 else cs.ST_F32_TOL
    assert max(v for k, v in errs.items() if k != "plain_float32") <= tol


def test_spot_tables_launchers_check_their_inputs(cs):
    from tapqir_tpu_torch.ops import spot_tables as st

    inputs, prox, gos = cs.spot_tables_case(2, 4, 5, dtype=torch.float32, device="cuda")
    views = [inputs[k].reshape(2, 1, 20, 2) for k in st.INPUTS]
    consts = st._constants(14, 0.75, 2.25, 10000.0)
    outs = [torch.empty(s, device="cuda") for s in ((4, 2, 3, 20), (4, 2, 20), (4, 2, 20),
                                                    (4, 2, 1, 20))]

    def launch(views=views, prox=prox, masks=(0, 1, 2, 3), spec=(0, 1, 2), outs=outs):
        st.tables(views, prox, masks, spec, consts, outs=outs)

    n = st.tables.launches
    with pytest.raises(TypeError):  # a float64 height
        launch(views=views[:2] + [views[2].double()] + views[3:])
    with pytest.raises(ValueError):  # a proximity for 3 chains
        launch(prox=torch.ones(3, device="cuda"))
    with pytest.raises(ValueError):  # theta states that are not 1 + K
        launch(spec=(0, 1))
    with pytest.raises(ValueError):  # a table of another shape
        launch(outs=outs[:3] + [torch.empty(4, 2, 2, 20, device="cuda")])
    with pytest.raises(ValueError):  # a width of another group count
        launch(views=views[:3] + [views[3][:, :, :10]] + views[4:])
    assert st.tables.launches == n
    launch()
    assert st.tables.launches == n + 1


@pytest.mark.parametrize("model", ["cosmos", "cosmos+hmm", "crosstalk"])
def test_elbo_through_the_tables_kernels(cs, model):
    """One ELBO of cosmos, cosmos+hmm and crosstalk through
    ``elbo_from_windows`` on the card launches each of the tables' kernels
    once, and its loss and window gradients match the plain tables' on the
    same batch and draws (float64: the loss within chip_smoke.ST_F64_TOL, the
    gradients within ST_ELBO_TOL)."""
    res = cs.compare_elbo_routes(model, op="spot_tables")
    assert res["launches"] == (1, 1, 1)
    assert res["loss_rel"] <= cs.ST_F64_TOL
    assert res["grads_scaled"] <= cs.ST_ELBO_TOL


@pytest.mark.parametrize("model", ["cosmos", "cosmos+hmm", "crosstalk"])
def test_launch_counts_show_the_tables_once_forward_and_twice_backward(cs, tmp_path, model):
    """``native.launch_counts()`` over three sparse steps of a float32
    model on the card: the tables' forward, backward and proximity sum
    once a step each."""
    from tapqir_tpu_torch.csrc import native
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.utils.dataset import save
    from tapqir_tpu_torch.utils.simulate import simulate

    sim, C, params = (("crosstalk", 2, cs.XTALK_PARAMS) if model == "crosstalk"
                      else ("cosmos", 1, cs.SIM_PARAMS))
    save(simulate(sim, N=6, F=16, C=C, P=14, seed=0, params=params, device="cuda"), tmp_path)
    m = models[model](device="cuda", dtype="float")
    m.load(tmp_path)
    m.init(lr=0.005, nbatch_size=3, fbatch_size=8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = native.launch_counts()
    for _ in range(3):
        assert np.isfinite(float(m._sparse_step(gen)))
    after = native.launch_counts()
    names = ("spot_tables", "spot_tables_grad", "spot_tables_prox")
    assert [after[k] - before[k] for k in names] == [3, 3, 3]


CHAIN_SCAN_CASES = {
    "hmm": ((10, 790, 1, 2, 2), -4, torch.float32),
    "hmm-float64": ((10, 790, 1, 2, 2), -4, torch.float64),
    "restarts-R4": ((4, 10, 790, 1, 2, 2), -4, torch.float32),
    "restarts-R4-float64": ((4, 10, 790, 1, 2, 2), -4, torch.float64),
    "posterior": ((856, 790, 1, 2, 2), 1, torch.float32),
    "posterior-float64": ((856, 790, 1, 2, 2), 1, torch.float64),
    "F1025": ((3, 1025, 1, 2, 2), 1, torch.float32),
    "F1025-float64": ((3, 1025, 1, 2, 2), 1, torch.float64),
    "S3": ((10, 790, 1, 3, 3), -4, torch.float32),
    "S3-float64": ((10, 790, 1, 3, 3), -4, torch.float64),
}


@pytest.mark.parametrize("case", list(CHAIN_SCAN_CASES))
def test_chain_scan_kernels_match_plain(cs, case):
    """The chain scan's kernels against the plain recursions in float64 on
    the same inputs at hmm's ELBO (10 x 790 on axis -4), the R=4 restart
    step's and the posterior's (856 x 790 on axis 1) inputs, at F = 1025
    and at 1 + S = 3: the prefix products and the gradient within
    chip_smoke.CS_F64_TOL (float64) or CS_F32_TOL (float32) of the largest
    magnitude, one launch each a call, two launches bitwise equal
    (chip_smoke.compare_chain_scan)."""
    shape, axis, dtype = CHAIN_SCAN_CASES[case]
    errs = cs.compare_chain_scan(shape, axis, dtype, seed=5)
    tol = cs.CS_F64_TOL if dtype == torch.float64 else cs.CS_F32_TOL
    assert max(errs["prods"], errs["grad"]) <= tol


def test_chain_scan_launchers_check_their_inputs(cs):
    from tapqir_tpu_torch.ops import chain_scan as chs

    a = torch.zeros((2, 5, 1, 2, 2), device="cuda")
    p = torch.empty_like(a)
    n = (chs.scan.launches, chs.scan_grad.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):  # a CPU tensor
        chs.scan(a.cpu(), 1, p.cpu())
    with pytest.raises(TypeError):  # a half-precision tensor
        chs.scan(a.half(), 1, p.half())
    with pytest.raises(TypeError):  # products of another dtype
        chs.scan(a, 1, p.double())
    with pytest.raises(ValueError):  # products of another shape
        chs.scan(a, 1, p[:, :4])
    with pytest.raises(ValueError):  # matrices that are not square
        chs.scan(a[..., :1], 1, p[..., :1])
    with pytest.raises(ValueError):  # more states than the kernels take
        big = torch.zeros((2, 5, 1, 8, 8), device="cuda")
        chs.scan(big, 1, torch.empty_like(big))
    with pytest.raises(ValueError):  # the frame axis among the matrices' axes
        chs.scan(a, -1, p)
    with pytest.raises(TypeError):  # a gradient of another dtype
        chs.scan_grad(a, 1, p, gp=p, ga=p.double())
    assert (chs.scan.launches, chs.scan_grad.launches) == n
    chs.scan(a, 1, p)
    chs.scan_grad(a, 1, p, gp=torch.zeros_like(a), ga=torch.empty_like(a))
    torch.cuda.synchronize()
    assert (chs.scan.launches, chs.scan_grad.launches) == (n[0] + 1, n[1] + 1)


def test_elbo_through_the_chain_scan_kernels(cs):
    """One float64 cosmos+hmm ELBO through ``elbo_from_windows`` on the card
    launches each of the scan's kernels once, and its loss and window
    gradients match the doubling scan's on the same batch and draws (the
    loss within chip_smoke.CS_F64_TOL, the gradients within
    CS_ELBO_TOL)."""
    res = cs.compare_elbo_routes("cosmos+hmm", op="cumulative_logmatmulexp")
    assert res["launches"] == (1, 1)
    assert res["loss_rel"] <= cs.CS_F64_TOL
    assert res["grads_scaled"] <= cs.CS_ELBO_TOL


def test_launch_counts_show_the_chain_scan_once_forward_and_once_backward(cs, tmp_path):
    """``native.launch_counts()`` over three sparse steps of a float32
    cosmos+hmm model on the card: the scan's forward and backward once a
    step each."""
    from tapqir_tpu_torch.csrc import native
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.utils.dataset import save
    from tapqir_tpu_torch.utils.simulate import simulate

    save(simulate("cosmos", N=6, F=16, C=1, P=14, seed=0, params=cs.SIM_PARAMS,
                  device="cuda"), tmp_path)
    m = models["cosmos+hmm"](device="cuda", dtype="float")
    m.load(tmp_path)
    m.init(lr=0.005, nbatch_size=3, fbatch_size=8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = native.launch_counts()
    for _ in range(3):
        assert np.isfinite(float(m._sparse_step(gen)))
    after = native.launch_counts()
    assert [after[k] - before[k] for k in ("chain_scan", "chain_scan_grad")] == [3, 3]


def _rank_device(mesh):
    return str(mesh.device)


def test_mesh_launch_builds_every_cuda_library_in_the_parent(monkeypatch):
    """``sharding.launch`` on a card mesh builds every CUDA library that the
    models declare in the calling process before it spawns the ranks, so no
    rank builds one itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's ranks run on it")
    import tapqir_tpu_torch.models  # noqa: F401  declares every kernel's library
    from tapqir_tpu_torch.csrc import native
    from tapqir_tpu_torch.parallel import sharding

    cuda = [lib for lib in native.LIBRARIES if lib.cuda]
    assert sorted(lib.stem for lib in cuda) == ["chain_scan", "offset_gamma", "sparse_adam",
                                                "spot_render", "spot_tables"]
    for lib in cuda:
        monkeypatch.setattr(lib, "_lib", None)  # as if this process had loaded none
    mesh = sharding.make_mesh(2, 1, ["cuda:0"] * 2)
    assert sharding.launch(mesh, _rank_device) == "cuda:0"
    assert all(lib._lib is not None and lib.path.exists() for lib in cuda)

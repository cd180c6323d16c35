#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tapqir_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and fails (non-zero exit, no result line) without
one. Phases, each printing its findings; any failure is an exception:

1. device: the card's name and power limit;
2. build: compile the offset-Gamma kernel with nvcc for sm_90a (build
   seconds, registers and spills);
3. kernel against its plain PyTorch version at the slice's shapes (M=4
   configs, nb=5120 images, EVP=256 lanes, ev=196 pixels, J=61 bins,
   float32: forward, concentration and rate gradients), then edge cases:
   pixels below every offset bin, ev-masked lanes, a ragged nb, M=16 and a
   small float64 case;
4. kernel timing with CUDA events, statistics on and off, beside the plain
   version and the least time the card could take (bound);
5. the main path: simulate an eLife-scale cosmos dataset (Nt=856 AOIs,
   F=790 frames, P=14, 61 offset bins) with the port's simulator, save it,
   then models["cosmos"]() -> load -> init(lr=0.005, nbatch_size=10,
   fbatch_size=512) -> run(400), and a held-out loss without gradient
   before and after; the kernels' launch counts are read around it.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# simulation parameters and offset histogram of the eLife-scale benchmark
SIM_PARAMS = {
    "pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15,
    "proximity": 0.2, "offset": 90.0, "height": 3000, "background": 150,
}
# H100 SXM published peaks: HBM3 bandwidth and dense FP32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
KERNEL_SOURCE = "tapqir_tpu_torch/csrc/offset_gamma.cu"
FWD_TOL = dict(rtol=3e-5, atol=1e-2)  # tests/test_pallas.py's summed forward
GRAD_TOL = dict(rtol=2e-4, atol=1e-4)  # tests/test_pallas.py's summed gradient
RATE_RTOL = 1e-3  # tests/test_pallas.py's rate gradient
F64_TOL = dict(rtol=1e-9, atol=1e-9)
F64_GRAD_TOL = dict(rtol=1e-6, atol=1e-6)  # Stirling digamma: < 7e-8 absolute


def offset_histogram(n_offsets=61):
    """Empirical-offset histogram: ``n_offsets`` integer bins around 90."""
    centers = np.arange(90 - n_offsets // 2, 90 + n_offsets // 2 + 1, dtype=np.float64)
    w = np.exp(-0.5 * ((centers - 90.0) / 8.0) ** 2)
    return centers, w / w.sum()


def make_dataset(Nt, F, C=1, P=14, J=61, device="cuda", n_chunk=8):
    """Simulated cosmos dataset in AOI chunks (each half on-target), with a
    J-bin offset histogram."""
    from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData
    from tapqir_tpu_torch.utils.simulate import simulate

    per = Nt // n_chunk
    chunks = [
        simulate("cosmos", N=per, F=F, C=C, P=P, seed=i, params=SIM_PARAMS,
                 device=device)
        for i in range(n_chunk)
    ]
    centers, w = offset_histogram(J)
    return CosmosDataset(
        images=np.concatenate([d.images for d in chunks]),
        xy=np.concatenate([d.xy for d in chunks]),
        is_ontarget=np.concatenate([d.is_ontarget for d in chunks]),
        offset=OffsetData(centers, w),
        name="chip-smoke-elife-scale",
    )


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_main_path(workdir, Nt=856, F=790, P=14, J=61, nbatch=10, fbatch=512,
                  num_iter=400, device="cuda", n_chunk=8):
    """Simulate, save, and fit cosmos through the user entry points.

    Returns the fit's numbers: steps/s, launches of each kernel variant
    during the run and the held-out evaluation, the held-out -ELBO before
    and after, the checkpoint's iteration on reload, and the logged losses.
    """
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.ops import offset_gamma as og
    from tapqir_tpu_torch.utils.dataset import save

    workdir = Path(workdir)
    t0 = time.perf_counter()
    data = make_dataset(Nt, F, P=P, J=J, device=device, n_chunk=n_chunk)
    t1 = time.perf_counter()
    save(data, workdir)
    t2 = time.perf_counter()

    model = models["cosmos"](device=device)
    model.load(workdir)
    model.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    _sync(device)
    t3 = time.perf_counter()
    iter0 = model.iter

    def held_out_loss():
        gen = torch.Generator(device=model.device)
        gen.manual_seed(12345)
        with torch.no_grad():
            return -float(model.elbo(model.params, gen, model._data_dev))

    loss_before = held_out_loss()
    warnings = []

    class _Collect(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    handler = _Collect(level=logging.WARNING)
    log = logging.getLogger("tapqir_tpu_torch")
    log.addHandler(handler)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        og.summed_fwd.launches = 0
        og.summed_stats.launches = 0
        _sync(device)
        t4 = time.perf_counter()
        model.run(num_iter)
        _sync(device)
        dt = time.perf_counter() - t4
        loss_after = held_out_loss()
        launches = {"fwd": og.summed_fwd.launches, "stats": og.summed_stats.launches}
    finally:
        log.removeHandler(handler)
    peak = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda"
            else None)

    csv = workdir / ".tapqir" / "logs" / "cosmos" / "metrics.csv"
    rows = [ln.split(",") for ln in csv.read_text().splitlines()]
    col = rows[0].index("-ELBO")
    logged = np.array([float(r[col]) for r in rows[1:]])

    ckpt = workdir / ".tapqir" / "cosmos_model.tpqr"
    reloaded = models["cosmos"](device=device)
    reloaded.load(workdir)
    reloaded.init(lr=0.005, nbatch_size=nbatch, fbatch_size=fbatch)
    same = all(
        torch.equal(reloaded.params[k], model.params[k]) for k in model.params
    )
    result = {
        "simulate_seconds": t1 - t0,
        "save_seconds": t2 - t1,
        "load_init_seconds": t3 - t2,
        "seconds": dt,
        "steps_per_s": num_iter / dt,
        "iter_before": iter0,
        "iter_after": model.iter,
        "iter_reloaded": reloaded.iter,
        "reloaded_params_equal": same,
        "checkpoint": str(ckpt),
        "checkpoint_exists": ckpt.exists(),
        "logged_losses": logged.tolist(),
        "loss_before": loss_before,
        "loss_after": loss_after,
        "warnings": warnings,
        "launches": launches,
        "peak_bytes": peak,
    }
    return result


def check_main_path(res, num_iter):
    """Raise unless the fit finished cleanly."""
    if res["warnings"]:
        raise RuntimeError(f"the fit logged warnings (restarts): {res['warnings']}")
    if not np.isfinite(res["logged_losses"]).all():
        raise RuntimeError(f"non-finite losses: {res['logged_losses']}")
    if not (math.isfinite(res["loss_before"]) and math.isfinite(res["loss_after"])):
        raise RuntimeError("non-finite held-out loss")
    if res["iter_after"] != res["iter_before"] + num_iter:
        raise RuntimeError(f"iteration count {res['iter_after']}")
    if not res["checkpoint_exists"] or res["iter_reloaded"] != res["iter_after"]:
        raise RuntimeError("the checkpoint was not written or did not reload")
    if not res["reloaded_params_equal"]:
        raise RuntimeError("reloaded parameters differ from the fit's")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------


def kernel_inputs(M, nb, EVP, ev, J, dtype, seed, device):
    """Inputs at realistic magnitudes: J integer offset bins around 90,
    pixel values from one above the lowest bin to 399 (some below some
    bins), concentrations 10..80, rate 1/7. Lanes >= ev hold NaN: the
    kernel must never read them."""
    rng = np.random.default_rng(seed)
    g, w = offset_histogram(J)
    x = rng.integers(int(g.min()) + 1, 400, size=(nb, EVP)).astype(np.float64)
    a = rng.uniform(10.0, 80.0, size=(M, nb, EVP))
    x[:, ev:] = np.nan
    a[:, :, ev:] = np.nan
    t = dict(device=device, dtype=dtype)
    return (
        torch.tensor(x, **t), torch.tensor(a, **t),
        torch.tensor(1.0 / 7.0, **t), torch.tensor(g, **t),
        torch.tensor(np.log(w), **t),
    )


def compare(M, nb, EVP, ev, J, dtype, seed, fwd_tol, grad_tol, below=False):
    """Kernel (through the autograd wrapper) against the plain version:
    forward, concentration gradient and rate gradient under a random
    cotangent in [-1, 1]. Returns the max abs errors, after checking the
    tolerances."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = kernel_inputs(M, nb, EVP, ev, J, dtype, seed, "cuda")
    keep = torch.ones(nb, dtype=torch.bool, device="cuda")
    if below:  # image 0: five pixels below every offset bin
        x[0, :5] = g.min() - 10.0
        keep[0] = False  # the plain version's value there is -inf
    cot = torch.tensor(np.random.default_rng(seed + 1).uniform(-1, 1, (M, nb)),
                       device="cuda", dtype=dtype) * keep

    a_k = a.clone().requires_grad_(True)
    r_k = rate.clone().requires_grad_(True)
    out_k = og.offset_gamma_summed(x, a_k, r_k, g, w, ev)
    ga_k, gr_k = torch.autograd.grad((out_k * cot).sum(), (a_k, r_k))
    with torch.no_grad():
        out_k_nograd = og.offset_gamma_summed(x, a, rate, g, w, ev)
    torch.cuda.synchronize()
    if below:
        for o in (out_k, out_k_nograd):
            v = o[:, 0]
            if not (torch.isfinite(v).all() and (v < -1e29).all()):
                raise RuntimeError(f"below-every-bin image gave {v.tolist()}")

    # the plain version on the real lanes (it would read the NaN padding), in
    # float64 on the same values: float32 round-off of the plain version
    # itself is of the order of the gradient tolerance. Images left out of
    # the comparison (below every bin) are left out of the plain version.
    def plain(dt):
        a_p = a[:, keep, :ev].to(dt).requires_grad_(True)
        r_p = rate.to(dt).requires_grad_(True)
        out_p = og.offset_gamma_summed_plain(
            x[keep, :ev].to(dt), a_p, r_p, g.to(dt), w.to(dt), ev
        )
        ga, gr = torch.autograd.grad((out_p * cot[:, keep].to(dt)).sum(), (a_p, r_p))
        return out_p.detach(), ga, gr

    out_p, ga_p, gr_p = plain(torch.float64)
    errs = {}
    if dtype == torch.float32:  # the float32 plain version, for scale
        out_p32, ga_p32, _ = plain(torch.float32)
        errs["plain_f32_forward"] = float((out_p32 - out_p).abs().max())
        errs["plain_f32_grad_concentration"] = float((ga_p32 - ga_p).abs().max())
        del out_p32, ga_p32
    if not torch.isfinite(ga_k).all():
        raise RuntimeError("non-finite kernel gradient")
    if (ga_k[..., ev:] != 0).any():
        raise RuntimeError("ev-masked lanes got a nonzero gradient")
    for name, got, want, tol in (
        ("forward", out_k[:, keep], out_p, fwd_tol),
        ("forward_nograd", out_k_nograd[:, keep], out_p, fwd_tol),
        ("grad_concentration", ga_k[:, keep, :ev], ga_p, grad_tol),
    ):
        got64 = got.detach().double().cpu().numpy()
        want64 = want.detach().double().cpu().numpy()
        np.testing.assert_allclose(got64, want64, err_msg=name, **tol)
        errs[name] = float(np.abs(got64 - want64).max())
    rtol_r = RATE_RTOL if dtype == torch.float32 else grad_tol["rtol"]
    np.testing.assert_allclose(float(gr_k), float(gr_p), rtol=rtol_r, err_msg="grad_rate")
    errs["grad_rate_rel"] = abs(float(gr_k) - float(gr_p)) / abs(float(gr_p))
    return errs


def time_ms(fn, iters):
    """Mean ms per call with CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(x, a, g, ev, stats):
    """Least time for the function on these inputs: max of bytes moved (the
    ev real lanes of x and a read once, outputs written once) over the
    memory rate, and the float32 operations the data needs over the fp32
    peak. Operations are counted per (pixel, bin) pair with x > g_j - the
    masked pairs need no work: 3 (difference, log, weight) + per config 4
    (exponent, max, exp, sum) or 6 with the two statistics sums; plus per
    (pixel, config) 4 (log of the sum, rate term, lgamma, event sum) and 5
    more with the statistics."""
    M, nb, EVP = a.shape
    item = a.element_size()
    read = nb * ev * (1 + M) * item
    write = M * nb * item + (2 * M * nb * EVP * item if stats else 0)
    xs = x[:, :ev]
    pairs = float((xs[..., None] > g).sum())
    per_pair = 3 + (6 if stats else 4) * M
    per_px_cfg = 4 + (5 if stats else 0)
    ops = pairs * per_pair + nb * ev * M * per_px_cfg
    t_bytes = (read + write) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tapqir_tpu_torch.ops import offset_gamma as og

    # phase 1: device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # phase 2: build
    og.library.get()
    ptx = [ln.strip() for ln in og.library.build_log.splitlines()
           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"[build] {og.library.path.name} in {og.library.build_seconds:.1f} s "
          f"(nvcc {' '.join(og.NVCC_FLAGS)})", flush=True)
    for ln in ptx:
        print(f"[build] {ln}", flush=True)

    # phase 3: kernel against plain
    M, nb, EVP, ev, J = 4, 5120, 256, 196, 61
    f32 = torch.float32
    errs = compare(M, nb, EVP, ev, J, f32, 0, FWD_TOL, GRAD_TOL)
    print(f"[kernel] slice shapes M={M} nb={nb} EVP={EVP} ev={ev} J={J} f32: "
          f"{json.dumps(errs)} (fwd {FWD_TOL}, grad {GRAD_TOL}, rate rtol {RATE_RTOL})",
          flush=True)
    cases = [
        ("below-every-bin", dict(M=4, nb=64, EVP=256, ev=196, J=61, dtype=f32, below=True)),
        ("ev-masked lanes", dict(M=4, nb=64, EVP=256, ev=130, J=61, dtype=f32)),
        ("ragged nb", dict(M=4, nb=37, EVP=256, ev=196, J=61, dtype=f32)),
        ("M=16", dict(M=16, nb=300, EVP=256, ev=196, J=61, dtype=f32)),
        ("float64", dict(M=4, nb=12, EVP=256, ev=196, J=7, dtype=torch.float64)),
    ]
    for i, (label, c) in enumerate(cases):
        f64 = c["dtype"] == torch.float64
        e = compare(c["M"], c["nb"], c["EVP"], c["ev"], c["J"], c["dtype"], 10 + i,
                    F64_TOL if f64 else FWD_TOL, F64_GRAD_TOL if f64 else GRAD_TOL,
                    below=c.get("below", False))
        print(f"[kernel] edge case {label}: {json.dumps(e)}", flush=True)

    # phase 4: timing at the slice shapes
    x, a, rate, g, w = kernel_inputs(M, nb, EVP, ev, J, f32, 0, "cuda")
    x[:, ev:] = 91.0  # finite padding for the plain version
    a[..., ev:] = 1.0
    r1 = rate.reshape(1)
    go = torch.ones((M, nb), device="cuda", dtype=f32)
    ms_fwd = time_ms(lambda: og.summed_fwd(x, a, r1, g, w, ev), 50)
    ms_stats = time_ms(lambda: og.summed_stats(x, a, r1, g, w, ev), 50)

    def plain_fwd():
        with torch.no_grad():
            og.offset_gamma_summed_plain(x, a, rate, g, w, ev)

    def plain_grad():
        a_p = a.detach().requires_grad_(True)
        r_p = rate.detach().requires_grad_(True)
        out = og.offset_gamma_summed_plain(x, a_p, r_p, g, w, ev)
        torch.autograd.grad(out, (a_p, r_p), go)

    plain_ms_fwd = time_ms(plain_fwd, 5)
    plain_ms_stats = time_ms(plain_grad, 5)
    b_fwd, by_fwd = bound_ms(x, a, g, ev, stats=False)
    b_stats, by_stats = bound_ms(x, a, g, ev, stats=True)
    print(f"[timing] {name} ({smi}): forward kernel {ms_fwd:.4f} ms, plain "
          f"{plain_ms_fwd:.4f} ms, bound {b_fwd:.4f} ms ({by_fwd}); with "
          f"statistics {ms_stats:.4f} ms, plain forward+backward "
          f"{plain_ms_stats:.4f} ms, bound {b_stats:.4f} ms ({by_stats}); "
          "library: none (no single PyTorch call computes this function)", flush=True)
    del x, a, go
    torch.cuda.empty_cache()

    # phase 5: the main path
    num_iter = 400
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        res = run_main_path(tmp, num_iter=num_iter, device="cuda")
    check_main_path(res, num_iter)
    if res["launches"]["stats"] < num_iter or res["launches"]["fwd"] < 1:
        raise RuntimeError(f"kernel launches on the main path: {res['launches']}")
    print(f"[main] cosmos Nt=856 F=790 P=14 J=61 batch 10x512: {num_iter} steps "
          f"in {res['seconds']:.3f} s = {res['steps_per_s']:.3f} steps/s on {name} "
          f"({smi}); peak memory {res['peak_bytes'] / 2**30:.3f} GiB; set-up: "
          f"simulate {res['simulate_seconds']:.1f} s, save {res['save_seconds']:.1f} s, "
          f"load+init {res['load_init_seconds']:.1f} s; held-out -ELBO {res['loss_before']:.6g} -> "
          f"{res['loss_after']:.6g}; logged -ELBO {res['logged_losses']}; "
          f"launches {res['launches']}; checkpoint reloaded at iter "
          f"{res['iter_reloaded']}", flush=True)
    if not res["loss_after"] < res["loss_before"]:
        raise RuntimeError("400 SVI steps did not lower the held-out -ELBO")

    common = {"route": "cuda", "source": KERNEL_SOURCE, "library_ms": None}
    kernels = [
        dict(name="offset_gamma_summed_fwd",
             replaces="tapqir_tpu/ops/offset_gamma.py:365",
             launches=res["launches"]["fwd"], max_abs_err=errs["forward_nograd"],
             ms=ms_fwd, plain_ms=plain_ms_fwd, bound_ms=b_fwd, bound_by=by_fwd,
             **common),
        dict(name="offset_gamma_summed_stats",
             replaces="tapqir_tpu/ops/offset_gamma.py:384",
             launches=res["launches"]["stats"],
             max_abs_err=max(errs["forward"], errs["grad_concentration"]),
             ms=ms_stats, plain_ms=plain_ms_stats, bound_ms=b_stats,
             bound_by=by_stats, **common),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

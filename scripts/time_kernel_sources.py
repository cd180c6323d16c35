#!/usr/bin/env python3
"""Time versions of the offset-Gamma kernel source against each other, in
turns, in one process on one card.

    python3 scripts/time_kernel_sources.py --source old=path/to/old.cu \\
        --source new=tapqir_tpu_torch/csrc/offset_gamma.cu [--iters 50]

Every source must export the C interface of
``tapqir_tpu_torch/csrc/offset_gamma.cu`` (``og_summed_*``,
``og_factored_*``, ``og_pixel_*``), or that of a source from before the
summed kernels took a rate per run of images (no ``og_max_runs``: no
``nbr`` argument); every launch here is one run. Each is built with the port's nvcc
flags (all builds started together) into ``tapqir_tpu_torch/_build/`` and
loaded with ctypes; its registers and spills (``-Xptxas -v``) are printed,
and, from ``cuobjdump -sass``, a digest of each float32 summed-template
kernel's code and the instruction mix per (pixel, bin) pair of the bin
loop of each float32 summed-template and pixel kernel instance. Then, at
the shapes of chip_smoke.py's phase 6 (float32, seed 0; summed and
factored: M=4 configs, nb=5120 images, EVP=256 lanes, ev=196 pixels, J=61
bins; per pixel: 1,003,520 pixels, J=61, M=1 and M=4), the summed forward,
summed statistics, factored statistics and per-pixel forward and
statistics kernels of every source are timed with CUDA events over
``--iters`` launches after one warm-up, in the order the sources were
given and then in reverse (old, new, new, old for two). Each source's
outputs are compared with the first source's, and its per-pixel outputs
with the float64 plain version (max abs error and the share of
chip_smoke.py's tolerance used). Prints the card's name and power limit,
and one JSON line at the end. Needs a CUDA card.
"""

import argparse
import collections
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


# the float32 instances of offset_gamma_summed_kernel<T, STATS, FACT>
SUMMED_F32 = {"summed_fwd": "summed_kernelIfLb0ELb0E",
              "summed_stats": "summed_kernelIfLb1ELb0E",
              "factored_stats": "summed_kernelIfLb1ELb1E"}
# float32 offset_gamma_pixel_kernel<T, STATS[, CH]> in mangled names: with a
# config chunk CH the bin loop is tiled; without one (an older source) it
# is a loop over single bins with a chunk of 4
PIXEL_F32 = re.compile(r"pixel_kernelIfLb([01])E(?:Li(\d+)E)?EEv")
TILE = 8  # kTile: bins per rescale of the running max


def _cuda_tool(name):
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which(name) or os.path.join(cuda_home, "bin", name)


def _function(sass, kernel):
    return next(f for f in sass.split("Function : ")[1:]
                if kernel in f.split("\n", 1)[0])


def bin_loop_mix(sass, kernel, ex2_per_bin=4):
    """Instruction counts per (pixel, bin) pair in the bin loop of
    ``kernel``'s SASS: the shortest loop (a backward branch and the code it
    jumps back over) holding a MUFU ex2 or lg2, divided by the bins one
    pass covers - its MUFU.LG2 count (one base-2 log per bin), or, for an
    accurate logf (a polynomial, no MUFU), its MUFU.EX2 count over
    ``ex2_per_bin``: the chunk of configs in a loop over single bins (one
    expf per config and bin), the chunk times (TILE + 1) / TILE in a tiled
    loop (one rescale exp per config and tile besides)."""
    func = _function(sass, kernel)
    ins = []  # (address, opcode with modifiers, branch target or None)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                         r"([^;]*);", func):
        target = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2) == "BRA" else None
        ins.append((int(m.group(1), 16), m.group(2), target and int(target.group(1), 16)))
    loops = [[op for a, op, _ in ins if t <= a <= addr]
             for addr, _, t in ins if t is not None and t < addr]
    body = min((ops for ops in loops
                if any(op.startswith(("MUFU.LG2", "MUFU.EX2")) for op in ops)), key=len)
    bins = (sum(op.startswith("MUFU.LG2") for op in body)
            or sum(op.startswith("MUFU.EX2") for op in body) / ex2_per_bin)
    mix = collections.Counter(op.split(".")[0] for op in body)
    return {"instructions_per_pair": len(body) / bins,
            **{op: n / bins for op, n in mix.most_common()}}


def build_all(sources):
    """nvcc every source at once; returns {label: (library path, log)}."""
    from tapqir_tpu_torch.csrc import native

    nvcc = _cuda_tool("nvcc")
    build = ROOT / "tapqir_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in sources.items():
        tag = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:16]
        out = build / f"lib_{label}_{tag}.so"
        procs[label] = out, subprocess.Popen(
            [nvcc, *native.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for label, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {sources[label]}:\n{log}")
        built[label] = out, log
    return built


def _single_rate(lib):
    """A source from before the summed kernels took a rate per run of
    images: its summed entries have no ``nbr`` argument."""
    return not hasattr(lib, "og_max_runs")


def _load(og, path):
    """The library at ``path`` with its entries' signatures: the package's,
    or those of a single-rate source (the same less ``nbr``)."""
    lib = ctypes.CDLL(str(path))
    if not _single_rate(lib):
        return og.library.load(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry, args in (("og_summed", [ptr] * 8 + [i32] * 6 + [ptr]),
                        ("og_factored", [ptr] * 10 + [i32] * 6 + [ptr]),
                        ("og_pixel", [ptr] * 8 + [i32, i64, i32, i32, ptr])):
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{entry}_{suffix}")
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def kernel_calls(lib, ins):
    """The summed-template kernels and the per-pixel kernels (M=4 and M=1)
    of ``lib`` as closures on ``ins``, each writing into its own
    preallocated outputs."""
    x, a, r1, g, w, ev, xf, base, deltas, masks, xp, ap = ins
    M, nb, EVP = a.shape
    Kf = deltas.shape[0]
    J = g.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    bits = (ctypes.c_int * len(masks))(*masks)

    def outs(m):
        return [torch.empty(s, device="cuda") for s in ((m, nb), (m, nb, EVP), (m, nb, EVP))]

    o_fwd, o_st, o_fa = outs(M), outs(M), outs(len(masks))

    def check(err):
        if err != 0:
            raise RuntimeError(f"kernel launch failed: CUDA error {err}")

    runs = () if _single_rate(lib) else (nb,)  # one run of nb images

    def summed(o, stats):
        def call():
            check(lib.og_summed_f32(
                x.data_ptr(), a.data_ptr(), g.data_ptr(), w.data_ptr(), r1.data_ptr(),
                o[0].data_ptr(), o[1].data_ptr() if stats else None,
                o[2].data_ptr() if stats else None, M, nb, EVP, ev, J, *runs, int(stats),
                stream))
            return o if stats else o[:1]
        return call

    def factored():
        check(lib.og_factored_f32(
            xf.data_ptr(), base.data_ptr(), deltas.data_ptr(),
            ctypes.cast(bits, ctypes.c_void_p), g.data_ptr(), w.data_ptr(),
            r1.data_ptr(), o_fa[0].data_ptr(), o_fa[1].data_ptr(), o_fa[2].data_ptr(),
            len(masks), Kf, nb, EVP, ev, J, *runs, stream))
        return o_fa

    def pixel(a2, stats):
        o = [torch.empty_like(a2) for _ in range(3 if stats else 1)]

        def call():
            check(lib.og_pixel_f32(
                xp.data_ptr(), a2.data_ptr(), g.data_ptr(), w.data_ptr(), r1.data_ptr(),
                o[0].data_ptr(), o[1].data_ptr() if stats else None,
                o[2].data_ptr() if stats else None, a2.shape[0], a2.shape[1], J,
                int(stats), stream))
            return o
        return call

    calls = {"summed_fwd": summed(o_fwd, False), "summed_stats": summed(o_st, True),
             "factored_stats": factored}
    for a2 in (ap, ap[:1].contiguous()):
        calls[f"pixel_fwd M={a2.shape[0]}"] = pixel(a2, False)
        calls[f"pixel_stats M={a2.shape[0]}"] = pixel(a2, True)
    return calls


def pixel_accuracy(cs, og, xp, ap, r1, g, w):
    """A function scoring a per-pixel kernel's (out[, spl, spd]) on these
    inputs (its M the leading configs of ``ap``) against the float64 plain
    version: max abs errors and the share of chip_smoke.py's tolerance
    used (forward PIXEL_FWD_TOL, concentration gradient PIXEL_GRAD_TOL,
    rate gradient RATE_RTOL)."""
    refs = {}

    def ref(m):
        if m not in refs:
            a_p = ap[:m].double().requires_grad_(True)
            r_p = r1.double().requires_grad_(True)
            want = og.offset_gamma_log_prob_plain(xp.double(), a_p, r_p, g.double(),
                                                  w.double())
            ga, gr = torch.autograd.grad(want.sum(), (a_p, r_p))
            refs[m] = want.detach(), ga, float(gr)
        return refs[m]

    def share(got, want, tol):
        err = (got.double() - want).abs()
        return float(err.max()), float((err / (tol["atol"] + tol["rtol"] * want.abs())).max())

    def score(outs):
        want, ga, gr = ref(outs[0].shape[0])
        err, use = share(outs[0], want, cs.PIXEL_FWD_TOL)
        res = {"forward_max_abs_err": err, "forward_tolerance_use": use}
        if len(outs) == 3:
            err, use = share(outs[1], ga, cs.PIXEL_GRAD_TOL)
            rel = abs(float(outs[2].double().sum()) - gr) / abs(gr)
            res.update(grad_concentration_max_abs_err=err,
                       grad_concentration_tolerance_use=use,
                       grad_rate_tolerance_use=rel / cs.RATE_RTOL)
        return res

    return score


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", required=True,
                    help="label=path of a kernel source; two or more")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernel_sources: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tapqir_tpu_torch.ops import offset_gamma as og

    sources = dict(s.split("=", 1) for s in args.source)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    built = build_all(sources)
    registers = {}
    for label, (path, log) in built.items():
        registers[label] = [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[build] {label}: {path.name}", flush=True)
        for ln in registers[label]:
            print(f"[build] {label}: {ln}", flush=True)
    mixes = {}
    for label, (path, _) in built.items():
        sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(path)],
                              capture_output=True, text=True, check=True).stdout
        for name, kernel in SUMMED_F32.items():
            # the code without its addresses and without the anonymous
            # namespace's name, which carries a hash of the source file
            code = re.sub(r"/\*[0-9a-f]{4,}\*/|\d+_GLOBAL__N__\w+?_[0-9a-f]{8}(?=\d)", "",
                          _function(sass, kernel))
            digest = hashlib.sha256(code.encode()).hexdigest()[:16]
            mix = mixes[f"{label}:{name}"] = bin_loop_mix(sass, kernel)
            print(f"[sass] {label} {name}: code digest {digest}; per (pixel, bin) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in mix.items()), flush=True)
        pixels = sorted(set(PIXEL_F32.findall(sass)))
        for stats, chunk in pixels:
            name = (f"pixel_{'stats' if stats == '1' else 'fwd'} "
                    f"CH={chunk or '4, single bins'}")
            ex2_per_bin = int(chunk) * (TILE + 1) / TILE if chunk else 4
            kernel = f"pixel_kernelIfLb{stats}E{f'Li{chunk}E' if chunk else ''}EEv"
            mix = mixes[f"{label}:{name}"] = bin_loop_mix(sass, kernel, ex2_per_bin)
            print(f"[sass] {label} {name}: per (pixel, bin) "
                  + ", ".join(f"{k} {v:.3f}" for k, v in mix.items()), flush=True)
    libs = {label: _load(og, path) for label, (path, _) in built.items()}

    # phase 6 inputs of chip_smoke.py, padding finite
    M, nb, EVP, ev, J, Kf = 4, 5120, 256, 196, 61, 2
    x, a, rate, g, w = cs.kernel_inputs(M, nb, EVP, ev, J, torch.float32, 0, "cuda")
    x[:, ev:] = 91.0
    a[..., ev:] = 1.0
    xf, base, deltas, mtab, _, _, _ = cs.factored_inputs(Kf, nb, EVP, ev, J, torch.float32,
                                                         0, "cuda")
    xf[:, ev:] = 91.0
    deltas[..., ev:] = 0.0
    xp, ap, _, _, _ = cs.pixel_inputs(M, 10 * 512 * 196, J, torch.float32, 0, "cuda")
    r1 = rate.reshape(1)
    ins = (x, a, r1, g, w, ev, xf, base, deltas, og.config_masks(mtab, Kf), xp, ap)
    calls = {label: kernel_calls(lib, ins) for label, lib in libs.items()}

    first = next(iter(calls))
    agree, accuracy = {}, {}
    score = pixel_accuracy(cs, og, xp, ap, r1, g, w)
    for label, kern in calls.items():
        for name, fn in kern.items():
            got = [t.clone() for t in fn()]
            want = calls[first][name]()
            torch.cuda.synchronize()
            agree[f"{label}:{name}"] = max(float((u - v).abs().max()) for u, v in zip(got, want))
            if name.startswith("pixel"):
                acc = accuracy[f"{label}:{name}"] = score(got)
                print(f"[accuracy] {label} {name} vs float64 plain: {json.dumps(acc)}",
                      flush=True)
    print(f"[agree] max abs difference from {first}: {json.dumps(agree)}", flush=True)

    order = list(calls) + list(reversed(calls))
    ms = {label: {name: [] for name in calls[label]} for label in calls}
    for name in calls[first]:
        for label in order:
            ms[label][name].append(cs.time_ms(calls[label][name], args.iters))
    for name in calls[first]:
        line = ", ".join(f"{label} {ms[label][name]}" for label in calls)
        print(f"[timing] {name} in turns {order} on {smi}: {line}", flush=True)

    # the SM clock under this load: read while ~1 s of launches of the last
    # source's summed statistics kernel is queued
    last = list(calls)[-1]
    for _ in range(int(1000 / ms[last]["summed_stats"][0])):
        calls[last]["summed_stats"]()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.cuda.synchronize()
    print(f"[clock] under load (clocks.sm, clocks.max.sm, power.draw): {clocks}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "order": order, "iters": args.iters, "ms": ms,
                      "max_abs_diff_vs_first": agree, "pixel_accuracy": accuracy,
                      "registers": registers,
                      "bin_loop_mix": mixes,
                      "clocks_under_load": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

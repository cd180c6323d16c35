"""Event-summed offset-marginalized Gamma log-likelihood: the CUDA kernel
(``csrc/offset_gamma.cu``), its autograd wrapper, and its plain PyTorch
version.

Counterpart of the dense summed pair of tapqir_tpu/ops/offset_gamma.py
(``offset_gamma_summed_pallas`` -> ``_lse_sum_core`` -> ``_sum_fwd_kernel``
/ ``_sum_stats_kernel``). For each config m, image n and real pixel i < ev:

    out[m, n] = sum_i ( logsumexp_j[w_j + (a-1) log(x-g_j) - b (x-g_j)]
                        + a log b - lgamma(a) )      (masked to x > g_j)

A loss evaluated without a gradient launches the forward-only variant; with
a gradient the forward also emits the per-pixel statistics
spl = d/da and spd = d/db, so the backward is elementwise in torch
(``da = go * spl``, ``drate = sum go * spd``), as the TPU's backward was XLA.

The kernel is built with ``nvcc`` for sm_90a at first use into ``_build/``
next to this package and loaded with ctypes through a plain C interface.
CUDA tensors always go through the kernel (or raise); CPU tensors take the
plain version. There is no fallback from one to the other.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "offset_gamma.cu"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


# ---------------------------------------------------------------------------
# plain version (CPU path and the kernel's reference on the card)
# ---------------------------------------------------------------------------


def offset_gamma_log_prob_plain(value, concentration, rate, offset_samples,
                                offset_logits):
    """Per-pixel log sum_j exp(w_j) Gamma(value - g_j; a, b), exact lgamma;
    the port of ``_offset_gamma_log_prob_xla``. A pixel below every bin
    gives -inf."""
    dtype = concentration.dtype
    v = value.to(dtype)[..., None]
    a = concentration[..., None]
    d = v - offset_samples.to(dtype)
    ok = d > 0
    d_safe = torch.where(ok, d, torch.ones_like(d))
    inner = (a - 1.0) * torch.log(d_safe) - rate * d_safe + offset_logits.to(dtype)
    inner = torch.where(ok, inner, torch.full_like(inner, -torch.inf))
    lse = torch.logsumexp(inner, dim=-1)
    return concentration * torch.log(rate) - torch.lgamma(concentration) + lse


def offset_gamma_summed_plain(value, concentration, rate, offset_samples,
                              offset_logits, ev):
    """(M, nb) sums over the first ``ev`` lanes of each (nb, EVP) image;
    gradients by autograd."""
    EVP = concentration.shape[-1]
    mask = (torch.arange(EVP, device=concentration.device) < ev).to(
        concentration.dtype
    )
    lp = offset_gamma_log_prob_plain(
        value, concentration, rate, offset_samples, offset_logits
    )
    return (lp * mask).sum(-1)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


class _Library:
    """The compiled kernel library, built once per process and source."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None
        self.build_log = ""
        self.path = None

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> Path:
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = _BUILD / f"liboffset_gamma_{tag}.so"
        self.path = out
        if out.exists():
            self.build_seconds = 0.0
            return out
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found (looked in PATH and {cuda_home})")
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SRC}:\n{self.build_log}")
        os.replace(tmp, out)
        return out

    @staticmethod
    def _load(path: Path):
        lib = ctypes.CDLL(str(path))
        args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        for name in ("og_summed_f32", "og_summed_f64"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.og_max_bins.argtypes = []
        lib.og_max_bins.restype = ctypes.c_int
        return lib


library = _Library()


class _Launcher:
    """One variant of the kernel (forward only, or forward + statistics),
    with its launch count."""

    def __init__(self, stats: bool):
        self.stats = stats
        self.launches = 0

    def __call__(self, x2, a3, rate, g, w, ev):
        """x2 (nb, EVP), a3 (M, nb, EVP), rate (1,), g and w (J,): CUDA
        tensors of one floating dtype, contiguous. Returns out (M, nb) and,
        for the statistics variant, spl and spd (M, nb, EVP)."""
        _check_inputs(x2, a3, rate, g, w, ev)
        lib = library.get()
        M, nb, EVP = a3.shape
        J = g.shape[0]
        if J > lib.og_max_bins():
            raise ValueError(f"{J} offset bins exceed the kernel's {lib.og_max_bins()}")
        out = torch.empty((M, nb), dtype=a3.dtype, device=a3.device)
        if self.stats:
            spl = torch.empty_like(a3)
            spd = torch.empty_like(a3)
            p_spl, p_spd = spl.data_ptr(), spd.data_ptr()
        else:
            spl = spd = None
            p_spl = p_spd = None
        fn = lib.og_summed_f32 if a3.dtype == torch.float32 else lib.og_summed_f64
        stream = torch.cuda.current_stream(a3.device).cuda_stream
        err = fn(
            x2.data_ptr(), a3.data_ptr(), g.data_ptr(), w.data_ptr(),
            rate.data_ptr(), out.data_ptr(), p_spl, p_spd,
            M, nb, EVP, int(ev), J, int(self.stats), stream,
        )
        if err != 0:
            raise RuntimeError(f"offset_gamma_summed kernel launch failed: CUDA error {err}")
        self.launches += 1
        return (out, spl, spd) if self.stats else out


summed_fwd = _Launcher(stats=False)  # replaces _sum_fwd_kernel
summed_stats = _Launcher(stats=True)  # replaces _sum_stats_kernel


def _check_inputs(x2, a3, rate, g, w, ev):
    if a3.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {a3.device}")
    if a3.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernel takes float32 or float64, got {a3.dtype}")
    if a3.ndim != 3 or x2.ndim != 2 or x2.shape != a3.shape[1:]:
        raise ValueError(f"shapes: value {tuple(x2.shape)} vs concentration {tuple(a3.shape)}")
    if rate.numel() != 1 or g.ndim != 1 or w.shape != g.shape:
        raise ValueError("rate must be a scalar and offsets (J,) vectors")
    if not 0 < ev <= a3.shape[-1]:
        raise ValueError(f"ev={ev} outside (0, {a3.shape[-1]}]")
    for t in (x2, a3, rate, g, w):
        if t.device != a3.device or t.dtype != a3.dtype:
            raise TypeError("all inputs must share the concentration's device and dtype")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


class _SummedFunction(torch.autograd.Function):
    """Forward + statistics in one launch; elementwise backward."""

    @staticmethod
    def forward(ctx, x2, a3, rate, g, w, ev):
        out, spl, spd = summed_stats(x2, a3, rate, g, w, ev)
        ctx.save_for_backward(spl, spd)
        return out

    @staticmethod
    def backward(ctx, go):
        spl, spd = ctx.saved_tensors
        da = go[..., None] * spl
        drate = (go[..., None] * spd).sum().reshape(1)
        return None, da, drate, None, None, None


def offset_gamma_summed(value, concentration, rate, offset_samples,
                        offset_logits, ev):
    """Offset-marginalized Gamma log-pdf, event-summed.

    :param value: (nb, EVP) flat images; lanes >= ev are ignored.
    :param concentration: (M, nb, EVP).
    :param rate: scalar tensor (the Gamma rate 1/gain).
    :param ev: number of real pixels per image.
    :return: (M, nb) log-probabilities summed over each image's pixels.
    """
    if concentration.device.type == "cpu":
        return offset_gamma_summed_plain(
            value, concentration, rate, offset_samples, offset_logits, ev
        )
    dtype = concentration.dtype
    x2 = value.to(dtype).contiguous()
    a3 = concentration.contiguous()
    g = offset_samples.to(dtype).contiguous()
    w = offset_logits.to(dtype).contiguous()
    rate1 = rate.to(dtype).reshape(1)
    if torch.is_grad_enabled() and (a3.requires_grad or rate1.requires_grad):
        return _SummedFunction.apply(x2, a3, rate1, g, w, int(ev))
    return summed_fwd(x2, a3, rate1, g, w, int(ev))

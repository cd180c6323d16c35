"""The process environment of a benchmark run, set before torch is
imported: the kernel caches of the program and its libraries at fixed
paths inside the checkout (``benchmark/.cache/``), so that only the first
run in a checkout builds them; one host thread for the CPU math libraries,
since the fit's host work is one thread dispatching launches and idle pool
threads only compete with it on a shared host; and no JAX for libraries
that would load it."""

import os
from pathlib import Path

CACHE = Path(__file__).resolve().parent / ".cache"


def prepare():
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"

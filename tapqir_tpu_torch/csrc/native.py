"""The port's one native-code layer: how a source under ``csrc/`` becomes a
loaded library, and how an entry of a CUDA library is launched and counted.

A :class:`Library` declares a source, the C signatures of its entries and
the probes of its limits; declaring it builds nothing. :meth:`Library.get`
builds it at first use, once per process: with ``nvcc`` and
:data:`NVCC_FLAGS` for a ``.cu`` source, with ``g++`` and :data:`CXX_FLAGS`
for any other, into ``_build/lib<stem>_<tag>.so`` next to this package, the
tag a hash of the source and the flags, so a built library is reused by
every later process and a changed source or flag builds anew. It is loaded
with ctypes.

A :class:`Kernel` is one entry of a CUDA library, which exports it once
per dtype as ``<entry>_f32`` and ``<entry>_f64``, with the stream last.
Its subclasses under ``ops/`` pack their arguments and check their own
shapes and limits; this module checks the device and dtype, picks the
entry, passes the stream, raises on a CUDA error and counts the launch.

Every library and kernel records itself when it is declared, at import:
:func:`build_cuda` builds every CUDA library declared in the process and
:func:`launch_counts` reads every kernel's count.
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

CSRC = Path(__file__).resolve().parent
BUILD = CSRC.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LIBRARIES = []  # every Library declared in this process
KERNELS = []  # every Kernel declared in this process
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


class Library:
    """A shared library built from one source at first use and loaded with
    ctypes, once per process.

    :param src: the source, relative to ``csrc/``.
    :param stem: the built file's name, ``lib<stem>_<tag>.so``.
    :param signatures: entry -> argtypes; every entry returns an int. A
        CUDA library binds each entry's ``_f32`` and ``_f64`` versions.
    :param probes: entries ``int f(void)`` that give the library's limits,
        read into :attr:`limits` at load.
    :param use_errno: load with ctypes' copy of ``errno``
        (``ctypes.get_errno``), for entries that report a failed call.
    """

    def __init__(self, src, stem, signatures, probes=(), use_errno=False):
        self.src, self.stem = CSRC / src, stem
        self.cuda = self.src.suffix == ".cu"
        self.flags = NVCC_FLAGS if self.cuda else CXX_FLAGS
        self.signatures, self.probes, self.use_errno = signatures, probes, use_errno
        self.path = None  # set when built or found built
        self.build_seconds = None  # 0.0 when found built
        self.build_log = ""
        self.limits = {}
        self._lib = None
        self._lock = threading.Lock()
        LIBRARIES.append(self)

    def get(self):
        """The loaded library, built at first use."""
        with self._lock:
            if self._lib is None:
                lib = self.load(self._build())
                self.limits = {probe: getattr(lib, probe)() for probe in self.probes}
                self._lib = lib
            return self._lib

    def load(self, path):
        """The library at ``path`` with this declaration's signatures bound
        (also a build of another version of the source)."""
        lib = ctypes.CDLL(str(path), use_errno=self.use_errno)
        suffixes = _SUFFIX.values() if self.cuda else ("",)
        for entry, args in self.signatures.items():
            for suffix in suffixes:
                fn = getattr(lib, entry + suffix)
                fn.argtypes, fn.restype = args, ctypes.c_int
        for probe in self.probes:
            fn = getattr(lib, probe)
            fn.argtypes, fn.restype = [], ctypes.c_int
        return lib

    def _compiler(self):
        if self.cuda:
            cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
            nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
            if not os.path.exists(nvcc):
                raise RuntimeError(f"nvcc not found (looked in PATH and {cuda_home})")
            return nvcc
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found in PATH: cannot build {self.src}")
        return cxx

    def _build(self) -> Path:
        tag = hashlib.sha256(self.src.read_bytes() + " ".join(self.flags).encode())
        out = BUILD / f"lib{self.stem}_{tag.hexdigest()[:16]}.so"
        self.path = out
        if out.exists():
            self.build_seconds = 0.0
            return out
        compiler = self._compiler()
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([compiler, *self.flags, "-o", str(tmp), str(self.src)],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            name = "nvcc" if self.cuda else "g++"
            raise RuntimeError(f"{name} failed for {self.src}:\n{self.build_log}")
        os.replace(tmp, out)  # atomic: concurrent builds leave one whole file
        return out


class Kernel:
    """One entry of a CUDA :class:`Library`, named ``name`` in
    :func:`launch_counts`, and its launch count; the count rises only where
    the kernel is launched. A launch is ``fn = self.function(like)``, the
    subclass's own checks, then ``self.launch(fn, like, *args)``."""

    def __init__(self, name, library, entry):
        self.name, self.library, self.entry = name, library, entry
        self.launches = 0
        self._functions = {}  # dtype suffix -> the bound entry, once the library is loaded
        KERNELS.append(self)

    def function(self, like):
        """The entry for the dtype of ``like``, the tensor that sets the
        launch's device and dtype, built at first use. ``like`` must be a
        float32 or float64 CUDA tensor on the runtime's current device (the
        library launches there: a tensor on another card would be read by
        the wrong one); that is checked before anything is built. The
        library's lock is taken only until the entry is found."""
        if like.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, got {like.device}")
        suffix = _SUFFIX.get(like.dtype)
        if suffix is None:
            raise TypeError(f"the kernel takes float32 or float64, got {like.dtype}")
        if like.device.index != torch.cuda.current_device():
            raise RuntimeError(
                f"{self.name}: the tensors are on {like.device} but the current device is "
                f"cuda:{torch.cuda.current_device()}; call torch.cuda.set_device first")
        fn = self._functions.get(suffix)
        if fn is None:
            fn = self._functions[suffix] = getattr(self.library.get(), self.entry + suffix)
        return fn

    def launch(self, fn, like, *args):
        """``fn(*args, stream)`` on the current stream of ``like``'s device;
        a non-zero return raises, else the launch is counted."""
        err = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1


def check_tensors(tensors, like, shapes=None, contiguous=True):
    """Every tensor of ``tensors`` (None skipped) on the device and in the
    dtype of ``like`` (else TypeError), contiguous unless ``contiguous`` is
    False (a kernel that reads through the strides it is given) and, where
    ``shapes`` is given, of the shape at its place there (else
    ValueError)."""
    device, dtype = like.device, like.dtype
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if t.device != device or t.dtype != dtype:
            raise TypeError(f"every tensor must be {dtype} on {device}, got {t.dtype} on "
                            f"{t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
        if shapes is not None and t.shape != shapes[i]:
            raise ValueError(f"a tensor of shape {tuple(t.shape)} where the kernel takes "
                             f"{tuple(shapes[i])}")


def build_cuda():
    """Builds every CUDA library declared in this process (the modules that
    declare them are imported by the models) and returns them."""
    libraries = [lib for lib in LIBRARIES if lib.cuda]
    for lib in libraries:
        lib.get()
    return libraries


def launch_counts():
    """{kernel name: launches} over every kernel declared in this process."""
    return {kernel.name: kernel.launches for kernel in KERNELS}

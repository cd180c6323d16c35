"""The native Glimpse frame decoder (``glimpse_io.cpp``) through ctypes, and
its plain numpy version.

Counterpart of tapqir_tpu/csrc/glimpse_native.py, with the same functions
and return values: :func:`read_frame` returns one frame as stored (the
2^15 shift taken off again), :func:`read_frames` a batch of frames of one
file shifted to unsigned, :func:`crop_aois` P x P crops of a decoded frame.

The library is built with ``g++ -O3 -shared -fPIC`` at first use and
loaded with ctypes by ``native.py``; importing this module builds nothing. A
failed build raises with g++'s message and a failed read with the
reader's. Nothing falls back to :func:`read_frames_plain`, the numpy
decoder the native one is held against.
"""

import ctypes
import os

import numpy as np

from tapqir_tpu_torch.csrc import native

SHIFT = 2**15  # raw frames are stored as int16 values minus 2^15
# what the decoder's non-zero return codes mean
_READ_ERRORS = {
    1: "cannot open the file",
    2: "cannot seek to the frame's offset",
    3: "the file ends before the frame does",
}

__all__ = ["read_frame", "read_frames", "crop_aois", "read_frames_plain"]

_i32p = ctypes.POINTER(ctypes.c_int32)
_i32, _i64 = ctypes.c_int, ctypes.c_longlong
library = native.Library(
    "glimpse_io.cpp", "glimpse_io",
    {
        "read_frame_i32": [ctypes.c_char_p, _i64, _i32, _i32, _i32p],
        "read_frames_i32": [ctypes.c_char_p, ctypes.POINTER(_i64), _i32, _i32, _i32, _i32p],
        "crop_aois_i32": [_i32p, _i32, _i32, ctypes.POINTER(_i32), ctypes.POINTER(_i32),
                          _i32, _i32, _i32p],
    },
    use_errno=True,
)


def _ptr(a):
    return a.ctypes.data_as(_i32p)


def _read_error(fn, rc, path):
    why = _READ_ERRORS.get(rc, f"code {rc}")
    if rc == 1:
        why += f" ({os.strerror(ctypes.get_errno())})"
    return OSError(f"glimpse_native.{fn} failed: {why}: {path}")


def read_frame(path, offset, height, width):
    """The (height, width) frame at byte ``offset`` of ``path`` as int32,
    as stored (without the +2^15 shift, as the JAX package's)."""
    lib = library.get()
    out = np.empty((height, width), np.int32)
    ctypes.set_errno(0)
    rc = lib.read_frame_i32(str(path).encode(), int(offset), height, width, _ptr(out))
    if rc != 0:
        raise _read_error("read_frame", rc, path)
    return out - SHIFT


def read_frames(path, offsets, height, width):
    """The frames at byte ``offsets`` of ``path``, one open of the file:
    (n, height, width) int32 shifted to unsigned (+2^15)."""
    lib = library.get()
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = np.empty((len(offsets), height, width), np.int32)
    ctypes.set_errno(0)
    rc = lib.read_frames_i32(
        str(path).encode(), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(offsets), height, width, _ptr(out))
    if rc != 0:
        raise _read_error("read_frames", rc, path)
    return out


def crop_aois(img, sx, sy, P):
    """(n_aoi, P, P) crops ``img[sy:sy+P, sx:sx+P]`` of a decoded int32
    frame; a crop outside the frame raises."""
    lib = library.get()
    img = np.ascontiguousarray(img, np.int32)
    sx = np.ascontiguousarray(sx, np.int32)
    sy = np.ascontiguousarray(sy, np.int32)
    if img.ndim != 2 or sx.shape != sy.shape or sx.ndim != 1:
        raise ValueError(f"crop_aois: a 2-d frame and two equal 1-d corner arrays, got "
                         f"{img.shape}, {sx.shape}, {sy.shape}")
    out = np.empty((len(sx), P, P), np.int32)
    rc = lib.crop_aois_i32(
        _ptr(img), img.shape[0], img.shape[1],
        sx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        sy.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(sx), P, _ptr(out))
    if rc != 0:
        raise ValueError(f"glimpse_native.crop_aois failed: a {P} x {P} crop lies "
                         f"outside the {img.shape} frame")
    return out


def read_frames_plain(path, offsets, height, width):
    """The plain version of :func:`read_frames`: ``np.fromfile`` of
    big-endian int16 per frame, then +2^15."""
    pixels = height * width
    out = np.empty((len(offsets), height, width), np.int32)
    with open(path, "rb") as fid:
        for i, offset in enumerate(offsets):
            fid.seek(int(offset))
            raw = np.fromfile(fid, dtype=">i2", count=pixels)
            if raw.size != pixels:
                raise OSError(f"read_frames_plain: the file ends before the frame at "
                              f"{int(offset)} does: {path}")
            out[i] = raw.reshape(height, width)
    return out + SHIFT

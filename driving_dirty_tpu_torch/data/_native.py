"""ctypes bindings for the native image decoder (data/native/loader.cpp,
driving_dirty_tpu/data/_native.py).

The library is built with g++ on first import into build/, under a name
hashed from the source and the flags (kernels/build.py:host_library), and
linked with libjpeg and libpng. Import raises ImportError, carrying the
compiler's message, when the compiler or the libjpeg/libpng headers are
missing; data/dataset.py then decodes with PIL.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from driving_dirty_tpu_torch.kernels.build import host_library

SOURCE = Path(__file__).resolve().parent / "native" / "loader.cpp"

try:
    _lib = host_library("dd_loader", SOURCE, libs=("jpeg", "png", "pthread"))
except RuntimeError as e:
    raise ImportError(f"cannot build the native image decoder: {e}") from e

_lib.dd_decode_image_u8.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
]
_lib.dd_decode_image_u8.restype = ctypes.c_int
_lib.dd_decode_image_f32.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
]
_lib.dd_decode_image_f32.restype = ctypes.c_int
_lib.dd_decode_batch.argtypes = [
    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32),
]
_lib.dd_decode_batch.restype = ctypes.c_int

_ERR = {-1: "cannot open", -2: "decode error", -3: "unexpected image shape"}


def _check(rc, path):
    if rc != 0:
        raise OSError(f"native decode failed for {path}: {_ERR.get(rc, rc)}")


def decode_image(path, h, w, raw_uint8=False, out=None):
    """Decode one JPEG/PNG into a [h, w, 3] RGB array (uint8, or f32 in [0,1]).

    `out` lets callers decode straight into a slice of a preallocated batch
    buffer (C-contiguous, of the right dtype and shape). A missing file, a
    corrupt one or one of another shape raises OSError."""
    dtype, ctype, fn = ((np.uint8, ctypes.c_uint8, _lib.dd_decode_image_u8) if raw_uint8
                        else (np.float32, ctypes.c_float, _lib.dd_decode_image_f32))
    if out is None:
        out = np.empty((h, w, 3), dtype)
    _check(fn(os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctype)), h, w), path)
    return out


def decode_batch(paths, h, w, raw_uint8=False, nthreads=0, out=None):
    """Decode N files into [n, h, w, 3] with a native thread pool
    (nthreads=0: min(n, cpu_count)). Raises OSError for the first file
    that fails."""
    n = len(paths)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    dtype = np.uint8 if raw_uint8 else np.float32
    if out is None:
        out = np.empty((n, h, w, 3), dtype)
    if not (out.flags["C_CONTIGUOUS"] and out.dtype == dtype and out.shape == (n, h, w, 3)):
        raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} array of shape {(n, h, w, 3)}")
    status = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = _lib.dd_decode_batch(
        arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if raw_uint8 else None,
        None if raw_uint8 else out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, nthreads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        bad = int(np.nonzero(status)[0][0])
        _check(int(status[bad]), paths[bad])
    return out

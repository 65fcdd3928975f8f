"""ctypes bindings for the native metric loops (metrics/native/iou.cpp,
driving_dirty_tpu/metrics/_native.py).

The library is built with g++ on first import into build/, under a name
hashed from the source and the flags (kernels/build.py:host_library).
Import raises ImportError, carrying the compiler's message, when it cannot
build; metrics/threat.py then runs its Python loop (metrics/polygon.py).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from driving_dirty_tpu_torch.kernels.build import host_library

SOURCE = Path(__file__).resolve().parent / "native" / "iou.cpp"

try:
    _lib = host_library("dd_iou", SOURCE)
except RuntimeError as e:
    raise ImportError(f"cannot build the native IoU loop: {e}") from e

_lib.masked_pair_iou.argtypes = [
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_double),
    ctypes.c_int64,
    ctypes.c_int64,
]
_lib.rasterize_boxes.argtypes = [
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_int64,
]


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def masked_pair_iou(boxes1, boxes2, cond):
    """boxes1 [n1, 2, 4], boxes2 [n2, 2, 4] (float64) and cond [n1, n2] bool ->
    the [n1, n2] float64 IoU matrix, 0 where cond is False."""
    b1 = np.ascontiguousarray(boxes1, np.float64)
    b2 = np.ascontiguousarray(boxes2, np.float64)
    c = np.ascontiguousarray(cond, np.uint8)
    n1, n2 = len(b1), len(b2)
    out = np.zeros((n1, n2), np.float64)
    _lib.masked_pair_iou(
        _ptr(b1, ctypes.c_double), _ptr(b2, ctypes.c_double),
        _ptr(c, ctypes.c_uint8), _ptr(out, ctypes.c_double),
        n1, n2,
    )
    return out


def rasterize_boxes(boxes, valid=None, size=800):
    """Host rasterizer: [n, 2, 4] meter boxes (and their validity) ->
    [size, size] uint8 occupancy map."""
    b = np.ascontiguousarray(boxes, np.float64)
    v = np.ascontiguousarray(valid, np.uint8) if valid is not None else None
    out = np.zeros((size, size), np.uint8)
    _lib.rasterize_boxes(
        _ptr(b, ctypes.c_double),
        _ptr(v, ctypes.c_uint8) if v is not None else None,
        len(b), _ptr(out, ctypes.c_uint8), size,
    )
    return out

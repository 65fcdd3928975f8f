"""The box rasterizer: [B, N, 2, 4] meter boxes + [B, N] valid ->
[B, size, size] {0,1} float32 occupancy maps, the box models' targets.

Replaces the TPU kernel driving_dirty_tpu/pallas/raster.py:
boxes_to_binary_map_pallas (and its vmapped batched_boxes_to_binary_map)
with a CUDA C++ kernel written for sm_90a (csrc/raster.cu), built by nvcc
and called through ctypes (kernels/build.py). Unlike the Pallas kernel it
takes any size (scale size * 10 / 800, offset size / 2, as ops/maps.py) and
any batch in one launch.

What bounds it on the H100: writing the output, B * size^2 * 4 bytes
(20.5 MB, 6.1 us for B = 8 at 800). What the design does about it: for a
fixed row each edge test is monotone in the column, so a box covers one
interval of columns per row. A first kernel runs the per-box prologue once
per (item, box) into a record array (`dd_raster_forward`'s scratch); a
second finds each (row, box) interval exactly, with the plain version's
rounded predicate, ORs it into a per-row bitmask in shared memory, and
writes each row once as 16-B stores. The work per pixel does not grow with
the number of boxes, and no [N, size, size] stack reaches device memory
(the csrc header has the details, including why it is bit-exact to the
plain version and what it does for boxes too large for that argument).

`raster` launches the kernel on a CUDA tensor and uses `raster_plain`
(ops/maps.py:boxes_to_binary_map) only for a tensor on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels.build import load_library
from driving_dirty_tpu_torch.ops.maps import MAP_SIZE, raster_geometry
from driving_dirty_tpu_torch.ops.maps import boxes_to_binary_map as raster_plain

__all__ = ["raster", "raster_plain"]


@functools.cache
def _entry():
    """The C entry of the raster library, built and typed on first use."""
    fn = load_library("raster").dd_raster_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(boxes, valid, size):
    if boxes.dtype != torch.float32:
        raise TypeError(f"raster kernel takes float32 boxes, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"raster kernel takes a bool valid mask, got {valid.dtype}")
    if boxes.dim() != 4 or tuple(boxes.shape[2:]) != (2, 4):
        raise ValueError(f"raster kernel takes [B, N, 2, 4] boxes, got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be {tuple(boxes.shape[:2])}, got {tuple(valid.shape)}")
    if valid.device != boxes.device:
        raise ValueError(f"valid on {valid.device}, boxes on {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("raster kernel takes contiguous boxes and valid")
    if isinstance(size, bool) or not isinstance(size, int) or not 1 <= size < 2 ** 24:
        # below 2^24, pixel coordinates are exact float32 integers
        raise ValueError(f"raster size must be an int in [1, 2^24), got {size!r}")
    if boxes.shape[0] > 65535:
        raise ValueError(f"raster kernel takes at most 65535 maps per call, got {boxes.shape[0]}")
    if boxes.shape[1] >= 2 ** 31:
        raise ValueError(f"raster kernel takes fewer than 2^31 boxes per map, got {boxes.shape[1]}")


def raster(boxes, valid, size: int = MAP_SIZE):
    """[B, N, 2, 4] float32 meter boxes (rows x/y, corners fl, fr, bl, br)
    + [B, N] bool -> [B, size, size] float32 {0,1} maps.

    On a CUDA tensor this launches the two kernels of csrc/raster.cu on the
    current stream (and adds one to `raster.launches`); on a CPU tensor it
    is `raster_plain`."""
    if boxes.device.type == "cpu":
        return raster_plain(boxes, valid, size)
    if boxes.device.type != "cuda":
        raise ValueError(f"raster runs on cuda or cpu tensors, got {boxes.device}")
    _check(boxes, valid, size)
    b, n = boxes.shape[:2]
    out = torch.empty((b, size, size), dtype=torch.float32, device=boxes.device)
    if b == 0:
        return out
    # scratch, one allocation: a 64-B record per (item, box), then two int32
    # counts per item
    scratch = torch.empty(b * n * 16 + 2 * b, dtype=torch.float32, device=boxes.device)
    records = scratch.data_ptr()
    scale, offset = (np.float32(v) for v in raster_geometry(size))
    with torch.cuda.device(boxes.device):
        err = _entry()(boxes.data_ptr(), valid.data_ptr(), records, records + b * n * 64,
                       out.data_ptr(), b, n, size, scale, offset,
                       torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster kernel launch failed with CUDA error {err}")
    raster.launches += 1
    return out


raster.launches = 0

"""Coordinates between BEV world meters and 800x800 pixel space
(driving_dirty_tpu/ops/coords.py).

World coordinates are meters in (-40, 40)^2 around the ego car; pixels are
(0, 800)^2 with px = m * 10 + 400 and the y axis flipped. Box tensors are
[..., 2, 4]: row 0 x, row 1 y; corners fl, fr, bl, br. Every function
takes torch tensors or numpy arrays (the host metrics pass numpy) and
returns the same kind.
"""
from __future__ import annotations

import numpy as np
import torch

MAP_SIZE = 800
PX_PER_METER = 10.0
CENTER = 400.0


def _lib(x):
    return torch if isinstance(x, torch.Tensor) else np


def meters_to_pixels(xy, flip_y: bool = True):
    """[..., 2, 4] meters (row 0 x, row 1 y) -> [..., 2, 4] pixels."""
    x = xy[..., 0, :] * PX_PER_METER + CENTER
    ysign = -PX_PER_METER if flip_y else PX_PER_METER
    y = xy[..., 1, :] * ysign + CENTER
    return _lib(xy).stack([x, y], -2)


def corners_to_aabb(boxes_m, flip_y: bool = True):
    """[..., 2, 4] meter corners -> [..., 4] pixel AABB [x0, y0, x1, y1]:
    each corner scaled to pixels (y flipped), then min/max per axis."""
    px = meters_to_pixels(boxes_m, flip_y=flip_y)
    xs, ys = px[..., 0, :], px[..., 1, :]
    if isinstance(px, torch.Tensor):
        return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)], -1)
    return np.stack([xs.min(-1), ys.min(-1), xs.max(-1), ys.max(-1)], -1)


def aabb_to_corners(aabb_px, flip_y: bool = True):
    """[..., 4] pixel AABB -> [..., 2, 4] meter corners fl, fr, bl, br:
    fl = (x1, y1), fr = (x1, y0), bl = (x0, y1), br = (x0, y0) unscaled."""
    x0 = (aabb_px[..., 0] - CENTER) / PX_PER_METER
    x1 = (aabb_px[..., 2] - CENTER) / PX_PER_METER
    ydiv = -PX_PER_METER if flip_y else PX_PER_METER
    y0 = (aabb_px[..., 1] - CENTER) / ydiv
    y1 = (aabb_px[..., 3] - CENTER) / ydiv
    lib = _lib(aabb_px)
    xs = lib.stack([x1, x1, x0, x0], -1)
    ys = lib.stack([y1, y0, y1, y0], -1)
    return lib.stack([xs, ys], -2)

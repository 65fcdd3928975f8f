"""Seeded box scenes in the dataset's padded layout, for checking the box
rasterizer and the box models without the dataset.

`box_scenes(seed, batch, max_bb)` -> (boxes [batch, max_bb, 2, 4] float32
meters, rows x/y, corners fl, fr, bl, br; valid [batch, max_bb] bool), as
LabeledDataset pads them. Each scene holds 5-60 valid boxes: cars 3.5-5.5 m
long and 1.6-2.2 m wide, about one in ten a truck 8-12 m x 2.5 m, any yaw,
centres in (-45, 45)^2 m so that some cross the edge of the 80 m map. Among
the valid boxes are three edge cases: one of zero area, one wound the other
way round, and one axis-aligned with corners on 0.1 m multiples (its edges
pass through pixel centres at 800 px). After the valid boxes comes one real
box marked invalid; the rest is zero padding.
"""
from __future__ import annotations

import numpy as np


def _box(cx, cy, length, width, yaw):
    """Corners fl, fr, bl, br of a box heading `yaw` -> [2, 4]."""
    along = np.array([length, length, -length, -length]) / 2
    across = np.array([width, -width, width, -width]) / 2
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([cx + c * along - s * across, cy + s * along + c * across])


def _vehicle(rng):
    if rng.rand() < 0.1:
        length, width = rng.uniform(8.0, 12.0), 2.5
    else:
        length, width = rng.uniform(3.5, 5.5), rng.uniform(1.6, 2.2)
    cx, cy = rng.uniform(-45.0, 45.0, 2)
    return _box(cx, cy, length, width, rng.uniform(0.0, 2 * np.pi))


def box_scenes(seed: int, batch: int = 8, max_bb: int = 100):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, max_bb, 2, 4), np.float32)
    valid = np.zeros((batch, max_bb), bool)
    for b in range(batch):
        n = min(rng.randint(5, 61), max_bb - 1)
        for i in range(n):
            boxes[b, i] = _vehicle(rng)
        # edge cases among the valid boxes
        boxes[b, 0] = np.repeat(rng.uniform(-30.0, 30.0, (2, 1)), 4, axis=1)  # zero area
        boxes[b, 1] = boxes[b, 1][:, [1, 0, 3, 2]]                            # wound the other way
        x0, y0 = np.round(rng.uniform(-35.0, 30.0, 2), 1)
        length, width = np.round(rng.uniform(3.5, 5.5), 1), np.round(rng.uniform(1.6, 2.2), 1)
        boxes[b, 2] = [[x0 + length, x0 + length, x0, x0],                    # axis-aligned,
                       [y0 + width, y0, y0 + width, y0]]                      # 0.1 m corners
        valid[b, :n] = True
        boxes[b, n] = _vehicle(rng)                                           # real, invalid
    return boxes, valid


def detection_scenes(seed: int, batch: int = 8, max_bb: int = 100, size: int = 800):
    """-> {"boxes", "box_valid"} of box_scenes(seed, batch, max_bb), plus
    "categories" and "road" from their own seeded stream."""
    boxes, valid = box_scenes(seed, batch, max_bb)
    rng = np.random.RandomState(seed + 7919)
    cats = np.where(valid, rng.randint(0, 9, valid.shape), -1).astype(np.int32)
    road = np.zeros((batch, size, size), np.float32)
    for b in range(batch):
        for _ in range(rng.randint(1, 4)):
            lo = rng.randint(0, size)
            hi = min(size, lo + rng.randint(size // 16, size // 4))
            if rng.rand() < 0.5:
                road[b, lo:hi, :] = 1.0
            else:
                road[b, :, lo:hi] = 1.0
    return {"boxes": boxes, "box_valid": valid, "categories": cats, "road": road}


def detection_rois(seed: int, batch: int = 8, r: int = 1000, size: int = 800):
    rng = np.random.RandomState(seed)
    wh = np.exp(rng.uniform(np.log(16.0), np.log(512.0), (batch, r, 2)))
    centre = rng.uniform(0.0, size, (batch, r, 2))
    rois = np.concatenate([centre - wh / 2, centre + wh / 2], -1)
    rois[:, ::50, 2:] = rois[:, ::50, :2]
    return rois.astype(np.float32)

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

`adversarial_boxes(seed, batch, max_bb)` -> the same layout, filled with
the boxes that stress an exact rasterizer: thin rotated boxes and
parallelograms with corners on the 0.1 m grid, near-horizontal and
near-vertical edges (slopes down to 1e-6), boxes that run off the map or
lie wholly outside it, point boxes and boxes of a few millimetres,
self-intersecting and concave rings; every fourth scene (from the third)
adds boxes beyond 2^60 px and non-finite ones, every fourth (from the
fourth) boxes covering the whole map, one of them beyond 2^60 px. A few
boxes of each scene are marked invalid.
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


_GRID_DIRECTIONS = ((3, 4), (4, 3), (5, 12), (12, 5), (8, 15), (1, 0), (0, 1), (1, 1), (2, 1), (7, 24))


def _corners(p0, along, across):
    """The parallelogram p0 + {along, 0} + {across, 0} as corners fl, fr,
    bl, br -> [2, 4]."""
    p0, along, across = (np.asarray(v, np.float64) for v in (p0, along, across))
    return np.stack([p0 + along + across, p0 + along, p0 + across, p0], axis=1)


def _thin_on_grid(rng):
    dx, dy = _GRID_DIRECTIONS[rng.randint(len(_GRID_DIRECTIONS))]
    d = np.array([dx, dy]) * rng.choice([-1, 1], 2)
    along = 0.1 * rng.randint(1, 31) * d
    across = [0.1 * np.array([-d[1], d[0]]), [0.1, 0.0], [0.0, 0.1]][rng.randint(3)]
    return _corners(np.round(rng.uniform(-39.0, 39.0, 2), 1), along, across)


def _near_axis(rng):
    slope = rng.choice([1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.05]) * rng.choice([-1, 1])
    length, width = rng.uniform(5.0, 40.0), rng.choice([0.1, 0.5, 2.0])
    along, across = np.array([length, slope * length]), np.array([slope * width, width])
    if rng.rand() < 0.3:  # near-vertical
        along, across = along[::-1], across[::-1]
    return _corners(rng.uniform(-40.0, 35.0, 2), along, across)


def _off_map(rng):
    centre = rng.uniform(-45.0, 45.0, 2)
    centre[rng.randint(2)] = rng.choice([-1, 1]) * rng.uniform(38.0, 60.0)
    return _box(centre[0], centre[1], rng.uniform(3.5, 30.0), rng.uniform(1.6, 2.5),
                rng.uniform(0.0, 2 * np.pi))


def _point(rng):
    p0 = np.round(rng.uniform(-39.0, 39.0, 2), 1)
    if rng.rand() < 0.5:
        return np.repeat(p0[:, None], 4, axis=1)
    side = rng.uniform(1e-3, 1e-2)
    return _box(p0[0], p0[1], side, side, rng.uniform(0.0, 2 * np.pi))


def _odd_ring(rng):
    """Four corners in random order: self-intersecting, concave or convex."""
    return rng.uniform(-5.0, 5.0, (2, 4)) + rng.uniform(-30.0, 30.0, (2, 1))


def _whole_map():
    big = 5e17
    return [_box(0.0, 0.0, 90.0, 90.0, 0.0), _box(0.0, 0.0, 2e4, 2e4, 0.3),
            np.array([[big, big, -big, -big], [big, -big, big, -big]])]


def _beyond_2_60():
    big, inf = 5e17, np.inf
    return [np.array([[big, big, -big, -big], [big, 0.0, big, 0.0]]),     # the half y >= 0
            np.array([[-big, -big, big, big], [1.0, -1.0, 1.0, -1.0]]),   # a strip, wound back
            np.array([[inf, 1.0, 0.0, 1.0], [1.0, 1.0, 0.0, 0.0]]),
            np.array([[np.nan, 1.0, 0.0, 1.0], [1.0, 1.0, 0.0, 0.0]])]


def adversarial_boxes(seed: int = 0, batch: int = 8, max_bb: int = 100):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, max_bb, 2, 4), np.float32)
    valid = np.zeros((batch, max_bb), bool)
    makers = (_thin_on_grid, _near_axis, _off_map, _point, _odd_ring)
    for b in range(batch):
        items = [make(rng) for _ in range(12) for make in makers]
        if b % 4 == 2:
            items = _beyond_2_60() + items
        if b % 4 == 3:
            items = _whole_map() + items
        n = min(len(items), max_bb)
        with np.errstate(invalid="ignore", over="ignore"):
            boxes[b, :n] = np.stack(items[:n])
        valid[b, :n] = True
        valid[b, rng.choice(n, 3, replace=False)] = False
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

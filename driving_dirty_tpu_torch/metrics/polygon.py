"""Convex polygon geometry for the box metrics, without GEOS
(driving_dirty_tpu/metrics/polygon.py, copied: the port imports nothing of
the JAX package).

The reference computes polygon IoU through Shapely (its
src/utils/helper.py:79-83): `Polygon(corners).convex_hull`, then the
intersection and union areas. Box quads are at most convex quadrilaterals,
so the same values come from Andrew's monotone-chain convex hull and a
Sutherland-Hodgman convex clip, in numpy. Runs on the host, off the hot
path.
"""
from __future__ import annotations

import numpy as np


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def convex_hull(points):
    """Andrew's monotone chain. points: [N, 2] -> hull vertices CCW [M, 2]."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and _cross2(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def polygon_area(poly):
    """Shoelace area of a CCW polygon [M, 2]."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))


def clip_convex(subject, clip):
    """Sutherland-Hodgman: intersection of two convex CCW polygons."""
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        if not output:
            return np.zeros((0, 2))
        input_pts = output
        output = []
        prev = input_pts[-1]
        prev_in = _cross2(edge, prev - a) >= 0
        for cur in input_pts:
            cur_in = _cross2(edge, cur - a) >= 0
            if cur_in != prev_in:
                d = cur - prev
                denom = _cross2(edge, d)
                if abs(denom) > 1e-12:
                    t = _cross2(edge, a - prev) / denom
                    output.append(prev + t * d)
            if cur_in:
                output.append(cur)
            prev, prev_in = cur, cur_in
    return np.array(output) if output else np.zeros((0, 2))


def box_iou(box1, box2):
    """Exact convex-hull IoU of two [2, 4] corner boxes (rows x, y).

    Value-parity with the reference's `compute_iou` (src/utils/helper.py:79-83),
    which builds Polygon(corners.T).convex_hull for each box.
    """
    h1 = convex_hull(np.asarray(box1).T)
    h2 = convex_hull(np.asarray(box2).T)
    a1, a2 = polygon_area(h1), polygon_area(h2)
    if len(h1) < 3 or len(h2) < 3:
        return 0.0
    inter = polygon_area(clip_convex(h1, h2))
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0

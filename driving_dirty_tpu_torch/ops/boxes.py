"""Axis-aligned box utilities for the detection stack, pixel-space xyxy
(driving_dirty_tpu/ops/boxes.py). Every function broadcasts over leading
axes; padded boxes are the callers' masks' business.
"""
from __future__ import annotations

import math

import torch


def area(boxes):
    """[..., 4] xyxy -> [...]."""
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def pairwise_iou(a, b):
    """a [..., N, 4], b [..., M, 4] -> [..., N, M] IoU (0 where the union is 0)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1), 0.0)


def encode(boxes, anchors, weights=(1.0, 1.0, 1.0, 1.0)):
    """Regression targets (dx, dy, dw, dh) of `boxes` w.r.t. `anchors`, both
    [..., 4] xyxy: the standard R-CNN parameterization."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)
    x = boxes[..., 0] + 0.5 * w
    y = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    return torch.stack([
        wx * (x - xa) / wa.clamp(min=1e-6),
        wy * (y - ya) / ha.clamp(min=1e-6),
        ww * torch.log(w / wa.clamp(min=1e-6)),
        wh * torch.log(h / ha.clamp(min=1e-6)),
    ], dim=-1)


def decode(deltas, anchors, weights=(1.0, 1.0, 1.0, 1.0), clip_exp=math.log(1000.0 / 16.0)):
    """Inverse of `encode`; dw and dh clamped at clip_exp = log(1000/16)
    (torchvision's clamp)."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clip_exp)
    dh = (deltas[..., 3] / wh).clamp(max=clip_exp)
    x = dx * wa + xa
    y = dy * ha + ya
    w = torch.exp(dw) * wa
    h = torch.exp(dh) * ha
    return torch.stack([x - 0.5 * w, y - 0.5 * h, x + 0.5 * w, y + 0.5 * h], dim=-1)


def clip_to_image(boxes, size):
    """Clamp xyxy boxes into [0, size]^2."""
    return boxes.clamp(0.0, float(size))


def smooth_l1(x, beta: float = 1.0 / 9.0):
    """Elementwise smooth-L1 (Huber) with torchvision's RPN beta."""
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)

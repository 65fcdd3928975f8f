"""Official task metrics (driving_dirty_tpu/metrics/threat.py): the roadmap
threat score and the box average threat score (parity targets the
reference's src/utils/helper.py:74-77 and :33-72).

`ts_road_map` runs on the tensors' device. `ats_bounding_boxes` runs on the
host: an axis-aligned prefilter over all pairs, then the exact convex IoU
of the pairs that pass, in the native C++ loop (metrics/_native.py, built
with g++ on first use) where it builds, else in Python (metrics/polygon.py,
the same math).
"""
from __future__ import annotations

import numpy as np
import torch

from driving_dirty_tpu_torch.metrics.polygon import box_iou

IOU_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


def ts_road_map(road_map1, road_map2):
    """Pixel threat score TP / (P1 + P2 - TP). Inputs broadcastable {0,1} maps;
    a 0-d f32 tensor on their device."""
    a = torch.as_tensor(road_map1).float()
    b = torch.as_tensor(road_map2, device=a.device).float()
    tp = torch.sum(a * b)
    return tp / (torch.sum(a) + torch.sum(b) - tp)


def _native_iou():
    """metrics/_native.py, or None where it cannot build."""
    try:
        from driving_dirty_tpu_torch.metrics import _native
    except ImportError:
        return None
    return _native


def _pairwise_iou_matrix(boxes1, boxes2):
    """[N1, N2] IoU of the pairs that pass the axis-aligned overlap prefilter
    (helper.py:47-57), 0 elsewhere; in the native loop where it builds."""
    b1 = np.asarray(boxes1, dtype=np.float64)  # [N1, 2, 4]
    b2 = np.asarray(boxes2, dtype=np.float64)  # [N2, 2, 4]
    max1, min1 = b1.max(axis=2), b1.min(axis=2)  # [N1, 2]
    max2, min2 = b2.max(axis=2), b2.min(axis=2)
    cond = ((max1[:, None, 0] > min2[None, :, 0]) & (min1[:, None, 0] < max2[None, :, 0])
            & (max1[:, None, 1] > min2[None, :, 1]) & (min1[:, None, 1] < max2[None, :, 1]))
    nat = _native_iou()
    if nat is not None:
        return nat.masked_pair_iou(b1, b2, cond)
    iou = np.zeros((len(b1), len(b2)))
    for i, j in zip(*np.nonzero(cond)):
        iou[i, j] = box_iou(b1[i], b2[j])
    return iou


def ats_bounding_boxes(boxes1, boxes2):
    """IoU-threshold-weighted average threat score between two [N, 2, 4]
    meter-space corner box sets: thresholds 0.5..0.9 weighted by 1/t,
    TS(t) = TP / (N1 + N2 - TP), with `iou_max` the max over boxes1 for each
    box of boxes2 (helper.py:59-72)."""
    boxes1, boxes2 = np.asarray(boxes1), np.asarray(boxes2)
    n1, n2 = len(boxes1), len(boxes2)
    if n1 == 0 or n2 == 0:
        return 0.0
    iou_max = _pairwise_iou_matrix(boxes1, boxes2).max(axis=0)  # [N2]
    total, weight = 0.0, 0.0
    for t in IOU_THRESHOLDS:
        tp = float((iou_max > t).sum())
        total += (1.0 / t) * (tp / (n1 + n2 - tp))
        weight += 1.0 / t
    return total / weight

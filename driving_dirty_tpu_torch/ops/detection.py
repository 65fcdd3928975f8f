"""Fixed-shape detection primitives for inference: anchors, exact top-k,
NMS and RoIAlign (driving_dirty_tpu/ops/detection.py, the inference half).

Every op keeps the JAX package's fixed shapes: candidates are padded and
masked, scores of invalid entries are NEG_INF, boxes are pixel xyxy.
Orders follow the JAX package's: `top_k` puts the lower index first among
equal values, as lax.top_k does, and NMS ranks candidates by a stable
descending sort, as jnp.argsort does. Equal scores are common (bf16
scores, NEG_INF padding), so these orders decide which candidates fill
the slots. The matching, sampling and loss helpers and the RoIAlign
backward come with detection training.
"""
from __future__ import annotations

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels.roialign import roialign
from driving_dirty_tpu_torch.ops.boxes import pairwise_iou

NEG_INF = -1e9
NMS_MAX_ITERS = 128
UNROLL = 4  # suppression steps between two convergence checks


def base_anchors(sizes=(32, 64, 128, 256, 512), ratios=(0.5, 1.0, 2.0)):
    """[A, 4] zero-centred xyxy anchors, A = len(sizes) * len(ratios), with
    torchvision's AnchorGenerator parameterization (h = s * sqrt(r),
    w = s / sqrt(r)); numpy float32."""
    out = []
    for s in sizes:
        for r in ratios:
            h = s * (r ** 0.5)
            w = s / (r ** 0.5)
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int, cell_anchors=None):
    """[feat_h * feat_w * A, 4] anchors of one feature level (numpy float32),
    cell-major: anchor a of cell (y, x) at row (y * feat_w + x) * A + a."""
    if cell_anchors is None:
        cell_anchors = base_anchors()
    cell_anchors = np.asarray(cell_anchors, np.float32)
    ys = (np.arange(feat_h, dtype=np.float32) * stride)[:, None]
    xs = (np.arange(feat_w, dtype=np.float32) * stride)[None, :]
    zz = np.zeros((feat_h, feat_w), np.float32)
    shifts = np.stack([xs + zz, ys + zz, xs + zz, ys + zz], axis=-1)  # [H, W, 4]
    return (shifts[:, :, None, :] + cell_anchors[None, None, :, :]).reshape(-1, 4)


def top_k(x, k: int):
    """The k largest values along the last axis and their indices, in
    descending order, the lower index first among equal values (lax.top_k's
    order; torch.topk promises none). A stable full sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_fixed(boxes, scores, iou_threshold: float, max_out: int,
              max_iters: int = NMS_MAX_ITERS, fixed_depth: int = 0):
    """Greedy NMS over fixed-size candidate sets, batched over leading axes.

    boxes [..., K, 4], scores [..., K] (invalid = NEG_INF) ->
    (keep_idx [..., max_out], keep_valid [..., max_out]): the survivors'
    indices in score order. Greedy NMS is the fixpoint of

        alive[i] <- valid[i] and no j ranked before i with alive[j] and iou[j, i] > thr,

    which is iterated from all-valid, UNROLL steps between convergence
    checks, until no image changes or max_iters steps have run (min(K,
    max_iters), rounded up to a multiple of UNROLL, as the JAX loop runs).
    Each check reads one flag back to the host (`nms_fixed.checks` counts
    them). An image that converged stays at its fixpoint while the others
    go on, so one loop over the batch gives each image what the JAX
    package's per-image loop gives.
    `fixed_depth` > 0 runs that many steps with no checks instead. A final
    step intersects the state with its own successor, so even under the
    cap no two kept boxes overlap by more than the threshold."""
    lead, k = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.reshape(-1, k, 4)
    s, order = torch.sort(scores.reshape(-1, k), dim=-1, descending=True, stable=True)
    b = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    rank = torch.arange(k, device=scores.device)
    suppress = (pairwise_iou(b, b) > iou_threshold) & (rank[:, None] < rank[None, :])
    valid = s > NEG_INF / 2

    def one(alive):
        return ~(suppress & alive[:, :, None]).any(dim=1) & valid

    keep = valid
    if fixed_depth:
        for _ in range(min(k, fixed_depth)):
            keep = one(keep)
    else:
        prev, it, it_cap = torch.zeros_like(valid), 0, min(k, max_iters)
        while it < it_cap:
            nms_fixed.checks += 1
            if not bool((keep != prev).any()):
                break
            prev = keep
            for _ in range(UNROLL):
                keep = one(keep)
            it += UNROLL
    keep = keep & one(keep)
    vals, kept_sorted = top_k(torch.where(keep, s, NEG_INF), max_out)
    keep_idx = order.gather(1, kept_sorted)
    return keep_idx.reshape(*lead, max_out), (vals > NEG_INF / 2).reshape(*lead, max_out)


nms_fixed.checks = 0


def batched_roi_align(features, rois, output_size: int = 7, spatial_scale: float = 1.0,
                      sampling_ratio: int = 2, aligned: bool = False):
    """features [B, H, W, C] + rois [B, R, 4] pixel xyxy -> [B, R, out, out, C]
    float32: kernel B3 on a CUDA tensor, its plain version on a CPU tensor."""
    return roialign(features.contiguous(), rois.float().contiguous(), output_size,
                    spatial_scale, sampling_ratio, aligned)


def roi_align(features, rois, output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = False):
    """One NHWC feature map [H, W, C] + rois [R, 4] -> [R, out, out, C]."""
    return batched_roi_align(features[None], rois[None], output_size, spatial_scale,
                             sampling_ratio, aligned)[0]

"""Fixed-shape detection primitives: anchors, anchor matching, balanced
sampling, exact top-k, NMS and RoIAlign (driving_dirty_tpu/ops/detection.py).

Every op keeps the JAX package's fixed shapes: candidates are padded and
masked, scores of invalid entries are NEG_INF, boxes are pixel xyxy.
Orders follow the JAX package's: `top_k` puts the lower index first among
equal values, as lax.top_k does, and NMS ranks candidates by a stable
descending sort, as jnp.argsort does. Equal scores are common (bf16
scores, NEG_INF padding), so these orders decide which candidates fill
the slots. Where the JAX package maps a function over images, the port's
takes a batch (leading axes) at once; `match_anchors` keeps its
single-image form (the tests' oracle). The samplers take their uniform
noise as an argument (the callers draw it from the step's generator), and
select with exact top-k where the JAX package may use lax.approx_max_k.
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


# ---------------------------------------------------------------------------
# Anchor <-> GT matching and balanced sampling
# ---------------------------------------------------------------------------
def match_anchors(anchors, gt_boxes, gt_valid, high_thresh: float = 0.7, low_thresh: float = 0.3,
                  force_match_gt: bool = True, block_size: int = 32768):
    """One image's anchors [N, 4] against its GT boxes [G, 4] (validity [G])
    -> (labels [N] int32: 1 positive, 0 negative, -1 ignored; the matched
    GT index [N] int32; the best IoU [N]).

    torchvision's Matcher with allow_low_quality_matches: IoU >= high is
    positive, < low negative, else ignored; every valid GT's best anchors
    (its argmax overlap and every anchor within 1e-7 of it) are forced
    positive. Argmax ties pick the lowest GT index. Anchors are matched in
    blocks of `block_size`, so the [N, G] IoU matrix is never whole. With
    no valid GT every anchor is negative."""
    best, bidx, gt_best = [], [], []
    for blk in anchors.split(block_size):
        iou = torch.where(gt_valid[None, :], pairwise_iou(blk, gt_boxes), 0.0)
        b, i = iou.max(dim=1)  # the first max on ties
        best.append(b)
        bidx.append(i)
        gt_best.append(iou.amax(dim=0))
    best_iou = torch.cat(best)
    best_idx = torch.cat(bidx).to(torch.int32)
    gt_best_iou = torch.stack(gt_best).amax(dim=0)
    labels = torch.where(best_iou >= high_thresh, 1, torch.where(best_iou < low_thresh, 0, -1))
    if force_match_gt:
        forced, forced_gt = [], []
        for blk in anchors.split(block_size):
            iou = torch.where(gt_valid[None, :], pairwise_iou(blk, gt_boxes), 0.0)
            is_best = (iou >= gt_best_iou[None, :] - 1e-7) & (gt_best_iou[None, :] > 0) & gt_valid[None, :]
            forced.append(is_best.any(dim=1))
            forced_gt.append(is_best.to(torch.uint8).argmax(dim=1))  # the first GT whose tie set holds it
        forced = torch.cat(forced)
        labels = torch.where(forced, 1, labels)
        best_idx = torch.where(forced & (best_iou <= 0), torch.cat(forced_gt).to(torch.int32), best_idx)
    labels = torch.where(gt_valid.any(), labels, 0)
    return labels.to(torch.int32), best_idx, best_iou


GRID_BLOCK_ELEMS = 1 << 25  # elements of one row block of match_labels_grid's [b, rows, G, W, A] overlaps


def match_labels_grid(cell_anchors, feat_h: int, feat_w: int, stride: int, gt_boxes, gt_valid,
                      high_thresh: float = 0.7, low_thresh: float = 0.3):
    """Labels of a regular anchor grid against each image's GT boxes:
    gt_boxes [b, G, 4], gt_valid [b, G] -> (labels [b, feat_h * feat_w * A]
    int32 cell-major, gt_best_iou [b, G]).

    The JAX package's grid factorization: anchors are per-axis intervals, so
    the overlaps are tables ox [b, W, A, G] and oy [b, H, A, G] and
    inter = oy * ox; a GT's best IoU is separable ((max oy) * (max ox) per
    anchor type, with divisions only on [A, G]); every threshold test is
    cross-multiplied, inter >= t * s_ag / (1 + t), against per-(A, G)
    constants, and the positive tests (>= high, or within 1e-7 of the GT's
    best) fold into one. Same labels as `match_anchors` except for anchors
    whose IoU lies within about 1e-5 relative of a threshold or tie (areas
    per anchor type, cross-multiplied tests).

    Here the product is formed a block of rows at a time, GRID_BLOCK_ELEMS
    elements at most, as [b, rows, G, W, A], so that the reductions over
    the GT run across rows of memory, and only over as many GT slots as the
    batch's fullest image has valid boxes (the valid ones moved to the
    front; one host readback), since an invalid GT labels nothing. The
    products and comparisons are the same, so are the labels. Matched GT
    indices of a sampled subset come from `match_subset`."""
    dev = gt_boxes.device
    ca = torch.as_tensor(cell_anchors, dtype=torch.float32, device=dev)  # [A, 4]
    b, g_all = gt_boxes.shape[:2]
    a_n = ca.shape[0]
    # the valid GT first in each image (stable), and no more slots than valid boxes
    order = torch.sort((~gt_valid).to(torch.uint8), dim=1, stable=True)[1]
    g = max(1, int(gt_valid.sum(dim=1).max()))
    order = order[:, :g]
    gt_boxes = gt_boxes.gather(1, order[..., None].expand(-1, -1, 4))
    gt_valid = gt_valid.gather(1, order)
    xs = torch.arange(feat_w, dtype=torch.float32, device=dev) * stride
    ys = torch.arange(feat_h, dtype=torch.float32, device=dev) * stride
    gx0, gy0, gx1, gy1 = (t[:, :, None, None] for t in gt_boxes.unbind(-1))  # [b, G, 1, 1]

    def overlap(pos, lo, hi, glo, ghi):  # -> [b, G, len(pos), A]
        a_lo = (pos[:, None] + ca[None, :, lo])[None, None]
        a_hi = (pos[:, None] + ca[None, :, hi])[None, None]
        return (torch.minimum(a_hi, ghi) - torch.maximum(a_lo, glo)).clamp(min=0)

    ox = overlap(xs, 0, 2, gx0, gx1)                                                       # [b, G, W, A]
    oy = overlap(ys, 1, 3, gy0, gy1).permute(0, 2, 1, 3)                                   # [b, H, G, A]
    sa = (ca[:, 2] - ca[:, 0]).clamp(min=0) * (ca[:, 3] - ca[:, 1]).clamp(min=0)           # [A]
    sg = (gt_boxes[..., 2] - gt_boxes[..., 0]).clamp(min=0) * (gt_boxes[..., 3] - gt_boxes[..., 1]).clamp(min=0)
    s_ag = sg[:, :, None] + sa[None, None, :]                                              # [b, G, A]
    mi = oy.amax(dim=1) * ox.amax(dim=2)
    union = s_ag - mi
    iou_best = torch.where(union > 0, mi / torch.where(union > 0, union, 1), 0.0)
    iou_best = torch.where(gt_valid[:, :, None], iou_best, 0.0)
    best = iou_best.amax(dim=2)                                                            # [b, G]
    gt_best_iou = torch.zeros((b, g_all), dtype=best.dtype, device=dev).scatter_(1, order, best)

    ok = gt_valid[:, :, None] & (s_ag > 0)
    inf = torch.tensor(float("inf"), device=dev)
    q_hi = torch.where(ok, high_thresh / (1.0 + high_thresh) * s_ag, inf)
    q_lo = torch.where(ok, low_thresh / (1.0 + low_thresh) * s_ag, inf)
    t = best - 1e-7
    q_f = torch.where(ok & (best > 0)[:, :, None], (t / (1.0 + t))[:, :, None] * s_ag, inf)
    q_pos = torch.minimum(q_hi, q_f)[:, None, :, None]                                     # [b, 1, G, 1, A]
    q_lo = q_lo[:, None, :, None]

    rows = max(1, GRID_BLOCK_ELEMS // max(1, b * g * feat_w * a_n))
    parts = []
    for y0 in range(0, feat_h, rows):
        inter = oy[:, y0:y0 + rows, :, None] * ox[:, None]                                 # [b, rows, G, W, A]
        pos = (inter >= q_pos).any(dim=2)
        near = (inter >= q_lo).any(dim=2)
        parts.append(torch.where(pos, 1, torch.where(near, -1, 0)).reshape(b, -1))
    labels = torch.cat(parts, dim=1)
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, 0)
    return labels.to(torch.int32), gt_best_iou


def match_subset(sub_anchors, gt_boxes, gt_valid, gt_best_iou):
    """Matched GT index of a small anchor subset: sub_anchors [..., S, 4],
    gt_boxes [..., G, 4], gt_valid and gt_best_iou [..., G] -> [..., S]
    int64. `match_anchors`' index exactly (first-max argmax ties; forced
    anchors with zero best IoU take their forcing GT), at [S, G] cost."""
    iou = torch.where(gt_valid[..., None, :], pairwise_iou(sub_anchors, gt_boxes), 0.0)
    best, idx = iou.max(dim=-1)
    gb = gt_best_iou[..., None, :]
    is_best = (iou >= gb - 1e-7) & (gb > 0) & gt_valid[..., None, :]
    forced = is_best.any(dim=-1)
    forced_gt = is_best.to(torch.uint8).argmax(dim=-1)
    return torch.where(forced & (best <= 0), forced_gt, idx)


def blocked_top_k(vals, k: int):
    """The exact top k along the last axis, lower index first among equal
    values (lax.top_k's order): the values and counts of the JAX package's
    blocked_top_k, which splits the 2.4M-anchor axis into blocks of 65536
    for the TPU. Here one stable sort (`top_k`) serves every length."""
    return top_k(vals, k)


def sample_balanced(noise, labels, num_samples: int, positive_fraction: float):
    """A fixed-size balanced sample of each row of `labels` [..., n] (1
    positive, 0 negative, else ignored), ranked by the uniform `noise`
    [..., n] -> (idx, is_pos, take), each [..., num_samples].

    torchvision's BalancedPositiveNegativeSampler counts: n_pos = min(#pos,
    num_samples * positive_fraction), n_neg = min(#neg, num_samples - n_pos);
    the highest-noise positives and negatives are taken, positives first,
    in the JAX package's slot order; slots past n_pos + n_neg are filler
    (take False). The JAX package draws the noise itself (uniform from its
    key) and may rank by lax.approx_max_k; here the caller draws it, and the
    ranking is exact (`blocked_top_k`)."""
    n = labels.shape[-1]
    n_pos_want = min(int(num_samples * positive_fraction), n)
    n_neg_want = min(num_samples, n)
    neg_inf = torch.tensor(NEG_INF, dtype=noise.dtype, device=noise.device)
    pos_val, pos_idx = blocked_top_k(torch.where(labels == 1, noise, neg_inf), n_pos_want)
    pos_take = pos_val > NEG_INF / 2
    n_pos = pos_take.sum(dim=-1, keepdim=True)
    neg_val, neg_idx = blocked_top_k(torch.where(labels == 0, noise, neg_inf), n_neg_want)
    rank = torch.arange(n_neg_want, device=labels.device)
    neg_take = (neg_val > NEG_INF / 2) & (rank < num_samples - n_pos)
    cand_idx = torch.cat([pos_idx, neg_idx], dim=-1)
    cand_pos = torch.cat([torch.ones_like(pos_take), torch.zeros_like(neg_take)], dim=-1)
    cand_take = torch.cat([pos_take, neg_take], dim=-1)
    order = torch.arange(cand_idx.shape[-1], dtype=torch.float32, device=labels.device)
    k_pack = min(num_samples, cand_idx.shape[-1])
    val, sel = top_k(torch.where(cand_take, -order, NEG_INF), k_pack)
    take = val > NEG_INF / 2
    idx, is_pos = cand_idx.gather(-1, sel), cand_pos.gather(-1, sel) & take
    if k_pack < num_samples:  # filler slots back to the fixed shape
        pad = (*idx.shape[:-1], num_samples - k_pack)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        is_pos = torch.cat([is_pos, is_pos.new_zeros(pad)], dim=-1)
        take = torch.cat([take, take.new_zeros(pad)], dim=-1)
    return idx, is_pos, take


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

"""Faster-RCNN RPN and box heads (driving_dirty_tpu/nn/detection.py).

Fixed shapes throughout, as in the JAX package: a dense anchor grid scored
in bulk, the top rpn_pre_nms_top_n by exact top-k (the JAX package's
default lax.approx_max_k has no PyTorch twin; its `exact_topk=True` is the
same selection), NMS over fixed candidate sets with validity masks
(ops/detection.py:nms_fixed), RoIAlign through kernel B3 (and, in
training, its backward B3-bwd), and a box head whose post-processing keeps
box_detections_per_img slots per image. Images are batched where the JAX
package vmaps them.

Training (`forward_train`) has torchvision's losses under their names:
RPN objectness BCE and smooth-L1 (beta 1/9) over 256 balanced anchor
samples an image, matched on the whole grid (ops/detection.py:
match_labels_grid); the box head's class CE and smooth-L1 (beta 1) on the
matched class's slot over 512 balanced proposal samples, the GT boxes
appended to the proposals. The two samplers rank by uniform noise drawn
from the step's generator (or passed in: `noise`). In a data-parallel
training step (parallel/mesh.py) the noise is this rank's rows of the
global batch's draw, the RPN losses' mean over images and the box head's
count of samples are the global batch's. Proposals come from the
detached RPN outputs, as the JAX package's stop_gradient.

Labels are the raw dataset category ids, as the reference feeds them
(class 0 collides with the background label; `label_offset` in the task
shifts them).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.ops import boxes as box_ops
from driving_dirty_tpu_torch.ops import detection as det
from driving_dirty_tpu_torch.ops.detection import NEG_INF
from driving_dirty_tpu_torch.parallel.collectives import batch_mean, global_count, global_rows

RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
ROI_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """The JAX package's DetectionConfig, every field with its default."""

    image_size: int = 800
    feat_stride: int = 2          # backbone c3 stride on the 800x800 layout image
    num_classes: int = 9
    anchor_sizes: tuple = (32, 64, 128, 256, 512)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    rpn_pre_nms_top_n: int = 2000
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_fg_thresh: float = 0.7
    rpn_bg_thresh: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    box_fg_thresh: float = 0.5
    box_batch_per_image: int = 512
    box_positive_fraction: float = 0.25
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_detections_per_img: int = 100
    roi_output_size: int = 7
    roi_sampling_ratio: int = 2
    backbone_channels: int = 32
    # The port always selects proposals exactly; the field is kept so that
    # configurations carry over.
    exact_topk: bool = False
    nms_fixed_depth: int = 0      # 0: convergence-checked loop; N > 0: N straight steps
    mlp_dim: int = 1024
    rpn_head_dilations: tuple = ()  # extra dilated 3x3 RPN convs after rpn_conv
    rpn_head_norm: bool = False     # per-cell RMS norm after each RPN ReLU

    @property
    def num_anchors_per_cell(self):
        return len(self.anchor_sizes) * len(self.anchor_ratios)

    @property
    def feat_size(self):
        return self.image_size // self.feat_stride


def _renorm(module, std, generator):
    """torchvision's head init: normal(0, std) weights, zero bias."""
    with torch.no_grad():
        module.weight.normal_(0.0, std, generator=generator)
        module.bias.zero_()


class FasterRCNNHead(nn.Module):
    """RPN and box heads on NHWC backbone features [b, Hf, Wf, C].

    Weights under the JAX package's names: rpn_conv, rpn_conv_d<d> (one per
    rpn_head_dilations entry), rpn_cls, rpn_reg, box_fc1, box_fc2,
    cls_score, bbox_pred. Init in distribution as the JAX package's
    (torchvision's): the RPN convs and the predictors normal with std 0.01
    (bbox_pred 0.001) and zero bias, the box MLP the layer default."""

    def __init__(self, cfg: DetectionConfig = DetectionConfig(), *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        c, a = cfg.backbone_channels, cfg.num_anchors_per_cell
        self.rpn_conv = L.Conv2d(c, c, 3, 1, 1, **kw)
        self.rpn_extra = tuple(f"rpn_conv_d{d}" for d in cfg.rpn_head_dilations)
        for name, d in zip(self.rpn_extra, cfg.rpn_head_dilations):
            self.add_module(name, L.Conv2d(c, c, 3, 1, d, d, **kw))
        self.rpn_cls = L.Conv2d(c, a, 1, **kw)
        self.rpn_reg = L.Conv2d(c, 4 * a, 1, **kw)
        flat = cfg.roi_output_size * cfg.roi_output_size * c
        self.box_fc1 = L.Linear(flat, cfg.mlp_dim, **kw)
        self.box_fc2 = L.Linear(cfg.mlp_dim, cfg.mlp_dim, **kw)
        self.cls_score = L.Linear(cfg.mlp_dim, cfg.num_classes, **kw)
        self.bbox_pred = L.Linear(cfg.mlp_dim, cfg.num_classes * 4, **kw)
        for name in ("rpn_conv", *self.rpn_extra, "rpn_cls", "rpn_reg", "cls_score"):
            _renorm(getattr(self, name), 0.01, generator)
        _renorm(self.bbox_pred, 0.001, generator)
        self._anchors = {}

    def anchors(self, device):
        """[feat_size^2 * A, 4] float32 anchors on `device`, built once."""
        key = str(device)
        if key not in self._anchors:
            cfg = self.cfg
            cells = det.base_anchors(cfg.anchor_sizes, cfg.anchor_ratios)
            grid = det.grid_anchors(cfg.feat_size, cfg.feat_size, cfg.feat_stride, cells)
            self._anchors[key] = torch.from_numpy(grid).to(device)
        return self._anchors[key]

    def rpn_forward(self, features):
        """features [b, Hf, Wf, C] -> (objectness [b, N], deltas [b, N, 4]),
        N = Hf * Wf * A, cell-major."""
        def norm(t):
            if not self.cfg.rpn_head_norm:
                return t
            return t * torch.rsqrt(t.square().mean(dim=-1, keepdim=True) + 1e-6)

        t = norm(torch.relu(self.rpn_conv(features)))
        for name in self.rpn_extra:
            t = norm(torch.relu(getattr(self, name)(t)))
        b = features.shape[0]
        return self.rpn_cls(t).reshape(b, -1), self.rpn_reg(t).reshape(b, -1, 4)

    def proposals(self, objectness, deltas):
        """-> (rois [b, P, 4], roi_valid [b, P], roi_scores [b, P]),
        P = rpn_post_nms_top_n: the exact top rpn_pre_nms_top_n anchors by
        objectness, decoded, clipped, degenerate boxes (side <= 1e-3) masked,
        then NMS."""
        cfg = self.cfg
        anchors = self.anchors(objectness.device)
        score, idx = det.top_k(objectness, cfg.rpn_pre_nms_top_n)
        d_sel = deltas.gather(1, idx[..., None].expand(-1, -1, 4))
        boxes = box_ops.decode(d_sel, anchors[idx], RPN_BOX_WEIGHTS)
        boxes = box_ops.clip_to_image(boxes, cfg.image_size)
        wh_ok = (boxes[..., 2] - boxes[..., 0] > 1e-3) & (boxes[..., 3] - boxes[..., 1] > 1e-3)
        score = torch.where(wh_ok, score, NEG_INF)
        keep_idx, keep_valid = det.nms_fixed(boxes, score, cfg.rpn_nms_thresh,
                                             cfg.rpn_post_nms_top_n,
                                             fixed_depth=cfg.nms_fixed_depth)
        rois = boxes.gather(1, keep_idx[..., None].expand(-1, -1, 4))
        return rois, keep_valid, score.gather(1, keep_idx)

    def roi_features(self, features, rois):
        """[b, Hf, Wf, C] + [b, R, 4] -> box-head embeddings [b, R, mlp]."""
        cfg = self.cfg
        pooled = det.batched_roi_align(features, rois, output_size=cfg.roi_output_size,
                                       spatial_scale=1.0 / cfg.feat_stride,
                                       sampling_ratio=cfg.roi_sampling_ratio)  # [b, R, 7, 7, C] f32
        b, r = pooled.shape[:2]
        # box_fc1's rows follow torch's NCHW flatten of the pooled [C, 7, 7];
        # RoIAlign returns f32, the MLP runs in the backbone's dtype
        flat = pooled.permute(0, 1, 4, 2, 3).reshape(b, r, -1).to(features.dtype)
        x = torch.relu(self.box_fc1(flat))
        return torch.relu(self.box_fc2(x))

    def box_predictions(self, embeddings):
        """-> (class logits [b, R, K], box deltas [b, R, K * 4])."""
        return self.cls_score(embeddings), self.bbox_pred(embeddings)

    # ------------------------------------------------------------------
    # Training losses
    # ------------------------------------------------------------------
    def draw_noise(self, b: int, n_gt: int, generator, device):
        """One training step's sampler noise, uniform on [0, 1): "rpn" [b, N]
        for the anchors, then "roi" [b, rpn_post_nms_top_n + n_gt] for the
        proposals with the GT boxes appended."""
        cfg = self.cfg
        n = cfg.feat_size * cfg.feat_size * cfg.num_anchors_per_cell
        rpn = global_rows(lambda rows: torch.rand((rows, n), generator=generator, device=device), b)
        roi = global_rows(lambda rows: torch.rand((rows, cfg.rpn_post_nms_top_n + n_gt), generator=generator,
                                                  device=device), b)
        return {"rpn": rpn, "roi": roi}

    def rpn_loss(self, objectness, deltas, gt_boxes, gt_valid, noise):
        """-> (loss_objectness, loss_rpn_box_reg), each the mean over images
        of its sum over the sampled anchors over their count. gt_boxes
        [b, G, 4] pixel xyxy, noise [b, N] (the sampler's)."""
        cfg = self.cfg
        b = objectness.shape[0]
        a_n = cfg.num_anchors_per_cell
        anchors = self.anchors(objectness.device)
        cells = det.base_anchors(cfg.anchor_sizes, cfg.anchor_ratios)
        labels, gt_best_iou = det.match_labels_grid(cells, cfg.feat_size, cfg.feat_size, cfg.feat_stride,
                                                    gt_boxes, gt_valid, cfg.rpn_fg_thresh, cfg.rpn_bg_thresh)
        idx, is_pos, take = det.sample_balanced(noise, labels, cfg.rpn_batch_per_image,
                                                cfg.rpn_positive_fraction)
        # the sampled logits and deltas gathered in the conv's [HW, A(*4)]
        # tiling: rows by cell, then the anchor type's column(s)
        cell, atype = idx // a_n, idx % a_n
        rows = objectness.reshape(b, -1, a_n).gather(1, cell[..., None].expand(-1, -1, a_n))
        o = rows.gather(2, atype[..., None])[..., 0].float()  # the BCE in f32 at any precision
        w = take.float()
        t = is_pos.float()
        n = w.sum(dim=-1).clamp(min=1.0)
        obj_loss = (w * (o.clamp(min=0) - o * t + torch.log1p(torch.exp(-o.abs())))).sum(dim=-1) / n
        sampled = anchors[idx]                                                   # [b, S, 4]
        match = det.match_subset(sampled, gt_boxes, gt_valid, gt_best_iou)
        targets = box_ops.encode(gt_boxes.gather(1, match[..., None].expand(-1, -1, 4)), sampled,
                                 RPN_BOX_WEIGHTS)
        rows = deltas.reshape(b, -1, a_n * 4).gather(1, cell[..., None].expand(-1, -1, a_n * 4))
        d_sel = rows.gather(2, atype[..., None] * 4 + torch.arange(4, device=idx.device))
        reg = (t[..., None] * box_ops.smooth_l1(d_sel - targets, beta=1.0 / 9.0)).sum(dim=(-1, -2)) / n
        return batch_mean(obj_loss), batch_mean(reg)

    @torch.no_grad()
    def sample_proposals(self, rois, roi_valid, gt_boxes, gt_valid, gt_labels, noise):
        """Match the proposals, with the GT boxes appended, to the GT and
        sample the box head's minibatch -> {"rois" [b, S, 4], "cls_target"
        [b, S] (0 = background), "reg_target" [b, S, 4], "is_pos", "take"}.
        noise [b, P + G] (the sampler's)."""
        cfg = self.cfg
        allr = torch.cat([rois, gt_boxes], dim=1)
        allv = torch.cat([roi_valid, gt_valid], dim=1)
        iou = torch.where(gt_valid[:, None, :], box_ops.pairwise_iou(allr, gt_boxes), 0.0)
        best, bidx = iou.max(dim=-1)
        labels = torch.where(allv, torch.where(best >= cfg.box_fg_thresh, 1, 0), -1)
        idx, is_pos, take = det.sample_balanced(noise, labels, cfg.box_batch_per_image,
                                                cfg.box_positive_fraction)
        sr = allr.gather(1, idx[..., None].expand(-1, -1, 4))
        m = bidx.gather(1, idx)
        sgt = gt_boxes.gather(1, m[..., None].expand(-1, -1, 4))
        cls_target = torch.where(is_pos, gt_labels.gather(1, m), 0)
        return {"rois": sr, "cls_target": cls_target, "reg_target": box_ops.encode(sgt, sr, ROI_BOX_WEIGHTS),
                "is_pos": is_pos, "take": take}

    def roi_loss(self, features, sampled):
        """-> (loss_classifier, loss_box_reg): class CE over the taken
        samples and smooth-L1 (beta 1) of the target class's deltas over the
        positives, both over the batch's count of taken samples."""
        cfg = self.cfg
        cls, reg = self.box_predictions(self.roi_features(features, sampled["rois"]))
        b, r = cls.shape[:2]
        w = sampled["take"].float()
        n = global_count(w.sum()).clamp(min=1.0)
        target = sampled["cls_target"].long()
        onehot = target[..., None] == torch.arange(cfg.num_classes, device=cls.device)
        logp = torch.log_softmax(cls, dim=-1)
        cls_loss = -(w * (onehot * logp).sum(dim=-1)).sum() / n
        sel = reg.reshape(b, r, cfg.num_classes, 4).gather(2, target[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        pw = sampled["is_pos"].float()[..., None]
        reg_loss = (pw * box_ops.smooth_l1(sel - sampled["reg_target"], beta=1.0)).sum() / n
        return cls_loss, reg_loss

    def forward_train(self, features, gt_boxes, gt_valid, gt_labels, generator=None, noise=None):
        """-> {"loss_classifier", "loss_box_reg", "loss_objectness",
        "loss_rpn_box_reg"}. The samplers' noise is `noise` ({"rpn", "roi"},
        as `draw_noise` gives) or drawn from `generator`."""
        if noise is None:
            noise = self.draw_noise(features.shape[0], gt_boxes.shape[1], generator, features.device)
        obj, dl = self.rpn_forward(features)
        loss_obj, loss_rpn_reg = self.rpn_loss(obj, dl, gt_boxes, gt_valid, noise["rpn"])
        with torch.no_grad():
            rois, rv, _ = self.proposals(obj.detach(), dl.detach())
        sampled = self.sample_proposals(rois, rv, gt_boxes, gt_valid, gt_labels, noise["roi"])
        loss_cls, loss_reg = self.roi_loss(features, sampled)
        return {"loss_classifier": loss_cls, "loss_box_reg": loss_reg,
                "loss_objectness": loss_obj, "loss_rpn_box_reg": loss_rpn_reg}

    def postprocess_detections(self, rois, roi_valid, scores, reg):
        """Per-class decode -> clip -> drop background class 0 -> score floor
        box_score_thresh -> the top 1000 candidates over all classes -> NMS
        per class (boxes offset by label * (image_size + 2)) -> the top
        box_detections_per_img.

        rois [b, P, 4], roi_valid [b, P], scores [b, P, K] (softmaxed),
        reg [b, P, K * 4] -> {"boxes" [b, D, 4], "scores" [b, D] (0 where
        invalid), "labels" [b, D], "valid" [b, D]}."""
        cfg = self.cfg
        b, p = rois.shape[:2]
        k = cfg.num_classes
        boxes_k = box_ops.decode(reg.reshape(b, p, k, 4), rois[:, :, None, :], ROI_BOX_WEIGHTS)
        boxes_k = box_ops.clip_to_image(boxes_k, cfg.image_size)
        cand_boxes = boxes_k[:, :, 1:].reshape(b, -1, 4)
        cand_scores = torch.where(roi_valid[:, :, None], scores[:, :, 1:], 0.0).reshape(b, -1)
        cand_labels = torch.arange(1, k, device=rois.device).expand(p, k - 1).reshape(-1)
        cand_scores = torch.where(cand_scores > cfg.box_score_thresh, cand_scores, NEG_INF)
        top_s, top_i = det.top_k(cand_scores, min(1000, cand_scores.shape[-1]))
        cand_boxes = cand_boxes.gather(1, top_i[..., None].expand(-1, -1, 4))
        cand_labels = cand_labels[top_i]
        offset = cand_labels.float()[..., None] * (cfg.image_size + 2.0)
        keep_idx, keep_valid = det.nms_fixed(cand_boxes + offset, top_s, cfg.box_nms_thresh,
                                             cfg.box_detections_per_img,
                                             fixed_depth=cfg.nms_fixed_depth)
        return {
            "boxes": cand_boxes.gather(1, keep_idx[..., None].expand(-1, -1, 4)),
            "scores": torch.where(keep_valid, top_s.gather(1, keep_idx), 0.0),
            "labels": cand_labels.gather(1, keep_idx),
            "valid": keep_valid,
        }

    def _classify(self, features):
        obj, dl = self.rpn_forward(features)
        rois, rv, _ = self.proposals(obj, dl)
        cls, reg = self.box_predictions(self.roi_features(features, rois))
        return rois, rv, torch.softmax(cls, dim=-1), reg

    def forward_eval(self, features):
        """-> detections: boxes [b, D, 4] pixel xyxy, scores, labels and
        valid [b, D]; D = box_detections_per_img."""
        return self.postprocess_detections(*self._classify(features))

    def forward_diag(self, features):
        """Stage-wise tap for the validation diagnostics: the post-NMS
        proposals, their validity and the class posteriors of each."""
        rois, rv, cls, _ = self._classify(features)
        return {"rois": rois, "roi_valid": rv, "cls": cls}

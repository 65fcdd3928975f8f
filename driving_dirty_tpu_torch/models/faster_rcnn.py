"""Faster-RCNN box tasks (driving_dirty_tpu/models/faster_rcnn.py).

  BBFasterRCNN      ("faster_rcnn"): six views -> the square layout image
                    (ops/maps.py:layout_images_as_map) -> the SSL encoder's
                    c3 trunk (kernel B1; a c3-only backbone) -> RPN and box
                    heads (nn/detection.py; RoIAlign is kernel B3, its
                    backward B3-bwd), 9 classes.
  FasterRCNNRoadMap ("faster_rcnn_rm"): also fuses the road map as a 4th
                    channel through mapper_cnn Conv(4->3) + sigmoid before
                    the backbone.

Images are [b, 6, H, W, 3] NHWC (uint8 or float), road [b, S, S] with S the
layout size (`image_size`, 800). Box targets: meter corners [.., 2, 4] ->
pixel AABBs (ops/coords.py:corners_to_aabb); labels the raw category ids
plus `label_offset`. At precision 8 `predict` calibrates the int8 trunk on
its first batch, on the trunk's own input (the layout image, fused with the
road map for faster_rcnn_rm; models/precision.py:Int8TrunkMixin).

Training: `loss(batch, train=True, generator=...)` gives the four
torchvision losses and their sum; the two samplers draw their noise from
the generator (or take `noise`, nn/detection.py:draw_noise's dict).
`freeze_mask` freezes the pretrained trunk before `unfreeze_epoch_no`
(default 10; a 0 also reads as 10, as `hp(...) or 10` does in the JAX
package); the heads and mapper_cnn train from step 0, so the rm variant's
trunk input, and with it the features RoIAlign pools, need a gradient at
every step. Validation is the eval-mode loss (`Task.val_metrics`, its draws
from the generator) and `host_val_metrics`. `step_variant` keeps the JAX
package's exact-top-k warm-up key. `add_model_specific_args` gives the CLI's
flags (cli/faster_rcnn.py). `fast_conv` raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from driving_dirty_tpu_torch.cli.hyperopt import opt_list, tune
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.metrics.threat import ats_bounding_boxes
from driving_dirty_tpu_torch.models.labeled_data import LabeledDataMixin, add_labeled_data_args
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin, compute_dtype
from driving_dirty_tpu_torch.models.pretrained import encoder_freeze_mask, init_backbone, load_pretrained_ae
from driving_dirty_tpu_torch.nn.detection import DetectionConfig, FasterRCNNHead
from driving_dirty_tpu_torch.ops.coords import aabb_to_corners, corners_to_aabb
from driving_dirty_tpu_torch.ops.maps import layout_images_as_map
from driving_dirty_tpu_torch.ops.stitch import normalize_images
from driving_dirty_tpu_torch.train.task import Task, hp


def _ints(v):
    return tuple(int(s) for s in v.split(",") if s) if isinstance(v, str) else tuple(v)


def _floats(v):
    return tuple(float(s) for s in v.split(",") if s) if isinstance(v, str) else tuple(v)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class BBFasterRCNN(Int8TrunkMixin, LabeledDataMixin, Task, nn.Module):
    name = "faster_rcnn"
    uses_roadmap = False
    # images per forward pass in predict: bounds the NMS temporaries (a
    # [2000, 2000] suppression matrix per image); larger batches run in
    # chunks, the tail padded with zero images
    predict_chunk = 8

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        Task.__init__(self, hparams)
        h = self.hparams
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.compute_dtype = compute_dtype(hp(h, "precision", 32))
        if hp(h, "fast_conv", False):
            raise NotImplementedError("fast_conv (the blocked space-to-depth convs) is not ported yet")
        self.batch_size = hp(h, "batch_size", 6)
        self.unfreeze_epoch_no = hp(h, "unfreeze_epoch_no", 10) or 10
        self.label_offset = hp(h, "label_offset", 0)
        self.exact_topk_warmup_steps = hp(h, "exact_topk_warmup_steps", 500)
        self.cfg = DetectionConfig(
            image_size=hp(h, "image_size", 800),
            anchor_sizes=_ints(hp(h, "anchor_sizes", (32, 64, 128, 256, 512))),
            anchor_ratios=_floats(hp(h, "anchor_ratios", (0.5, 1.0, 2.0))),
            rpn_head_dilations=_ints(hp(h, "rpn_head_dilations", ()) or ()),
            rpn_head_norm=bool(hp(h, "rpn_head_norm", False)),
            rpn_pre_nms_top_n=hp(h, "rpn_pre_nms_top_n", 2000),
            rpn_post_nms_top_n=hp(h, "rpn_post_nms_top_n", 1000),
            exact_topk=bool(hp(h, "exact_topk", False)),
            box_batch_per_image=hp(h, "box_batch_per_image", 512),
            num_classes=9 + self.label_offset,
            nms_fixed_depth=hp(h, "nms_fixed_depth", 0),
        )
        self.ae, ae_weights = load_pretrained_ae(h)
        # c3_only: the detection backbone taps the conv feature map only
        self.encoder = init_backbone(self.ae, ae_weights, c3_only=True, **kw)
        self.head = FasterRCNNHead(self.cfg, **kw)
        if self.uses_roadmap:
            self.mapper_cnn = L.Conv2d(4, 3, 3, 1, 1, **kw)

    def _backbone_input(self, images, road=None):
        """Six views -> the square layout image (+ the road channel through
        mapper_cnn for the rm variant): the trunk's [b, S, S, 3] input,
        contiguous, in the compute dtype."""
        dtype = self.compute_dtype
        x = layout_images_as_map(normalize_images(images, dtype), size=self.cfg.image_size)
        if self.uses_roadmap:
            x = torch.cat([x, road[..., None].to(dtype)], dim=-1)
            x = torch.sigmoid(self.mapper_cnn(x))
        return x.contiguous()

    def backbone_features(self, images, road=None):
        """-> c3 features [b, S/2, S/2, 32] (kernel B1 on the card; B1-int8 in
        eval mode at precision 8 once calibrated)."""
        return self.encoder(self._backbone_input(images, road), c3_only=True,
                            **self.enc_int8_kwargs(self.training))

    @torch.no_grad()
    def calibrate_int8(self, images, road=None):
        """One-time int8 activation-scale calibration (precision 8 only), on
        `_backbone_input`: the road-map fusion of faster_rcnn_rm included."""
        if not self.int8_trunk or self._int8_scales is not None:
            return
        road = road if self.uses_roadmap else None
        self.calibrate_int8_on(self.encoder, self._backbone_input(images, road))

    def _targets(self, batch):
        """-> (gt boxes [b, G, 4] pixel xyxy, their validity, labels)."""
        cats = batch["categories"].to(torch.int32) + self.label_offset
        return corners_to_aabb(batch["boxes"]), batch["box_valid"], cats

    def loss(self, batch, *, train: bool, generator=None, noise=None):
        """-> (the sum of the four losses, {loss name: value}). Batch:
        images, boxes, box_valid, categories (and road for faster_rcnn_rm).
        The samplers' noise is `noise` or drawn from `generator`."""
        self.train(train)
        gt_boxes, gt_valid, gt_labels = self._targets(batch)
        feats = self.backbone_features(batch["images"], batch.get("road") if self.uses_roadmap else None)
        losses = self.head.forward_train(feats, gt_boxes, gt_valid, gt_labels, generator=generator, noise=noise)
        return sum(losses.values()), losses

    def step_variant(self, global_step: int):
        """Trainer hook: the JAX package's key of the step variant at this
        optimizer step, "exact_topk_warmup" for the first
        exact_topk_warmup_steps steps unless exact_topk is on, else None.
        There the warm-up swaps approx_max_k for exact top-k; the port's
        proposals and samplers are always exact, so here it changes no
        numerics."""
        if self.exact_topk_warmup_steps and not self.cfg.exact_topk \
                and global_step < self.exact_topk_warmup_steps:
            return "exact_topk_warmup"
        return None

    def _detect(self, images, road):
        dets = self.head.forward_eval(self.backbone_features(images, road))
        if self.label_offset:
            dets["labels"] = dets["labels"] - self.label_offset  # raw category ids out
        return dets

    @torch.no_grad()
    def predict(self, images, road=None):
        """-> detections {"boxes" [b, D, 4] pixel xyxy, "scores" [b, D],
        "labels" [b, D] (raw category ids), "valid" [b, D]}. Eval mode; the
        road map is used by the rm variant only. At precision 8 it first
        calibrates the int8 scales on the whole batch (`calibrate_int8`)."""
        road = road if self.uses_roadmap else None
        self.calibrate_int8(images, road)
        return self._predict(images, road)

    def _predict(self, images, road):
        """`predict` without the calibration: validation runs the trunk as
        the model stands (bf16 with the one-time message while uncalibrated
        at precision 8, as the JAX trainer's validation does)."""
        self.eval()
        b, ch = images.shape[0], self.predict_chunk
        if b <= ch:
            return self._detect(images, road)
        pad = (-b) % ch

        def padded(t):
            return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))]) if pad else t

        images = padded(images)
        road = None if road is None else padded(road)
        parts = [self._detect(images[i:i + ch], None if road is None else road[i:i + ch])
                 for i in range(0, b + pad, ch)]
        return {k: torch.cat([p[k] for p in parts])[:b] for k in parts[0]}

    @torch.no_grad()
    def host_val_metrics(self, batch, bmask):
        """Validation metrics of one batch, each a (value, weight) pair:
        `val_ats` (the box threat score of the detections over the score
        floor val_ats_score_thresh, against the ground truth in meters,
        averaged over the images that have boxes), `val_det_kept`
        (detections over the floor per image) and, with val_diag, the
        stage diagnostics. `bmask` [b] marks the real images of a padded
        batch. Empty when val_ats is off."""
        if not hp(self.hparams, "val_ats", True):
            return {}
        dets = self._predict(batch["images"], batch.get("road") if self.uses_roadmap else None)
        boxes_m = aabb_to_corners(_np(dets["boxes"]))  # [b, D, 2, 4]
        thr = hp(self.hparams, "val_ats_score_thresh", self.cfg.box_score_thresh)
        valid = _np(dets["valid"] & (dets["scores"] > thr))  # in the scores' dtype
        gt, gtv = _np(batch["boxes"]), _np(batch["box_valid"])
        bmask = _np(bmask).astype(bool)
        scores = []
        for j in range(min(len(bmask), len(gt))):
            if not bmask[j] or not gtv[j].any():
                continue
            scores.append(float(ats_bounding_boxes(boxes_m[j][valid[j]], gt[j][gtv[j]])))
        out = {"val_ats": (float(np.mean(scores)), float(len(scores)))} if scores else {}
        n_imgs = int(np.sum(bmask[:len(gt)]))
        if n_imgs:
            out["val_det_kept"] = (float(valid[:len(bmask)][bmask].sum(1).mean()), float(n_imgs))
        if hp(self.hparams, "val_diag", True):
            out.update(self._stage_diagnostics(batch, bmask))
        return out

    def _stage_diagnostics(self, batch, bmask):
        """val_rpn_recall (share of GT boxes that some valid post-NMS proposal
        matches at axis-aligned IoU >= 0.5), val_prop_cov (mean best proposal
        IoU per GT box) and val_cls_acc (on each GT's best proposal with IoU
        >= 0.5, argmax class posterior == its label); weights are GT box
        counts."""
        self.eval()
        bmask = _np(bmask).astype(bool)
        road = batch.get("road") if self.uses_roadmap else None
        d = self.head.forward_diag(self.backbone_features(batch["images"], road))
        rois = _np(d["rois"]).astype(np.float32)
        rv = _np(d["roi_valid"])
        cls = _np(d["cls"].float())
        gtb = corners_to_aabb(_np(batch["boxes"])).astype(np.float32)
        gtv = _np(batch["box_valid"])
        gtl = _np(batch["categories"]) + self.label_offset  # the classifier's label space
        rec, cov, acc = [], [], []
        for j in range(min(len(bmask), len(gtb))):
            if not bmask[j] or not gtv[j].any():
                continue
            g, labels, r = gtb[j][gtv[j]], gtl[j][gtv[j]], rois[j][rv[j]]
            if len(r) == 0:
                rec += [0.0] * len(g)
                cov += [0.0] * len(g)
                continue
            x0 = np.maximum(r[:, None, 0], g[None, :, 0])
            y0 = np.maximum(r[:, None, 1], g[None, :, 1])
            x1 = np.minimum(r[:, None, 2], g[None, :, 2])
            y1 = np.minimum(r[:, None, 3], g[None, :, 3])
            inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
            area_r = (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
            area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
            iou = inter / np.maximum(area_r[:, None] + area_g[None, :] - inter, 1e-9)
            best, bidx = iou.max(0), iou.argmax(0)
            rec += list((best >= 0.5).astype(np.float64))
            cov += list(best.astype(np.float64))
            pred = cls[j][rv[j]][bidx].argmax(-1)
            acc += [float(pred[i] == labels[i]) for i in range(len(g)) if best[i] >= 0.5]
        out = {}
        if rec:
            out["val_rpn_recall"] = (float(np.mean(rec)), float(len(rec)))
            out["val_prop_cov"] = (float(np.mean(cov)), float(len(cov)))
        if acc:
            out["val_cls_acc"] = (float(np.mean(acc)), float(len(acc)))
        return out

    # --- optimization (the learning rate is Task's: hp learning_rate, 1e-3)
    def freeze_mask(self, epoch: int):
        """The encoder frozen before unfreeze_epoch_no; the heads and
        mapper_cnn always train."""
        return encoder_freeze_mask(self, epoch)

    # --- CLI -------------------------------------------------------------
    @staticmethod
    def add_model_specific_args(parser):
        opt_list(parser, "--learning_rate", type=float, default=1e-3,
                 options=[1e-3, 1e-4, 1e-5], tunable=True)
        parser.add_argument("--batch_size", type=int, default=6)
        parser.add_argument("--unfreeze_epoch_no", type=int, default=10)
        parser.add_argument("--max_bb", type=int, default=100)
        parser.add_argument("--anchor_sizes", type=str, default="32,64,128,256,512",
                            help="comma-separated anchor sizes (px); the default is the reference's "
                                 "torchvision config")
        parser.add_argument("--anchor_ratios", type=str, default="0.5,1.0,2.0",
                            help="comma-separated anchor aspect ratios")
        parser.add_argument("--rpn_head_dilations", type=str, default="",
                            help="comma-separated dilations of extra RPN-head 3x3 convs (e.g. '4,8,16,32'); "
                                 "empty (default) = torchvision's single-conv head")
        parser.add_argument("--rpn_head_norm", type=int, default=0, choices=[0, 1],
                            help="per-cell RMS norm in the RPN head (0 = torchvision's head)")
        parser.add_argument("--rpn_pre_nms_top_n", type=int, default=2000)
        parser.add_argument("--exact_topk", type=int, default=0, choices=[0, 1],
                            help="accepted for the JAX package's configurations: the port always "
                                 "selects proposals and samples with exact top-k")
        parser.add_argument("--exact_topk_warmup_steps", type=int, default=500,
                            help="steps of the JAX package's exact-top-k warm-up (step_variant's key; "
                                 "the port is exact throughout; 0 disables)")
        parser.add_argument("--nms_fixed_depth", type=int, default=0,
                            help="N > 0: NMS as N straight suppression steps instead of the "
                                 "convergence-checked loop (exact for dependency chains < N)")
        parser.add_argument("--label_offset", type=int, default=0,
                            help="shift category ids by N for the classifier (1 = torchvision's "
                                 "background 0, classes 1..9; default 0 = the reference's labels, "
                                 "category 0 colliding with the background)")
        parser.add_argument("--rpn_post_nms_top_n", type=int, default=1000)
        parser.add_argument("--box_batch_per_image", type=int, default=512)
        parser.add_argument("--mse_loss", action="store_true", default=False)
        parser.add_argument("--val_ats", type=int, default=1, choices=[0, 1],
                            help="compute the box threat score (val_ats) during validation")
        parser.add_argument("--val_diag", type=int, default=1, choices=[0, 1],
                            help="log the stage diagnostics (val_rpn_recall, val_prop_cov, "
                                 "val_cls_acc) each validation epoch")
        parser.add_argument("--val_ats_score_thresh", type=float, default=0.05,
                            help="score floor of the detections entering val_ats (default: the "
                                 "eval pipeline's box_score_thresh)")
        add_labeled_data_args(parser)
        return parser


class FasterRCNNRoadMap(BBFasterRCNN):
    """faster_rcnn_rm: + the road map fused as a 4th input channel."""

    name = "faster_rcnn_rm"
    uses_roadmap = True

    @staticmethod
    def add_model_specific_args(parser):
        BBFasterRCNN.add_model_specific_args(parser)
        parser.set_defaults(output_img_freq=100)  # the reference's CLI default for this task
        tune(parser, "unfreeze_epoch_no", [0, 10])
        return parser

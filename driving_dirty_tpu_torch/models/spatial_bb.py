"""Spatial occupancy-map box tasks (driving_dirty_tpu/models/spatial_bb.py).

  BBSpatialModel   ("spatial_bb"): SpatialMappingCNN + the SSL encoder's c3
                   feature tap (a c3-only backbone) -> BoxesMergingCNN ->
                   [b, R, R] occupancy probabilities; targets are the boxes
                   rasterized by kernel B2; BCE (or MSE with `mse_loss`) on
                   probabilities.
  BBSpatialRoadMap ("spatial_rm"): adds the road map as an input branch
                   (RoadMapBoxesMergingCNN).

R is the geometry's raster size (800 at "reference"). Images are
[b, 6, H, W, 3] NHWC (uint8 or float), boxes [b, max_bb, 2, 4] meters with
box_valid [b, max_bb], road [b, 800, 800]. At precision 8 `predict`
calibrates the int8 trunk on its first batch
(models/precision.py:Int8TrunkMixin).

Training: `loss(batch, train=True, generator=...)` rasterizes the step's
targets (B2) and runs the trunk (B1, differentiable through
the op of kernels/trunk.py:trunk once the encoder trains). The c3-only
backbone has no dropout, so `generator` draws nothing here. `freeze_mask`
freezes the pretrained trunk before `unfreeze_epoch_no` (default 20; a 0
also reads as 20, as `hp(...) or 20` does in the JAX package).
`add_model_specific_args` gives the CLI's flags (cli/spatial_bb.py), plus
`--spatial_geometry`, the hparam both packages read, which the JAX CLIs
leave unexposed: "small" (64x78 views) keeps the same network for quick
runs. `param_sharding_rules` are the JAX package's: under a 'model' axis
the conv and transposed-conv weights of box_merge and space_map_cnn with
8k output channels are cut on them, with their biases, and run
column-parallel (nn/spatial.py); the 1-channel last stage and the encoder
stay whole on every rank.
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.cli.hyperopt import opt_list
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.kernels.raster import raster
from driving_dirty_tpu_torch.metrics.threat import ts_road_map
from driving_dirty_tpu_torch.models.labeled_data import LabeledDataMixin, add_labeled_data_args
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin, compute_dtype
from driving_dirty_tpu_torch.models.pretrained import encoder_freeze_mask, init_backbone, load_pretrained_ae
from driving_dirty_tpu_torch.nn.spatial import (
    GEOMETRIES,
    BoxesMergingCNN,
    RoadMapBoxesMergingCNN,
    SpatialMappingCNN,
)
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch
from driving_dirty_tpu_torch.parallel.collectives import batch_mean
from driving_dirty_tpu_torch.parallel.mesh import spec
from driving_dirty_tpu_torch.train.task import Task, hp


def _bce_probs(probs, target, eps=1e-7):
    """F.binary_cross_entropy on probabilities, mean reduction, written out
    as the JAX package writes it."""
    p = torch.clamp(probs, eps, 1 - eps)
    return -batch_mean(target * torch.log(p) + (1 - target) * torch.log1p(-p))


def box_targets(batch, size: int):
    """The batch's boxes as [b, size, size] {0,1} maps: kernel B2 on a CUDA
    tensor, its plain version on a CPU tensor."""
    return raster(batch["boxes"], batch["box_valid"], size)


def add_geometry_arg(parser):
    parser.add_argument("--spatial_geometry", type=str, default="reference", choices=sorted(GEOMETRIES),
                        help="spatial pipeline geometry: reference (256x306 views, 800-px rasters) "
                             "or small (64x78 views, 148/152-px rasters)")
    return parser


class BBSpatialModel(Int8TrunkMixin, LabeledDataMixin, Task, nn.Module):
    name = "spatial_bb"
    merge_cls = BoxesMergingCNN
    uses_roadmap = False

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        Task.__init__(self, hparams)
        h = self.hparams
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.compute_dtype = compute_dtype(hp(h, "precision", 32))
        self.batch_size = hp(h, "batch_size", 16)
        self.mse_loss = hp(h, "mse_loss", False)
        self.unfreeze_epoch_no = hp(h, "unfreeze_epoch_no", 20) or 20
        self.ae, ae_weights = load_pretrained_ae(h)
        self.geometry = hp(h, "spatial_geometry", "reference")
        # c3_only: this backbone taps the conv feature map only
        self.encoder = init_backbone(self.ae, ae_weights, c3_only=True, **kw)
        self.space_map_cnn = SpatialMappingCNN(self.geometry, **kw)
        self.box_merge = self.merge_cls(self.geometry, **kw)
        self.raster_size = self.box_merge.raster_size

    def forward(self, images, road=None):
        """[b, 6, H, W, C] (+ road [b, 800, 800]) -> occupancy probabilities
        [b, R, R] f32 (losses and metrics in f32)."""
        images = normalize_images(images, self.compute_dtype)
        spatial = self.space_map_cnn(images)
        ssr = self.encoder(wide_stitch(images), c3_only=True, **self.enc_int8_kwargs(self.training))
        if self.uses_roadmap:
            probs = self.box_merge(ssr, spatial, road[..., None].to(spatial.dtype))
        else:
            probs = self.box_merge(ssr, spatial)
        return probs[..., 0].float()

    @torch.no_grad()
    def calibrate_int8(self, images):
        """One-time int8 activation-scale calibration (precision 8 only); the
        trunk input is the stitched panorama."""
        if not self.int8_trunk or self._int8_scales is not None:
            return
        self.calibrate_int8_on(self.encoder, wide_stitch(normalize_images(images, self.compute_dtype)))

    @torch.no_grad()
    def predict(self, images, road=None):
        """Inference entry: -> occupancy probabilities [b, R, R] (not a
        thresholded mask: callers pick their operating point). Eval mode;
        calibrates the int8 scales first at precision 8."""
        self.eval()
        self.calibrate_int8(images)
        return self(images, road if self.uses_roadmap else None)

    def _targets(self, batch):
        return box_targets(batch, self.raster_size)

    def _loss(self, probs, target):
        if self.mse_loss:
            return batch_mean((probs - target) ** 2)
        return _bce_probs(probs, target)

    def loss(self, batch, *, train: bool, generator=None):
        self.train(train)
        target = self._targets(batch)
        probs = self(batch["images"], batch["road"] if self.uses_roadmap else None)
        return self._loss(probs, target), {}

    @torch.no_grad()
    def val_metrics(self, batch, generator=None):
        """Eval loss and the threat score of the rounded prediction against
        the rasterized boxes."""
        self.eval()
        target = self._targets(batch)
        probs = self(batch["images"], batch["road"] if self.uses_roadmap else None)
        return {
            "val_loss": self._loss(probs, target),
            "val_ts_boxes": ts_road_map(target, torch.round(probs)),
        }

    def freeze_mask(self, epoch: int):
        return encoder_freeze_mask(self, epoch)

    def param_sharding_rules(self, path, leaf):
        """The JAX package's rules, on its paths and layouts: a conv or
        transposed-conv weight of the heads (HWIO, [kh, kw, in, out]) is cut
        on its output channels when they are a multiple of 8, and its bias
        alike; the 1-channel last stage and the encoder replicate."""
        if path[0] in ("box_merge", "space_map_cnn"):
            if path[-1] == "w" and leaf.ndim == 4 and leaf.shape[-1] % 8 == 0:
                return spec(None, None, None, "model")
            if path[-1] == "b" and leaf.ndim == 1 and leaf.shape[0] % 8 == 0:
                return spec("model")
        return None

    @torch.no_grad()
    def log_images(self, batch, step_name: str, generator=None):
        """The first scene's stitched input, its rasterized boxes and the
        predicted occupancy probabilities, in eval mode (the reference's
        spatial_model.py:126-134)."""
        self.eval()
        first = {k: v[:1] for k, v in batch.items()}
        probs = self(first["images"], first["road"] if self.uses_roadmap else None)
        target = self._targets(first)
        return {
            f"{step_name}_input_images": normalize_images(wide_stitch(first["images"]), torch.float32)[0].clamp(0, 1),
            f"{step_name}_target_bbs": target[0][..., None],
            f"{step_name}_pred_bbs": probs[0][..., None],
        }

    @staticmethod
    def add_model_specific_args(parser):
        opt_list(parser, "--learning_rate", type=float, default=1e-3,
                 options=[1e-3, 1e-4, 1e-5], tunable=True)
        parser.add_argument("--batch_size", type=int, default=16)
        parser.add_argument("--unfreeze_epoch_no", type=int, default=20)
        parser.add_argument("--mse_loss", action="store_true", default=False)
        parser.add_argument("--max_bb", type=int, default=100)
        add_labeled_data_args(parser)
        return add_geometry_arg(parser)


class BBSpatialRoadMap(BBSpatialModel):
    """spatial_rm: + the road map as an input branch."""

    name = "spatial_rm"
    merge_cls = RoadMapBoxesMergingCNN
    uses_roadmap = True

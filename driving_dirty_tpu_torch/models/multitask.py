"""Joint multi-task model: one shared SSL encoder pass -> roadmap and
box-occupancy heads (driving_dirty_tpu/models/multitask.py; BASELINE.json
config 5).

The encoder runs once per batch (`with_c3`): its latent feeds the roadmap
head (Linear latent -> 640000, 800x800 logits), its c3 feature map feeds
the spatial box pipeline (SpatialMappingCNN + BoxesMergingCNN). Box targets
are rasterized by kernel B2. At precision 8 `predict` calibrates the
int8 trunk on its first batch (models/precision.py:Int8TrunkMixin).

Training: `loss(batch, train=True, generator=...)` -> the roadmap BCE plus
`box_loss_weight` times the box BCE, with `rm_loss` and `box_loss` as its
metrics; the encoder's dropout draws from `generator`. c3 feeds both heads,
so once the encoder trains, autograd adds the two gradients into the one
trunk output of the op of kernels/trunk.py:trunk. `freeze_mask` freezes the
pretrained encoder before `unfreeze_epoch_no` (default 20; a 0 also reads
as 20, as in the JAX package). The JAX package's `remat` hparam
(jax.checkpoint over the encoder) has no separate counterpart: the trunk's
backward already recomputes the plain trunk, and the CLI accepts `--remat`
(cli/common.py). The sharding rules wait for multi-device training
(ROADMAP A.12).
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.cli.hyperopt import opt_list
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.metrics.threat import ts_road_map
from driving_dirty_tpu_torch.models.labeled_data import LabeledDataMixin, add_labeled_data_args
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin, compute_dtype
from driving_dirty_tpu_torch.models.pretrained import encoder_freeze_mask, init_backbone, load_pretrained_ae
from driving_dirty_tpu_torch.models.roadmap import MAP_PIXELS, RoadMapBCE
from driving_dirty_tpu_torch.models.spatial_bb import _bce_probs, add_geometry_arg, box_targets
from driving_dirty_tpu_torch.nn.spatial import BoxesMergingCNN, SpatialMappingCNN
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch
from driving_dirty_tpu_torch.train.task import Task, hp


class MultiTask(Int8TrunkMixin, LabeledDataMixin, Task, nn.Module):
    name = "multitask"

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        Task.__init__(self, hparams)
        h = self.hparams
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.compute_dtype = compute_dtype(hp(h, "precision", 32))
        self.batch_size = hp(h, "batch_size", 16)
        self.box_loss_weight = hp(h, "box_loss_weight", 1.0)
        self.unfreeze_epoch_no = hp(h, "unfreeze_epoch_no", 20) or 20
        self.ae, ae_weights = load_pretrained_ae(h)
        self.latent_dim = self.ae.latent_dim
        self.encoder = init_backbone(self.ae, ae_weights, **kw)
        self.rm_head = L.Linear(self.latent_dim, MAP_PIXELS, **kw)
        # "small" geometry shrinks the box pipeline; the roadmap head stays 800x800
        self.geometry = hp(h, "spatial_geometry", "reference")
        self.space_map_cnn = SpatialMappingCNN(self.geometry, **kw)
        self.box_merge = BoxesMergingCNN(self.geometry, **kw)
        self.raster_size = self.box_merge.raster_size

    def forward(self, images, generator=None):
        """-> (rm_logits [b, 800, 800], box_probs [b, R, R]), both f32, from one
        encoder pass (the conv trunk runs once). In training mode the
        encoder's dropout draws from `generator`."""
        images = normalize_images(images, self.compute_dtype)
        z, ssr = self.encoder(wide_stitch(images), with_c3=True, generator=generator,
                              **self.enc_int8_kwargs(self.training))
        rm_logits = self.rm_head(z).reshape(z.shape[0], 800, 800).float()
        # the box head runs in the compute dtype; only its output is promoted
        spatial = self.space_map_cnn(images)
        box_probs = self.box_merge(ssr, spatial)[..., 0].float()
        return rm_logits, box_probs

    @torch.no_grad()
    def calibrate_int8(self, images):
        """One-time int8 activation-scale calibration (precision 8 only); the
        trunk input is the stitched panorama."""
        if not self.int8_trunk or self._int8_scales is not None:
            return
        self.calibrate_int8_on(self.encoder, wide_stitch(normalize_images(images, self.compute_dtype)))

    @torch.no_grad()
    def predict(self, images):
        """Inference entry: -> {"road_mask": [b, 800, 800] binary f32 (logits
        > 0), "box_occupancy": [b, R, R] probabilities}, one encoder pass;
        calibrates the int8 scales first at precision 8."""
        self.eval()
        self.calibrate_int8(images)
        rm_logits, box_probs = self(images)
        return {"road_mask": (rm_logits > 0).float(), "box_occupancy": box_probs}

    def _box_targets(self, batch):
        return box_targets(batch, self.raster_size)

    def _losses(self, batch, generator=None):
        rm_logits, box_probs = self(batch["images"], generator)
        box_t = self._box_targets(batch)
        rm_loss = RoadMapBCE._bce(rm_logits, batch["road"])
        box_loss = _bce_probs(box_probs, box_t)
        return rm_logits, box_probs, box_t, rm_loss, box_loss

    def loss(self, batch, *, train: bool, generator=None):
        self.train(train)
        _, _, _, rm_loss, box_loss = self._losses(batch, generator)
        return rm_loss + self.box_loss_weight * box_loss, {"rm_loss": rm_loss, "box_loss": box_loss}

    @torch.no_grad()
    def val_metrics(self, batch, generator=None):
        self.eval()
        rm_logits, box_probs, box_t, rm_loss, box_loss = self._losses(batch)
        return {
            "val_loss": rm_loss + self.box_loss_weight * box_loss,
            "val_rm_ts_rounded": ts_road_map(batch["road"], (rm_logits > 0).float()),
            "val_box_loss": box_loss,
            "val_ts_boxes": ts_road_map(box_t, torch.round(box_probs)),
        }

    def freeze_mask(self, epoch: int):
        return encoder_freeze_mask(self, epoch)

    @staticmethod
    def add_model_specific_args(parser):
        opt_list(parser, "--learning_rate", type=float, default=1e-3,
                 options=[1e-3, 1e-4], tunable=True)
        parser.add_argument("--batch_size", type=int, default=16)
        parser.add_argument("--unfreeze_epoch_no", type=int, default=20)
        opt_list(parser, "--box_loss_weight", type=float, default=1.0,
                 options=[0.5, 1.0, 2.0], tunable=True)
        parser.add_argument("--max_bb", type=int, default=100)
        add_labeled_data_args(parser)
        return add_geometry_arg(parser)

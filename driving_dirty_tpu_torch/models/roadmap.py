"""Roadmap prediction: pretrained encoder + Linear head -> 800x800 logits
(driving_dirty_tpu/models/roadmap.py).

  RoadMap      ("roadmap_mse"): sigmoid + MSE.
  RoadMapBCE   ("roadmap_bce_v1"): BCE-with-logits; val TS on *raw logits*
               (the reference's quirk, roadmap_bce_loss.py:141-142).
  RoadMapBCEv2 ("roadmap_bce", the registry default): BCE-with-logits, TS on
               the sigmoid output.

Images are [b, 6, H, W, 3] NHWC (uint8 or float), masks [b, 800, 800].
`loss(batch, train=True, generator=...)` is the training loss, the encoder's
dropout drawn from `generator`. `freeze_mask` (applied by the Task's
`apply_freeze_mask`) freezes the pretrained encoder before
`unfreeze_epoch_no` (30 for roadmap_mse and roadmap_bce_v1, 0 for
roadmap_bce unless the hparam says otherwise). roadmap_bce lowers its LR on
a plateau (patience 10, factor 0.1). `param_sharding_rules` are the JAX
package's: under a mesh with a 'model' axis the head's fc1 runs
column-parallel and the encoder's fc1.fc row-parallel
(parallel/mesh.py:shard_module). The labeled loaders come from
models/labeled_data.py, the CLI flags from `add_model_specific_args`.

At precision 8 the encoder trunk runs in static-scale int8 at inference
(models/precision.py:Int8TrunkMixin): `predict` calibrates the scales on
its first batch (`calibrate_int8`), and later calls launch kernel B1-int8.
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.cli.hyperopt import tune
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.metrics.threat import ts_road_map
from driving_dirty_tpu_torch.models.labeled_data import LabeledDataMixin, add_labeled_data_args
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin, compute_dtype
from driving_dirty_tpu_torch.models.pretrained import encoder_freeze_mask, init_backbone, load_pretrained_ae
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch
from driving_dirty_tpu_torch.parallel.collectives import batch_mean
from driving_dirty_tpu_torch.parallel.mesh import spec
from driving_dirty_tpu_torch.train.task import Task, hp

MAP_PIXELS = 800 * 800


class RoadMapBase(Int8TrunkMixin, LabeledDataMixin, Task, nn.Module):
    name = "roadmap_base"
    unfreeze_default = 30  # hard-coded in mse / bce-v1 (roadmap_pretrain_ae.py:131)

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        Task.__init__(self, hparams)
        h = self.hparams
        device = resolve_device(device)
        self.batch_size = hp(h, "batch_size", 16)
        self.compute_dtype = compute_dtype(hp(h, "precision", 32))
        self.ae, ae_weights = load_pretrained_ae(h)
        self.latent_dim = self.ae.latent_dim
        self.encoder = init_backbone(self.ae, ae_weights, device=device, generator=generator)
        self.fc1 = L.Linear(self.latent_dim, MAP_PIXELS, device=device, generator=generator)
        ue = hp(h, "unfreeze_epoch_no", None)
        self.unfreeze_epoch_no = self.unfreeze_default if ue is None else ue

    def forward(self, images, generator=None):
        """[b, 6, H, W, C] -> (logits [b, 800, 800] f32, probs).

        Stitching runs before the /255 (it only moves pixels), so the copy
        moves uint8 bytes. In training mode the encoder's dropout draws from
        `generator`; in eval mode at precision 8 the trunk runs int8 once
        calibrated."""
        x = normalize_images(wide_stitch(images), self.compute_dtype)
        z = self.encoder(x, generator=generator, **self.enc_int8_kwargs(self.training))
        logits = self.fc1(z).reshape(z.shape[0], 800, 800).float()  # losses/metrics in f32
        return logits, torch.sigmoid(logits)

    @torch.no_grad()
    def calibrate_int8(self, images):
        """One-time int8 activation-scale calibration (precision 8 only), on
        the stitched panorama exactly as `forward` builds it."""
        if not self.int8_trunk or self._int8_scales is not None:
            return
        x = normalize_images(wide_stitch(images), self.compute_dtype)
        self.calibrate_int8_on(self.encoder, x)

    @torch.no_grad()
    def predict(self, images):
        """Inference entry: -> binary [b, 800, 800] f32 mask. Thresholds raw
        logits at 0 (== sigmoid > 0.5). Runs in eval mode; at precision 8 it
        calibrates the int8 scales on its first call."""
        self.eval()
        self.calibrate_int8(images)
        logits, _ = self(images)
        return (logits > 0).float()

    def freeze_mask(self, epoch: int):
        """None (everything trains) from `unfreeze_epoch_no` on; before it
        {parameter name: trainable}, False for the encoder's parameters."""
        return encoder_freeze_mask(self, epoch)

    def param_sharding_rules(self, path, leaf):
        """The JAX package's rules, on its paths and layouts: the head's
        output dimension (fc1 w [latent, 640000] and b) and the encoder fc1's
        input dimension (w [940032, hidden]) over 'model'; the rest
        replicates."""
        if path[:2] == ("fc1", "w"):
            return spec(None, "model")
        if path[:2] == ("fc1", "b"):
            return spec("model")
        if path[:4] == ("encoder", "fc1", "fc", "w"):
            return spec("model", None)
        return None

    @torch.no_grad()
    def log_images(self, batch, step_name: str, generator=None):
        """The first scene's stitched input and its target and predicted
        (rounded) road maps, in eval mode (the reference's _log_rm_images
        triptych, roadmap_bce_v2.py:110-123)."""
        self.eval()
        x = batch["images"][:1]
        _, probs = self(x)
        return {
            f"{step_name}_input_images": normalize_images(wide_stitch(x), torch.float32)[0].clamp(0, 1),
            f"{step_name}_target_roadmaps": batch["road"][0][..., None],
            f"{step_name}_pred_roadmaps": torch.round(probs[0])[..., None],
        }

    @staticmethod
    def add_model_specific_args(parser):
        parser.add_argument("--learning_rate", type=float, default=1e-3)
        parser.add_argument("--batch_size", type=int, default=16)
        parser.add_argument("--unfreeze_epoch_no", type=int, default=None)
        add_labeled_data_args(parser)
        return parser


class RoadMap(RoadMapBase):
    """MSE on sigmoid probabilities."""

    name = "roadmap_mse"

    @staticmethod
    def add_model_specific_args(parser):
        RoadMapBase.add_model_specific_args(parser)
        tune(parser, "learning_rate", [1e-3, 1e-4, 1e-5])
        return parser

    def loss(self, batch, *, train: bool, generator=None):
        self.train(train)
        _, probs = self(batch["images"], generator)
        return batch_mean((batch["road"] - probs) ** 2), {}

    @torch.no_grad()
    def val_metrics(self, batch, generator=None):
        self.eval()
        _, probs = self(batch["images"])
        target = batch["road"]
        return {
            "val_loss": torch.mean((target - probs) ** 2),
            "val_ts": ts_road_map(target, probs),
            "val_ts_rounded": ts_road_map(target, torch.round(probs)),
        }


class RoadMapBCE(RoadMapBase):
    """BCE-with-logits; v1 quirk: TS computed on raw logits."""

    name = "roadmap_bce_v1"
    ts_on_logits = True

    @staticmethod
    def _bce(logits, target):
        # F.binary_cross_entropy_with_logits, mean reduction, written out as
        # the JAX package writes it
        return batch_mean(torch.clamp(logits, min=0) - logits * target
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    def loss(self, batch, *, train: bool, generator=None):
        self.train(train)
        logits, _ = self(batch["images"], generator)
        return self._bce(logits, batch["road"]), {}

    @torch.no_grad()
    def val_metrics(self, batch, generator=None):
        self.eval()
        logits, probs = self(batch["images"])
        target = batch["road"]
        scored = logits if self.ts_on_logits else probs
        return {
            "val_loss": self._bce(logits, target),
            "val_ts": ts_road_map(target, scored),
            "val_ts_rounded": ts_road_map(target, torch.round(scored)),
        }


class RoadMapBCEv2(RoadMapBCE):
    """Registry default 'roadmap_bce': TS on the sigmoid output."""

    name = "roadmap_bce"
    ts_on_logits = False
    unfreeze_default = 0  # CLI default (roadmap_bce_v2.py:211)

    @staticmethod
    def add_model_specific_args(parser):
        RoadMapBase.add_model_specific_args(parser)
        tune(parser, "unfreeze_epoch_no", [0, 20])  # the v2 grid (roadmap_bce_v2.py:211)
        return parser

    def lr_schedule(self):
        return {"plateau_patience": 10, "factor": 0.1}

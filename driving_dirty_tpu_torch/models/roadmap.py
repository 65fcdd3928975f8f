"""Roadmap prediction: pretrained encoder + Linear head -> 800x800 logits
(driving_dirty_tpu/models/roadmap.py).

  RoadMap      ("roadmap_mse"): sigmoid + MSE.
  RoadMapBCE   ("roadmap_bce_v1"): BCE-with-logits; val TS on *raw logits*
               (the reference's quirk, roadmap_bce_loss.py:141-142).
  RoadMapBCEv2 ("roadmap_bce", the registry default): BCE-with-logits, TS on
               the sigmoid output.

Images are [b, 6, H, W, 3] NHWC (uint8 or float), masks [b, 800, 800].
Freezing, the LR schedule and image logging come with training.
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.metrics.threat import ts_road_map
from driving_dirty_tpu_torch.models.precision import compute_dtype
from driving_dirty_tpu_torch.models.pretrained import init_backbone, load_pretrained_ae
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch
from driving_dirty_tpu_torch.train.task import Task, hp

MAP_PIXELS = 800 * 800


class RoadMapBase(Task, nn.Module):
    name = "roadmap_base"

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        Task.__init__(self, hparams)
        h = self.hparams
        device = resolve_device(device)
        self.compute_dtype = compute_dtype(hp(h, "precision", 32))
        self.ae, ae_weights = load_pretrained_ae(h)
        self.latent_dim = self.ae.latent_dim
        self.encoder = init_backbone(self.ae, ae_weights, device=device, generator=generator)
        self.fc1 = L.Linear(self.latent_dim, MAP_PIXELS, device=device, generator=generator)

    def forward(self, images):
        """[b, 6, H, W, C] -> (logits [b, 800, 800] f32, probs).

        Stitching runs before the /255 (it only moves pixels), so the copy
        moves uint8 bytes."""
        x = normalize_images(wide_stitch(images), self.compute_dtype)
        z = self.encoder(x)
        logits = self.fc1(z).reshape(z.shape[0], 800, 800).float()  # losses/metrics in f32
        return logits, torch.sigmoid(logits)

    @torch.no_grad()
    def predict(self, images):
        """Inference entry: -> binary [b, 800, 800] f32 mask. Thresholds raw
        logits at 0 (== sigmoid > 0.5). Runs in eval mode."""
        self.eval()
        logits, _ = self(images)
        return (logits > 0).float()


class RoadMap(RoadMapBase):
    """MSE on sigmoid probabilities."""

    name = "roadmap_mse"

    def loss(self, batch, *, train: bool):
        self.train(train)
        _, probs = self(batch["images"])
        return torch.mean((batch["road"] - probs) ** 2), {}

    @torch.no_grad()
    def val_metrics(self, batch):
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
        return torch.mean(torch.clamp(logits, min=0) - logits * target
                          + torch.log1p(torch.exp(-torch.abs(logits))))

    def loss(self, batch, *, train: bool):
        self.train(train)
        logits, _ = self(batch["images"])
        return self._bce(logits, batch["road"]), {}

    @torch.no_grad()
    def val_metrics(self, batch):
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

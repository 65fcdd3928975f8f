"""Coordinate-regression MLP box task "Boxes" (driving_dirty_tpu/models/
bb_mlp.py, the reference's bb_coord_reg/bb_MLP.py).

The pretrained encoder's latent -> Linear(latent, max_bb * 4) -> ReLU ->
Linear(-> max_bb * 8), reshaped to [b, max_bb, 2, 4] box corners in
meters. The loss is the MSE against the zero-padded boxes, in f32,
padding rows included: regressing them toward zero is the training signal
the reference model sees (bb_MLP.py:135). Boxes never rasterizes, so
kernel B2 is not on its path; the encoder's trunk is kernel B1 on the card.

`loss(batch, train=True, generator=...)` draws the encoder's dropout from
`generator`; validation is the eval-mode loss (train/task.py). The encoder
is frozen before `unfreeze_epoch_no` (default 20; a 0 also reads as 20, as
in the JAX package). At precision 8 it trains in bf16, and, never
calibrated, evaluates in bf16 after a one-time message
(models/precision.py:Int8TrunkMixin). There is no `predict`: the JAX
class has none.
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.cli.hyperopt import opt_list
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.models.labeled_data import LabeledDataMixin, add_labeled_data_args
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin, compute_dtype
from driving_dirty_tpu_torch.models.pretrained import encoder_freeze_mask, init_backbone, load_pretrained_ae
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch
from driving_dirty_tpu_torch.parallel.collectives import batch_mean
from driving_dirty_tpu_torch.train.task import Task, hp


class Boxes(Int8TrunkMixin, LabeledDataMixin, Task, nn.Module):
    name = "bb_mlp"

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        Task.__init__(self, hparams)
        h = self.hparams
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.compute_dtype = compute_dtype(hp(h, "precision", 32))
        self.batch_size = hp(h, "batch_size", 16)
        self.max_bb = hp(h, "max_bb", 100)
        self.unfreeze_epoch_no = hp(h, "unfreeze_epoch_no", 20) or 20
        self.ae, ae_weights = load_pretrained_ae(h)
        self.encoder = init_backbone(self.ae, ae_weights, **kw)
        self.output_dim = self.max_bb * 8
        self.fc1 = L.Linear(self.ae.latent_dim, self.output_dim // 2, **kw)
        self.fc2 = L.Linear(self.output_dim // 2, self.output_dim, **kw)

    def forward(self, images, generator=None):
        """[b, 6, H, W, C] -> box corners [b, max_bb, 2, 4] f32 (the loss is
        taken in f32)."""
        x = normalize_images(wide_stitch(images), self.compute_dtype)
        z = self.encoder(x, generator=generator, **self.enc_int8_kwargs(self.training))
        y = self.fc2(torch.relu(self.fc1(z))).float()
        return y.reshape(y.shape[0], self.max_bb, 2, 4)

    def loss(self, batch, *, train: bool, generator=None):
        self.train(train)
        pred = self(batch["images"], generator)
        return batch_mean((batch["boxes"] - pred) ** 2), {}

    def freeze_mask(self, epoch: int):
        return encoder_freeze_mask(self, epoch)

    @staticmethod
    def add_model_specific_args(parser):
        opt_list(parser, "--learning_rate", type=float, default=1e-3,
                 options=[1e-3, 1e-4, 1e-5], tunable=True)
        parser.add_argument("--batch_size", type=int, default=16)
        parser.add_argument("--max_bb", type=int, default=100)
        parser.add_argument("--unfreeze_epoch_no", type=int, default=20)
        add_labeled_data_args(parser)
        return parser

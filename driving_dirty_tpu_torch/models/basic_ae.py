"""BasicAE: the six-to-one infill pretext task
(driving_dirty_tpu/models/basic_ae.py).

Stitch the six camera views into a 256 x 1836 panorama, black out one
306-wide view column, and reconstruct it through Encoder -> latent ->
Decoder, with the MSE in f32 as the loss. The never-mask-position-5 quirk is
kept; `mask_all_six` masks any position. The constructor's fallbacks
(hidden 128, latent 128) are the JAX package's.

The masked view and the DenseBlocks' dropout come from the `generator`
given to `forward` / `loss` (or an explicit `view`), so two runs fed the
same generator state draw the same. The encoder's conv trunk is kernel B1
on the card; under autograd its backward recomputes the plain trunk, which
is also the step's remat of the encoder (the JAX package wraps the encoder
in jax.checkpoint). Downstream models take only the encoder
(`build_encoder`, models/pretrained.py). `cache_dir` wraps the datasets in
the decode-once sample cache (data/cache.py); `add_model_specific_args`
gives the CLI's flags, whose defaults (hidden 256) differ from the
constructor's. At precision 8 BasicAE trains in bf16 and, never
calibrated, evaluates in bf16 after a one-time message, as the JAX
package's does (models/precision.py:Int8TrunkMixin).
"""
from __future__ import annotations

import os

import torch
from torch import nn

from driving_dirty_tpu_torch.cli.hyperopt import opt_list
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.data.cache import SampleCache
from driving_dirty_tpu_torch.data.dataset import (
    NUM_SAMPLE_PER_SCENE,
    UNLABELED_SCENES,
    UnlabeledDataset,
    scene_split,
)
from driving_dirty_tpu_torch.data.pipeline import Loader
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin, compute_dtype
from driving_dirty_tpu_torch.nn.autoencoder import Decoder, Encoder
from driving_dirty_tpu_torch.ops.stitch import normalize_images, six_to_one_task
from driving_dirty_tpu_torch.parallel.collectives import batch_mean
from driving_dirty_tpu_torch.train.task import Task, hp


class AEConfig(Task):
    """BasicAE's hparams and the Encoder they describe, without weights:
    what a downstream model reads from a pretrained checkpoint
    (models/pretrained.py)."""

    name = "basic_ae"

    def __init__(self, hparams=None):
        super().__init__(hparams)
        h = self.hparams
        self.hidden_dim = hp(h, "hidden_dim", 128)
        self.latent_dim = hp(h, "latent_dim", 128)
        self.input_width = hp(h, "input_width", 306 * 6)
        self.input_height = hp(h, "input_height", 256)
        self.output_width = hp(h, "output_width", 306)
        self.output_height = hp(h, "output_height", 256)
        self.batch_size = hp(h, "batch_size", 16)
        self.in_channels = hp(h, "in_channels", 3)
        self.mask_all_six = hp(h, "mask_all_six", False)

    def build_encoder(self, *, dense: bool = True, device=None, generator=None) -> Encoder:
        return Encoder(self.hidden_dim, self.latent_dim, self.in_channels,
                       self.input_height, self.input_width, dense=dense,
                       device=device, generator=generator)


class BasicAE(Int8TrunkMixin, AEConfig, nn.Module):
    """The trainable pretext model: encoder and decoder on `device`
    (default cuda), initialized from `generator`."""

    def __init__(self, hparams=None, *, device=None, generator=None):
        nn.Module.__init__(self)
        AEConfig.__init__(self, hparams)
        kw = dict(device=resolve_device(device), generator=generator)
        self.encoder = self.build_encoder(**kw)
        self.decoder = Decoder(self.hidden_dim, self.latent_dim, self.in_channels,
                               self.output_height, self.output_width, **kw)

    # --- model -----------------------------------------------------------
    def forward(self, images, view=None, generator=None):
        """[b, 6, H, W, C] views (uint8 or float) -> (y_hat, y), both
        [b, H, W, C] in the compute dtype: the reconstruction and the
        blacked-out column. `view` as six_to_one_task takes it; None draws
        it from `generator`, which then also drives the dropout."""
        dtype = compute_dtype(hp(self.hparams, "precision", 32))
        x_masked, y = six_to_one_task(images, view, generator=generator,
                                      num_maskable=6 if self.mask_all_six else 5)
        z = self.encoder(normalize_images(x_masked, dtype), generator=generator,
                         **self.enc_int8_kwargs(self.training))
        return self.decoder(z, generator), normalize_images(y, dtype)

    def loss(self, batch, *, train: bool, view=None, generator=None):
        """-> (MSE of the reconstruction in f32, {}); the mode follows `train`
        (BatchNorm batch statistics and dropout when training)."""
        self.train(train)
        images = batch["images"] if isinstance(batch, dict) else batch
        y_hat, y = self(images, view, generator)
        return batch_mean((y.float() - y_hat.float()) ** 2), {}

    # --- data ------------------------------------------------------------
    def _datasets(self):
        h = self.hparams
        link = hp(h, "link", None)
        sps = hp(h, "samples_per_scene", NUM_SAMPLE_PER_SCENE)
        n_scenes = hp(h, "num_unlabeled_scenes", len(UNLABELED_SCENES))
        train_idx, val_idx = scene_split(UNLABELED_SCENES[:n_scenes], seed=hp(h, "seed", 20200505))

        cache_dir = hp(h, "cache_dir", None)

        def mk(idx):
            ds = UnlabeledDataset(link, idx, "sample", samples_per_scene=sps,
                                  raw_uint8=bool(hp(h, "uint8_pipeline", True)))
            return SampleCache(ds, cache_dir) if cache_dir else ds

        return mk(train_idx), mk(val_idx)

    def _num_workers(self):
        # the reference hardcodes 4; this scales with the host, capped
        return hp(self.hparams, "num_workers", None) or min(48, 4 * (os.cpu_count() or 4))

    def train_loader(self):
        tr, _ = self._datasets()
        return Loader(tr, self.batch_size, shuffle=True,
                      num_workers=self._num_workers(), drop_last=True)

    def val_loader(self):
        _, va = self._datasets()
        return Loader(va, self.batch_size, shuffle=False, num_workers=self._num_workers())

    # --- logging ---------------------------------------------------------
    @torch.no_grad()
    def log_images(self, batch, step_name: str, generator=None, view=None):
        """The first scene's reconstruction (clipped to [0, 1]) and target,
        in eval mode: {"<step_name>_predicted_images", "<step_name>_target_images"},
        [H, W, C] each."""
        self.eval()
        images = batch["images"] if isinstance(batch, dict) else batch
        y_hat, y = self(images[:1], view, generator)
        return {f"{step_name}_predicted_images": y_hat[0].clamp(0, 1),
                f"{step_name}_target_images": y[0]}

    # --- CLI -------------------------------------------------------------
    @staticmethod
    def add_model_specific_args(parser):
        # flags and defaults of the reference's autoencoder.py:161-182 (the
        # CLI's hidden_dim 256 differs from the constructor's 128); the
        # tunable grid dimensions are declared in place, test-tube style
        parser.add_argument("--hidden_dim", type=int, default=256)
        opt_list(parser, "--latent_dim", type=int, default=128, options=[64, 128], tunable=True)
        opt_list(parser, "--learning_rate", type=float, default=1e-3,
                 options=[1e-3, 1e-4, 1e-5], tunable=True)
        parser.add_argument("--batch_size", type=int, default=16)
        parser.add_argument("--input_width", type=int, default=306 * 6)
        parser.add_argument("--input_height", type=int, default=256)
        parser.add_argument("--output_width", type=int, default=306)
        parser.add_argument("--output_height", type=int, default=256)
        parser.add_argument("--in_channels", type=int, default=3)
        parser.add_argument("--link", type=str, default="/scratch/ab8690/DLSP20Dataset/data")
        parser.add_argument("--output_img_freq", type=int, default=500)
        parser.add_argument("--samples_per_scene", type=int, default=NUM_SAMPLE_PER_SCENE)
        parser.add_argument("--num_unlabeled_scenes", type=int, default=len(UNLABELED_SCENES))
        parser.add_argument("--cache_dir", type=str, default=None,
                            help="decode-once sample cache directory (data/cache.py)")
        return parser

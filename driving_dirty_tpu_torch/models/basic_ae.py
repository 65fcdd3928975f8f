"""BasicAE hparams and the Encoder they describe
(driving_dirty_tpu/models/basic_ae.py:39-57).

The six-to-one pretext forward, the Decoder and the loss come with the
training slice; downstream models need only the encoder.
"""
from __future__ import annotations

from driving_dirty_tpu_torch.nn.autoencoder import Encoder
from driving_dirty_tpu_torch.train.task import Task, hp


class BasicAE(Task):
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

    def build_encoder(self, *, dense: bool = True, device=None, generator=None) -> Encoder:
        return Encoder(self.hidden_dim, self.latent_dim, self.in_channels,
                       self.input_height, self.input_width, dense=dense,
                       device=device, generator=generator)

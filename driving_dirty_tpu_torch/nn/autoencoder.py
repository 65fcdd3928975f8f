"""Autoencoder components (driving_dirty_tpu/nn/autoencoder.py): DenseBlock
and Encoder. The Decoder comes with training.

Architecture as in the reference (its src/autoencoder/
components.py:6-52): conv trunk c1 -> c2 -> c3, flatten in NCHW order,
max-pool(4) over the flat vector, two DenseBlocks, Linear to the latent.
The trunk is kernels/trunk.py: the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor.
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.kernels.trunk import C as TRUNK_C
from driving_dirty_tpu_torch.kernels.trunk import out_hw, trunk


class DenseBlock(nn.Module):
    """Linear -> BatchNorm -> ReLU -> Dropout(p)."""

    def __init__(self, in_dim: int, out_dim: int, drop_p: float = 0.2, *,
                 device=None, generator=None):
        super().__init__()
        self.drop_p = drop_p
        self.fc = L.Linear(in_dim, out_dim, device=device, generator=generator)
        self.bn = L.BatchNorm(out_dim, device=device)

    def forward(self, x):
        x = torch.relu(self.bn(self.fc(x)))
        return L.dropout(x, self.drop_p, self.training)


class Encoder(nn.Module):
    """[b, H, W, C] NHWC -> latent [b, latent_dim]; `c3_only` returns the c3
    feature map [b, (H+1)//2, (W+1)//2, 32] (the backbone tap), `with_c3`
    returns (z, c3) from one trunk pass."""

    def __init__(self, hidden_dim: int, latent_dim: int, in_channels: int = 3,
                 input_height: int = 256, input_width: int = 306 * 6,
                 pooling_size: int = 4, drop_p: float = 0.2, *,
                 device=None, generator=None):
        super().__init__()
        self.hidden_dim, self.latent_dim = hidden_dim, latent_dim
        self.in_channels = in_channels
        self.input_height, self.input_width = input_height, input_width
        self.pooling_size = pooling_size
        kw = dict(device=device, generator=generator)
        self.c1 = L.Conv2d(in_channels, TRUNK_C, 3, 1, 1, **kw)
        self.c2 = L.Conv2d(TRUNK_C, TRUNK_C, 3, 1, 1, **kw)
        self.c3 = L.Conv2d(TRUNK_C, TRUNK_C, 3, 2, 1, **kw)
        self.fc1 = DenseBlock(self.conv_out_dim(), hidden_dim, drop_p, **kw)
        self.fc2 = DenseBlock(hidden_dim, hidden_dim, drop_p, **kw)
        self.fc_z_out = L.Linear(hidden_dim, latent_dim, **kw)

    def c3_shape(self):
        """(H', W') of the c3 feature map (stride-2 halving with p1)."""
        return out_hw(self.input_height, self.input_width)

    def conv_out_dim(self) -> int:
        """Flattened-and-pooled conv output size."""
        h, w = self.c3_shape()
        return TRUNK_C * h * w // self.pooling_size

    def forward(self, x, *, c3_only: bool = False, with_c3: bool = False,
                int8: bool = False):
        if int8:
            raise NotImplementedError("the int8 trunk (precision 8) is not ported yet")
        x = trunk(x, self.c1.weight, self.c1.bias, self.c2.weight, self.c2.bias,
                  self.c3.weight, self.c3.bias)
        if c3_only:
            return x
        c3_map = x
        # torch flattens NCHW-contiguously (components.py:46); the fc1 weight
        # rows follow that order.
        x = L.max_pool_flat(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1), self.pooling_size)
        z = self.fc_z_out(self.fc2(self.fc1(x)))
        return (z, c3_map) if with_c3 else z

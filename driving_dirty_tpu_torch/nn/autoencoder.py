"""Autoencoder components (driving_dirty_tpu/nn/autoencoder.py): DenseBlock,
Encoder and Decoder.

Architecture as in the reference (its src/autoencoder/
components.py:6-52): conv trunk c1 -> c2 -> c3, flatten in NCHW order,
max-pool(4) over the flat vector, two DenseBlocks, Linear to the latent.
The trunk is kernels/trunk.py: the CUDA kernel on a CUDA tensor (under
autograd its backward recomputes the plain trunk), its plain version on a
CPU tensor; with `int8=True` (precision 8 at inference) it is
kernels/trunk_int8.py, kernel B1-int8 with the caller's static scales. The
Decoder mirrors the reference's components.py:55-93.

In training mode the DenseBlocks' dropout draws from the `generator` their
forward is given (torch's default generator when None); `drop_p` sets its
rate.
"""
from __future__ import annotations

import torch
from torch import nn

from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.kernels.trunk import C as TRUNK_C
from driving_dirty_tpu_torch.kernels.trunk import out_hw, trunk
from driving_dirty_tpu_torch.kernels.trunk_int8 import trunk_int8


class DenseBlock(nn.Module):
    """Linear -> BatchNorm -> ReLU -> Dropout(p)."""

    def __init__(self, in_dim: int, out_dim: int, drop_p: float = 0.2, *,
                 device=None, generator=None):
        super().__init__()
        self.drop_p = drop_p
        self.fc = L.Linear(in_dim, out_dim, device=device, generator=generator)
        self.bn = L.BatchNorm(out_dim, device=device)

    def forward(self, x, generator=None):
        x = torch.relu(self.bn(self.fc(x)))
        return L.dropout(x, self.drop_p, self.training, generator)


class Encoder(nn.Module):
    """[b, H, W, C] NHWC -> latent [b, latent_dim]; `c3_only` returns the c3
    feature map [b, (H+1)//2, (W+1)//2, 32] (the backbone tap), `with_c3`
    returns (z, c3) from one trunk pass. `int8=True` runs the trunk in
    static-scale int8 with `int8_scales` (ops/quant.py:calibrate_trunk;
    None is the dynamic absmax, CPU tensors only), inference only.

    `dense=False` builds the conv trunk alone (c1, c2, c3), for backbones
    that only tap c3: the dense latent path is then absent (at full width
    fc1 alone is 940032x128, 481 MB in f32) and only `c3_only` calls work."""

    def __init__(self, hidden_dim: int, latent_dim: int, in_channels: int = 3,
                 input_height: int = 256, input_width: int = 306 * 6,
                 pooling_size: int = 4, drop_p: float = 0.2, *, dense: bool = True,
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
        self.dense = dense
        if not dense:
            return
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

    def trunk_params(self):
        """(w1, b1, w2, b2, w3, b3) of the conv trunk, OIHW."""
        return (self.c1.weight, self.c1.bias, self.c2.weight, self.c2.bias,
                self.c3.weight, self.c3.bias)

    def forward(self, x, *, c3_only: bool = False, with_c3: bool = False,
                int8: bool = False, int8_scales=None, generator=None):
        if int8:
            x = trunk_int8(x, *self.trunk_params(), int8_scales)
        else:
            x = trunk(x, *self.trunk_params())
        if c3_only:
            return x
        if not self.dense:
            raise ValueError("this encoder holds the conv trunk only: call it with c3_only=True")
        c3_map = x
        # torch flattens NCHW-contiguously (components.py:46); the fc1 weight
        # rows follow that order.
        x = L.max_pool_flat(x.permute(0, 3, 1, 2).reshape(x.shape[0], -1), self.pooling_size)
        z = self.fc_z_out(self.fc2(self.fc1(x, generator), generator))
        return (z, c3_map) if with_c3 else z


class Decoder(nn.Module):
    """latent [b, latent_dim] -> [b, output_height, output_width, C] NHWC:
    DenseBlock(latent -> hidden) -> DenseBlock(hidden -> 64 h' w') ->
    reshape to [b, 64, h', w'] (the reference's element order) -> ConvT
    (64->32, k3, p1) -> ReLU -> ConvT(32->32, k3, p1) -> ReLU -> ConvT(32->32,
    k2, s2) -> ReLU -> ConvT(32->C, k1); no final sigmoid."""

    def __init__(self, hidden_dim: int, latent_dim: int, in_channels: int = 3,
                 output_height: int = 256, output_width: int = 306, drop_p: float = 0.2, *,
                 device=None, generator=None):
        super().__init__()
        self.hidden_dim, self.latent_dim = hidden_dim, latent_dim
        self.in_channels = in_channels
        self.output_height, self.output_width = output_height, output_width
        kw = dict(device=device, generator=generator)
        h, w = self.deconv_dims
        self.fc1 = DenseBlock(latent_dim, hidden_dim, drop_p, **kw)
        self.fc2 = DenseBlock(hidden_dim, 64 * h * w, drop_p, **kw)
        self.dc1 = L.ConvTranspose2d(64, 32, 3, 1, 1, **kw)
        self.dc2 = L.ConvTranspose2d(32, 32, 3, 1, 1, **kw)
        self.dc3 = L.ConvTranspose2d(32, 32, 2, 2, 0, **kw)
        self.dc4 = L.ConvTranspose2d(32, in_channels, 1, 1, 0, **kw)

    @property
    def deconv_dims(self):
        """(h', w'): the reference's probe conv stack (k1s1, k2s2, k3p1, k3p1)
        applied to the output size, i.e. (H - 2) // 2 + 1."""
        return (self.output_height - 2) // 2 + 1, (self.output_width - 2) // 2 + 1

    def forward(self, z, generator=None):
        h, w = self.deconv_dims
        x = self.fc2(self.fc1(z, generator), generator)
        x = x.reshape(x.shape[0], 64, h, w).permute(0, 2, 3, 1)
        x = torch.relu(self.dc1(x))
        x = torch.relu(self.dc2(x))
        x = torch.relu(self.dc3(x))
        return self.dc4(x)

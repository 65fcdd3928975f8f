"""Layers with the JAX package's numerics (driving_dirty_tpu/core/layers.py).

Activations keep the JAX layouts at the module boundary: NHWC for Conv2d,
[..., features] for Linear and BatchNorm. Weights use PyTorch layouts
(OIHW conv, [out, in] linear); checkpoints/convert.py maps between them.
Weights are cast to the activation dtype before use, so bf16 activations
with f32 parameters compute in bf16, as in the JAX package.

Init matches torch defaults in distribution (Kaiming-uniform(a=sqrt(5))
weights, U(+-1/sqrt(fan_in)) bias), drawn from the caller's
torch.Generator. The draws differ from JAX's: tests copy weights across.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, bound, device, generator):
    t = torch.empty(shape, device=device)
    return nn.Parameter(t.uniform_(-bound, bound, generator=generator))


class Linear(nn.Module):
    """y = x @ weight.T + bias, weight [out, in]."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None, generator=None):
        super().__init__()
        bound = math.sqrt(1.0 / in_dim)
        self.weight = _uniform((out_dim, in_dim), bound, device, generator)
        self.bias = _uniform((out_dim,), bound, device, generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Module):
    """NHWC conv with an OIHW weight; torch.nn.Conv2d shape semantics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, *, device=None, generator=None):
        super().__init__()
        fan_in = in_channels * kernel_size * kernel_size
        bound = math.sqrt(1.0 / fan_in)
        self.stride, self.padding = stride, padding
        self.weight = _uniform((out_channels, in_channels, kernel_size, kernel_size),
                               bound, device, generator)
        self.bias = _uniform((out_channels,), bound, device, generator)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing feature axis.

    Training normalizes with the biased batch variance and updates the
    running stats with the unbiased one (momentum 0.1, eps 1e-5). Eval is
    (x - mean) * (rsqrt(var + eps) * weight) + bias, with the factors formed
    in f32 and cast to x's dtype, as the JAX package forms them."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 *, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x):
        if self.training:
            xf = x.float().reshape(-1, x.shape[-1])
            mean = xf.mean(0)
            var = xf.var(0, unbiased=False)
            n = xf.shape[0]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.to(x.dtype)) * inv.to(x.dtype) + self.bias.to(x.dtype)


def dropout(x, rate: float, train: bool, generator=None):
    """Inverted dropout, gated on `train`. (The reference's functional
    F.dropout defaults to training=True and so also drops at eval; the JAX
    package gates it, and so does this.)"""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def max_pool_flat(x, pool: int):
    """torch `F.max_pool1d(flat, kernel_size=pool)` over a flattened [b, n]
    vector: max over groups of `pool` consecutive elements; the tail that
    does not fill a group is dropped."""
    b, n = x.shape
    m = (n // pool) * pool
    return x[:, :m].reshape(b, n // pool, pool).amax(-1)

"""Layers with the JAX package's numerics (driving_dirty_tpu/core/layers.py).

Activations keep the JAX layouts at the module boundary: NHWC for Conv2d
and ConvTranspose2d, [..., features] for Linear and BatchNorm. Weights use
PyTorch layouts (OIHW conv, [in, out, kh, kw] transposed conv, [out, in]
linear); checkpoints/convert.py maps between them.
Weights are cast to the activation dtype before use, so bf16 activations
with f32 parameters compute in bf16, as in the JAX package.

Init matches torch defaults in distribution (Kaiming-uniform(a=sqrt(5))
weights, U(+-1/sqrt(fan_in)) bias), drawn from the caller's
torch.Generator. The draws differ from JAX's: tests copy weights across.

Under a mesh (parallel/mesh.py) a Linear layer whose weight the task's
sharding rules cut runs column- or row-parallel (`tp`), a Conv2d or
ConvTranspose2d cut on its output channels column-parallel, and in a
data-parallel training step BatchNorm's statistics and dropout's draw
cover the global batch (parallel/collectives.py), as the JAX package's
step over a mesh computes them. Without a mesh the code is the one-process
code.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from driving_dirty_tpu_torch.parallel import collectives as C
from driving_dirty_tpu_torch.parallel.mesh import step_mesh


def _uniform(shape, bound, device, generator):
    t = torch.empty(shape, device=device)
    return nn.Parameter(t.uniform_(-bound, bound, generator=generator))


class Linear(nn.Module):
    """y = x @ weight.T + bias, weight [out, in]. `tp` is None, or
    ("column" | "row", mesh) once parallel/mesh.py:shard_module has cut the
    weight on its output or its input dimension."""

    def __init__(self, in_dim: int, out_dim: int, *, device=None, generator=None):
        super().__init__()
        bound = math.sqrt(1.0 / in_dim)
        self.weight = _uniform((out_dim, in_dim), bound, device, generator)
        self.bias = _uniform((out_dim,), bound, device, generator)
        self.tp = None

    def forward(self, x):
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.tp is None:
            return F.linear(x, w, b)
        mode, mesh = self.tp
        parallel = C.column_parallel_linear if mode == "column" else C.row_parallel_linear
        return parallel(x, w, b, mesh)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _column_conv(conv, x, w, b, tp, gather: bool):
    """conv(x, w, b) on the NCHW view of an NHWC activation -> NHWC. Under
    tp = ("column", mesh), w and b hold this rank's output channels: the
    input's gradient is summed over 'model' (f), and the output channels
    are gathered from every rank (g) unless `gather` is False, when this
    rank's channels come back."""
    x = x.permute(0, 3, 1, 2)
    if tp is None:
        return conv(x, w, b).permute(0, 2, 3, 1)
    mesh = tp[1]
    y = conv(C.copy_to_tp(x, mesh), w, b)
    return (C.gather_channels(y, mesh) if gather else y).permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """NHWC conv with an OIHW weight; torch.nn.Conv2d shape semantics.
    kernel_size, stride, padding and dilation are an int or an (h, w) pair.
    `tp` is None, or ("column", mesh) once parallel/mesh.py:shard_module has
    cut the weight and the bias on their output channels; `forward(x,
    gather=False)` then returns this rank's channels only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, *, device=None, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        bound = math.sqrt(1.0 / (in_channels * kh * kw))
        self.stride, self.padding, self.dilation = _pair(stride), _pair(padding), _pair(dilation)
        self.weight = _uniform((out_channels, in_channels, kh, kw), bound, device, generator)
        self.bias = _uniform((out_channels,), bound, device, generator)
        self.tp = None

    def forward(self, x, gather: bool = True):
        def conv(x, w, b):
            return F.conv2d(x, w, b, stride=self.stride, padding=self.padding, dilation=self.dilation)

        return _column_conv(conv, x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.tp, gather)


class ConvTranspose2d(nn.Module):
    """NHWC transposed conv with torch.nn.ConvTranspose2d semantics and its
    weight layout [in, out, kh, kw]:

        out = (in - 1) * stride - 2 * padding + dilation * (k - 1) + output_padding + 1

    Init fan-in is out_channels * kh * kw, as torch's (and the JAX package's).
    An ordinary conv that the JAX package leaves to XLA: it runs through
    F.conv_transpose2d (cuDNN on the card). `tp` as Conv2d's: the weight's
    output dimension is its dim 1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, *, device=None, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        bound = math.sqrt(1.0 / (out_channels * kh * kw))
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.output_padding, self.dilation = _pair(output_padding), _pair(dilation)
        self.weight = _uniform((in_channels, out_channels, kh, kw), bound, device, generator)
        self.bias = _uniform((out_channels,), bound, device, generator)
        self.tp = None

    def forward(self, x, gather: bool = True):
        def conv(x, w, b):
            return F.conv_transpose2d(x, w, b, stride=self.stride, padding=self.padding,
                                      output_padding=self.output_padding, dilation=self.dilation)

        return _column_conv(conv, x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.tp, gather)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing feature axis.

    Training normalizes with the biased batch variance (its statistics in
    f32, or f64 for f64 input) and updates the running stats with the
    unbiased one (momentum 0.1, eps 1e-5). Eval is
    (x - mean) * (rsqrt(var + eps) * weight) + bias, with the factors formed
    in f32 and cast to x's dtype, as the JAX package forms them. In a
    data-parallel training step the mean and the variance are the global
    batch's: Σx, then Σ(x - mean)², summed over the data ranks by an
    autograd all-reduce (so the backward's means are global too, as in
    SyncBatchNorm), and the running variance takes the global count."""

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
            xf = x.reshape(-1, x.shape[-1]).to(torch.promote_types(x.dtype, torch.float32))
            mesh = step_mesh()
            if mesh is None:
                mean = xf.mean(0)
                var = xf.var(0, unbiased=False)
                n = xf.shape[0]
            else:
                n = xf.shape[0] * mesh.data  # the rows divide evenly over 'data'
                mean = C.all_reduce_sum(xf.sum(0), mesh) / n
                var = C.all_reduce_sum((xf - mean).square().sum(0), mesh) / n
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
    package gates it, and so does this.) In a data-parallel training step
    the mask is this rank's rows of the global batch's mask."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = C.global_rows(lambda n: torch.rand((n, *x.shape[1:]), device=x.device, generator=generator),
                         x.shape[0]) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def max_pool_flat(x, pool: int):
    """torch `F.max_pool1d(flat, kernel_size=pool)` over a flattened [b, n]
    vector: max over groups of `pool` consecutive elements; the tail that
    does not fill a group is dropped."""
    b, n = x.shape
    m = (n // pool) * pool
    return x[:, :m].reshape(b, n // pool, pool).amax(-1)

"""The collectives of multi-device training: what XLA inserts for the JAX
package's mesh, written out.

Tensor parallelism on the 'model' axis (Megatron's f and g):

  * `copy_to_tp`     forward identity, backward all-reduce over 'model'
                     (the input of a column-parallel layer: each rank's
                     gradient covers only its output columns);
  * `reduce_from_tp` forward all-reduce, backward identity (the partial
                     products of a row-parallel layer);
  * `gather_from_tp` forward all-gather on the last dimension, backward this
                     rank's block (the gathered output is used alike on
                     every rank, so the gradient needs no sum);
                     `gather_channels` is the same on the channels of an
                     NCHW activation, in the memory order it has (an
                     NCHW-contiguous one stays so: a conv layer cut on its
                     output channels, core/layers.py);
  * `scatter_to_tp`  forward this rank's block of the last dimension,
                     backward all-gather (the replicated input of a
                     row-parallel layer gets its whole gradient back, so the
                     layers under it stay equal across 'model').

Data parallelism on the 'data' axis, inside a training step
(mesh.py:data_parallel_step), so the step computes the global batch's
step: `batch_mean` (a loss mean: this rank's mean over the data ranks, whose
gradients the trainer sums), `global_count` (a count over the global
batch), `global_rows` (a random draw of the global batch's shape, of which
this rank keeps its rows), `all_reduce_sum` (forward and backward an
all-reduce, for BatchNorm's statistics). Outside a step each is its one-process form.

`TP_COMM` counts the activation collectives over 'model' (the gathers,
and the sums of `copy_to_tp`'s backward and `reduce_from_tp`), and
`mean_over_model`'s averages of the replicated parameters' gradients.

`all_reduce_grads` sums gradients over 'data' in flat buckets
(`sum_in_buckets`, which also sums a checkpoint's accumulator). Only
all_reduce, all_gather and broadcast are used: gloo has no reduce_scatter.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.autograd import Function

from driving_dirty_tpu_torch.parallel.mesh import step_mesh

BUCKET_NUMEL = 1 << 24  # elements a gradient bucket (64 MB of f32)

# the data-parallel gradient sums of this process: calls, bytes summed and,
# when `timed` is set, each call's host ms with the device synced around it
GRAD_REDUCE = {"calls": 0, "bytes": 0, "ms": [], "timed": False}

# the activation collectives over 'model' of this process, by kind: calls,
# bytes (of the gathered or summed tensor) and, when `timed` is set, their
# host ms in all with the device synced around each
TP_KINDS = ("gather", "sum", "mean")
TP_COMM = {"timed": False, **{kind: {"calls": 0, "bytes": 0, "ms": 0.0} for kind in TP_KINDS}}


def reset_tp_comm(timed: bool = False) -> None:
    TP_COMM["timed"] = timed
    for kind in TP_KINDS:
        TP_COMM[kind].update(calls=0, bytes=0, ms=0.0)


def _counted(kind, cuda, run):
    """run() -> (result, bytes moved): the result, counted in TP_COMM[kind]."""
    timed = TP_COMM["timed"] and cuda
    if timed:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, nbytes = run()
    if timed:
        torch.cuda.synchronize()
        TP_COMM[kind]["ms"] += 1e3 * (time.perf_counter() - t0)
    TP_COMM[kind]["calls"] += 1
    TP_COMM[kind]["bytes"] += nbytes
    return y


def _tp_collective(kind, fn, x, *args):
    """fn(x, *args), counted in TP_COMM[kind] with the bytes of its result."""
    def run():
        y = fn(x, *args)
        return y, y.numel() * y.element_size()

    return _counted(kind, x.is_cuda, run)


def _block(x, mesh, dim=-1):
    k = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.tp_rank * k, k)


def _all_gather(x, mesh, dim=-1):
    """Every 'model' rank's `x` joined on `dim` in rank order. Each block
    travels contiguous, so a dimension other than the last suits a tensor
    whose memory is contiguous in this order (dim 1 of an NCHW one)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(mesh.model)]
    dist.all_gather(parts, x.contiguous(), group=mesh.tp_group)
    return torch.cat(parts, dim=dim)


def summed(x, group):
    """A copy of `x` summed over `group` (no gradient of its own)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToTP(Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_collective("sum", summed, g, ctx.mesh.tp_group), None


class _ReduceFromTP(Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _tp_collective("sum", summed, x, mesh.tp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _tp_collective("gather", _all_gather, x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.dim).contiguous(), None, None


class _ScatterToTP(Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _block(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh), None


def copy_to_tp(x, mesh):
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x, mesh):
    return _ReduceFromTP.apply(x, mesh)


def gather_from_tp(x, mesh):
    return _GatherFromTP.apply(x, mesh, -1)


def gather_channels(y, mesh):
    """y [b, C / model, H, W], this rank's channels -> [b, C, H, W], every
    rank's in rank order, in y's memory format: NCHW-contiguous blocks join
    on dim 1 as they lie, channels-last ones on their last memory
    dimension. The backward takes this rank's channels."""
    if y.is_contiguous():
        return _GatherFromTP.apply(y, mesh, 1)
    return _GatherFromTP.apply(y.permute(0, 2, 3, 1), mesh, -1).permute(0, 3, 1, 2)


def scatter_to_tp(x, mesh):
    return _ScatterToTP.apply(x, mesh)


def column_parallel_linear(x, weight, bias, mesh):
    """y = x @ W.T + b with W [out / model, in] and b cut alike on this rank:
    each rank computes its block of the outputs, then all-gather."""
    y = torch.nn.functional.linear(copy_to_tp(x, mesh), weight, bias)
    return gather_from_tp(y, mesh)


def row_parallel_linear(x, weight, bias, mesh):
    """y = x @ W.T + b with W [out, in / model] on this rank and b whole:
    each rank multiplies its block of x's features, then all-reduce."""
    y = reduce_from_tp(torch.nn.functional.linear(scatter_to_tp(x, mesh), weight), mesh)
    return y + bias


def gather_shard(mesh, t: torch.Tensor, sharding) -> torch.Tensor:
    """The whole tensor from every 'model' rank's block under `sharding`
    (dim, "model"); no gradient."""
    dim = sharding[0]
    t = t.detach().movedim(dim, -1).contiguous()
    return _all_gather(t, mesh).movedim(-1, dim).contiguous()


# ----------------------------------------------------------------------------
# data parallelism inside a training step


class _AllReduceSum(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return summed(g, ctx.group), None


def all_reduce_sum(x, mesh):
    """Σ over the data ranks with the gradient summed back (each rank's loss
    is a part of the global loss)."""
    return _AllReduceSum.apply(x, mesh.dp_group)


def batch_mean(x):
    """A loss's mean over the global batch, as this rank's share: its mean
    over its rows divided by the number of data ranks (the rows divide
    evenly), so the data ranks' sum is the global mean and the sum of
    their gradients its gradient."""
    mesh = step_mesh()
    return x.mean() if mesh is None else x.mean() / mesh.data


def global_count(n):
    """A count over the global batch (no gradient)."""
    mesh = step_mesh()
    if mesh is None:
        return n
    return summed(n.detach(), mesh.dp_group)


def global_rows(draw, rows: int):
    """`draw(n)` makes a random array of n rows. -> this rank's `rows` rows
    of the draw for the global batch, so every topology drops, masks and
    samples what the one-process step does (the generators of all ranks
    are in one state)."""
    mesh = step_mesh()
    if mesh is None:
        return draw(rows)
    return draw(rows * mesh.data)[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows]


def sum_in_buckets(tensors, group) -> int:
    """Sum `tensors` in place over `group`, packed by dtype into flat
    buckets of at most BUCKET_NUMEL elements -> the bytes summed."""
    nbytes = 0
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        bucket, size = [], 0
        for t in ts + [None]:
            if t is not None and (not bucket or size + t.numel() <= BUCKET_NUMEL):
                bucket.append(t)
                size += t.numel()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            nbytes += flat.numel() * flat.element_size()
            if t is not None:
                bucket, size = [t], t.numel()
    return nbytes


def mean_over_model(tensors, mesh) -> None:
    """Average the replicated parameters' gradients over 'model' in place.
    Every 'model' rank computes them whole from the same inputs, but the
    card's default algorithms (cuDNN's transposed-conv weight gradient among
    them) need not give every rank the same bits, and Adam would carry the
    difference into the weights step after step. The mean (bucketed, as
    `sum_in_buckets`) hands every rank the same gradient, so the copies stay
    equal; where the ranks' gradients are equal it changes no bit at a
    power-of-two 'model' width. Counted in TP_COMM["mean"]."""
    if not tensors:
        return

    def run():
        nbytes = sum_in_buckets(tensors, mesh.tp_group)
        torch._foreach_div_(tensors, float(mesh.model))
        return None, nbytes

    _counted("mean", tensors[0].is_cuda, run)


def all_reduce_grads(tensors, group) -> int:
    """The gradient sum of an update (`sum_in_buckets`), counted in
    GRAD_REDUCE -> the bytes summed."""
    t0 = time.perf_counter()
    timed = GRAD_REDUCE["timed"] and tensors and tensors[0].is_cuda
    if timed:
        torch.cuda.synchronize()
    nbytes = sum_in_buckets(tensors, group)
    if timed:
        torch.cuda.synchronize()
        GRAD_REDUCE["ms"].append(1e3 * (time.perf_counter() - t0))
    GRAD_REDUCE["calls"] += 1
    GRAD_REDUCE["bytes"] += nbytes
    return nbytes

"""B1-int8: the encoder conv trunk in static-scale int8 (precision 8), NHWC
bf16 in and out.

Replaces the XLA int8 convs of driving_dirty_tpu/ops/quant.py:
encoder_convs_int8 with static scales (the JAX package has no Pallas kernel
for it: three conv_general_dilated on int8 operands with int32
accumulation). PyTorch has no int8 convolution on CUDA, so the port runs a
CUDA C++ kernel written for sm_90a (csrc/trunk_int8.cu), built by nvcc and
called through ctypes (kernels/build.py). It computes exactly
`ops/quant.py:encoder_convs_int8(params, x, scales)` at bf16 x: quantize x
by s1, three exact int8 convs, each dequantized by f32(1/s) * w_inv, bias,
ReLU, rounded to bf16, the next layer's input requantized; c3 in bf16.

What bounds it on the H100: operations. Per 256x1836 panorama the trunk
takes 5.82 G products, 11.64 GOP, 5.9 us at 1,979 TOPS int8 dense, against
10.3 MB of bf16 input and output (3.1 us at 3.35 TB/s).

What the design does about it: c1 and c2 stay in shared memory as int8 (32
B a pixel); each 3x3 tap of c2 and c3 is one mma.sync.m16n8k32.s8 k-step
(32 input channels), c1's 27 products pad to one. The epilogue, most of
the kernel's time, runs no int <-> float conversion: the sums start at the
bits of 1.5 * 2^23 (exact while |acc| <= 2^22; `int_path_flags` sends a
layer that could pass it to __int2float_rn), ReLU and the bf16 rounding are
one cvt, and the requantization rounds by adding 1.5 * 2^23; every float
step rounds as the plain version's does, so the kernel equals it bit for
bit. Tiles of 16 x 16 c3 positions, 8 warps, two CTAs an SM. The stage
switch (`trunk_int8_variant`) bisects it on the card
(scripts/probe_trunk_int8_variants.py).

The kernel takes its weights in its own layout (`prepare_int8_weights`:
int8 B fragments, the f32 epilogue constants and the int path flags), built
once per (weight tensors, scales) and cached (`kernel_int8_weights`).

`trunk_int8` calls the torch.library op `torch.ops.driving_dirty.
trunk_int8` (`trunk_int8_op`), so that torch.export traces a precision-8
model through it (its static scales become constants of the program): on
a CUDA tensor the op launches the kernel (and adds one to
`trunk_int8.launches`), on a CPU tensor it is `trunk_int8_plain`. On the
card it takes bf16 input and static scales, or raises: there is no f32
instantiation (the models give it bf16 at precision 8) and no
dynamic-scale kernel. Inference only: it has no backward. The stage
variants (`trunk_int8_variant`) are a probe and stay plain ctypes calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from driving_dirty_tpu_torch.kernels.build import OP_NAMESPACE, load_library
from driving_dirty_tpu_torch.kernels.trunk import C, cached_layout, check_inputs, out_hw
from driving_dirty_tpu_torch.ops import quant
from driving_dirty_tpu_torch.ops.quant import QMAX

K_STEP = 32  # products per mma.sync.m16n8k32 k-step: one 3x3 tap of 32 channels

# The kernel's stage bisection, by the stage it stops after: v0 the input
# quantized (q0), v1 + c1 and its requantization (q1), v2 + c2 (q2), full
# the trunk (c3). Each variant writes [b, Ho, Wo, 32] at the stride-2
# positions, as kernels/trunk.py:trunk_variant does.
INT8_VARIANT_STAGES = {"v0": 0, "v1": 1, "v2": 2, "full": 3}


def trunk_int8_plain(x, w1, b1, w2, b2, w3, b3, scales):
    """The plain version: ops/quant.py:encoder_convs_int8 with static
    `scales` (s1, s2, s3); conv weights OIHW."""
    return quant.encoder_convs_int8((w1, b1, w2, b2, w3, b3), x, scales=scales)


def trunk_int8_variant_plain(x, w1, b1, w2, b2, w3, b3, scales, *, variant: str):
    """What `trunk_int8_variant` writes: [b, (H+1)//2, (W+1)//2, 32] in x's
    dtype, the int8 activation of `variant`'s stage at (2oy, 2ox) as values
    (v0: channel c holds q0[..., c % 3]; v1: q1; v2: q2), or c3 for "full"
    (`trunk_int8_plain`). Built from ops/quant.py's functions with the
    static `scales`."""
    stages = _int8_stages(variant)
    params = (w1, b1, w2, b2, w3, b3)
    if stages == 3:
        return trunk_int8_plain(x, *params, scales)
    q = quant.quantize(x, scales[0])
    for i, (w, b, stride) in enumerate(quant.trunk_params(params)[:stages]):
        wq, w_inv = quant.quantize_conv_weight(w)
        v = quant.conv2d_int8(q, wq, 1.0 / scales[i], w_inv, stride=stride)
        q = quant.quantize(torch.relu(v + b.float()).to(x.dtype), scales[i + 1])
    q = q[:, ::2, ::2]
    if stages == 0:
        q = q[..., [c % q.shape[-1] for c in range(C)]]
    return q.to(x.dtype).contiguous()


def _int8_stages(variant: str) -> int:
    if variant not in INT8_VARIANT_STAGES:
        raise ValueError(f"unknown int8 trunk variant {variant!r}; one of {sorted(INT8_VARIANT_STAGES)}")
    return INT8_VARIANT_STAGES[variant]


# B's column c of an n8 tile j computes channel N_PERM[8j + c]: with
# N_PERM[8j + 2t + e] = 8t + 2j + e, accumulator lane (g, tg) holds the 8
# consecutive channels 8tg .. 8tg + 7 of its rows (its n8 tiles' columns
# 2tg, 2tg + 1), which its epilogue packs and stores whole.
N_PERM = [8 * t + 2 * j + e for j in range(4) for t in range(4) for e in range(2)]
EXACT_BOUND = 2 ** 22  # |acc| below it: the magic int -> float conversion is exact


def int8_fragments(wq):
    """OIHW int8 weight -> the mma.sync.m16n8k32 B-operand fragment order of
    csrc/trunk_int8.cu: B[k][c] = wq's output channel N_PERM[c] at k = (ky*3
    + kx)*Cin + ci (zero rows pad K to a whole k-step of 32), laid out
    [k-step][n-pair][lane = 4g + tg][n8 tile of the pair][register b0, b1]
    [byte e], 16 B a lane and pair, with k = 32*step + 16*register + 4*tg +
    e and c = 8*(2*pair + tile) + g."""
    b = wq.permute(2, 3, 1, 0).reshape(-1, C)[:, N_PERM]
    b = torch.cat([b, b.new_zeros((-b.shape[0] % K_STEP, C))])
    return b.reshape(-1, 2, 4, 4, 2, 2, 8).permute(0, 4, 6, 2, 5, 1, 3).reshape(-1)


def int_path_flags(wqs) -> int:
    """Which layers' accumulators can reach 2^22 in magnitude: bit l for
    layer l (0 c1, 1 c2, 2 c3) where 127 * max_n sum_k |wq[n, k]| >= 2^22
    (every int8 input is within +-127). Those take __int2float_rn in the
    kernel; the others the exact magic conversion."""
    flags = 0
    for layer, wq in enumerate(wqs):
        if QMAX * int(wq.abs().sum(dim=(1, 2, 3), dtype=torch.int64).max()) >= EXACT_BOUND:
            flags |= 1 << layer
    return flags


def prepare_int8_weights(ws, bs, scales):
    """The kernel's weights for static `scales` (s1, s2, s3): (fragments,
    epilogue, int path flags).

    fragments: the three weights quantized per output channel
    (ops/quant.py:quantize_conv_weight) in mma fragment order, one after
    another (int8, 19,456 B). epilogue: f32 [comb1 | comb2 | comb3 | b1 | b2
    | b3], comb_l = combined_scale(1/s_l, w_inv_l), as the plain version
    computes it. flags: `int_path_flags` of the quantized weights. Counts
    its builds in `prepare_int8_weights.calls`."""
    frags, combs, wqs = [], [], []
    for w, s in zip(ws, scales):
        wq, w_inv = quant.quantize_conv_weight(w.detach())
        wqs.append(wq)
        frags.append(int8_fragments(wq))
        combs.append(quant.combined_scale(1.0 / s, w_inv))
    epilogue = torch.cat(combs + [b.detach().float() for b in bs])
    prepare_int8_weights.calls += 1
    return torch.cat(frags).contiguous(), epilogue.contiguous(), int_path_flags(wqs)


prepare_int8_weights.calls = 0

# (ids of the weight tensors, scales) -> (weak references to them, their
# (data_ptr, _version), prepare_int8_weights' result)
_PREPARED: dict = {}


def kernel_int8_weights(ws, bs, scales):
    """prepare_int8_weights(ws, bs, scales), cached per (weight tensors,
    scales) under the rules of kernels/trunk.py:cached_layout."""
    return cached_layout(_PREPARED, (*ws, *bs), tuple(scales),
                         lambda: prepare_int8_weights(ws, bs, scales))


@functools.cache
def _entry():
    """The library's C entry dd_trunk_int8, built and typed on first use."""
    entry = load_library("trunk_int8").dd_trunk_int8
    entry.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                      + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    return entry


def _check(x, ws, bs, scales):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the int8 trunk kernel takes bfloat16 input (precision 8), got {x.dtype}")
    check_inputs(x, ws, bs)
    if len(scales) != 3 or not all(s > 0 for s in scales):
        raise ValueError(f"int8 trunk takes three positive static scales, got {scales}")


def _launch(x, params, scales, stages):
    """Check, allocate and launch dd_trunk_int8(stages) on x's device and
    current stream."""
    if x.device.type != "cuda":
        raise ValueError(f"int8 trunk runs on cuda or cpu tensors, got {x.device}")
    if scales is None:
        raise NotImplementedError("the int8 trunk kernel takes static scales; dynamic absmax "
                                  "(scales=None) runs on CPU tensors only (ROADMAP §C)")
    ws, bs = params[0::2], params[1::2]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ws, *bs)):
        raise NotImplementedError("the int8 trunk is inference-only and has no backward; "
                                  "call it under torch.no_grad()")
    scales = tuple(float(s) for s in scales)
    _check(x, ws, bs, scales)
    b, h, w, _ = x.shape
    out = torch.empty((b, *out_hw(h, w), C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    frags, epilogue, flags = kernel_int8_weights(ws, bs, scales)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        # c_float rounds each scale to nearest f32, as the plain version's casts do
        err = _entry()(stages, flags, x.data_ptr(), frags.data_ptr(), epilogue.data_ptr(), out.data_ptr(),
                       b, h, w, *scales, stream)
    if err != 0:
        raise RuntimeError(f"int8 trunk kernel launch failed with CUDA error {err}")
    return out


@torch.library.custom_op(f"{OP_NAMESPACE}::trunk_int8", mutates_args=(), device_types="cpu")
def trunk_int8_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
                  scales: Optional[list[float]]) -> torch.Tensor:
    """B1-int8 as a torch.library op: the plain version on a CPU tensor
    (scales None: the dynamic absmax)."""
    return trunk_int8_plain(x, w1, b1, w2, b2, w3, b3, None if scales is None else tuple(scales))


@trunk_int8_op.register_kernel("cuda")
def _trunk_int8_op_cuda(x, w1, b1, w2, b2, w3, b3, scales):
    out = _launch(x, (w1, b1, w2, b2, w3, b3), scales, INT8_VARIANT_STAGES["full"])
    if out.numel():
        trunk_int8.launches += 1
    return out


@trunk_int8_op.register_fake
def _trunk_int8_op_fake(x, w1, b1, w2, b2, w3, b3, scales):
    b, h, w, _ = x.shape
    return x.new_empty((b, *out_hw(h, w), C))


def trunk_int8(x, w1, b1, w2, b2, w3, b3, scales):
    """Static-scale int8 c1 -> c2 -> c3 trunk: [b, H, W, 3] -> [b, (H+1)//2,
    (W+1)//2, 32] in x's dtype; conv weights OIHW, biases [32], `scales` the
    static (input, c1 out, c2 out) scales of ops/quant.py:calibrate_trunk.

    Calls `trunk_int8_op`: on a CUDA tensor it launches the kernel on the
    current stream (and adds one to `trunk_int8.launches`); it takes
    bfloat16 input and static scales and raises otherwise, and raises if
    asked for a gradient. On a CPU tensor it is `trunk_int8_plain`
    (scales=None: the dynamic absmax)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 trunk runs on cuda or cpu tensors, got {x.device}")
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2, w3, b3)):
        # the op's kernel runs below autograd, where grad mode reads off
        raise NotImplementedError("the int8 trunk is inference-only and has no backward; "
                                  "call it under torch.no_grad()")
    return trunk_int8_op(x, w1, b1, w2, b2, w3, b3,
                         None if scales is None else [float(s) for s in scales])


trunk_int8.launches = 0


def trunk_int8_variant(x, w1, b1, w2, b2, w3, b3, scales, *, variant: str):
    """One stage-bisection variant of the int8 trunk kernel
    (INT8_VARIANT_STAGES), as `trunk_int8_variant_plain` defines its
    output. "full" is the kernel that `trunk_int8` launches.

    On a CUDA tensor this launches the kernel (and adds one to
    `trunk_int8_variant.launches`), under the rules of `trunk_int8`. On a
    CPU tensor it is `trunk_int8_variant_plain`."""
    stages = _int8_stages(variant)
    if x.device.type == "cpu":
        return trunk_int8_variant_plain(x, w1, b1, w2, b2, w3, b3, scales, variant=variant)
    out = _launch(x, (w1, b1, w2, b2, w3, b3), scales, stages)
    if out.numel():
        trunk_int8_variant.launches += 1
    return out


trunk_int8_variant.launches = 0

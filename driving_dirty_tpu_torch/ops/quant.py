"""int8 quantized inference for the encoder conv trunk
(driving_dirty_tpu/ops/quant.py), in plain PyTorch.

This module is the numerics reference of the int8 trunk kernel B1-int8
(kernels/trunk_int8.py, csrc/trunk_int8.cu): on the card the models run the
kernel, which equals `encoder_convs_int8` with static scales bit for bit;
the CPU path and the tests run the functions here.

Scheme (symmetric linear quantization, as the JAX package's):
  * weights: per-output-channel absmax scales; conv weights are OIHW here
    (core/layers.py), so the absmax runs over dims (1, 2, 3), where the JAX
    package's HWIO weights reduce over (0, 1, 2);
  * activations: static per-tensor scales from one calibration pass
    (`calibrate_trunk`), or a dynamic absmax per batch (`scales=None`, a
    plain function only: no model reaches it, and on a CUDA tensor it
    raises, see ROADMAP §C);
  * products: int8 x int8 summed exactly in int32 (`conv_int32`), then
    dequantized with the combined scale f32(1/s) * w_inv, the bias added,
    ReLU, and rounded to the compute dtype (bf16 at precision 8) before the
    next layer quantizes it.

Typing follows the JAX package's: a static scale s is a Python float that
holds an f32 value; 1/s is taken in double and rounded to f32 where it
meets the f32 w_inv (`combined_scale`), and every elementwise step runs in
f32, one operation at a time, which is what the kernel's `_rn` intrinsics
repeat.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

QMAX = 127
EPS = 1e-8


def _f32(v, device) -> torch.Tensor:
    """A Python float or a tensor as an f32 tensor on `device` (a Python
    float rounds to f32, as JAX's weak typing rounds it)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def absmax_scale(x, dim=None, eps=EPS):
    """Symmetric quant scale 127/absmax in f32; dim=None -> per tensor (a
    0-d tensor), else reduced over `dim` with the dims kept."""
    a = x.float().abs()
    m = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    return _f32(float(QMAX), x.device) / torch.clamp_min(m, eps)


def quantize(x, scale):
    """round(f32(x) * scale), ties to even (torch.round, as jnp.round),
    clipped to +-127 -> int8."""
    return torch.clamp(torch.round(x.float() * _f32(scale, x.device)), -QMAX, QMAX).to(torch.int8)


def quantize_conv_weight(w):
    """OIHW weight -> (int8 weight, per-output-channel inverse scale [O] f32)."""
    s = absmax_scale(w, dim=(1, 2, 3))  # [O, 1, 1, 1]
    return quantize(w, s), (1.0 / s).reshape(-1)


def combined_scale(x_inv_scale, w_inv_scale):
    """f32(x_inv_scale) * w_inv, in f32: the dequant factor of the int32
    accumulator (JAX: `x_inv_scale * w_inv_scale`, a Python float meeting an
    f32 array)."""
    return _f32(x_inv_scale, w_inv_scale.device) * w_inv_scale


def conv_int32(xq, wq, stride=1, padding=1):
    """Exact int8 conv: NHWC int8 xq [b, H, W, Ci], OIHW int8 wq -> NHWC int32
    accumulator. Every |sum| <= 288 * 127 * 127 < 2^24, so the float64 conv
    holds it exactly whatever the summation order, and torch.round removes
    what a transform algorithm (Winograd, FFT) may add; the result equals
    XLA's int32 accumulation bit for bit."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=stride, padding=padding)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)


def conv2d_int8(xq, wq, x_inv_scale, w_inv_scale, stride=1, padding=1):
    """int8 NHWC conv with int32 accumulation, dequantized to float32:
    xq [b, H, W, Ci] int8, wq OIHW int8 -> f32 [b, H', W', O] = conv(x, w) up
    to quantization error."""
    acc = conv_int32(xq, wq, stride, padding)
    return acc.float() * combined_scale(x_inv_scale, w_inv_scale)


def trunk_params(params):
    """(w1, b1, w2, b2, w3, b3) -> ((w, b, stride) for c1, c2, c3)."""
    w1, b1, w2, b2, w3, b3 = params
    return ((w1, b1, 1), (w2, b2, 1), (w3, b3, 2))


def calibrate_trunk(params, x):
    """One float forward over a sample batch -> static activation scales
    (Python floats) for (input, c1 out, c2 out). params: (w1, b1, w2, b2, w3,
    b3), OIHW. The f32 conv chain runs with TF32 off (cuDNN on the card), as
    the JAX package runs it on XLA's f32 convs: the kernels keep c1 and c2
    on chip, so their absmax needs this pass."""
    scales = []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            v = x.permute(0, 3, 1, 2)
            for w, b, stride in trunk_params(params)[:2]:
                scales.append(float(absmax_scale(v)))
                y = F.conv2d(v.float(), w.float(), stride=stride, padding=1)
                v = torch.relu(y + b.float()[:, None, None])
            scales.append(float(absmax_scale(v)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return tuple(scales)


def encoder_convs_int8_resident(params, x, scales):
    """int8 trunk with int8-resident inter-layer activations: the next
    layer's requantization taken straight from the f32 epilogue,

        q_next = clip(round(relu(acc * (x_inv * w_inv) + b) * s_next)),

    without the rounding to x.dtype in between that `encoder_convs_int8`
    makes. The JAX package keeps it as a probe target (not used by any
    model); here it is a plain function only. Equal to `encoder_convs_int8`
    at f32 x, where that rounding is the identity."""
    cdt = x.dtype
    layers = trunk_params(params)

    def epilogue(acc, comb, b):
        return torch.relu(acc.float() * comb + b.float())

    q = quantize(x, scales[0])
    for i, (w, b, stride) in enumerate(layers):
        wq, w_inv = quantize_conv_weight(w)
        y = epilogue(conv_int32(q, wq, stride), combined_scale(1.0 / scales[i], w_inv), b)
        if i == 2:
            return y.to(cdt)
        q = torch.clamp(torch.round(y * _f32(scales[i + 1], y.device)), -QMAX, QMAX).to(torch.int8)


def encoder_convs_int8(params, x, scales=None):
    """int8 drop-in for the encoder conv trunk (c1 -> c2 -> c3 with ReLUs):
    NHWC x [b, H, W, 3] -> the c3 feature map [b, (H+1)//2, (W+1)//2, 32] in
    x.dtype. params: (w1, b1, w2, b2, w3, b3), OIHW.

    scales: static (input, c1 out, c2 out) scales from calibrate_trunk; None
    takes a dynamic absmax of each layer's input, on a CPU tensor only (no
    model reaches it; it has no kernel, and on a CUDA tensor it raises
    rather than run plain there, ROADMAP §C)."""
    if scales is None and x.device.type != "cpu":
        raise NotImplementedError("dynamic-absmax int8 (scales=None) has no kernel and runs on CPU "
                                  "tensors only; calibrate static scales (ROADMAP §C)")
    cdt = x.dtype
    y = x
    for i, (w, b, stride) in enumerate(trunk_params(params)):
        wq, w_inv = quantize_conv_weight(w)
        s = absmax_scale(y) if scales is None else scales[i]
        v = conv2d_int8(quantize(y, s), wq, 1.0 / s, w_inv, stride=stride)
        y = torch.relu(v + b.float()).to(cdt)
    return y

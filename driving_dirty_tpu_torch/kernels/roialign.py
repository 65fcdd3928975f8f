"""RoIAlign: NHWC features [B, H, W, C] + pixel xyxy rois [B, R, 4] ->
[B, R, out, out, C] float32, torchvision semantics with a fixed sampling
ratio (the detection box head's pooling), and its backward.

Replaces the TPU kernel driving_dirty_tpu/pallas/roialign.py:roi_align_fused
(and, on the card, the XLA path batched_roi_align that the JAX package runs:
the same function) with a CUDA C++ kernel written for sm_90a
(csrc/roialign.cu, B3), built by nvcc and called through ctypes
(kernels/build.py). The Pallas kernel has no backward; the JAX package
trains through the custom VJP of ops/detection.py:roi_align, whose
backward (_roi_align_bwd) is dense separable matmuls in XLA. Here the
backward is a second hand-written kernel (csrc/roialign_bwd.cu, B3-bwd),
the exact adjoint of B3, and the JAX formulation is its plain version
(`roialign_backward_plain`).

What bounds the forward on the H100: bytes. At [8, 400, 400, 32] with 1000
rois an image the output alone is 50.2 MB (15 us at 3.35 TB/s), plus the
part of the feature map the rois touch; the arithmetic, 16 taps x 2
operations per output value, is 6 us at 67 TFLOP/s. The TPU kernel
contracted dense interpolation matrices against every feature row because
Mosaic could not gather arbitrary rows; here each output reads its <= 16
taps directly. Each thread owns 16 B of channels of one bin (4 in f32, 8 in
bf16), so a tap is one 16-B load and the sums leave as 16-B streaming
stores; features whose channels do not split so, or that do not start on
16 B, run the same kernel at one channel a thread (`channels_per_thread`;
the csrc header has the layout). The backward is bound by bytes too (g read
once, dF written once: 0.057 ms in f32 at 512 rois an image); each block of
B3-bwd owns a tile of dF and sums, in roi order, the taps that land in it,
with no atomics, so its result does not change from launch to launch.

`roialign` calls the torch.library op `torch.ops.driving_dirty.roialign`
(`roialign_op`), so that torch.export traces the detection models through
it: on a CUDA tensor the op launches B3, on a CPU tensor it is
`roialign_plain` (a direct bilinear gather in f32). Its backward gives the
rois no gradient (the JAX VJP's zeros) and the features theirs: B3-bwd
(`roialign_backward`) on the card; on the CPU the gradient of
`roialign_plain` recomputed, as ordinary autograd through it gives.
`roialign_backward` on a CPU tensor is `roialign_backward_plain`. B3-bwd
itself stays a plain ctypes call: no exported program reaches it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels.build import OP_NAMESPACE, load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WIDE = {torch.float32: 4, torch.bfloat16: 8}  # channels in 16 B
MAX_SAMPLES = 256  # output_size * sampling_ratio, per axis (csrc/roialign.cu)


def sample_coords(rois, h: int, w: int, output_size: int, spatial_scale: float,
                  sampling_ratio: int, aligned: bool):
    """rois [..., 4] xyxy -> clipped sample coordinates (ys, xs), each
    [..., output_size * sampling_ratio] float32: sample k of bin i sits at
    y0 + (i + (k + 0.5) / s) * (y1 - y0) / out on the scaled roi."""
    def div(a, d):
        # true division: PyTorch's CUDA division by a scalar multiplies by
        # its reciprocal, which rounds differently (and one ulp of a sample
        # coordinate near 400 is 3e-5 of a bilinear weight)
        return a / torch.full_like(a, d)

    r = rois.float() * np.float32(spatial_scale)
    x0, y0, x1, y1 = r.unbind(-1)
    off = div(torch.arange(sampling_ratio, dtype=torch.float32, device=r.device) + 0.5,
              sampling_ratio)
    grid = (torch.arange(output_size, dtype=torch.float32, device=r.device)[:, None]
            + off[None, :]).reshape(-1)
    ys = y0[..., None] + grid * div(y1 - y0, output_size)[..., None]
    xs = x0[..., None] + grid * div(x1 - x0, output_size)[..., None]
    if aligned:
        ys, xs = ys - 0.5, xs - 0.5
    return ys.clamp(0.0, h - 1.0), xs.clamp(0.0, w - 1.0)


def roialign_plain(features, rois, output_size: int = 7, spatial_scale: float = 1.0,
                   sampling_ratio: int = 2, aligned: bool = False):
    """The plain version: every sample's four taps gathered and lerped in
    f32, then the s x s samples of each bin averaged."""
    b, h, w, c = features.shape
    r = rois.shape[1]
    ys, xs = sample_coords(rois, h, w, output_size, spatial_scale, sampling_ratio, aligned)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0)[..., :, None, None]  # [B, R, P, 1, 1]
    wx = (xs - x0)[..., None, :, None]  # [B, R, 1, Q, 1]
    flat = features.reshape(b, h * w, c).float()
    item = torch.arange(b, device=features.device).view(b, 1, 1, 1)

    def tap(yi, xi):  # -> [B, R, P, Q, C]
        return flat[item, yi[..., :, None] * w + xi[..., None, :]]

    v = (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x1) * (1 - wy) * wx
         + tap(y1, x0) * wy * (1 - wx) + tap(y1, x1) * wy * wx)
    s = sampling_ratio
    return v.reshape(b, r, output_size, s, output_size, s, c).mean(dim=(3, 5))


def channels_per_thread(features) -> int:
    """The channels a thread of the kernel owns for these [B, H, W, C]
    features: 16 B of them (4 float32, 8 bfloat16) where C splits into such
    pieces and the data starts on 16 B, else 1."""
    wide = _WIDE[features.dtype]
    return wide if features.shape[-1] % wide == 0 and features.data_ptr() % 16 == 0 else 1


def interp_matrix(coords, size: int, output_size: int, sampling_ratio: int):
    """Clipped sample coordinates [..., out * s] -> the bin interpolation
    matrix [..., out, size]: row i holds the bilinear weight of every
    feature row (or column) for output bin i, the 1/s sample average folded
    in (driving_dirty_tpu/ops/detection.py:_interp_matrix)."""
    c0 = coords.floor().long()
    c1 = (c0 + 1).clamp(max=size - 1)
    frac = coords - c0
    grid = torch.arange(size, device=coords.device)
    m = (grid == c0[..., None]) * (1.0 - frac[..., None]) + (grid == c1[..., None]) * frac[..., None]
    return m.reshape(*coords.shape[:-1], output_size, sampling_ratio, size).mean(dim=-2)


BACKWARD_CHUNK = 256  # rois a step of the plain backward: bounds its [chunk, out, C, W] temporary


def roialign_backward_plain(grad, rois, features_shape, dtype, output_size: int = 7,
                            spatial_scale: float = 1.0, sampling_ratio: int = 2, aligned: bool = False):
    """The plain backward, the JAX package's formulation
    (ops/detection.py:_roi_align_bwd): with the bin interpolation matrices
    By_r [out, H] and Bx_r [out, W] of each roi, dF = sum_r By_r^T g_r Bx_r,
    as two contractions: u = g Bx in the features' dtype, then By^T u
    summed in f32 over (roi, bin) jointly, rounded to the features' dtype.
    grad [B, R, out, out, C] -> dF [B, H, W, C] in `dtype`; in chunks of
    BACKWARD_CHUNK rois."""
    b, h, w, c = features_shape
    s = sampling_ratio
    ys, xs = sample_coords(rois, h, w, output_size, spatial_scale, s, aligned)
    by = interp_matrix(ys, h, output_size, s).to(dtype)  # [B, R, out, H]
    bx = interp_matrix(xs, w, output_size, s).to(dtype)  # [B, R, out, W]
    gc = grad.to(dtype)
    out = torch.zeros((b, h, c * w), dtype=torch.float32, device=grad.device)
    for i in range(b):
        for r0 in range(0, rois.shape[1], BACKWARD_CHUNK):
            sl = slice(r0, r0 + BACKWARD_CHUNK)
            u = torch.einsum("rpqc,rqw->rpcw", gc[i, sl], bx[i, sl])  # [r, out, C, W]
            out[i] += by[i, sl].reshape(-1, h).float().T @ u.reshape(-1, c * w).float()
    return out.reshape(b, h, c, w).permute(0, 1, 3, 2).to(dtype).contiguous()


def grad_channels_per_load(grad) -> int:
    """The channels B3-bwd reads from g [B, R, out, out, C] with one load:
    4 (16 B) where C is a multiple of 4 and g starts on 16 B, else 1."""
    return 4 if grad.shape[-1] % 4 == 0 and grad.data_ptr() % 16 == 0 else 1


@functools.cache
def _entry(name: str):
    """A C entry of the RoIAlign libraries (dd_roialign_forward in
    roialign.cu, dd_roialign_backward in roialign_bwd.cu), built and typed on
    first use; both take the same arguments."""
    lib = "roialign" if name == "dd_roialign_forward" else "roialign_bwd"
    fn = getattr(load_library(lib), name)
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(shape, dtype, device, rois, output_size, sampling_ratio):
    """What both kernels take: float32 or bfloat16 features of `shape`
    [B, H, W, C] on `device` and contiguous float32 rois [B, R, 4] there."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"roialign kernels take float32 or bfloat16 features, got {dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"roialign kernels take float32 rois, got {rois.dtype}")
    if len(shape) != 4 or min(shape[1:]) < 1:
        raise ValueError(f"roialign kernels take [B, H, W, C] features, got {tuple(shape)}")
    if rois.dim() != 3 or rois.shape[-1] != 4 or rois.shape[0] != shape[0]:
        raise ValueError(f"rois must be [{shape[0]}, R, 4], got {tuple(rois.shape)}")
    if rois.device != device:
        raise ValueError(f"rois on {rois.device}, features on {device}")
    if not rois.is_contiguous():
        raise ValueError("roialign kernels take contiguous rois")
    if shape[0] > 65535:
        raise ValueError(f"roialign kernels take at most 65535 images per call, got {shape[0]}")
    if rois.shape[1] >= 2 ** 31:
        raise ValueError(f"roialign kernels take fewer than 2^31 rois per image, got {rois.shape[1]}")
    if not (output_size >= 1 and sampling_ratio >= 1
            and output_size * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f"roialign kernels take output_size, sampling_ratio >= 1 with a product "
                         f"<= {MAX_SAMPLES}, got {output_size}, {sampling_ratio}")


def _call(name, dtype, vec, src, rois, dst, shape, r, output_size, sampling_ratio, spatial_scale, aligned):
    b, h, w, c = shape
    with torch.cuda.device(src.device):
        err = _entry(name)(
            _DTYPE_CODE[dtype], vec, src.data_ptr(), rois.data_ptr(), dst.data_ptr(),
            b, r, h, w, c, output_size, sampling_ratio, float(np.float32(spatial_scale)),
            int(aligned), torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


@torch.library.custom_op(f"{OP_NAMESPACE}::roialign", mutates_args=(), device_types="cpu")
def roialign_op(features: torch.Tensor, rois: torch.Tensor, output_size: int, spatial_scale: float,
                sampling_ratio: int, aligned: bool) -> torch.Tensor:
    """B3 as a torch.library op: the plain version on a CPU tensor."""
    return roialign_plain(features, rois, output_size, spatial_scale, sampling_ratio, aligned)


@roialign_op.register_kernel("cuda")
def _forward_kernel(features, rois, output_size, spatial_scale, sampling_ratio, aligned):
    _check(features.shape, features.dtype, features.device, rois, output_size, sampling_ratio)
    if not features.is_contiguous():
        raise ValueError("roialign kernel takes contiguous features")
    b, h, w, c = features.shape
    r = rois.shape[1]
    out = torch.empty((b, r, output_size, output_size, c), dtype=torch.float32, device=features.device)
    if r == 0:
        return out
    _call("dd_roialign_forward", features.dtype, channels_per_thread(features), features, rois, out,
          features.shape, r, output_size, sampling_ratio, spatial_scale, aligned)
    roialign.launches += 1
    return out


@roialign_op.register_fake
def _roialign_op_fake(features, rois, output_size, spatial_scale, sampling_ratio, aligned):
    b, _, _, c = features.shape
    return features.new_empty((b, rois.shape[1], output_size, output_size, c), dtype=torch.float32)


def _roialign_op_setup(ctx, inputs, output):
    features, rois, *geometry = inputs
    # the CPU backward recomputes roialign_plain from the features; the
    # card's (B3-bwd) needs only their shape and dtype
    ctx.save_for_backward(rois, features if features.device.type == "cpu" else None)
    ctx.geometry = (tuple(features.shape), features.dtype, *geometry)


def _roialign_op_backward(ctx, grad):
    rois, features = ctx.saved_tensors
    shape, dtype, *geometry = ctx.geometry
    if not ctx.needs_input_grad[0]:
        return None, None, None, None, None, None
    if features is not None:
        with torch.enable_grad():
            f = features.detach().requires_grad_()
            (d_features,) = torch.autograd.grad(roialign_plain(f, rois, *geometry), f, grad)
    else:
        d_features = roialign_backward(grad.contiguous(), rois, shape, dtype, *geometry)
    return d_features, None, None, None, None, None


roialign_op.register_autograd(_roialign_op_backward, setup_context=_roialign_op_setup)


def roialign(features, rois, output_size: int = 7, spatial_scale: float = 1.0,
             sampling_ratio: int = 2, aligned: bool = False):
    """features [B, H, W, C] (float32 or bfloat16) + rois [B, R, 4] float32
    pixel xyxy -> [B, R, output_size, output_size, C] float32.

    Calls `roialign_op`: on a CUDA tensor it launches B3 on the current
    stream (and adds one to `roialign.launches`), and a gradient of the
    features runs B3-bwd; on a CPU tensor it is `roialign_plain`. The rois
    get no gradient."""
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roialign runs on cuda or cpu tensors, got {features.device}")
    return roialign_op(features, rois, int(output_size), float(spatial_scale), int(sampling_ratio),
                       bool(aligned))


roialign.launches = 0


def roialign_backward(grad, rois, features_shape, dtype, output_size: int = 7,
                      spatial_scale: float = 1.0, sampling_ratio: int = 2, aligned: bool = False):
    """The gradient of the features: grad [B, R, out, out, C] float32 (of
    `roialign`'s output) + the rois -> dF `features_shape` in `dtype`
    (float32 or bfloat16), summed in f32 and rounded once.

    On a CUDA tensor this launches B3-bwd on the current stream (and adds
    one to `roialign_backward.launches`); on a CPU tensor it is
    `roialign_backward_plain`."""
    if grad.device.type == "cpu":
        return roialign_backward_plain(grad, rois, features_shape, dtype, output_size, spatial_scale,
                                       sampling_ratio, aligned)
    if grad.device.type != "cuda":
        raise ValueError(f"roialign_backward runs on cuda or cpu tensors, got {grad.device}")
    _check(tuple(features_shape), dtype, grad.device, rois, output_size, sampling_ratio)
    b, h, w, c = features_shape
    r = rois.shape[1]
    if grad.dtype != torch.float32:
        raise TypeError(f"roialign_backward takes a float32 gradient, got {grad.dtype}")
    if tuple(grad.shape) != (b, r, output_size, output_size, c) or not grad.is_contiguous():
        raise ValueError(f"roialign_backward takes a contiguous gradient of shape "
                         f"{(b, r, output_size, output_size, c)}, got {tuple(grad.shape)}")
    dF = torch.empty(features_shape, dtype=dtype, device=grad.device)
    if r == 0:
        return dF.zero_()
    _call("dd_roialign_backward", dtype, grad_channels_per_load(grad), grad, rois, dF, features_shape, r,
          output_size, sampling_ratio, spatial_scale, aligned)
    roialign_backward.launches += 1
    return dF


roialign_backward.launches = 0

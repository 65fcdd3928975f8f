"""RoIAlign forward: NHWC features [B, H, W, C] + pixel xyxy rois [B, R, 4]
-> [B, R, out, out, C] float32, torchvision semantics with a fixed sampling
ratio (the detection box head's pooling).

Replaces the TPU kernel driving_dirty_tpu/pallas/roialign.py:roi_align_fused
(and, on the card, the XLA path batched_roi_align that the JAX package runs:
the same function) with a CUDA C++ kernel written for sm_90a
(csrc/roialign.cu), built by nvcc and called through ctypes
(kernels/build.py).

What bounds it on the H100: bytes. At [8, 400, 400, 32] with 1000 rois an
image the output alone is 50.2 MB (15 us at 3.35 TB/s), plus the part of
the feature map the rois touch; the arithmetic, 16 taps x 2 operations per
output value, is 6 us at 67 TFLOP/s. The TPU kernel contracted dense
interpolation matrices against every feature row because Mosaic could not
gather arbitrary rows; here each output reads its <= 16 taps directly. Each
thread owns 16 B of channels of one bin (4 in f32, 8 in bf16), so a tap is
one 16-B load and the sums leave as 16-B streaming stores; features whose
channels do not split so, or that do not start on 16 B, run the same
kernel at one channel a thread (`channels_per_thread`; the csrc header has
the layout).

`roialign` launches the kernel on a CUDA tensor and uses `roialign_plain`,
the plain PyTorch version (a direct bilinear gather in f32), only for a
tensor on the CPU. Inference only: the wrapper raises if asked for a
gradient (the backward comes with detection training).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels.build import load_library

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


@functools.cache
def _entry():
    """The C entry of the RoIAlign library, built and typed on first use."""
    fn = load_library("roialign").dd_roialign_forward
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(features, rois, output_size, sampling_ratio):
    if features.dtype not in _DTYPE_CODE:
        raise TypeError(f"roialign kernel takes float32 or bfloat16 features, got {features.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"roialign kernel takes float32 rois, got {rois.dtype}")
    if features.dim() != 4 or min(features.shape[1:]) < 1:
        raise ValueError(f"roialign kernel takes [B, H, W, C] features, got {tuple(features.shape)}")
    if rois.dim() != 3 or rois.shape[-1] != 4 or rois.shape[0] != features.shape[0]:
        raise ValueError(f"rois must be [{features.shape[0]}, R, 4], got {tuple(rois.shape)}")
    if rois.device != features.device:
        raise ValueError(f"rois on {rois.device}, features on {features.device}")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roialign kernel takes contiguous features and rois")
    if features.shape[0] > 65535:
        raise ValueError(f"roialign kernel takes at most 65535 images per call, got {features.shape[0]}")
    if rois.shape[1] >= 2 ** 31:
        raise ValueError(f"roialign kernel takes fewer than 2^31 rois per image, got {rois.shape[1]}")
    if not (output_size >= 1 and sampling_ratio >= 1
            and output_size * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f"roialign kernel takes output_size, sampling_ratio >= 1 with a product "
                         f"<= {MAX_SAMPLES}, got {output_size}, {sampling_ratio}")
    if torch.is_grad_enabled() and features.requires_grad:
        raise NotImplementedError("the roialign kernel has no backward yet; call it under torch.no_grad()")


def roialign(features, rois, output_size: int = 7, spatial_scale: float = 1.0,
             sampling_ratio: int = 2, aligned: bool = False):
    """features [B, H, W, C] (float32 or bfloat16) + rois [B, R, 4] float32
    pixel xyxy -> [B, R, output_size, output_size, C] float32.

    On a CUDA tensor this launches the kernel on the current stream (and
    adds one to `roialign.launches`); on a CPU tensor it is `roialign_plain`."""
    if features.device.type == "cpu":
        return roialign_plain(features, rois, output_size, spatial_scale, sampling_ratio, aligned)
    if features.device.type != "cuda":
        raise ValueError(f"roialign runs on cuda or cpu tensors, got {features.device}")
    _check(features, rois, output_size, sampling_ratio)
    b, h, w, c = features.shape
    r = rois.shape[1]
    out = torch.empty((b, r, output_size, output_size, c), dtype=torch.float32,
                      device=features.device)
    if r == 0:
        return out
    with torch.cuda.device(features.device):
        err = _entry()(
            _DTYPE_CODE[features.dtype], channels_per_thread(features), features.data_ptr(),
            rois.data_ptr(), out.data_ptr(),
            b, r, h, w, c, output_size, sampling_ratio, float(np.float32(spatial_scale)),
            int(aligned), torch.cuda.current_stream(features.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roialign kernel launch failed with CUDA error {err}")
    roialign.launches += 1
    return out


roialign.launches = 0

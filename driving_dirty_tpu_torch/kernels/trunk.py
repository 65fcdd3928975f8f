"""The encoder conv trunk: c1 Conv(3->32,k3,p1)+ReLU -> c2 Conv(32->32,k3,p1)
+ReLU -> c3 Conv(32->32,k3,s2,p1)+ReLU, NHWC in and out.

Replaces the TPU kernel driving_dirty_tpu/pallas/trunk.py:fused_trunk with a
CUDA C++ kernel written for sm_90a (csrc/trunk.cu), built by nvcc and called
through ctypes (kernels/build.py).

What bounds it on the H100: per 256x1836 panorama the trunk does 11.64 GFLOP
(c1 0.81, c2 8.66, c3 2.17) and must move 20.7 MB in f32 (5.6 MB in, 15.0 MB
out), so it is bound by operations: 174 us/scene at 67 TFLOP/s on the f32
CUDA cores, 11.8 us/scene at 989 TFLOP/s on the bf16 tensor cores. A plain
conv chain also writes c1 and c2 (60 MB each per scene in f32) to device
memory and reads them back.

What the design does about it: one CTA per 4x16 tile of c3 keeps c1 and c2
in shared memory, so device memory sees only the input and c3; the convs run
as register-blocked f32 FMAs on the CUDA cores (f32 accumulation in both
dtypes). Moving c2 and c3 onto the tensor cores (wgmma) is later work. The
csrc header states the tiling and the shared-memory budget.

`trunk` launches the kernel on a CUDA tensor and uses `trunk_plain`, the
plain PyTorch version, only for a tensor on the CPU. There is no autograd
yet: the wrapper raises if asked for a gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from driving_dirty_tpu_torch.kernels.build import load_library

C = 32  # trunk width, fixed by the architecture
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_SHAPES = ((C, 3, 3, 3), (C, C, 3, 3), (C, C, 3, 3))


def out_hw(h: int, w: int) -> tuple[int, int]:
    """(H', W') of c3: stride-2 halving with padding 1."""
    return (h + 1) // 2, (w + 1) // 2


def trunk_plain(x, w1, b1, w2, b2, w3, b3):
    """[b, H, W, 3] -> [b, (H+1)//2, (W+1)//2, 32]; conv weights OIHW.

    Weights and biases are cast to x's dtype, as xla_trunk casts them."""
    def conv(v, w, b, stride):
        return F.relu(F.conv2d(v, w.to(v.dtype), b.to(v.dtype), stride=stride, padding=1))

    y = x.permute(0, 3, 1, 2)
    y = conv(y, w1, b1, 1)
    y = conv(y, w2, b2, 1)
    y = conv(y, w3, b3, 2)
    return y.permute(0, 2, 3, 1).contiguous()


@functools.cache
def _entry():
    """The C entry of the trunk library, built and typed on first use."""
    fn = load_library("trunk").dd_trunk_forward
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, ws, bs):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"trunk kernel takes float32 or bfloat16 input, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"trunk kernel takes [b, H, W, 3] input, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("trunk kernel takes a contiguous input")
    if x.shape[0] > 65535:
        raise ValueError(f"trunk kernel takes at most 65535 images per call, got {x.shape[0]}")
    for w, shape in zip(ws, _W_SHAPES):
        if tuple(w.shape) != shape:
            raise ValueError(f"trunk weight must be OIHW {shape}, got {tuple(w.shape)}")
    for b in bs:
        if tuple(b.shape) != (C,):
            raise ValueError(f"trunk bias must be ({C},), got {tuple(b.shape)}")
    for t in (*ws, *bs):
        if t.device != x.device:
            raise ValueError(f"trunk weights on {t.device}, input on {x.device}")
        if not t.is_floating_point():
            raise TypeError(f"trunk weights must be floating point, got {t.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ws, *bs)):
        raise NotImplementedError("the trunk kernel has no backward yet; call it under torch.no_grad()")


def trunk(x, w1, b1, w2, b2, w3, b3):
    """c1 -> c2 -> c3 trunk. [b, H, W, 3] -> [b, (H+1)//2, (W+1)//2, 32] in x's
    dtype (float32 or bfloat16); conv weights OIHW, biases [32].

    On a CUDA tensor this launches the kernel on the current stream (and adds
    one to `trunk.launches`); on a CPU tensor it is `trunk_plain`."""
    if x.device.type == "cpu":
        return trunk_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"trunk runs on cuda or cpu tensors, got {x.device}")
    ws, bs = (w1, w2, w3), (b1, b2, b3)
    _check(x, ws, bs)
    b, h, w, _ = x.shape
    out = torch.empty((b, *out_hw(h, w), C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # Kernel layout: f32 HWIO [3, 3, Cin, 32] holding the values that the
    # activation dtype rounds the weights to (xla_trunk casts them so).
    kw = [t.to(x.dtype).float().permute(2, 3, 1, 0).contiguous() for t in ws]
    kb = [t.to(x.dtype).float().contiguous() for t in bs]
    with torch.cuda.device(x.device):
        err = _entry()(
            _DTYPE_CODE[x.dtype], x.data_ptr(),
            kw[0].data_ptr(), kb[0].data_ptr(), kw[1].data_ptr(), kb[1].data_ptr(),
            kw[2].data_ptr(), kb[2].data_ptr(), out.data_ptr(), b, h, w,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trunk kernel launch failed with CUDA error {err}")
    trunk.launches += 1
    return out


trunk.launches = 0

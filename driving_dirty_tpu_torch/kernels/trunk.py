"""The encoder conv trunk: c1 Conv(3->32,k3,p1)+ReLU -> c2 Conv(32->32,k3,p1)
+ReLU -> c3 Conv(32->32,k3,s2,p1)+ReLU, NHWC in and out.

Replaces the TPU kernel driving_dirty_tpu/pallas/trunk.py:fused_trunk with a
CUDA C++ kernel written for sm_90a (csrc/trunk.cu), built by nvcc and called
through ctypes (kernels/build.py). Its stage switch replaces the bisection
variants of scripts/probe_trunk_variants.py (`trunk_variant`).

What bounds it on the H100: per 256x1836 panorama the trunk does 11.64 GFLOP
(c1 0.81, c2 8.66, c3 2.17) and must move 10.3 MB in bf16 (20.7 MB in f32),
so it is bound by operations: 11.8 us/scene at 989 TFLOP/s on the bf16
tensor cores; in f32 three TF32 products per product (below), 70.5
us/scene at 495 TFLOP/s (174 us/scene as f32 FMAs at 67 TFLOP/s on the
CUDA cores). A plain conv chain also writes c1 and c2 (30 MB each per
scene in bf16) to device memory and reads them back.

What the design does about it: c1 and c2 stay in shared memory, so device
memory sees only the input and c3. Each conv is an implicit GEMM on the
tensor cores (mma.sync, A fragments gathered with ldmatrix from the
swizzled activation tile, weights staged once per CTA of a persistent grid
of c3 tiles: 8x16 in bf16, 6x16 in f32). In f32 every operand is split
into two TF32 values (`tf32_split`) and each product taken as three TF32
products, which keeps f32 accuracy where one TF32 product would miss the
f32 tolerance. The csrc header states the tilings and the shared-memory
budgets.

The kernels take their weights in their own layouts (`prepare_weights`),
built once per (weight tensors, dtype) and cached (`kernel_weights`).

`trunk` and `trunk_variant` launch the kernel on a CUDA tensor and use the
plain PyTorch versions (`trunk_plain`, `trunk_variant_plain`) only for a
tensor on the CPU. `trunk` is differentiable through `TrunkFunction`: the
kernel computes the forward and saves only its inputs; the backward
recomputes `trunk_plain` from them and differentiates it (cuDNN on the
card), as pallas/trunk.py's custom VJP runs the backward through
jax.vjp(xla_trunk). The JAX package has no Pallas backward for the trunk,
so neither has the port. `trunk_variant` is a probe and takes no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
import weakref

import torch
import torch.nn.functional as F

from driving_dirty_tpu_torch.kernels.build import load_library

C = 32  # trunk width, fixed by the architecture
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W_SHAPES = ((C, 3, 3, 3), (C, C, 3, 3), (C, C, 3, 3))

# The stage bisection of scripts/probe_trunk_variants.py, by the stage the
# kernel stops after (0 input, 1 c1, 2 c2, 3 c3). The Hopper kernel writes
# c1 straight into the swizzled layout that c2's ldmatrix reads, so the JAX
# probe's "+shuffle1" (v2) runs the same program as v1, and its "c2 without
# the shuffle" (v3) the same as v4.
VARIANT_STAGES = {"v0": 0, "v1": 1, "v2": 1, "v3": 2, "v4": 2, "full": 3}


def out_hw(h: int, w: int) -> tuple[int, int]:
    """(H', W') of c3: stride-2 halving with padding 1."""
    return (h + 1) // 2, (w + 1) // 2


def trunk_stages(x, w1, b1, w2, b2, w3, b3, stages: int = 3):
    """The plain trunk's first `stages` convs, NHWC: [c1, c2, c3][:stages].

    Weights and biases are cast to x's dtype, as xla_trunk casts them."""
    def conv(v, w, b, stride):
        return F.relu(F.conv2d(v, w.to(v.dtype), b.to(v.dtype), stride=stride, padding=1))

    y = x.permute(0, 3, 1, 2)
    out = []
    for w, b, stride in ((w1, b1, 1), (w2, b2, 1), (w3, b3, 2))[:stages]:
        y = conv(y, w, b, stride)
        out.append(y.permute(0, 2, 3, 1).contiguous())
    return out


def trunk_plain(x, w1, b1, w2, b2, w3, b3):
    """[b, H, W, 3] -> [b, (H+1)//2, (W+1)//2, 32]; conv weights OIHW."""
    return trunk_stages(x, w1, b1, w2, b2, w3, b3)[-1]


def trunk_variant_plain(x, w1, b1, w2, b2, w3, b3, *, variant: str):
    """What `trunk_variant` writes: [b, (H+1)//2, (W+1)//2, 32], the stage of
    `variant` at (2oy, 2ox). v0: the input, channel c holding x[..., c % 3];
    v1, v2: c1; v3, v4: c2; full: c3 (`trunk_plain`)."""
    stages = _stages(variant)
    if stages == 0:
        return x[:, ::2, ::2][..., [c % 3 for c in range(C)]].contiguous()
    y = trunk_stages(x, w1, b1, w2, b2, w3, b3, stages)[-1]
    return y if stages == 3 else y[:, ::2, ::2].contiguous()


def _stages(variant: str) -> int:
    if variant not in VARIANT_STAGES:
        raise ValueError(f"unknown trunk variant {variant!r}; one of {sorted(VARIANT_STAGES)}")
    return VARIANT_STAGES[variant]


def _fragments(w):
    """HWIO -> the mma.sync B-operand fragment order of csrc/trunk.cu:
    B[k][n] with k = (ky*3 + kx)*Cin + ci (zero rows pad K to a whole
    k-step), laid out [k-step][n-pair][lane = 4g + tg][n8 tile of the pair]
    [...], 16 B a lane and pair, with n = 8*(2*pair + tile) + g. bfloat16
    (m16n8k16): [k-half][e] last, k = 16*step + 8*half + 2*tg + e. float32
    (m16n8k8, split TF32 in the kernel): [e] last, k = 8*step + 4*e + tg."""
    b = w.reshape(-1, C)
    if w.dtype == torch.float32:
        b = torch.cat([b, b.new_zeros((-b.shape[0] % 8, C))])
        return b.reshape(-1, 2, 4, 2, 2, 8).permute(0, 3, 5, 2, 4, 1).reshape(-1)
    b = torch.cat([b, b.new_zeros((-b.shape[0] % 16, C))])
    return b.reshape(-1, 2, 4, 2, 2, 2, 8).permute(0, 4, 6, 2, 5, 1, 3).reshape(-1)


def tf32_split(v):
    """The f32 kernel's split of an operand (csrc/trunk.cu), bit for bit:
    hi = v rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds a finite v; lo = v - hi truncated
    to TF32. -> (hi, lo), f32 tensors holding TF32 values, hi + lo within
    2^-21 of |v|. The kernel takes each product as a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi."""
    v = v.float().contiguous()
    hi = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def prepare_weights(ws, bs, dtype):
    """The kernel's weights for activations of `dtype`: (weights, biases).

    Weights and biases take the values that `dtype` rounds them to
    (xla_trunk casts them so): the three weights one after another in the
    mma fragment order of `dtype` (`_fragments`; f32 stays unsplit, the
    kernel splits it as it loads it). Biases: [b1 | b2 | b3], f32. Counts
    its builds in `prepare_weights.calls`."""
    hwio = [w.detach().to(dtype).permute(2, 3, 1, 0) for w in ws]
    weights = torch.cat([_fragments(w) for w in hwio])
    biases = torch.cat([b.detach().to(dtype).float() for b in bs])
    prepare_weights.calls += 1
    return weights.contiguous(), biases


prepare_weights.calls = 0

# (ids of the weight tensors, dtype) -> (weak references to them, their
# (data_ptr, _version), prepare_weights' result)
_PREPARED: dict = {}


def cached_layout(cache: dict, ts, key, build):
    """build(), cached in `cache` per (the tensors ts, key).

    An entry is used again only for the same live tensors with the same
    data_ptr and _version, so load_state_dict, an in-place update or a new
    storage builds anew, and a freed tensor's reused id cannot hit.
    Inference tensors (made under torch.inference_mode) keep no version, and
    inside inference mode they can be written in place at the same data_ptr,
    so a cached layout could go stale unseen: they are never cached, every
    call builds the layout anew and a warning says so. To keep the cache,
    create or load the weights outside inference mode and serve under
    torch.no_grad or torch.inference_mode."""
    if any(t.is_inference() for t in ts):
        warnings.warn("trunk weights are inference tensors, which keep no version; their "
                      "kernel layout is built on every call, not cached. Create or load the "
                      "weights outside torch.inference_mode to cache it.", stacklevel=3)
        return build()
    full_key = (tuple(id(t) for t in ts), key)
    stamp = tuple((t.data_ptr(), t._version) for t in ts)
    hit = cache.get(full_key)
    if hit is not None and hit[1] == stamp and all(r() is t for r, t in zip(hit[0], ts)):
        return hit[2]
    for k in [k for k, v in cache.items() if any(r() is None for r in v[0])]:
        del cache[k]
    built = build()
    cache[full_key] = (tuple(weakref.ref(t) for t in ts), stamp, built)
    return built


def kernel_weights(ws, bs, dtype):
    """prepare_weights(ws, bs, dtype), cached per (weight tensors, dtype)
    (`cached_layout`)."""
    return cached_layout(_PREPARED, (*ws, *bs), dtype, lambda: prepare_weights(ws, bs, dtype))


@functools.cache
def _entry():
    """The trunk library's C entry dd_trunk, built and typed on first use."""
    entry = load_library("trunk").dd_trunk
    entry.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


def check_inputs(x, ws, bs):
    """Raise unless x, the OIHW weights ws and the biases bs are what the
    trunk kernels take (the dtype aside for B1-int8, which checks its own)."""
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


def _launch(x, params, stages):
    """Check, allocate and launch dd_trunk(stages) on x's device and current
    stream."""
    if x.device.type != "cuda":
        raise ValueError(f"trunk runs on cuda or cpu tensors, got {x.device}")
    ws, bs = params[0::2], params[1::2]
    check_inputs(x, ws, bs)
    b, h, w, _ = x.shape
    out = torch.empty((b, *out_hw(h, w), C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    weights, biases = kernel_weights(ws, bs, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(stages, _DTYPE_CODE[x.dtype], x.data_ptr(), weights.data_ptr(),
                       biases.data_ptr(), out.data_ptr(), b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"trunk kernel launch failed with CUDA error {err}")
    return out


class TrunkFunction(torch.autograd.Function):
    """The trunk under autograd: TrunkFunction.apply(forward, x, w1, b1, w2,
    b2, w3, b3). `forward` computes the output (`trunk` passes the kernel's
    launch; a CPU test may pass `trunk_plain`); only the seven inputs are
    saved. The backward recomputes `trunk_plain` from them under
    enable_grad and differentiates it with torch.autograd.grad, for the
    inputs that need a gradient. That recompute is also the training
    step's remat of the encoder: c1 and c2 exist only inside the backward."""

    @staticmethod
    def forward(ctx, forward, x, w1, b1, w2, b2, w3, b3):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        return forward(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(trunk_plain(*inputs), wanted, grad))
        return (None, *(next(grads) if need else None for need in needs))


def _trunk_kernel(x, w1, b1, w2, b2, w3, b3):
    out = _launch(x, (w1, b1, w2, b2, w3, b3), VARIANT_STAGES["full"])
    if out.numel():
        trunk.launches += 1
    return out


def trunk(x, w1, b1, w2, b2, w3, b3):
    """c1 -> c2 -> c3 trunk. [b, H, W, 3] -> [b, (H+1)//2, (W+1)//2, 32] in x's
    dtype (float32 or bfloat16); conv weights OIHW, biases [32].

    On a CUDA tensor this launches the kernel on the current stream (and adds
    one to `trunk.launches`), through `TrunkFunction` so that gradients flow
    (the backward launches no kernel); on a CPU tensor it is `trunk_plain`,
    under ordinary autograd."""
    if x.device.type == "cpu":
        return trunk_plain(x, w1, b1, w2, b2, w3, b3)
    return TrunkFunction.apply(_trunk_kernel, x, w1, b1, w2, b2, w3, b3)


trunk.launches = 0


def trunk_variant(x, w1, b1, w2, b2, w3, b3, *, variant: str):
    """One stage-bisection variant of the trunk kernel (VARIANT_STAGES), as
    `trunk_variant_plain` defines its output. "full" is the kernel that
    `trunk` launches.

    On a CUDA tensor this launches the kernel (and adds one to
    `trunk_variant.launches`); it has no backward and raises for inputs that
    need a gradient. On a CPU tensor it is `trunk_variant_plain`."""
    stages = _stages(variant)
    if x.device.type == "cpu":
        return trunk_variant_plain(x, w1, b1, w2, b2, w3, b3, variant=variant)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2, w3, b3)):
        raise NotImplementedError("trunk_variant has no backward; call it under torch.no_grad()")
    out = _launch(x, (w1, b1, w2, b2, w3, b3), stages)
    if out.numel():
        trunk_variant.launches += 1
    return out


trunk_variant.launches = 0

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

`trunk` calls a torch.library op, so that torch.export traces a model
through it. Where no gradient is asked for (no_grad, a frozen encoder,
validation, every exported program) it is `torch.ops.driving_dirty.trunk`
(`trunk_op`): on a CUDA tensor B1's launch, on a CPU tensor the plain
PyTorch version `trunk_plain`. Under autograd it is
`torch.ops.driving_dirty.trunk_train` (`trunk_train_op`): B1-save, the same
kernel compiled with a switch that also writes each tile's own c1 and c2
positions to device memory (csrc/trunk.cu: save_stage), or `trunk_stages`
on the CPU; its backward is `torch.ops.driving_dirty.trunk_bwd`
(`trunk_bwd_op`): B1-bwd (csrc/trunk_bwd.cu, `trunk_bwd`), which computes
every gradient autograd asks for from x, the weights and the saved c1, c2
and c3 with no recompute (bf16 natively on the tensor cores, f32 by split
TF32), or its plain version `trunk_bwd_plain` (autograd's
own threshold_backward and convolution_backward calls) on the CPU. The
JAX package leaves this backward to XLA (pallas/trunk.py's custom VJP runs
jax.vjp(xla_trunk)). B1-bwd takes its weights transposed and tap-flipped
(`prepare_bwd_weights`, cached beside the forward's layout by
`kernel_bwd_weights`). `trunk_op` keeps a backward for a caller that
differentiates the op itself (trunk never does): B1-save on its saved
inputs, then B1-bwd. `trunk_variant` is a probe, a plain ctypes call that
takes no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
import weakref

import torch
import torch.nn.functional as F

from driving_dirty_tpu_torch.kernels.build import OP_NAMESPACE, load_library

C = 32  # trunk width, fixed by the architecture
CIN = 3  # input channels
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


def _dx_fragments(d):
    """B1-bwd's dx B operand from the dgrad weight d [3, 3, 32 (o), 3 (ci)]:
    B[k][n] = d with k = (ky'*3 + kx')*32 + o, n = ci (N padded to 8), in
    m16n8k8 fragment order [k-step][lane = 4g + tg][e], b_e = B[8*step +
    tg + 4e][g]."""
    b = d.reshape(-1, CIN)
    b = torch.cat([b, b.new_zeros((b.shape[0], 8 - CIN))], 1)
    return b.reshape(-1, 2, 4, 8).permute(0, 3, 2, 1).reshape(-1)


def prepare_bwd_weights(ws, dtype):
    """B1-bwd's weights for activations of `dtype`: one buffer of `dtype`
    [W1 | W2 | W3] of each conv weight transposed and tap-flipped,
    d[ky'][kx'][o][i] = w[o][i][2 - ky'][2 - kx'] (the transposed conv as a
    correlation), with the values `dtype` rounds the weights to (as
    prepare_weights). W2 and W3 in the fragment order of `_fragments` for
    `dtype` (K = (tap', o), N = i): m16n8k8 TF32 for float32, m16n8k16 for
    bfloat16, whose kernels multiply bf16 natively; W1 in `_dx_fragments`'
    order (the dx pass widens bf16 to TF32). Counts its builds in
    `prepare_bwd_weights.calls`."""
    d = [w.detach().to(dtype).flip(2, 3).permute(2, 3, 0, 1) for w in ws]
    prepare_bwd_weights.calls += 1
    return torch.cat([_dx_fragments(d[0]), _fragments(d[1]), _fragments(d[2])]).contiguous()


prepare_bwd_weights.calls = 0

# (ids of the weight tensors, dtype) -> prepare_bwd_weights' result, as _PREPARED
_PREPARED_BWD: dict = {}


def kernel_bwd_weights(ws, dtype):
    """prepare_bwd_weights(ws, dtype), cached per (weight tensors, dtype)
    (`cached_layout`)."""
    return cached_layout(_PREPARED_BWD, tuple(ws), dtype, lambda: prepare_bwd_weights(ws, dtype))


@functools.cache
def _entry():
    """The trunk library's C entry dd_trunk, built and typed on first use."""
    entry = load_library("trunk").dd_trunk
    entry.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return entry


@functools.cache
def _bwd_entries():
    """The C entries of B1-bwd's library, dd_trunk_bwd_grids and
    dd_trunk_bwd, built and typed on first use."""
    lib = load_library("trunk_bwd")
    grids = lib.dd_trunk_bwd_grids
    grids.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    grids.restype = ctypes.c_int
    entry = lib.dd_trunk_bwd
    entry.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    return grids, entry


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


def _launch(x, params, stages, save: bool = False):
    """Check, allocate and launch dd_trunk(stages) on x's device and current
    stream -> its output; with save (stages 3, B1-save) -> (c3, c1, c2)."""
    if x.device.type != "cuda":
        raise ValueError(f"trunk runs on cuda or cpu tensors, got {x.device}")
    ws, bs = params[0::2], params[1::2]
    check_inputs(x, ws, bs)
    b, h, w, _ = x.shape
    out = torch.empty((b, *out_hw(h, w), C), dtype=x.dtype, device=x.device)
    saved = [torch.empty((b, h, w, C), dtype=x.dtype, device=x.device) for _ in range(2 if save else 0)]
    if out.numel() == 0:
        return (out, *saved) if save else out
    weights, biases = kernel_weights(ws, bs, x.dtype)
    c1, c2 = (t.data_ptr() for t in saved) if save else (None, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(stages, _DTYPE_CODE[x.dtype], x.data_ptr(), weights.data_ptr(),
                       biases.data_ptr(), out.data_ptr(), c1, c2, b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"trunk kernel launch failed with CUDA error {err}")
    return (out, *saved) if save else out


# B1-bwd's partial sums a CTA (csrc/trunk_bwd.cu): the c3 pass's dW3 | db3,
# the c2 pass's dW2 | db2 | dW1 | db1
_NW, _NW1 = C * C * 9, C * CIN * 9
_PART3, _PART2 = _NW + C, _NW + C + _NW1 + C


def trunk_bwd_plain(g3, x, w1, b1, w2, b2, w3, b3, c1, c2, c3, needs):
    """The trunk's backward from the forward's saved activations: g3 [b,
    H', W', 32] (c3's gradient), the seven inputs and c1, c2 [b, H, W, 32],
    c3 (NHWC, x's dtype) -> the gradients of (x, w1, b1, w2, b2, w3, b3),
    None where `needs` is False, each in its input's dtype.

    Autograd's own operations for F.relu and F.conv2d, in its order:
    threshold_backward against the saved post-ReLU tensor, then
    convolution_backward, layer by layer down to the lowest input asked
    for; the saved tensors are read as NCHW views (channels-last strides,
    the strides trunk_stages' conv outputs have). On the CPU the gradients
    equal ordinary autograd through `trunk_plain` bit for bit. The weights
    are cast to x's dtype first, as trunk_stages casts them, and their
    gradients back; every gradient is returned contiguous, as the kernel's
    are."""
    nchw = [t.permute(0, 3, 1, 2) for t in (x, c1, c2, c3)]
    ws, bs = (w1, w2, w3), (b1, b2, b3)
    lowest = min((i for i, need in enumerate(needs) if need), default=7)
    grads = [None] * 7
    g = g3.permute(0, 3, 1, 2)
    for layer in (2, 1, 0):
        if lowest > 2 + 2 * layer:
            break
        gz = torch.ops.aten.threshold_backward(g, nchw[layer + 1], 0)
        mask = [lowest < 1 + 2 * layer, bool(needs[1 + 2 * layer]), bool(needs[2 + 2 * layer])]
        g, dw, db = torch.ops.aten.convolution_backward(
            gz, nchw[layer], ws[layer].to(x.dtype), [C], [2 if layer == 2 else 1] * 2, [1, 1], [1, 1], False,
            [0, 0], 1, mask)
        if mask[1]:
            grads[1 + 2 * layer] = dw.to(ws[layer].dtype).contiguous()
        if mask[2]:
            grads[2 + 2 * layer] = db.to(bs[layer].dtype)
    if needs[0]:
        grads[0] = g.permute(0, 2, 3, 1).contiguous()
    return grads


def trunk_bwd(g3, x, w1, b1, w2, b2, w3, b3, c1, c2, c3, needs):
    """The trunk's backward (`trunk_bwd_plain`'s function): on a CUDA tensor
    B1-bwd (csrc/trunk_bwd.cu) on the current stream, adding one to
    `trunk_bwd.launches`; on a CPU tensor `trunk_bwd_plain`.

    The kernel takes contiguous g3, c1, c2 and c3 in x's dtype, at
    addresses that are multiples of 16 B (its tile copies move 16 B at a
    time), and returns the weight and bias gradients rounded to x's dtype
    once (summed in f32), in the parameters' dtypes; dx in x's dtype."""
    needs = [bool(n) for n in needs]
    if len(needs) != 7:
        raise ValueError(f"trunk_bwd takes 7 needs flags, got {len(needs)}")
    if g3.device.type == "cpu":
        return trunk_bwd_plain(g3, x, w1, b1, w2, b2, w3, b3, c1, c2, c3, needs)
    if g3.device.type != "cuda":
        raise ValueError(f"trunk_bwd runs on cuda or cpu tensors, got {g3.device}")
    ws, bs = (w1, w2, w3), (b1, b2, b3)
    check_inputs(x, ws, bs)
    b, h, w, _ = x.shape
    shapes = {"g3": (b, *out_hw(h, w), C), "c3": (b, *out_hw(h, w), C), "c1": (b, h, w, C), "c2": (b, h, w, C)}
    for name, t in (("g3", g3), ("c3", c3), ("c1", c1), ("c2", c2)):
        if (tuple(t.shape) != shapes[name] or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"trunk_bwd takes a contiguous, 16-B aligned {name} {shapes[name]} of {x.dtype} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    flags = (needs[0] | (needs[1] or needs[2]) << 1 | (needs[3] or needs[4]) << 2
             | (needs[5] or needs[6]) << 3)
    dx = torch.empty_like(x) if needs[0] else None
    dw3 = torch.zeros(_PART3, dtype=torch.float32, device=x.device)
    dw21 = torch.zeros(_PART2, dtype=torch.float32, device=x.device)
    if flags and x.numel():
        grids_entry, entry = _bwd_entries()
        grids = (ctypes.c_int * 2)()
        code = _DTYPE_CODE[x.dtype]
        with torch.cuda.device(x.device):
            err = grids_entry(code, b, h, w, grids)
            if err != 0:
                raise RuntimeError(f"trunk_bwd grid query failed with CUDA error {err}")
            part = torch.empty(grids[0] * _PART3 + grids[1] * _PART2, dtype=torch.float32, device=x.device)
            gz2 = torch.empty((b, h, w, C), dtype=x.dtype, device=x.device) if flags & 7 else None
            gz1 = torch.empty((b, h, w, C), dtype=x.dtype, device=x.device) if flags & 1 else None
            wd = kernel_bwd_weights(ws, x.dtype)
            ptr = [None if t is None else t.data_ptr() for t in (gz2, gz1, dx)]
            err = entry(code, flags, g3.data_ptr(), x.data_ptr(), c1.data_ptr(), c2.data_ptr(), c3.data_ptr(),
                        wd.data_ptr(), ptr[0], ptr[1], part.data_ptr(), grids[0], grids[1], dw3.data_ptr(),
                        dw21.data_ptr(), ptr[2], b, h, w, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"trunk_bwd kernel launch failed with CUDA error {err}")
        trunk_bwd.launches += 1
    elif dx is not None:
        dx.zero_()
    parts = (dx, dw21[_NW + C:_NW + C + _NW1].view(C, CIN, 3, 3), dw21[_NW + C + _NW1:],
             dw21[:_NW].view(C, C, 3, 3), dw21[_NW:_NW + C], dw3[:_NW].view(C, C, 3, 3), dw3[_NW:])
    params = (x, w1, b1, w2, b2, w3, b3)
    return [None if not need else t if i == 0 else t.to(params[i].dtype, copy=True)
            for i, (t, need) in enumerate(zip(parts, needs))]


trunk_bwd.launches = 0


@torch.library.custom_op(f"{OP_NAMESPACE}::trunk", mutates_args=(), device_types="cpu")
def trunk_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """B1 as a torch.library op: the plain version on a CPU tensor."""
    return trunk_plain(x, w1, b1, w2, b2, w3, b3)


@trunk_op.register_kernel("cuda")
def _trunk_kernel(x, w1, b1, w2, b2, w3, b3):
    out = _launch(x, (w1, b1, w2, b2, w3, b3), VARIANT_STAGES["full"])
    if out.numel():
        trunk.launches += 1
    return out


@trunk_op.register_fake
def _trunk_op_fake(x, w1, b1, w2, b2, w3, b3):
    b, h, w, _ = x.shape
    return x.new_empty((b, *out_hw(h, w), C))


@torch.library.custom_op(f"{OP_NAMESPACE}::trunk_train", mutates_args=(), device_types="cpu")
def trunk_train_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   w3: torch.Tensor, b3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B1-save as a torch.library op -> (c3, c1, c2): the plain version's
    stages (`trunk_stages`) on a CPU tensor."""
    c1, c2, c3 = trunk_stages(x, w1, b1, w2, b2, w3, b3)
    return c3, c1, c2


@trunk_train_op.register_kernel("cuda")
def _trunk_train_kernel(x, w1, b1, w2, b2, w3, b3):
    c3, c1, c2 = _launch(x, (w1, b1, w2, b2, w3, b3), VARIANT_STAGES["full"], save=True)
    if c3.numel():
        trunk.launches += 1
        trunk.save_launches += 1
    return c3, c1, c2


@trunk_train_op.register_fake
def _trunk_train_fake(x, w1, b1, w2, b2, w3, b3):
    b, h, w, _ = x.shape
    return x.new_empty((b, *out_hw(h, w), C)), x.new_empty((b, h, w, C)), x.new_empty((b, h, w, C))


@torch.library.custom_op(f"{OP_NAMESPACE}::trunk_bwd", mutates_args=(), device_types=("cpu", "cuda"))
def trunk_bwd_op(g3: torch.Tensor, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                 c3: torch.Tensor, needs: list[bool]) -> list[torch.Tensor]:
    """B1-bwd as a torch.library op (`trunk_bwd`): the gradients of the
    inputs whose `needs` flag is set, in input order."""
    return [t for t in trunk_bwd(g3, x, w1, b1, w2, b2, w3, b3, c1, c2, c3, needs) if t is not None]


@trunk_bwd_op.register_fake
def _trunk_bwd_fake(g3, x, w1, b1, w2, b2, w3, b3, c1, c2, c3, needs):
    return [t.new_empty(t.shape) for t, need in zip((x, w1, b1, w2, b2, w3, b3), needs) if need]


def _grads(saved, needs, g3):
    """(x, w1, .., b3)'s gradients through trunk_bwd_op, None where not needed."""
    grads = iter(trunk_bwd_op(g3.contiguous(), *saved, list(needs)))
    return tuple(next(grads) if need else None for need in needs)


def _trunk_train_setup(ctx, inputs, output):
    c3, c1, c2 = output
    ctx.save_for_backward(*inputs, c1, c2, c3)
    ctx.mark_non_differentiable(c1, c2)
    ctx.set_materialize_grads(False)


def _trunk_train_backward(ctx, g3, _g1, _g2):
    return _grads(ctx.saved_tensors, ctx.needs_input_grad, g3)


trunk_train_op.register_autograd(_trunk_train_backward, setup_context=_trunk_train_setup)


def _trunk_op_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _trunk_op_backward(ctx, grad):
    # `trunk` takes this op only where no gradient is asked for; a direct
    # caller's gradient runs B1-save on the saved inputs, then B1-bwd
    inputs = ctx.saved_tensors
    with torch.no_grad():
        c3, c1, c2 = trunk_train_op(*inputs)
    return _grads((*inputs, c1, c2, c3), ctx.needs_input_grad, grad)


trunk_op.register_autograd(_trunk_op_backward, setup_context=_trunk_op_setup)


def trunk(x, w1, b1, w2, b2, w3, b3):
    """c1 -> c2 -> c3 trunk. [b, H, W, 3] -> [b, (H+1)//2, (W+1)//2, 32] in x's
    dtype (float32 or bfloat16); conv weights OIHW, biases [32].

    Where grad is enabled and some input requires grad, calls
    `trunk_train_op` (B1-save on a CUDA tensor, which also writes c1 and
    c2 for the backward; `trunk_stages` on a CPU tensor), whose backward is
    `trunk_bwd_op` (B1-bwd on a CUDA tensor, `trunk_bwd_plain` on a CPU
    one). Otherwise (no_grad, a frozen encoder, validation, every exported
    program) calls `trunk_op`: B1 on a CUDA tensor, `trunk_plain` on a CPU
    one. Either kernel adds one to `trunk.launches`, B1-save also to
    `trunk.save_launches`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"trunk runs on cuda or cpu tensors, got {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2, w3, b3)):
        return trunk_train_op(x, w1, b1, w2, b2, w3, b3)[0]
    return trunk_op(x, w1, b1, w2, b2, w3, b3)


trunk.launches = 0
trunk.save_launches = 0


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

#!/usr/bin/env python3
"""Smoke run of driving_dirty_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Names the card (torch and nvidia-smi) and builds the CUDA kernels from
   the sources in this checkout (kernels/build.py, into build/), one nvcc
   per source, all started together.
2. Trunk kernel phase (B1): calls the trunk kernel on the card at the shape
   the main path gives it, holds it against its plain PyTorch version with a
   stated tolerance, and times the kernel, the plain version and one library
   call that computes the same function.
3. Raster kernel phase (B2): seeded box scenes (data/boxes.py: 8 scenes of
   max_bb 100 with 5-60 valid cars and trucks and the edge cases) at sizes
   800, 148 and 157: the kernel must equal its plain version with 0
   differing pixels; at 800 the kernel's device time (torch.profiler), its
   time per call back to back and the plain version's (CUDA events) beside
   the bound.
4. Roadmap serving phase: builds a full-width RoadMapBCEv2 (hidden 128,
   latent 64, 6x256x306 views) from a seed, writes it with
   export.save_task_ckpt, loads it back through cli.run_test.load_roadmap_model,
   and answers requests of 8 uint8 scenes through `predict` at precision 32
   and 16: one warm-up and 5 timed requests under torch.profiler
   (throughput, device-busy time, idle share and the device operations that
   take the most time come from that one window). Each request must launch
   the trunk kernel exactly once. The model's c3 map (stitched, /255, in the
   compute dtype) and its logits are held against the same model run with
   the plain trunk.
5. Box-family phase: a full-width MultiTask (reference geometry, hidden 128,
   latent 64) from a seed, written with export.save_task_ckpt and loaded
   back through export.load_task_ckpt, at precision 32 and 16: one warm-up
   and 5 timed `predict` requests of 8 scenes under torch.profiler, then
   `val_metrics` on 2 batches of 8 seeded box scenes. Each `predict` must
   launch the trunk once (the shared encoder pass) and the rasterizer never;
   each `val_metrics` the trunk once and the rasterizer once. Box
   occupancy, roadmap logits and every val_metrics value are held against
   the same model with the plain trunk and the plain rasterizer patched in;
   the targets must be equal. Then a full-width BBSpatialModel (c3-only
   backbone: no fc weights) and a BBSpatialRoadMap, one `predict` and one
   `val_metrics` each at precision 32, with the same checks.
6. Prints the card's name and power limit, one JSON line of kernel records,
   and last the JSON line {"ok": true, "device": {...}}.

TF32 is off for cuDNN and cuBLAS in every phase (printed at each).

Every phase raises on failure. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.export import load_task_ckpt, save_task_ckpt
from driving_dirty_tpu_torch.kernels import build
from driving_dirty_tpu_torch.kernels.raster import raster, raster_plain
from driving_dirty_tpu_torch.kernels.trunk import out_hw, trunk, trunk_plain
from driving_dirty_tpu_torch.models.multitask import MultiTask
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap
from driving_dirty_tpu_torch.ops.maps import raster_geometry
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch

SEED = 0
BATCH = 8
VIEW_H, VIEW_W = 256, 306
PANO = (VIEW_H, 6 * VIEW_W)          # 256 x 1836, the main path's trunk input
REQUESTS = 5                         # timed requests per precision, after one warm-up
HPARAMS = dict(ae_hidden_dim=128, ae_latent_dim=64, pretrained_path=None, batch_size=BATCH)

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Trunk kernel vs plain version, max |error| <= TOL * max|plain| (no floor:
# the outputs here are well below 1, so an absolute floor would let a wrong
# kernel through):
#  f32: both accumulate in f32 (cuDNN with TF32 off), in another order over
#       K <= 288 terms: 2e-4 of the largest output covers the reassociation,
#       as the JAX package's fused-vs-XLA trunk test allows.
#  bf16: both round c1, c2 and c3 to bf16, but from sums taken in another
#       order (and cuDNN may round the sum before adding the bias), so an
#       output can land an ulp or two away (2^-8..2^-7 of its size each).
#       2^-6 of the largest output is 2 to 4 ulps there, and below 1/8 of
#       the mean output.
TOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -6}
# Logits of the kernel path vs the plain-trunk path, max |error| <= this *
# max|plain logits|: f32 heads on c3 maps within f32 rounding of each other,
# 1e-4 as tests/test_torch_port_models.py allows against the JAX model;
# bf16 heads, where one-ulp c3 differences pass through the 940032-wide
# bf16 fc1 and the bf16 latent: 2^-5.
LOGITS_TOL = {32: 1e-4, 16: 2.0 ** -5}
# Masks from the kernel path vs the plain trunk, by precision: f32 flips only
# logits within float error of 0; bf16 rounds the 940032-wide head inputs, so
# more logits near 0 can flip: the JAX package's bar for a lower-precision
# trunk against the float path is >99% agreement.
MASK_AGREEMENT = {32: 0.999, 16: 0.99}

MAX_BB = 100                         # boxes per scene, padded (the dataset's max_bb)
RASTER_SIZES = (800, 148, 157)       # the main path's size and two that fit no tile
# f32 operations per pixel of a box's bounding rectangle: four edge tests of
# 2 subtractions, 2 multiplications, 1 subtraction, 1 sign multiplication
# and 1 comparison each, and the ANDs between them
RASTER_OPS_PER_PIXEL_BOX = 30
VAL_BATCHES = 2                      # val_metrics batches of 8 per precision
BOX_HPARAMS = dict(HPARAMS, spatial_geometry="reference")
# Box occupancy (probabilities) from the kernel path vs the plain trunk,
# max |error| <= this * max|plain|: f32 1e-4, as the logits; bf16 2^-5, as
# the CPU tests allow against the JAX package's bf16 (c3 maps a bf16 ulp or
# two apart pass through the bf16 transposed-conv chain).
BOX_TOL = {32: 1e-4, 16: 2.0 ** -5}
# val_metrics values, |error| <= this * |plain|: losses agree to float error,
# but a threat score moves with every pixel whose probability or logit lies
# within float error of its threshold; with random weights many do. f32 1e-3;
# bf16 2e-2 (bf16 roundings a few ulps apart flip more of them).
VAL_TOL = {32: 1e-3, 16: 2e-2}


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, budget_ms: float = 400.0) -> float:
    """Mean time of fn() on the current stream by CUDA events, after a
    warm-up, over enough calls to fill about budget_ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(max(3, min(50, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def trunk_args(gen, dtype, shape):
    x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    convs = [L.Conv2d(3, 32, 3, device="cuda", generator=gen),
             L.Conv2d(32, 32, 3, device="cuda", generator=gen),
             L.Conv2d(32, 32, 3, device="cuda", generator=gen)]
    params = []
    for c in convs:
        params += [c.weight.detach(), c.bias.detach()]
    return x, params


def trunk_library(x, w1, b1, w2, b2, w3, b3):
    """The yardstick: cuDNN's conv chain on channels-last tensors (no layout
    copies), in x's dtype. Timed only; the port never calls it."""
    y = x.permute(0, 3, 1, 2)  # NHWC storage == NCHW in channels_last
    for w, b, s in ((w1, b1, 1), (w2, b2, 1), (w3, b3, 2)):
        w = w.to(x.dtype).contiguous(memory_format=torch.channels_last)
        y = torch.relu(torch.nn.functional.conv2d(y, w, b.to(x.dtype), stride=s, padding=1))
    return y


def trunk_bound_ms(x) -> tuple[float, str]:
    b, h, w, _ = x.shape
    ho, wo = out_hw(h, w)
    macs = b * (h * w * 32 * 27 + h * w * 32 * 288 + ho * wo * 32 * 288)
    nbytes = (x.numel() + b * ho * wo * 32) * x.element_size() + 4 * (2 * 32 * 32 * 9 + 32 * 27 + 96)
    t_ops, t_bytes = 2 * macs / PEAK_OPS[x.dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def hold(what: str, got, ref, rel_tol: float) -> dict:
    """Raise unless got and ref have one shape, got is finite and
    max|got - ref| <= rel_tol * max|ref|; -> the error and the scale."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite values")
    diff = (got.float() - ref.float()).abs()
    ref_abs = ref.float().abs()
    rec = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
           "max_abs_plain": ref_abs.max().item(), "mean_abs_plain": ref_abs.mean().item()}
    rec["tol"] = rel_tol * rec["max_abs_plain"]
    print(f"{what}: max_abs_err {rec['max_abs_err']:.3e} (tol {rec['tol']:.3e}), "
          f"mean_abs_err {rec['mean_abs_err']:.3e}, max|plain| {rec['max_abs_plain']:.3e}, "
          f"mean|plain| {rec['mean_abs_plain']:.3e}", flush=True)
    if not rec["max_abs_err"] <= rec["tol"]:
        raise RuntimeError(f"{what}: kernel path disagrees with plain, "
                           f"{rec['max_abs_err']} > {rec['tol']}")
    return rec


def check_trunk(gen, dtype, shape) -> dict:
    x, params = trunk_args(gen, dtype, shape)
    got = trunk(x, *params)
    ref = trunk_plain(x, *params)
    rec = hold(f"trunk {str(dtype)[6:]} {list(shape)}", got, ref, TOL[dtype])
    return {"x": x, "params": params, **rec}


def kernel_phase(gen) -> list[dict]:
    torch.backends.cudnn.allow_tf32 = False  # the f32 plain version in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        check_trunk(gen, dtype, (2, 17, 35, 3))  # odd H and W, partial tiles
        c = check_trunk(gen, dtype, (BATCH, *PANO, 3))
        x, p = c["x"], c["params"]
        ms = cuda_ms(lambda: trunk(x, *p))
        plain_ms = cuda_ms(lambda: trunk_plain(x, *p))
        library_ms = cuda_ms(lambda: trunk_library(x, *p))
        bound_ms, bound_by = trunk_bound_ms(x)
        records.append({
            "name": "trunk", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/trunk.cu",
            "replaces": "driving_dirty_tpu/pallas/trunk.py:245 (fused_trunk)",
            "shape": list(x.shape), "dtype": str(dtype)[6:],
            **{k: c[k] for k in ("max_abs_err", "tol", "mean_abs_err", "max_abs_plain",
                                 "mean_abs_plain")},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "roofline_share": bound_ms / ms,
        })
        print(f"trunk {str(dtype)[6:]} {list(x.shape)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        del x, p, c
        torch.cuda.empty_cache()
    return records


def device_us(event) -> float:
    """Device time of a traced kernel or copy, in microseconds."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def kernel_device_ms(fn, kernel: str, calls: int = 50) -> float:
    """Mean device time of the kernels named `kernel` per call of fn(), from
    torch.profiler over `calls` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    if not us:
        raise RuntimeError(f"the profiler traced no {kernel} on the device")
    return us / 1e3 / calls


def tf32_line(label: str) -> None:
    print(f"{label}: TF32 cudnn {torch.backends.cudnn.allow_tf32}, "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}", flush=True)


def raster_bound_ms(boxes, valid, size) -> tuple[float, str, int]:
    """-> (bound ms, what binds, pixel-boxes). Bytes: the output written once,
    boxes and valid read once, over 3.35 TB/s. Operations: for each valid,
    non-degenerate box, RASTER_OPS_PER_PIXEL_BOX f32 operations on each pixel
    of its bounding rectangle clipped to the map, over 67 TFLOP/s."""
    b, v = boxes.cpu().numpy(), valid.cpu().numpy()
    scale, offset = (np.float32(x) for x in raster_geometry(size))
    px = b[:, :, 0, [0, 1, 3, 2]] * scale + offset
    py = b[:, :, 1, [0, 1, 3, 2]] * scale + offset
    t = px * np.roll(py, -1, axis=-1) - np.roll(px, -1, axis=-1) * py
    ok = v & (np.abs(((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]) > np.float32(1e-6))

    def span(lo, hi):
        return np.maximum(0, np.minimum(size - 1, np.floor(hi)) - np.maximum(0, np.ceil(lo)) + 1)

    pixel_boxes = int((span(px.min(-1), px.max(-1)) * span(py.min(-1), py.max(-1)))[ok].sum())
    nbytes = b.shape[0] * size * size * 4 + boxes.numel() * 4 + valid.numel()
    t_ops = pixel_boxes * RASTER_OPS_PER_PIXEL_BOX / PEAK_OPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", pixel_boxes


def raster_phase() -> dict:
    boxes, valid = (torch.from_numpy(a).cuda() for a in box_scenes(SEED, BATCH, MAX_BB))
    print(f"raster: {int(valid.sum())} valid boxes in {BATCH} scenes of max_bb {MAX_BB}", flush=True)
    diffs, max_err = {}, 0.0
    for size in RASTER_SIZES:
        got, ref = raster(boxes, valid, size), raster_plain(boxes, valid, size)
        n = int((got != ref).sum())
        max_err = max(max_err, (got - ref).abs().max().item())
        print(f"raster [{BATCH},{MAX_BB},2,4] -> [{BATCH},{size},{size}]: {n} differing pixels "
              f"({int(ref.sum())} set)", flush=True)
        if n or tuple(got.shape) != (BATCH, size, size):
            raise RuntimeError(f"raster kernel differs from plain at size {size}: {n} pixels")
        diffs[size] = n
    # The kernel runs for less time than its wrapper takes on the host, so
    # events around back-to-back calls time the host (call_ms); the
    # kernel's own time is its device time in a profiled run.
    ms = kernel_device_ms(lambda: raster(boxes, valid, 800), "raster_kernel")
    call_ms = cuda_ms(lambda: raster(boxes, valid, 800))
    plain_ms = cuda_ms(lambda: raster_plain(boxes, valid, 800))
    bound_ms, bound_by, pixel_boxes = raster_bound_ms(boxes, valid, 800)
    print(f"raster [{BATCH},{MAX_BB},2,4] -> [{BATCH},800,800]: kernel {ms:.4f} ms on the device, "
          f"{call_ms:.4f} ms per call back to back, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {pixel_boxes} pixel-boxes), roofline share {bound_ms / ms:.3f}", flush=True)
    return {"name": "raster", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/raster.cu",
            "replaces": "driving_dirty_tpu/pallas/raster.py:76 (boxes_to_binary_map_pallas)",
            "shape": [BATCH, MAX_BB, 2, 4], "size": 800, "dtype": "float32",
            "max_abs_err": max_err, "differing_pixels": diffs, "valid_boxes": int(valid.sum()),
            "pixel_boxes": pixel_boxes, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "roofline_share": bound_ms / ms}


def serve(model, requests) -> tuple[list, float]:
    """Answer each request (host uint8 scenes) with host outputs; -> (outputs,
    seconds)."""
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for images in requests:
        x = torch.from_numpy(images).pin_memory().to("cuda", non_blocking=True)
        y = model.predict(x)
        outs.append({k: v.cpu() for k, v in y.items()} if isinstance(y, dict) else y.cpu())
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def window_report(prof, seconds: float, label: str, smi: str) -> dict:
    """Throughput, device busy, idle share and the top device ops of one
    profiled window of REQUESTS requests."""
    ops = sorted(((e.key, e.count, device_us(e)) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), key=lambda t: -t[2])
    if not ops:
        raise RuntimeError("the profiler traced no device time")
    wall_ms = 1e3 * seconds / REQUESTS
    busy_ms = sum(us for _, _, us in ops) / 1e3 / REQUESTS
    sps = REQUESTS * BATCH / seconds
    print(f"{label} ({smi}): {sps:.1f} scenes/s over {REQUESTS} requests of {BATCH} under "
          f"torch.profiler; {wall_ms:.3f} ms/request wall, {busy_ms:.3f} ms device-busy, "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    for name, count, us in ops[:10]:
        print(f"  {us / 1e3 / REQUESTS:9.3f} ms/request  x{count // REQUESTS:<3d} {name[:90]}")
    return {"scenes_per_s": sps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top_ops": [[n[:60], us / 1e3 / REQUESTS] for n, _, us in ops[:5]]}


def request_images(rng, n):
    return [rng.randint(0, 256, size=(BATCH, 6, VIEW_H, VIEW_W, 3), dtype=np.uint8) for _ in range(n)]


def serving_phase(ckpt: Path, smi: str) -> dict:
    """Roadmap serving -> {precision: {"launches", "scenes_per_s", "idle_share", ...}}."""
    requests = request_images(np.random.RandomState(SEED), REQUESTS + 1)
    out = {}
    for precision in (32, 16):
        tf32_line(f"roadmap serving precision {precision}")
        model = load_roadmap_model(str(ckpt), precision=precision, device="cuda")
        trunk.launches = raster.launches = 0
        masks, _ = serve(model, requests[:1])  # warm-up: allocator, cuDNN, first launch
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed, seconds = serve(model, requests[1:])
        launches = trunk.launches
        if launches != len(requests) or raster.launches:
            raise RuntimeError(f"precision {precision}: {launches} trunk and {raster.launches} "
                               f"raster launches for {len(requests)} requests")
        for m in masks + timed:
            if tuple(m.shape) != (BATCH, 800, 800) or not ((m == 0) | (m == 1)).all():
                raise RuntimeError(f"precision {precision}: bad mask {tuple(m.shape)}")
        rec = window_report(prof, seconds, f"serve precision {precision}", smi)

        # The kernel path against the same model with the plain trunk, on the
        # first request: the c3 map in the model's own input layout, then
        # the logits and the masks.
        x = torch.from_numpy(requests[0]).cuda()
        with torch.no_grad():
            pano = normalize_images(wide_stitch(x), model.compute_dtype)
            c3 = model.encoder(pano, c3_only=True)
            logits, _ = model(x)
            with mock.patch("driving_dirty_tpu_torch.nn.autoencoder.trunk", trunk_plain):
                c3_plain = model.encoder(pano, c3_only=True)
                logits_plain, _ = model(x)
        c3_rec = hold(f"model c3 precision {precision}", c3, c3_plain, TOL[pano.dtype])
        logits_rec = hold(f"model logits precision {precision}", logits, logits_plain,
                          LOGITS_TOL[precision])
        agree = (masks[0].cuda() == (logits_plain > 0).float()).float().mean().item()
        print(f"serve precision {precision}: mask agreement with the plain trunk {agree:.6f}",
              flush=True)
        if agree < MASK_AGREEMENT[precision]:
            raise RuntimeError(f"precision {precision}: mask agreement {agree} "
                               f"< {MASK_AGREEMENT[precision]}")
        out[precision] = {"launches": launches, **rec, "c3_err": c3_rec["max_abs_err"],
                          "logits_err": logits_rec["max_abs_err"], "mask_agreement": agree}
        del model, prof
        torch.cuda.empty_cache()
    return out


@contextmanager
def plain_kernels():
    """The plain trunk and the plain rasterizer in place of the kernels."""
    with mock.patch("driving_dirty_tpu_torch.nn.autoencoder.trunk", trunk_plain), \
            mock.patch("driving_dirty_tpu_torch.models.spatial_bb.raster", raster_plain):
        yield


def expect_launches(what: str, trunks: int, rasters: int) -> dict:
    got = {"trunk": trunk.launches, "raster": raster.launches}
    if got != {"trunk": trunks, "raster": rasters}:
        raise RuntimeError(f"{what}: launches {got}, expected trunk {trunks}, raster {rasters}")
    return got


def box_batches():
    """VAL_BATCHES labeled batches of BATCH scenes on the card: uint8 views,
    seeded box scenes, a random road map."""
    rng = np.random.RandomState(SEED + 2)
    out = []
    for i in range(VAL_BATCHES):
        boxes, valid = box_scenes(SEED + 1 + i, BATCH, MAX_BB)
        batch = {"images": request_images(rng, 1)[0], "boxes": boxes, "box_valid": valid,
                 "road": (rng.rand(BATCH, 800, 800) > 0.5).astype(np.float32)}
        out.append({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    return out


def check_val_metrics(model, batches, precision: int, label: str) -> dict:
    """val_metrics through the kernels (launch counts read around exactly
    that run), then held against the plain kernels; the targets must be
    equal."""
    trunk.launches = raster.launches = 0
    metrics = [model.val_metrics(b) for b in batches]
    torch.cuda.synchronize()
    launches = expect_launches(f"{label} val_metrics", len(batches), len(batches))
    for b, m in zip(batches, metrics):
        targets = model._box_targets(b) if hasattr(model, "_box_targets") else model._targets(b)
        with plain_kernels():
            m_plain = model.val_metrics(b)
            t_plain = raster_plain(b["boxes"], b["box_valid"], model.raster_size)
        n = int((targets != t_plain).sum())
        print(f"{label}: targets {n} differing pixels from plain ({int(t_plain.sum())} set)")
        if n:
            raise RuntimeError(f"{label}: box targets differ from plain in {n} pixels")
        if set(m) != set(m_plain):
            raise RuntimeError(f"{label}: val_metrics keys {sorted(m)} vs {sorted(m_plain)}")
        for k in m:
            hold(f"{label} {k} ({m[k].item():.6f})", m[k], m_plain[k], VAL_TOL[precision])
    return {"launches": launches,
            "metrics": [{k: v.item() for k, v in m.items()} for m in metrics]}


def box_phase(tmp: Path, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ckpt = tmp / "multitask.ckpt"
    save_task_ckpt(ckpt, MultiTask(BOX_HPARAMS, device="cuda", generator=gen))
    torch.cuda.empty_cache()
    requests = request_images(np.random.RandomState(SEED + 1), REQUESTS + 1)
    batches = box_batches()
    out = {}
    for precision in (32, 16):
        label = f"multitask precision {precision}"
        tf32_line(label)
        model = load_task_ckpt(str(ckpt), precision=precision)
        if not isinstance(model, MultiTask):
            raise RuntimeError(f"load_task_ckpt gave a {type(model).__name__}")
        trunk.launches = raster.launches = 0
        outs, _ = serve(model, requests[:1])  # warm-up: allocator, cuDNN autotuning
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed, seconds = serve(model, requests[1:])
        launches = expect_launches(f"{label} predict", len(requests), 0)
        for o in outs + timed:
            rm, box = o["road_mask"], o["box_occupancy"]
            if (tuple(rm.shape) != (BATCH, 800, 800) or tuple(box.shape) != (BATCH, 800, 800)
                    or not ((rm == 0) | (rm == 1)).all() or not torch.isfinite(box).all()
                    or box.min() < 0 or box.max() > 1):
                raise RuntimeError(f"{label}: bad outputs {tuple(rm.shape)} {tuple(box.shape)}")
        rec = window_report(prof, seconds, f"{label} serve", smi)
        del prof

        x = torch.from_numpy(requests[0]).cuda()
        with torch.no_grad():
            rm_logits, box = model(x)
            with plain_kernels():
                rm_plain, box_plain = model(x)
        box_rec = hold(f"{label} box_occupancy", box, box_plain, BOX_TOL[precision])
        rm_rec = hold(f"{label} roadmap logits", rm_logits, rm_plain, LOGITS_TOL[precision])
        val = check_val_metrics(model, batches, precision, label)
        out[f"multitask_{precision}"] = {"predict_launches": launches, **rec,
                                         "box_err": box_rec["max_abs_err"],
                                         "logits_err": rm_rec["max_abs_err"], **val}
        del model
        torch.cuda.empty_cache()

    tf32_line("spatial_bb / spatial_rm precision 32")
    for cls in (BBSpatialModel, BBSpatialRoadMap):
        model = cls(BOX_HPARAMS, device="cuda", generator=gen).eval().requires_grad_(False)
        dense = [k for k in model.state_dict() if k.startswith("encoder.") and
                 not k.startswith(("encoder.c1.", "encoder.c2.", "encoder.c3."))]
        if dense:
            raise RuntimeError(f"{cls.name}: the c3-only backbone holds {dense}")
        b = batches[0]
        road = b["road"] if cls.uses_roadmap else None
        model.predict(b["images"], road)  # warm-up: cuDNN autotuning
        trunk.launches = raster.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = model.predict(b["images"], road)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = expect_launches(f"{cls.name} predict", 1, 0)
        with plain_kernels():
            probs_plain = model.predict(b["images"], road)
        err = hold(f"{cls.name} occupancy", probs, probs_plain, BOX_TOL[32])["max_abs_err"]
        print(f"{cls.name}: one predict of {BATCH} scenes {wall_ms:.3f} ms wall ({smi})", flush=True)
        val = check_val_metrics(model, batches[:1], 32, cls.name)
        out[cls.name] = {"predict_launches": launches, "predict_wall_ms": wall_ms,
                         "occupancy_err": err, **val}
        del model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = device_line()
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    build.load_libraries(("trunk", "raster"))
    print(f"built trunk.cu and raster.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOG.items():
        print(f"ptxas [{name}]:\n{log.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = kernel_phase(gen)
    tf32_line("kernel phases")
    raster_rec = raster_phase()

    build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD) as tmp:
        ckpt = Path(tmp) / "roadmap_bce.ckpt"
        save_task_ckpt(ckpt, RoadMapBCEv2(HPARAMS, device="cuda", generator=gen))
        torch.cuda.empty_cache()
        served = serving_phase(ckpt, smi)
        boxes = box_phase(Path(tmp), smi)

    for r in records:
        r["launches"] = served[32 if r["dtype"] == "float32" else 16]["launches"]
    raster_rec["launches"] = boxes["multitask_32"]["launches"]["raster"]
    records.append(raster_rec)
    print(json.dumps({"serving": served, "box_family": boxes}))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

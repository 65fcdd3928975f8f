#!/usr/bin/env python3
"""Smoke run of driving_dirty_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Names the card (torch and nvidia-smi) and builds the CUDA kernels from
   the sources in this checkout (kernels/build.py, into build/).
2. Kernel phase: calls every kernel of the roadmap inference path on the
   card at the shapes that path gives it, holds it against its plain
   PyTorch version with a stated tolerance, and times the kernel, the plain
   version and one library call that computes the same function.
3. Serving phase: builds a full-width RoadMapBCEv2 (hidden 128, latent 64,
   6x256x306 views) from a seed, writes it with the package's checkpoint
   writer, loads it back through cli.run_test.load_roadmap_model, and
   answers requests of 8 uint8 scenes through `predict` at precision 32 and
   16, the timed requests under torch.profiler (throughput, device-busy
   time, idle share and the device operations that take the most time come
   from that one window). Launch counts are zeroed before each precision's
   requests and read after: each request must launch the trunk kernel
   exactly once. The model's c3 map (stitched, /255, in the compute dtype)
   and its logits are held against the same model run with the plain trunk.
4. Prints the card's name and power limit, one JSON line of kernel records,
   and last the JSON line {"ok": true, "device": {...}}.

Every phase raises on failure. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import to_jax
from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.kernels import build
from driving_dirty_tpu_torch.kernels.trunk import out_hw, trunk, trunk_plain
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
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


def serve(model, requests) -> tuple[list, float]:
    """Answer each request (host uint8 scenes) with host masks; -> (masks,
    seconds)."""
    masks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for images in requests:
        x = torch.from_numpy(images).pin_memory().to("cuda", non_blocking=True)
        masks.append(model.predict(x).cpu())
    torch.cuda.synchronize()
    return masks, time.perf_counter() - t0


def serving_phase(ckpt: Path, smi: str) -> dict:
    """-> {precision: {"launches", "scenes_per_s", "idle_share", ...}}."""
    rng = np.random.RandomState(SEED)
    requests = [rng.randint(0, 256, size=(BATCH, 6, VIEW_H, VIEW_W, 3), dtype=np.uint8)
                for _ in range(REQUESTS + 1)]
    out = {}
    for precision in (32, 16):
        model = load_roadmap_model(str(ckpt), precision=precision, device="cuda")
        trunk.launches = 0
        masks, _ = serve(model, requests[:1])  # warm-up: allocator, cuDNN, first launch
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed, seconds = serve(model, requests[1:])
        launches = trunk.launches
        if launches != len(requests):
            raise RuntimeError(f"precision {precision}: {launches} trunk launches "
                               f"for {len(requests)} requests")
        for m in masks + timed:
            if tuple(m.shape) != (BATCH, 800, 800) or not ((m == 0) | (m == 1)).all():
                raise RuntimeError(f"precision {precision}: bad mask {tuple(m.shape)}")

        ops = sorted(((e.key, e.count, device_us(e)) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), key=lambda t: -t[2])
        if not ops:
            raise RuntimeError("the profiler traced no device time")
        wall_ms = 1e3 * seconds / REQUESTS
        busy_ms = sum(us for _, _, us in ops) / 1e3 / REQUESTS
        sps = REQUESTS * BATCH / seconds
        print(f"serve precision {precision} ({smi}): {sps:.1f} scenes/s over {REQUESTS} requests "
              f"of {BATCH} under torch.profiler; {wall_ms:.3f} ms/request wall, "
              f"{busy_ms:.3f} ms device-busy, idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
        for name, count, us in ops[:10]:
            print(f"  {us / 1e3 / REQUESTS:9.3f} ms/request  x{count // REQUESTS:<3d} {name[:90]}")

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
        out[precision] = {"launches": launches, "scenes_per_s": sps, "wall_ms": wall_ms,
                          "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                          "c3_err": c3_rec["max_abs_err"], "logits_err": logits_rec["max_abs_err"],
                          "mask_agreement": agree}
        del model, prof
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
    build.load_library("trunk")
    print(f"built trunk.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOG.items():
        print(f"ptxas [{name}]:\n{log.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = kernel_phase(gen)

    build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD) as tmp:
        model = RoadMapBCEv2(HPARAMS, device="cuda", generator=gen)
        params, state = to_jax(model.state_dict())
        ckpt = Path(tmp) / "roadmap_bce.ckpt"
        ckpt_io.save(ckpt, params=params, state=state, hparams=HPARAMS, meta={"task": "roadmap_bce"})
        del model, params, state
        torch.cuda.empty_cache()
        served = serving_phase(ckpt, smi)

    for r in records:
        r["launches"] = served[32 if r["dtype"] == "float32" else 16]["launches"]
    print(json.dumps({"serving": served}))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Bisect the int8 trunk kernel B1-int8 stage by stage on the card
(kernels/trunk_int8.py:trunk_int8_variant), beside bf16 B1 on the same input.

Variants (cumulative), each writing [b, H/2, W/2, 32] at the c3 positions:
  v0    the input quantized (q0): tile loads, weight staging and stores
  v1    + c1 and its requantization (q1)
  v2    + c2 and its requantization (q2)
  full  the trunk kernel (c1 + c2 + c3)

    python3 -m driving_dirty_tpu_torch.scripts.probe_trunk_int8_variants [--batch 8]

Needs a CUDA card. At the roadmap path's [b, 256, 1836, 3] and the detection
path's [b, 800, 800, 3], bf16 inputs and weights from a seed (numpy) and
static scales calibrated on the input: every variant is held against
`trunk_int8_variant_plain` (0 differing elements, or it raises), then timed
with CUDA events over back-to-back launches after a warm-up, beside bf16
B1 (`trunk`) on the same input, and printed with the ptxas report of
csrc/trunk_int8.cu (registers, spills, warnings) and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels import build
from driving_dirty_tpu_torch.kernels.trunk import trunk
from driving_dirty_tpu_torch.kernels.trunk_int8 import (INT8_VARIANT_STAGES, trunk_int8_variant,
                                                        trunk_int8_variant_plain)
from driving_dirty_tpu_torch.ops import quant
from driving_dirty_tpu_torch.scripts.probe_trunk_variants import device_line

SEED = 0
SHAPES = {"roadmap": (256, 1836), "detection": (800, 800)}  # the two main paths' trunk inputs
_W_SHAPES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]


def probe_inputs(batch: int, hw, seed: int = SEED):
    """bf16 x [batch, *hw, 3] in [0, 1), OIHW f32 weights and biases (randn
    * 0.1) from numpy's RandomState(seed), on the card, and static scales
    calibrated on x (at most its first 8 images)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(batch, *hw, 3).astype(np.float32)).cuda().to(torch.bfloat16)
    params = [torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32)).cuda() for s in _W_SHAPES]
    return x, params, quant.calibrate_trunk(params, x[:8])


def ptxas_report(name: str = "trunk_int8") -> dict:
    """The ptxas report of csrc/<name>.cu from this process's build: per
    compiled kernel its registers and spill bytes, and every warning line
    (a serialized wgmma is warning C7520). Empty if the library was loaded
    from build/ without a build."""
    log = build.BUILD_LOG.get(name)
    if log is None:
        return {"built": False}
    kernels, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"function": m.group(1)}
            kernels.append(current)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    warnings = [line.strip() for line in log.splitlines() if "warning" in line.lower()]
    return {"built": True, "kernels": kernels, "warnings": warnings,
            "max_registers": max((k.get("registers", 0) for k in kernels), default=0),
            "spill_bytes": sum(k.get("spill_stores", 0) + k.get("spill_loads", 0) for k in kernels),
            "c7520": any("C7520" in w for w in warnings)}


def ptxas_line(rep: dict) -> str:
    if not rep["built"]:
        return "ptxas: library loaded from build/, no report in this process"
    per = [(k.get("registers"), k.get("spill_stores", 0) + k.get("spill_loads", 0)) for k in rep["kernels"]]
    return (f"ptxas: {len(per)} kernels, (registers, spill bytes) {per}, spill bytes {rep['spill_bytes']}, "
            f"C7520 {'yes' if rep['c7520'] else 'no'}, warnings {rep['warnings'] or 'none'}")


def cuda_ms(fn, budget_ms: float = 200.0) -> float:
    """Mean time of fn() by CUDA events over back-to-back calls filling about
    budget_ms, after a warm-up."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    fn()
    events[0].record()
    fn()
    events[1].record()
    events[1].synchronize()
    iters = int(max(3, min(100, budget_ms / max(events[0].elapsed_time(events[1]), 1e-3))))
    events[0].record()
    for _ in range(iters):
        fn()
    events[1].record()
    events[1].synchronize()
    return events[0].elapsed_time(events[1]) / iters


def hold_variant(x, params, scales, variant: str, label: str) -> int:
    """One variant against its plain version: -> elements held; raises on
    one differing element."""
    got = trunk_int8_variant(x, *params, scales, variant=variant)
    ref = trunk_int8_variant_plain(x, *params, scales, variant=variant)
    torch.cuda.synchronize()
    diff = int((got != ref).sum()) if got.shape == ref.shape else -1
    if diff or not torch.isfinite(got).all():
        raise RuntimeError(f"{label} {variant}: {diff} of {ref.numel()} elements differ from "
                           f"trunk_int8_variant_plain (-1: shape {tuple(got.shape)} vs {tuple(ref.shape)})")
    return ref.numel()


def run_probe(batch: int = 8, paths=tuple(SHAPES)) -> list[dict]:
    """Hold and time every variant at each path's shape; -> one record a
    (path, variant): ms, launches (the hold's and the timed ones), elements
    held, bf16 B1's ms on the same input and the ratio."""
    if not torch.cuda.is_available():
        raise RuntimeError("the int8 trunk probe needs a CUDA card")
    records = []
    with torch.no_grad():
        for path in paths:
            x, params, scales = probe_inputs(batch, SHAPES[path])
            label = f"trunk_int8_variant {list(x.shape)}"
            bf16_ms = cuda_ms(lambda: trunk(x, *params))
            for v, stages in INT8_VARIANT_STAGES.items():
                start = trunk_int8_variant.launches
                held = hold_variant(x, params, scales, v, label)
                ms = cuda_ms(lambda: trunk_int8_variant(x, *params, scales, variant=v))
                records.append({"path": path, "shape": list(x.shape), "variant": v, "stages": stages,
                                "ms": ms, "launches": trunk_int8_variant.launches - start,
                                "held_elements": held, "differing_elements": 0,
                                "bf16_trunk_ms": bf16_ms, "ratio_to_bf16": ms / bf16_ms})
            del x, params
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    build.load_libraries(("trunk", "trunk_int8"))
    records = run_probe(args.batch)
    print(f"{torch.cuda.get_device_name(0)} | nvidia-smi: {device_line()}", flush=True)
    print(ptxas_line(ptxas_report()), flush=True)
    for r in records:
        print(f"{r['path']:9s} {r['shape']} {r['variant']:4s}: {r['ms']:8.4f} ms ({r['ratio_to_bf16']:.3f} of "
              f"bf16 B1's {r['bf16_trunk_ms']:.4f} ms), 0 of {r['held_elements']} elements differ", flush=True)


if __name__ == "__main__":
    main()

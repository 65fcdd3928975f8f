"""Bisect the trunk kernel stage by stage on the card (kernels/trunk.py:
trunk_variant; the counterpart of scripts/probe_trunk_variants.py).

Variants (cumulative), each writing [b, H/2, W/2, 32] at the c3 positions:
  v0    pass-through: tile loads, weight staging and stores
  v1    + c1 products, bias, ReLU, edge mask
  v2    + shuffle1: on Hopper c1 is stored straight into the swizzled layout
        that c2's ldmatrix reads, so v2 runs v1's program
  v3    + c2 products without that relayout: the same program as v4
  v4    + c1 relayout + c2
  full  the trunk kernel (c1 + c2 + c3)

    python3 -m driving_dirty_tpu_torch.scripts.probe_trunk_variants [--batch 64] [--dtype bfloat16]

Needs a CUDA card. Inputs and weights come from a seed (numpy), as the JAX
probe makes them; each variant is timed with CUDA events over back-to-back
launches after a warm-up, and printed as ms/batch and scenes/s beside the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from driving_dirty_tpu_torch.kernels.trunk import VARIANT_STAGES, trunk_variant

SEED = 0
PANO = (256, 1836)  # the six-view panorama the roadmap path's trunk takes
_W_SHAPES = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]


def device_line() -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def probe_inputs(batch: int, dtype):
    """x [batch, *PANO, 3] in [0, 1) and OIHW weights and biases
    (randn * 0.1), from numpy's RandomState(SEED), on the card."""
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.rand(batch, *PANO, 3).astype(np.float32)).cuda().to(dtype)
    params = [torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32)).cuda() for s in _W_SHAPES]
    return x, params


def time_variant(x, params, variant: str, budget_ms: float = 300.0) -> tuple[float, int]:
    """-> (ms per launch by CUDA events, launches made), after one warm-up
    launch, over enough back-to-back launches to fill about budget_ms."""
    start = trunk_variant.launches
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    trunk_variant(x, *params, variant=variant)
    events[0].record()
    trunk_variant(x, *params, variant=variant)
    events[1].record()
    events[1].synchronize()
    iters = int(max(3, min(100, budget_ms / max(events[0].elapsed_time(events[1]), 1e-3))))
    events[0].record()
    for _ in range(iters):
        trunk_variant(x, *params, variant=variant)
    events[1].record()
    events[1].synchronize()
    return events[0].elapsed_time(events[1]) / iters, trunk_variant.launches - start


def run_probe(batch: int = 64, dtype=torch.bfloat16) -> list[dict]:
    """Time every variant at [batch, *PANO, 3] on the card; -> one
    record a variant: variant, stages, ms, scenes_per_s, launches."""
    if not torch.cuda.is_available():
        raise RuntimeError("the trunk probe needs a CUDA card")
    x, params = probe_inputs(batch, dtype)
    with torch.no_grad():
        records = []
        for v in VARIANT_STAGES:
            ms, launches = time_variant(x, params, v)
            records.append({"variant": v, "stages": VARIANT_STAGES[v], "ms": ms,
                            "scenes_per_s": batch / ms * 1e3, "launches": launches})
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    args = ap.parse_args(argv)
    records = run_probe(args.batch, getattr(torch, args.dtype))
    print(f"{torch.cuda.get_device_name(0)} | nvidia-smi: {device_line()} | "
          f"[{args.batch},{PANO[0]},{PANO[1]},3] {args.dtype}", flush=True)
    for r in records:
        print(f"{r['variant']:5s}: {r['ms']:8.3f} ms/batch  {r['scenes_per_s']:9.1f} scenes/s", flush=True)


if __name__ == "__main__":
    main()

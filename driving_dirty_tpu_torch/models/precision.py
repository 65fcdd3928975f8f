"""--precision handling (driving_dirty_tpu/models/precision.py): 32 -> f32
activations; 16 -> bf16 activations with f32 parameters. Precision 8 (the
JAX package's static-scale int8 trunk) is not ported yet and raises."""
from __future__ import annotations

import torch


def compute_dtype(precision) -> torch.dtype:
    p = 32 if precision is None else int(precision)
    if p == 32:
        return torch.float32
    if p == 16:
        return torch.bfloat16
    if p == 8:
        raise NotImplementedError("precision 8 (int8 trunk) is not ported yet")
    raise ValueError(f"precision must be 32, 16 or 8, got {precision}")

"""--precision handling for every task (driving_dirty_tpu/models/precision.py):
32 -> f32 activations; 16 -> bf16 activations with f32 parameters; 8 -> bf16
activations and, at inference once static scales are calibrated, the conv
trunk in static-scale int8 (ops/quant.py; kernel B1-int8 on the card).
"""
from __future__ import annotations

import torch

from driving_dirty_tpu_torch.ops import quant
from driving_dirty_tpu_torch.train.task import hp


def compute_dtype(precision) -> torch.dtype:
    p = 32 if precision is None else int(precision)
    if p == 32:
        return torch.float32
    if p in (16, 8):
        return torch.bfloat16
    raise ValueError(f"precision must be 32, 16 or 8, got {precision}")


class Int8TrunkMixin:
    """Precision-8 plumbing shared by every task that owns an encoder trunk.

    int8 runs only when not training, and only with static scales: a task
    calls `calibrate_int8_on(encoder, sample_input)` once (its
    `calibrate_int8`, which `predict` calls first) and the scales stay for
    the task's life. Tasks pass `**self.enc_int8_kwargs(self.training)` to
    their encoder. An eval call at precision 8 before calibration runs the
    trunk in bf16 and prints a one-time message per class, as the JAX
    package does, rather than the dynamic-absmax int8 that measured slower
    than bf16 there. The JAX mixin also leaves the scales unset when called
    under a jit trace; eager PyTorch has no trace, so that guard has no
    counterpart. `Int8TrunkMixin.calibrations` counts calibrations."""

    _int8_scales = None
    _warned_uncalibrated = False
    calibrations = 0

    @property
    def int8_trunk(self) -> bool:
        return hp(self.hparams, "precision", 32) == 8

    def calibrate_int8_on(self, encoder, x) -> None:
        """Static scales from one f32 pass of `encoder`'s trunk over the trunk
        input x (ops/quant.py:calibrate_trunk), once; a no-op below precision
        8 or once calibrated."""
        if not self.int8_trunk or self._int8_scales is not None:
            return
        self._int8_scales = quant.calibrate_trunk(encoder.trunk_params(), x)
        Int8TrunkMixin.calibrations += 1

    def enc_int8_kwargs(self, train: bool) -> dict:
        use = self.int8_trunk and not train
        if use and self._int8_scales is None:
            if not type(self)._warned_uncalibrated:
                type(self)._warned_uncalibrated = True
                print(
                    f"[{getattr(self, 'name', 'task')}] --precision 8 without "
                    "calibrated scales: trunk runs bf16 (call calibrate_int8 "
                    "eagerly for static-scale int8)"
                )
            use = False
        return {"int8": use, "int8_scales": self._int8_scales}

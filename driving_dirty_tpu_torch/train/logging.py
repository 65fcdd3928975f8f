"""Scalar and image logging (driving_dirty_tpu/train/logging.py): JSONL
always, TensorBoard when `torch.utils.tensorboard` imports.

`metrics.jsonl` holds one record a call, {"step": ..., "time": ..., <key>:
<float>, ...}, in the JAX package's format. The trainer hands over device
tensors only at its log cadence, so the `float()` here is the step loop's
one host sync.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._tb = None
        # DD_NO_TB=1 keeps TensorBoard (and TensorFlow, which it imports when
        # installed) out of the process; the JSONL stream still has everything
        if use_tensorboard and not os.environ.get("DD_NO_TB"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None

    def log_scalars(self, scalars: dict, step: int, prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            val = float(v)
            rec[key] = val
            if self._tb is not None:
                self._tb.add_scalar(key, val, step)
        self._jsonl.write(json.dumps(rec) + "\n")

    def log_image(self, name: str, image, step: int):
        """image: [H, W, C] (or [H, W]) floats in [0, 1], a numpy array or a
        tensor on any device."""
        if self._tb is not None:
            if hasattr(image, "detach"):
                image = image.detach().float().cpu().numpy()
            arr = np.asarray(image)
            if arr.ndim == 2:
                arr = arr[..., None]
            self._tb.add_image(name, arr, step, dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """The logger of a rank that does not log (every rank of a mesh but the
    first): it takes the same calls and writes nothing."""

    def log_scalars(self, scalars: dict, step: int, prefix: str = ""):
        pass

    def log_image(self, name: str, image, step: int):
        pass

    def close(self):
        pass

"""The port's torch.library ops, in one namespace (kernels/build.py:
OP_NAMESPACE): importing this module registers every one of them, which a
process must do before it loads an exported program that calls them
(export.py:load).

  torch.ops.driving_dirty.trunk       B1, kernels/trunk.py:trunk_op
  torch.ops.driving_dirty.trunk_train B1-save (B1 that also writes c1 and c2), kernels/trunk.py:trunk_train_op;
                                      its backward the next op
  torch.ops.driving_dirty.trunk_bwd   B1-bwd, kernels/trunk.py:trunk_bwd_op
  torch.ops.driving_dirty.trunk_int8  B1-int8, kernels/trunk_int8.py:trunk_int8_op
  torch.ops.driving_dirty.roialign    B3 (its backward B3-bwd), kernels/roialign.py:roialign_op
  torch.ops.driving_dirty.nms         ops/detection.py:nms_op (no kernel of its own)

Each op launches its kernel on a CUDA tensor and runs the plain version
on a CPU tensor; each has a fake that gives its outputs' shapes and dtypes.
B2 and B3-bwd stay plain ctypes calls: no exported program reaches them.
trunk_train and trunk_bwd run only under autograd, so no exported program
calls them either; they are ops so that a traced training graph could.
"""
from __future__ import annotations

from driving_dirty_tpu_torch.kernels.roialign import roialign_op
from driving_dirty_tpu_torch.kernels.trunk import trunk_bwd_op, trunk_op, trunk_train_op
from driving_dirty_tpu_torch.kernels.trunk_int8 import trunk_int8_op
from driving_dirty_tpu_torch.ops.detection import nms_op

OPS = {"trunk": trunk_op, "trunk_train": trunk_train_op, "trunk_bwd": trunk_bwd_op, "trunk_int8": trunk_int8_op,
       "roialign": roialign_op, "nms": nms_op}

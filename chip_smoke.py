#!/usr/bin/env python3
"""Smoke run of driving_dirty_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Names the card (torch and nvidia-smi) and builds the CUDA kernels from
   the sources in this checkout (kernels/build.py, into build/), one nvcc
   per source, all started together.
2. Trunk kernel phase (B1): calls the trunk kernel on the card at the shape
   the main path gives it, holds it against its plain PyTorch version with a
   stated tolerance, and times the kernel, the plain version and one library
   call that computes the same function. Both dtypes run on the tensor
   cores (mma.sync): bf16 products, and f32 by split TF32 (three TF32
   products a product); the f32 bound counts those three, with the f32
   CUDA-core bound beside it.
2a. Int8 trunk phase (B1-int8, precision 8): bf16 inputs at [8, 256,
   1836, 3], [8, 800, 800, 3] and two odd shapes, seeded weights, static
   scales calibrated on the input itself: the kernel must equal its plain
   version (trunk_int8_plain, float64 convs) with 0 differing elements; at
   the JAX package's int8 headline batch [512, 256, 1836, 3] (bench.py:30)
   the first and last 8 images are held. At the main-path shapes and batch
   512: the kernel's time by CUDA events over back-to-back launches, the
   plain version's, bf16 B1's on the same input, the library route's (per
   layer an im2col, torch._int_mm and the epilogue in torch; empty if
   _int_mm refuses), the int8 bound beside its bytes bound, the share, and
   B1-int8's time over bf16 B1's. Then the kernel's stage bisection
   (scripts/probe_trunk_int8_variants.py: v0 input quantized, v1 + c1, v2 +
   c2, full) at batch 8 of both main-path shapes, each stage held against
   trunk_int8_variant_plain (0 differing elements) and timed, with the
   launch count read around the probe, and the ptxas report of
   csrc/trunk_int8.cu (registers, spills, C7520), which must show no spill
   and no serialized wgmma.
2b. Trunk stage-bisection phase (B1'): at f32 and bf16 [8, 256, 1836, 3]
   and at the JAX probe's bf16 [64, 256, 1836, 3], holds every variant of
   the trunk kernel (v0 .. full) against its plain version, checks that
   "full" equals `trunk` bit for bit, then drives the probe's entry point
   (scripts/probe_trunk_variants.py:run_probe) with the launch count set to
   0 just before and read just after, and times each variant's plain
   version and its cuDNN prefix.
3. Raster kernel phase (B2): seeded box scenes (data/boxes.py: 8 scenes of
   max_bb 100 with 5-60 valid cars and trucks and the edge cases), the
   adversarial set (data/boxes.py:adversarial_boxes: thin rotated boxes on
   the 0.1 m grid, near-horizontal edges, boxes off the map, point boxes,
   whole-map boxes, odd rings, boxes beyond 2^60 px and non-finite ones)
   and items of 500 boxes, at sizes 800, 148 and 157: the kernel must equal
   its plain version with 0 differing pixels; on the seeded scenes at 800
   the device time of both kernels the wrapper launches (torch.profiler),
   its time per call back to back and the plain version's (CUDA events)
   beside the bound.
4. Roadmap serving phase: builds a full-width RoadMapBCEv2 (hidden 128,
   latent 64, 6x256x306 views) from a seed, writes it with
   export.save_task_ckpt, loads it back through cli.run_test.load_roadmap_model,
   and answers requests of 8 uint8 scenes through `predict` at precision 32
   and 16: two requests on the freshly loaded model must build the trunk's
   kernel weights once (kernels/trunk.py:prepare_weights.calls), then one
   warm-up and 5 timed requests under torch.profiler
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
6. RoIAlign kernel phase (B3): features [8, 400, 400, 32] in f32 and bf16
   and 1000 seeded rois an image (data/boxes.py:detection_rois: sides 16-512
   px in the 800-px image, some across its edge, some of zero size),
   spatial_scale 0.5: the kernel against its plain version, then its device
   time (torch.profiler), its time per call back to back, the plain
   version's, the two-call grid_sample + avg_pool2d yardstick's, and the
   bound from the feature pixels these rois touch. Also three odd shapes
   and a feature view 4 B off 16-B alignment; each shape prints the
   kernel instantiation it ran (16 B of channels a thread, or one).
6b. RoIAlign backward phase (B3-bwd): gradients of RoIAlign's output at
   the odd shapes of step 6 (and one 4 B off 16-B alignment) and at the
   detection training path's [8, 400, 400, 32] features with 512 seeded
   rois an image, in f32 and bf16: the kernel against its plain version
   (roialign_backward_plain, the JAX formulation), two launches bit-equal,
   its device time (torch.profiler), its time per call back to back, the
   plain version's, and the bound (g read once, dF written once).
7. Detection phase: a full-width FasterRCNNRoadMap (the JAX package's
   defaults: 800-px layout image, anchors 32..512 x {0.5, 1, 2}, 2000
   pre-NMS and 1000 post-NMS proposals, mlp 1024, 9 classes) from a seed,
   written with export.save_task_ckpt and loaded back through
   cli.eval_boxes.load_detection_task, at precision 32 and 16: one warm-up
   and 5 timed `predict` requests of 8 uint8 scenes and their road maps
   under torch.profiler, then `host_val_metrics` on 2 batches of 8 seeded
   scenes with categories. Each `predict` must launch the trunk (at
   [8, 800, 800, 3]) and RoIAlign once each; each `host_val_metrics` twice
   each (predict and the diagnostics pass). The RPN outputs, RoIAlign's
   output and the class posteriors on the same rois, and the detections
   are held against the same model with the plain kernels patched in. Then
   a BBFasterRCNN: one `predict` and one `host_val_metrics` at precision 32.
7b. Precision-8 serving phase: the RoadMapBCEv2, MultiTask and
   FasterRCNNRoadMap of steps 4, 5 and 7, loaded at precision 8: one
   warm-up request (it calibrates) and 5 timed requests of 8 uint8 scenes
   under torch.profiler. One calibration, one int8 weight layout, B1-int8
   once a request and bf16 B1 never; c3 bit-equal and logits, box
   probabilities and RPN outputs within 2^-5 against the same model with
   the plain int8 trunk; more than 99% of mask pixels (faster_rcnn_rm: RPN
   objectness signs) in agreement with the same model at precision 16 on
   the warm-up batch. Scenes/s, ms/request, device busy and idle share
   beside the precision-16 windows.
8. Training phase, precision 32, batches of 8 seeded uint8 scenes: the
   trunk under autograd (kernel forward, plain backward) at
   [8, 256, 1836, 3] against autograd through the plain trunk for x and the
   six parameters; then 5 Adam steps of a full-width BasicAE (hidden 128,
   latent 64) six-to-one pretraining and 3 steps of RoadMapBCEv2 over its
   frozen encoder (loaded from the BasicAE checkpoint), each from one init
   against the same steps with the plain kernels (same views and dropout
   masks from one seeded generator): loss trajectories within stated
   tolerances, B1 launched once a step (the backward launches none), the
   kernel weights laid out once a step (once in all for the frozen
   encoder), the frozen encoder's parameters bit-identical; ms per step,
   scenes/s, device idle share (steps 1.. under torch.profiler) and peak
   device memory.
8b. Box-training phase, precision 32, batch 8: spatial_bb, spatial_rm,
   multitask and bb_mlp over the BasicAE checkpoint of step 8 (reference
   geometry, max_bb 100, seeded box scenes from data/boxes.py), each from
   one init: 3 Adam steps (train/optim.py:Adam, the trainer's) with the
   freeze mask of epoch 0 (encoder frozen), then 2 with the mask of epoch 20
   (everything trains, B1's gradient through its op's backward), against the
   same steps with the plain trunk and rasterizer patched in (the same
   dropout draws from one seeded generator): loss trajectories within
   LOSS_TOL, the B2 targets equal to the plain rasterizer's, B1 once a step
   and B2 once a step (never for bb_mlp), one kernel-weight layout for the
   frozen steps and one after each update once the encoder trains, the
   encoder bit-identical while frozen; ms per step, and for each stage
   (its steps after the first, which autotunes cuDNN for the shapes new to
   it) scenes/s, device idle share and the device operations and aten
   operations (by input shape) that take the most time, under
   torch.profiler; peak device memory.
8c. Detection-training phase, precision 32, batch 8: faster_rcnn_rm and
   faster_rcnn (the JAX package's DetectionConfig defaults) over the
   BasicAE checkpoint of step 8, each from one init: the first step by
   parts against the plain trunk and the plain RoIAlign forward and
   backward (RPN losses, and RoI losses on the plain run's sampled rois,
   within 1e-4; differing proposals counted), then 3 Adam steps with the
   freeze mask of epoch 0 and 2 with that of epoch 10, against the same
   steps with the plain kernels (the samplers' noise from one seeded
   generator): losses after the first within LOSS_TOL, B1 and B3 once a
   step, B3-bwd once a step for faster_rcnn_rm and once an unfrozen step
   for faster_rcnn, one kernel-weight layout while frozen and one after
   each update once the encoder trains, the encoder bit-identical while
   frozen; ms a step, scenes/s, idle share, the device and aten
   operations that take the most time, NMS host checks a step, peak
   memory; then each stage of a faster_rcnn_rm step alone (B1, its
   backward, the RPN convs, matching, sampling, proposals with NMS, B3,
   B3-bwd, the box MLP): its device time under torch.profiler and its
   time on the stream by CUDA events.
9. Trainer phase, the main-path CLIs at the width of step 8 (batch 8,
   precision 32) on a synthetic dataset (data/synthetic.py: 5 unlabeled and
   5 labeled scenes of 8 samples, full-size JPEG views and 800x800 road
   maps, so 4 training batches and 1 validation batch per task):
   cli.basic_ae for 2 epochs of 4 batches; the same run stopped by
   --max_steps 5 and resumed from its last.ckpt, whose losses must match the
   uninterrupted run's within RESUME_TOL; cli.roadmap (bce_v2) over the
   basic_ae checkpoint with the encoder frozen in epoch 0 (bit-identical
   through it, one kernel-weight layout in all) and trained in epoch 1 (one
   layout after each Adam update); cli.run_test on the roadmap checkpoint,
   at precision 32 and at precision 8 (one calibration, B1-int8 once a
   batch and for the warm-up, bf16 B1 never, masks in > 99% agreement with
   precision 32's); cli.roadmap --precision 16 for 2 steps (B1's bf16
   kernel, finite losses); cli.roadmap --precision 8 for 2 steps and its
   validation batch (bf16 B1 each time, B1-int8 never, the uncalibrated
   message printed once); the box-family CLIs over the same encoder,
   frozen in epoch 0 and trained in epoch 1 as cli.roadmap is:
   cli.spatial_bb --variant rm (log_images every 2 batches), cli.multitask
   and cli.bb_mlp, with B1 and B2 launches counted in each training step,
   validation batch and log_images call; cli.multitask under deterministic
   algorithms, uninterrupted and stopped by --max_steps 5 and resumed, the
   resumed losses equal to the uninterrupted run's within RESUME_TOL;
   cli.multitask --precision 16 for 2 steps (B1's bf16 kernel);
   cli.faster_rcnn --variant rm over the same encoder, frozen in epoch 0
   and trained in epoch 1 (B1, B3, B3-bwd once each a training step, B1
   and B3 three times and B3-bwd never a validation batch: the eval loss,
   predict and the diagnostics), the same run under deterministic
   algorithms, uninterrupted and stopped by --max_steps 5 and resumed (the
   resumed losses equal to the uninterrupted run's within RESUME_TOL),
   --precision 16 for 2 steps (B1, B3 and B3-bwd in bf16) and --variant
   plain for 2 frozen steps (no B3-bwd);
   then the frozen roadmap_bce epochs through Trainer with device_prefetch's
   staging thread and with each batch pinned on the step's thread, in turns
   (PREFETCH_AB), median step_ms of each.
   B1 must launch once per train step, validation batch, log_images call
   and run_test batch (plus its warm-up), and B2 once per train step,
   validation batch and log_images call of the rasterizing tasks, counted
   from 0 around each CLI call. Each CLI run
   prints its scenes/s per epoch and median step_ms (from its
   metrics.jsonl), the device idle share over its last training epoch (or
   run_test's timed loop) under torch.profiler, its peak device memory and
   B1 launches, beside the bare loop's figures from step 8.
10. Decode phase: whether g++ finds jpeglib.h and png.h, whether the
   native decoder (data/_native.py) builds and why not, the bytes where it
   differs from PIL on the synthetic dataset, cli.run_test at precision 32
   and 8 and the first step of a cli.roadmap epoch with each decoder that
   builds (scenes/s, idle share, decodes by backend from
   data/dataset.py:DECODES), and metrics/threat.py:ats_bounding_boxes on
   the host, the native IoU loop against Python on the detection phase's
   scenes (equal values, ms a call).
11. Deploy phase: the roadmap checkpoint of step 4 at precision 32, 16 and
   8, the faster_rcnn_rm one of step 7 at 32 and 16, the multitask one of
   step 5 and a spatial_rm one from the seed, each exported at batch 8
   (export.py, traced on the card), then loaded and served in a fresh
   process (scripts/serve_artifacts.py): no model module imported by the
   loads; B1, B1-int8 and B3 launched a request as each model's predict
   launches them; after a warm-up, three windows of 50 requests of 8 uint8
   scenes a path, alternating between the artifact and the same model's
   predict on the same inputs (scenes/s of each window, median and range;
   ms a request, median and 10th / 90th percentile; device ops under
   torch.profiler); their answers on 10 distinct requests equal at
   precision 32, within the serving phases' bars at 16 and 8; one HTTP
   round trip on 127.0.0.1, port 0; swap_params from a second checkpoint
   (masks changed, equal to its predict's) and the refusal of a drifted
   state.
12. Mesh phase (multi-device training): two ranks spawned on cuda:0
   (parallel/launch.py), which they share over gloo, the one layout one
   card allows: gloo's all_reduce, all_gather and broadcast of CUDA
   tensors checked; the decoder's widest dropout draw for the global batch
   and for a rank's half timed; BasicAE dp=2 (3 steps, dropout and the
   six-to-one mask on), roadmap_bce frozen dp=1 x tp=2 (3 steps, its
   shards' shapes checked), multitask dp=2 (2 steps, B2 in each rank's
   loss) and spatial_rm dp=1 x tp=2 over step 8's BasicAE (3 steps, the
   reference geometry, its heads' convs cut on their output channels and
   their activations gathered over 'model', its shards' shapes checked;
   cuDNN's default algorithms on both sides, the replicated up_conv_5's
   gradient averaged over 'model' once a step), full
   width, each against the one-process run of the same global batches
   from the same seed within MESH_LOSS_TOL, one gradient sum a step on
   every data rank, every rank's final weights equal and rank 0's within
   MESH_STATE_TOL of one process's, B1 (and B2) once a step on every
   rank; ms a step beside one process's, the gradient all-reduce's bytes
   and ms a step, the 'model' axis's gathers and sums (count, bytes, ms a
   step), peak memory per rank, the backend; then cli.roadmap --gpus 2
   --model_parallel 2 --device cuda:0 stopped at step 2 and resumed in one
   process, within RESUME_TOL of the uninterrupted 2-rank run. Ranks
   sharing a card give no scaling figure.
12c. Submit phase: cli.submit's roadmap_bce grid (2 trials of 2 steps and
   one validation batch) over step 8's BasicAE on the trainer phase's
   synthetic dataset, in this process (B1 launches counted a trial, finite
   val_loss); then --on_cluster --parallel_trials 2 on the one card, which
   must print the clamp to 1 and run its trial as a subprocess with
   CUDA_VISIBLE_DEVICES=0 (return code 0, finite val_loss, its log).
13. Prints the card's name and power limit, one JSON line of kernel records
   (with each kernel's launches a request from the artifacts of step 11,
   per rank in phase 12 and per trial in phase 12c), and last the JSON
   line {"ok": true, "device": {...}}.

TF32 is off for cuDNN and cuBLAS in every phase (printed at each).

Every phase raises on failure. Without a CUDA card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import ExitStack, contextmanager, nullcontext, redirect_stdout
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from PIL import Image
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from driving_dirty_tpu_torch.cli import basic_ae as cli_basic_ae
from driving_dirty_tpu_torch.cli import common as cli_common
from driving_dirty_tpu_torch.cli import bb_mlp as cli_bb_mlp
from driving_dirty_tpu_torch.cli import faster_rcnn as cli_faster_rcnn
from driving_dirty_tpu_torch.cli import multitask as cli_multitask
from driving_dirty_tpu_torch.cli import roadmap as cli_roadmap
from driving_dirty_tpu_torch.cli import run_test as cli_run_test
from driving_dirty_tpu_torch.cli import spatial_bb as cli_spatial_bb
from driving_dirty_tpu_torch.cli import submit as cli_submit
from driving_dirty_tpu_torch.cli.eval_boxes import load_detection_task
from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.data.boxes import (adversarial_boxes, box_scenes, detection_rois,
                                                detection_scenes)
from driving_dirty_tpu_torch import export as ddx
from driving_dirty_tpu_torch.data import dataset as dataset_module
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.export import load_task_ckpt, save_task_ckpt
from driving_dirty_tpu_torch.metrics import threat as threat_module
from driving_dirty_tpu_torch.kernels import build
from driving_dirty_tpu_torch.kernels import trunk as trunk_module
from driving_dirty_tpu_torch.kernels.raster import raster, raster_plain
from driving_dirty_tpu_torch.kernels import roialign as roialign_module
from driving_dirty_tpu_torch.kernels.roialign import (channels_per_thread, grad_channels_per_load, roialign,
                                                      roialign_backward, roialign_backward_plain, roialign_plain,
                                                      sample_coords)
from driving_dirty_tpu_torch.kernels.trunk import (VARIANT_STAGES, out_hw, prepare_weights, trunk,
                                                   trunk_plain, trunk_variant, trunk_variant_plain)
from driving_dirty_tpu_torch.kernels.trunk_int8 import (prepare_int8_weights, trunk_int8,
                                                        trunk_int8_plain, trunk_int8_variant,
                                                        trunk_int8_variant_plain)
from driving_dirty_tpu_torch.models.basic_ae import BasicAE
from driving_dirty_tpu_torch.models.bb_mlp import Boxes
from driving_dirty_tpu_torch.models.faster_rcnn import BBFasterRCNN, FasterRCNNRoadMap
from driving_dirty_tpu_torch.models.multitask import MultiTask
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap, box_targets
from driving_dirty_tpu_torch.ops import detection as det
from driving_dirty_tpu_torch.ops import quant
from driving_dirty_tpu_torch.ops.maps import raster_geometry
from driving_dirty_tpu_torch.ops.stitch import normalize_images, wide_stitch
from driving_dirty_tpu_torch.scripts import probe_trunk_int8_variants as int8_probe
from driving_dirty_tpu_torch.scripts.probe_trunk_variants import device_line, probe_inputs, run_probe
from driving_dirty_tpu_torch.data.pipeline import tree_map
from driving_dirty_tpu_torch.parallel import launch
from driving_dirty_tpu_torch.train import trainer as trainer_module
from driving_dirty_tpu_torch.train.optim import Adam

SEED = 0
BATCH = 8
VIEW_H, VIEW_W = 256, 306
PANO = (VIEW_H, 6 * VIEW_W)          # 256 x 1836, the roadmap path's trunk input
PROBE_RUNS = ((torch.float32, BATCH), (torch.bfloat16, BATCH), (torch.bfloat16, 64))  # B1' (dtype, batch)
LAYOUT = (800, 800)                  # the detection path's trunk input (the layout image)
REQUESTS = 5                         # timed requests per precision, after one warm-up
DEPLOY_REQUESTS = 50                 # phase 11: requests in each timed window of a path
DEPLOY_POOL = 10                     # phase 11: distinct requests, cycled through by the windows
HPARAMS = dict(ae_hidden_dim=128, ae_latent_dim=64, pretrained_path=None, batch_size=BATCH)

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and ops/s by type
# (float32 on the CUDA cores, tf32, bfloat16 and int8 on the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, "tf32": 495e12, torch.bfloat16: 989e12, "int8": 1979e12}
F32_PRODUCTS = 3  # TF32 products per f32 product in the f32 trunk (split TF32)
TRUNK_DESIGN = {torch.float32: "split-tf32 mma.sync.m16n8k8", torch.bfloat16: "mma.sync.m16n8k16"}

# Trunk kernel vs plain version, max |error| <= TOL * max|plain| (no floor:
# the outputs here are well below 1, so an absolute floor would let a wrong
# kernel through):
#  f32: the kernel's split-TF32 products are within about 2^-21 of f32
#       products (a few 1e-6 of the largest output over K <= 288 terms),
#       and both accumulate in f32 (cuDNN with TF32 off), in another order:
#       2e-4 of the largest output covers that, as the JAX package's
#       fused-vs-XLA trunk test allows; one TF32 product alone misses it.
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

# B1-int8 (precision 8): the kernel must equal its plain version with 0
# differing elements (exact int32 sums, the plain version's f32 epilogue
# operations one by one) at the main paths' shapes, two odd ones, and the
# JAX package's int8 headline batch (bench.py:30, BATCH_INT8 = 512), where
# the plain version (float64 convs) runs in chunks of INT8_CHUNK images and
# only the first and last chunk are held.
INT8_SHAPES = ((BATCH, *PANO, 3), (BATCH, *LAYOUT, 3), (2, 17, 35, 3), (3, 37, 101, 3))
INT8_HEADLINE, INT8_CHUNK = 512, 8
INT8_DESIGN = ("mma.sync.m16n8k32.s8, 16x16 c3 tiles of 8 warps, two CTAs an SM, int8 q1/q2 in shared memory, "
               "an epilogue without int<->float conversions")
# Precision-8 serving against the same model at precision 16 on one batch:
# the JAX package's bar for the int8 trunk against the float path is > 99%
# of mask pixels (tests/test_quant.py:80-94); for faster_rcnn_rm, which
# gives boxes, not masks, the sign of the RPN objectness logits.
P8_AGREEMENT = 0.99
# Precision-8 logits, probabilities and RPN outputs against the same model
# with the plain int8 trunk patched in: c3 is bit-equal, and the bf16 heads
# run the same kernels on it: 2^-5 of the largest value, as at precision 16.
P8_TOL = 2.0 ** -5

MAX_BB = 100                         # boxes per scene, padded (the dataset's max_bb)
RASTER_SIZES = (800, 148, 157)       # the main path's size and two that fit no tile
RASTER_KERNELS = ("raster_records_kernel", "raster_spans_kernel")  # what `raster` launches
# f32 operations of an exact rasterizer: in each row a box meets, the four
# edge tests (2 subtractions, 2 multiplications, 1 comparison) at the two
# ends of its span; and one operation per output pixel
RASTER_OPS_PER_ROW_BOX = 40
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

# RoIAlign kernel vs plain, max |error| <= ROI_TOL * max|plain|, in either
# feature dtype: both read the same taps with the same f32 weights (the
# sample coordinates are computed without fma contraction on both sides);
# each output is a convex combination of 16 taps whose products and sums
# round in another order, at most about 16 f32 ulps of the largest value.
ROI_TOL = 4e-6
ROIS = 1000                          # rois an image, the detection head's post-NMS count
ROI_FEATS = (BATCH, 400, 400, 32)    # c3 of the 800-px layout image
ROI_ODD = ((2, 37, 53, 24, 1), (1, 21, 30, 32, 1001), (3, 16, 19, 3, 33))
ROI_KW = dict(output_size=7, spatial_scale=0.5, sampling_ratio=2)
# detection head, default config: 16 taps x (multiply + add) per output value
ROI_OPS_PER_OUTPUT = 32
DET_HPARAMS = dict(pretrained_path=None, batch_size=BATCH)  # the JAX package's defaults
DET_SIZE = 800                       # the layout image and road map side
# Detection path vs the same model with the plain kernels, max |error| <=
# this * max|plain| on the RPN objectness and deltas and on the class
# posteriors: f32 1e-4, as the logits above; bf16 2^-5 (c3 maps a bf16 ulp
# or two apart, and the pooled f32 values rounded to bf16 before the
# 1568-wide box MLP).
DET_TOL = {32: 1e-4, 16: 2.0 ** -5}
# f32: share of the plain run's valid detections that the kernel run also
# returns (same label, IoU >= 0.99). Only scores within f32 rounding of each
# other can swap ranks, and a swap changes a detection only at a cut-off or
# between overlapping boxes of one class.
DET_AGREEMENT = 0.99
# B3-bwd (RoIAlign's backward) against roialign_backward_plain, max |error|
# <= this * max|plain|: f32: both sum in f32, the kernel sample by sample in
# roi order, the plain version through the bin interpolation matrices; the
# sample-level sums lie within 6.4e-6 of the largest value from a float64
# sum where 1001 rois crowd a 21 x 30 map, the plain version's within
# 2.2e-7 (measured on the CPU): 1e-5. bf16: the plain version rounds By, Bx, g and u to bf16 as
# the JAX package does (up to 3.95e-3 of the largest value from float64 on
# the CPU), the kernel rounds its f32 sum once (2^-9 of each value): 2^-6.
ROI_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
ROI_SAMPLED = 512                    # rois an image in detection training (box_batch_per_image)
ROI_BWD_OPS_PER_TAP = 2              # per channel: multiply by the tap's weight, add
# Detection-training phase: FasterRCNNRoadMap and BBFasterRCNN at the JAX
# package's DetectionConfig defaults over the training phase's BasicAE
# checkpoint, batch 8 f32, train/optim.py:Adam: DET_FROZEN steps with the
# freeze mask of epoch 0, then DET_UNFROZEN with that of epoch DET_UNFREEZE
# (the default unfreeze_epoch_no), against the same steps with the plain
# trunk and the plain RoIAlign forward and backward patched in, the
# samplers' noise from one seeded generator. A last-bit trunk difference
# can swap a proposal at the 2000 cut or in NMS and change the RoI samples,
# so the first step is held by parts: the RPN losses (their labels come
# from the anchors and GT alone) and the RoI losses on the plain run's
# sampled rois, each to DET_STEP0_TOL relative; the differing proposals are
# counted. Later steps' losses within LOSS_TOL[1].
DET_FROZEN, DET_UNFROZEN, DET_UNFREEZE = 3, 2, 10
DET_TRAIN_TASKS = (FasterRCNNRoadMap, BBFasterRCNN)
DET_STEP0_TOL = 1e-4

# Training phase: BasicAE six-to-one pretraining at the full width of
# HPARAMS, then the roadmap_bce fine-tune over its frozen encoder, with
# torch.optim.Adam (the update of optax.adam).
AE_HPARAMS = dict(hidden_dim=HPARAMS["ae_hidden_dim"], latent_dim=HPARAMS["ae_latent_dim"],
                  batch_size=BATCH)
AE_STEPS, RM_STEPS = 5, 3
LR = 1e-3
# The trunk's gradients under autograd (kernel forward, plain backward)
# against autograd through the plain trunk, for one cotangent, max |error| <=
# GRAD_TOL * max|plain|: both run the same backward on the same inputs;
# only cuDNN's reduction order (sums of up to 3.7M terms) can differ.
GRAD_TOL = 1e-4
# Losses of the kernel run against the plain-kernel run from one init, with
# the same masked views and dropout masks: the first step's loss (no update
# yet) differs only by the trunk's split-TF32 forward, a few 1e-6 of c3:
# 1e-4, as the logits. Later steps: 5e-2, since Adam turns gradient noise
# into sign-like +-lr steps on weights whose gradient is float noise
# (tests/test_training_dynamics_parity.py measured up to 1.7% loss drift
# over 30 steps between XLA and ATen and allows 5%).
LOSS_TOL = (1e-4, 5e-2)

# Box-training phase: spatial_bb, spatial_rm, multitask and bb_mlp over the
# training phase's BasicAE checkpoint, batch 8 f32, train/optim.py:Adam as
# the trainer runs it (optax's global count across the unfreeze):
# BOX_FROZEN steps with the freeze mask of epoch 0 (encoder frozen), then
# BOX_UNFROZEN with the mask of epoch BOX_UNFREEZE (the default
# unfreeze_epoch_no: everything trains). Losses against the plain kernels'
# run within LOSS_TOL.
BOX_FROZEN, BOX_UNFROZEN, BOX_UNFREEZE = 3, 2, 20
BOX_TRAIN_TASKS = (BBSpatialModel, BBSpatialRoadMap, MultiTask, Boxes)

# Trainer phase: the main-path CLIs on a synthetic dataset (data/synthetic.py)
# of full-size JPEG views and 800x800 road maps. CLI_SCENES unlabeled and as
# many labeled scenes of CLI_SAMPLES samples: the 80/20 scene split leaves 4
# scenes (4 batches of 8) to train on and 1 (1 batch) to validate, per task.
CLI_SCENES, CLI_SAMPLES, CLI_BATCHES, CLI_EPOCHS = 5, 8, 4, 2
# Decode phase (10): the native decoder's headers, and the steps of the
# cli.roadmap epoch whose first step shows the loader's start
NATIVE_HEADERS = ("jpeglib.h", "png.h")
DECODE_STEPS = 3
# Deploy phase (11): (kind, precision) -> the checkpoint of an earlier phase
# exported at batch BATCH, and the (B1, B1-int8, B3) launches a request of
# each artifact: what its model's predict launches
DEPLOY_EXPORTS = {("roadmap", 32): "roadmap_bce.ckpt", ("roadmap", 16): "roadmap_bce.ckpt",
                  ("roadmap", 8): "roadmap_bce.ckpt", ("detection", 32): "faster_rcnn_rm.ckpt",
                  ("detection", 16): "faster_rcnn_rm.ckpt", ("multitask", 32): "multitask.ckpt",
                  ("spatial", 32): "spatial_rm.ckpt"}
DEPLOY_NAMES = {f"{kind}_{precision}": (kind, precision) for kind, precision in DEPLOY_EXPORTS}
DEPLOY_LAUNCHES = {("roadmap", 32): (1, 0, 0), ("roadmap", 16): (1, 0, 0), ("roadmap", 8): (0, 1, 0),
                   ("detection", 32): (1, 0, 1), ("detection", 16): (1, 0, 1), ("multitask", 32): (1, 0, 0),
                   ("spatial", 32): (1, 0, 0)}
CLI_AE_STOP = 5  # --max_steps of the interrupted basic_ae and multitask runs: mid-epoch 1
CLI_IMG_FREQ = 2  # --output_img_freq of cli.spatial_bb: log_images at batches 0 and 2 of each epoch
# train_loss of the resumed basic_ae steps against the uninterrupted run's,
# |relative| <= RESUME_TOL. Both take the same steps on the same batches with
# the same masked views and dropout (the step generator's state is in the
# checkpoint) from the same weights and Adam state. In the default modes two
# runs of the same steps differ: some of cuDNN's backward algorithms sum in
# an order that changes from run to run, and Adam's early sign-like steps
# turn those last-bit differences into +-lr steps on weights whose gradient
# is float noise, which moves the loss by as much as a wrong batch or view
# could. So the basic_ae
# runs use deterministic algorithms (cuDNN's, and torch's with a warning for
# any op that has none, printed), under which the same kernels run on the
# same data in the same order: the losses must be equal but for the
# rounding of their JSON log (1e-6).
RESUME_TOL = 1e-6
# device_prefetch A/B: the frozen roadmap_bce epochs with its staging
# thread against pinning each batch on the step's thread (the pipeline
# before the staging thread), in turns; each a Trainer run of CLI_EPOCHS
# frozen epochs without checkpoints
PREFETCH_AB = ("staged", "pinned on the step's thread", "pinned on the step's thread", "staged")


def cuda_ms(fn, budget_ms: float = 400.0, min_iters: int = 3) -> float:
    """Mean time of fn() on the current stream by CUDA events, after a
    warm-up, over enough calls (at least min_iters) to fill about
    budget_ms."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(max(min_iters, min(50, budget_ms / max(start.elapsed_time(end), 1e-3))))
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


def conv_bound(macs: int, nbytes: int, dtype) -> dict:
    """Least time of a trunk kernel's `macs` products and `nbytes` of traffic
    -> {"bound_ms", "bound_by"}: bf16 products on the bf16 tensor cores;
    f32 ones as F32_PRODUCTS TF32 products each, the work of the split-TF32
    kernel, and beside it "cuda_core_bound_ms", the same f32 products as
    FMAs on the CUDA cores."""
    t_bytes = nbytes / PEAK_BYTES
    if dtype == torch.float32:
        t_ops = F32_PRODUCTS * 2 * macs / PEAK_OPS["tf32"]
    else:
        t_ops = 2 * macs / PEAK_OPS[dtype]
    rec = {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if dtype == torch.float32:
        rec["cuda_core_bound_ms"] = 1e3 * max(2 * macs / PEAK_OPS[torch.float32], t_bytes)
    return rec


def trunk_bound(x) -> dict:
    b, h, w, _ = x.shape
    ho, wo = out_hw(h, w)
    macs = b * (h * w * 32 * 27 + h * w * 32 * 288 + ho * wo * 32 * 288)
    nbytes = (x.numel() + b * ho * wo * 32) * x.element_size() + 4 * (2 * 32 * 32 * 9 + 32 * 27 + 96)
    return conv_bound(macs, nbytes, x.dtype)


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
    for (path, hw), dtype in [(p, d) for p in (("roadmap", PANO), ("detection", LAYOUT))
                              for d in (torch.float32, torch.bfloat16)]:
        if path == "roadmap":
            check_trunk(gen, dtype, (2, 17, 35, 3))  # odd H and W, partial tiles
        c = check_trunk(gen, dtype, (BATCH, *hw, 3))
        x, p = c["x"], c["params"]
        ms = cuda_ms(lambda: trunk(x, *p))
        plain_ms = cuda_ms(lambda: trunk_plain(x, *p))
        library_ms = cuda_ms(lambda: trunk_library(x, *p))
        bound = trunk_bound(x)
        records.append({
            "name": "trunk", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/trunk.cu",
            "replaces": "driving_dirty_tpu/pallas/trunk.py:245 (fused_trunk)",
            "design": TRUNK_DESIGN[dtype], "path": path, "shape": list(x.shape), "dtype": str(dtype)[6:],
            **{k: c[k] for k in ("max_abs_err", "tol", "mean_abs_err", "max_abs_plain",
                                 "mean_abs_plain")},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **bound, "roofline_share": bound["bound_ms"] / ms,
        })
        cuda_core = (f", CUDA-core f32 bound {bound['cuda_core_bound_ms']:.3f} ms"
                     if "cuda_core_bound_ms" in bound else "")
        print(f"trunk {str(dtype)[6:]} {list(x.shape)} ({TRUNK_DESIGN[dtype]}): kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
              f"({bound['bound_by']}){cuda_core}", flush=True)
        del x, p, c
        torch.cuda.empty_cache()
    return records


def variant_work(x, stages: int) -> tuple[int, int]:
    """(products, bytes) of one stage-bisection variant (stages < 3) at x's
    shape: the products its output needs (the stage-1 variant: c1 at the c3
    positions; stage 2: c1 everywhere and c2 at the c3 positions), and its
    bytes (the input it reads, all of x but for stage 0's quarter, and the
    output at the c3 positions)."""
    b, h, w, _ = x.shape
    ho, wo = out_hw(h, w)
    macs = b * ((0, ho * wo * 32 * 27, h * w * 32 * 27 + ho * wo * 32 * 288)[stages])
    pixels_in = b * ho * wo if stages == 0 else b * h * w
    return macs, (pixels_in * 3 + b * ho * wo * 32) * x.element_size()


def variant_bound(x, stages: int) -> dict:
    """Least time of one B1 stage-bisection variant at x's shape
    (conv_bound of variant_work; full: the trunk)."""
    return trunk_bound(x) if stages == 3 else conv_bound(*variant_work(x, stages), x.dtype)


def variant_library(x, w1, b1, w2, b2, w3, b3, *, stages: int):
    """cuDNN's conv chain cut to a variant's output (v1: c1 at stride 2; v3:
    c1, then c2 at stride 2), channels-last; None for v0. Timed only."""
    y = x.permute(0, 3, 1, 2)
    for i, (w, b) in enumerate(((w1, b1), (w2, b2), (w3, b3))[:stages]):
        w = w.to(x.dtype).contiguous(memory_format=torch.channels_last)
        stride = 2 if i == stages - 1 else 1  # the last conv runs at the c3 positions only
        y = torch.relu(torch.nn.functional.conv2d(y, w, b.to(x.dtype), stride=stride, padding=1))
    return y


def probe_phase() -> list[dict]:
    """B1': every variant against its plain version and "full" against
    `trunk`, then the probe's entry point with the launch count read around
    it, for each PROBE_RUNS (dtype, batch) at the panorama shape."""
    records = []
    for dtype, batch in PROBE_RUNS:
        x, p = probe_inputs(batch, dtype)
        label = f"trunk_variant {str(dtype)[6:]} {list(x.shape)}"
        checks = {}
        for v in VARIANT_STAGES:
            checks[v] = hold(f"{label} {v}", trunk_variant(x, *p, variant=v),
                             trunk_variant_plain(x, *p, variant=v), TOL[dtype])
        if not torch.equal(trunk_variant(x, *p, variant="full"), trunk(x, *p)):
            raise RuntimeError(f"{label}: full differs from trunk")
        print(f"{label}: full equals trunk bit for bit", flush=True)
        trunk_variant.launches = 0
        probe = run_probe(batch, dtype)
        launches = trunk_variant.launches
        if sum(r["launches"] for r in probe) != launches or not all(r["launches"] for r in probe):
            raise RuntimeError(f"{label}: probe launches {[r['launches'] for r in probe]}, counted {launches}")
        for r in probe:
            v, stages = r["variant"], r["stages"]
            plain_ms = cuda_ms(lambda: trunk_variant_plain(x, *p, variant=v))
            library_ms = cuda_ms(lambda: variant_library(x, *p, stages=stages)) if stages else None
            bound = variant_bound(x, stages)
            same = [u for u, s in VARIANT_STAGES.items() if s == stages and u != v]
            records.append({
                "name": "trunk_variant", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/trunk.cu",
                "replaces": f"scripts/probe_trunk_variants.py:123 ({v})", "design": TRUNK_DESIGN[dtype],
                "variant": v, "stages": stages,
                "same_program_as": same, "path": "probe", "shape": list(x.shape), "dtype": str(dtype)[6:],
                **{k: checks[v][k] for k in ("max_abs_err", "tol", "max_abs_plain")},
                "launches": r["launches"], "ms": r["ms"], "scenes_per_s": r["scenes_per_s"],
                "plain_ms": plain_ms, "library_ms": library_ms, **bound,
                "roofline_share": bound["bound_ms"] / r["ms"]})
            print(f"{label} {v}: kernel {r['ms']:.3f} ms ({r['scenes_per_s']:.1f} scenes/s, "
                  f"{r['launches']} launches), plain {plain_ms:.3f} ms, library "
                  f"{'-' if library_ms is None else f'{library_ms:.3f} ms'}, bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']})", flush=True)
        del x, p
        torch.cuda.empty_cache()
    return records


def int8_ops_bound(macs: int, nbytes: int) -> dict:
    """Least time of `macs` int8 products at 1,979 TOPS against `nbytes`
    over 3.35 TB/s."""
    t_ops, t_bytes = 2 * macs / PEAK_OPS["int8"], nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes_bound_ms": 1e3 * t_bytes}


def int8_bound(x) -> dict:
    """Least time of B1-int8 on x: its products as int8 operations (c1's 27
    products a position, c2's and c3's 288), against the bf16 input read
    once, the bf16 c3 written once and its weights and epilogue constants
    (19,456 + 768 B)."""
    b, h, w, _ = x.shape
    ho, wo = out_hw(h, w)
    macs = b * (h * w * 32 * 27 + h * w * 32 * 288 + ho * wo * 32 * 288)
    return int8_ops_bound(macs, (x.numel() + b * ho * wo * 32) * x.element_size() + 19456 + 768)


def int8_library_layers(params, scales):
    """Per layer, what the library route needs: the int8 weight as a [K, 32]
    GEMM operand (K = 9 * Cin, zero rows to a multiple of 8), the combined
    scales, the f32 bias and the stride."""
    layers = []
    for i, (w, b, stride) in enumerate(quant.trunk_params(params)):
        wq, w_inv = quant.quantize_conv_weight(w)
        bmat = wq.permute(2, 3, 1, 0).reshape(-1, 32)
        bmat = torch.cat([bmat, bmat.new_zeros((-bmat.shape[0] % 8, 32))])
        layers.append((bmat, quant.combined_scale(1.0 / scales[i], w_inv), b.float(), stride))
    return layers


def int8_library(x, layers, scales):
    """The nearest library route, timed only (the port never calls it): per
    layer an im2col of the int8 input (a copy), torch._int_mm (cuBLASLt's
    int8 GEMM with int32 sums) and the epilogue in torch."""
    q = quant.quantize(x, scales[0])
    for i, (bmat, comb, bias, stride) in enumerate(layers):
        b, h, w, c = q.shape
        cols = torch.nn.functional.pad(q, (0, 0, 1, 1, 1, 1)).unfold(1, 3, stride).unfold(2, 3, stride)
        ho, wo = cols.shape[1:3]
        a = cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, 9 * c)
        a = torch.nn.functional.pad(a, (0, bmat.shape[0] - a.shape[1]))
        y = torch.relu(torch._int_mm(a, bmat).float() * comb + bias).to(x.dtype).reshape(b, ho, wo, 32)
        if i < 2:
            q = quant.quantize(y, scales[i + 1])
    return y


def chunked(fn, x, chunk: int = INT8_CHUNK):
    """fn over x in chunks of `chunk` images (the plain version's float64
    convs and the library route's im2col do not fit at batch 512)."""
    return [fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)]


def int8_phase(gen) -> list[dict]:
    """B1-int8 at INT8_SHAPES and the headline batch: 0 differing elements
    against trunk_int8_plain, then (main-path shapes and batch 512) the
    kernel, the plain version, bf16 B1 on the same input and the library
    route by CUDA events, beside the bound. Scales are calibrated on the
    input itself (its first INT8_CHUNK images)."""
    records = []
    for shape in INT8_SHAPES + ((INT8_HEADLINE, *PANO, 3),):
        x, params = trunk_args(gen, torch.bfloat16, shape)
        scales = quant.calibrate_trunk(params, x[:INT8_CHUNK])
        label = f"trunk_int8 {list(shape)}"
        with torch.no_grad():
            got = trunk_int8(x, *params, scales)
            if shape[0] > INT8_CHUNK:  # the headline batch: first and last chunk
                held = [(got[:INT8_CHUNK], trunk_int8_plain(x[:INT8_CHUNK], *params, scales)),
                        (got[-INT8_CHUNK:], trunk_int8_plain(x[-INT8_CHUNK:], *params, scales))]
            else:
                held = [(got, trunk_int8_plain(x, *params, scales))]
        torch.cuda.synchronize()
        diff = sum(int((g != r).sum()) for g, r in held)
        n = sum(r.numel() for _, r in held)
        if diff or any(g.shape != r.shape for g, r in held) or not all(torch.isfinite(g).all() for g, _ in held):
            raise RuntimeError(f"{label}: {diff} of {n} elements differ from trunk_int8_plain")
        scale = max(r.float().abs().max().item() for _, r in held)
        print(f"{label}: 0 of {n} elements differ from trunk_int8_plain"
              f"{' (first and last ' + str(INT8_CHUNK) + ' images)' if shape[0] > INT8_CHUNK else ''}, "
              f"max|plain| {scale:.3e}, scales {scales}", flush=True)
        if shape not in ((BATCH, *PANO, 3), (BATCH, *LAYOUT, 3), (INT8_HEADLINE, *PANO, 3)):
            continue
        reps = 1 if shape[0] > INT8_CHUNK else 3  # calls timed at batch 512 (seconds each)
        with torch.no_grad():
            ms = cuda_ms(lambda: trunk_int8(x, *params, scales))
            bf16_ms = cuda_ms(lambda: trunk(x, *params))
            plain_ms = cuda_ms(lambda: chunked(lambda v: trunk_int8_plain(v, *params, scales), x), min_iters=reps)
            library_ms = library_diff = None
            try:
                layers = int8_library_layers(params, scales)
                library_diff = int((int8_library(x[:INT8_CHUNK], layers, scales) != held[0][1]).sum())
                library_ms = cuda_ms(lambda: chunked(lambda v: int8_library(v, layers, scales), x), min_iters=reps)
                library_how = "im2col + torch._int_mm + epilogue, per layer"
            except RuntimeError as e:  # torch._int_mm refusing these shapes
                library_how = f"none: torch._int_mm refused ({str(e).splitlines()[0][:120]})"
        bound = int8_bound(x)
        path = {PANO: "roadmap", LAYOUT: "detection"}[tuple(shape[1:3])] if shape[0] == BATCH else "headline"
        records.append({
            "name": "trunk_int8", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/trunk_int8.cu",
            "replaces": "driving_dirty_tpu/ops/quant.py:139 (encoder_convs_int8, static scales: XLA int8 "
                        "convs, no Pallas twin)",
            "design": INT8_DESIGN, "path": path,
            "shape": list(shape), "dtype": "bfloat16", "scales": list(scales),
            "max_abs_err": 0.0, "differing_elements": diff, "held_elements": n, "max_abs_plain": scale,
            "ms": ms, "plain_ms": plain_ms, "plain_how": f"float64 convs, in chunks of {INT8_CHUNK}",
            "bf16_trunk_ms": bf16_ms, "ratio_to_bf16": ms / bf16_ms, "library_ms": library_ms,
            "library_calls": library_how + (f", in chunks of {INT8_CHUNK}" if library_ms is not None else ""),
            "library_differing_elements": library_diff,
            **bound, "roofline_share": bound["bound_ms"] / ms})
        print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms ({records[-1]['plain_how']}), "
              f"bf16 B1 {bf16_ms:.4f} ms (B1-int8 / bf16 B1 {ms / bf16_ms:.3f}), library ({library_how}) "
              f"{'-' if library_ms is None else f'{library_ms:.3f} ms ({library_diff} elements differ from plain)'}, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; bytes {bound['bytes_bound_ms']:.4f} ms), "
              f"share {bound['bound_ms'] / ms:.3f}", flush=True)
        del x, params, got, held
        torch.cuda.empty_cache()
    return records


def int8_variant_bound(x, stages: int) -> dict:
    """Least time of one B1-int8 stage variant at x's shape: variant_work's
    products as int8 operations (full: int8_bound)."""
    return int8_bound(x) if stages == 3 else int8_ops_bound(*variant_work(x, stages))


def int8_variant_phase() -> list[dict]:
    """B1-int8's stage bisection: the ptxas report of csrc/trunk_int8.cu
    (no spill, no serialized wgmma, or this raises), then the probe's
    run_probe at batch 8 of both main-path shapes (each stage held against
    trunk_int8_variant_plain with 0 differing elements, and timed beside
    bf16 B1) with the launch count read around it, and each stage's plain
    version timed on the same seeded inputs."""
    rep = int8_probe.ptxas_report()
    print(f"trunk_int8 {int8_probe.ptxas_line(rep)}", flush=True)
    if rep["built"] and (rep["spill_bytes"] or rep["c7520"]):
        raise RuntimeError(f"trunk_int8.cu: {rep['spill_bytes']} spill bytes, C7520 {rep['c7520']}")
    trunk_int8_variant.launches = 0
    probe = int8_probe.run_probe(BATCH)
    launches = trunk_int8_variant.launches
    if sum(r["launches"] for r in probe) != launches or not all(r["launches"] for r in probe):
        raise RuntimeError(f"int8 probe launches {[r['launches'] for r in probe]}, counted {launches}")
    records = []
    for path, hw in int8_probe.SHAPES.items():
        x, params, scales = int8_probe.probe_inputs(BATCH, hw)
        with torch.no_grad():
            for r in (r for r in probe if r["path"] == path):
                v, stages = r["variant"], r["stages"]
                plain_ms = cuda_ms(lambda: trunk_int8_variant_plain(x, *params, scales, variant=v))
                bound = int8_variant_bound(x, stages)
                records.append({
                    "name": "trunk_int8_variant", "route": "cuda",
                    "source": "driving_dirty_tpu_torch/csrc/trunk_int8.cu",
                    "replaces": f"driving_dirty_tpu/ops/quant.py:139 (encoder_convs_int8), stage {v} "
                                "(scripts/probe_trunk_int8_variants.py)",
                    "design": INT8_DESIGN, "variant": v, "stages": stages, "path": path, "shape": r["shape"],
                    "dtype": "bfloat16", "max_abs_err": 0.0, "differing_elements": 0,
                    "held_elements": r["held_elements"], "launches": r["launches"], "ms": r["ms"],
                    "bf16_trunk_ms": r["bf16_trunk_ms"], "ratio_to_bf16": r["ratio_to_bf16"],
                    "plain_ms": plain_ms, "library_ms": None, **bound,
                    "roofline_share": bound["bound_ms"] / r["ms"]})
                print(f"trunk_int8_variant {r['shape']} {v}: kernel {r['ms']:.4f} ms ({r['ratio_to_bf16']:.3f} of "
                      f"bf16 B1's {r['bf16_trunk_ms']:.4f} ms; {r['launches']} launches), 0 of "
                      f"{r['held_elements']} elements differ, plain {plain_ms:.3f} ms, bound "
                      f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
        del x, params
        torch.cuda.empty_cache()
    return records


def device_us(event) -> float:
    """Device time of a traced kernel or copy, in microseconds."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def kernel_device_ms(fn, kernels: tuple[str, ...], calls: int = 50) -> dict:
    """Mean device time per call of fn() of each of `kernels` (every kernel
    fn launches, by name), from torch.profiler over `calls` calls after a
    warm-up -> {name: ms, ..., "total": ms}. Raises if one is missing."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {}
    for kernel in kernels:
        us = sum(device_us(e) for e in events if kernel in e.key)
        if not us:
            raise RuntimeError(f"the profiler traced no {kernel} on the device")
        out[kernel] = us / 1e3 / calls
    out["total"] = sum(out.values())
    return out


def tf32_line(label: str) -> None:
    print(f"{label}: TF32 cudnn {torch.backends.cudnn.allow_tf32}, "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}", flush=True)


def raster_bound_ms(boxes, valid, size) -> tuple[float, str, int]:
    """-> (bound ms, what binds, row-boxes). Bytes: the output written once,
    boxes and valid read once, over 3.35 TB/s. Operations: for each valid,
    non-degenerate box, RASTER_OPS_PER_ROW_BOX f32 operations in each map
    row of its bounding rectangle, and one per output pixel, over 67
    TFLOP/s."""
    b, v = boxes.cpu().numpy(), valid.cpu().numpy()
    scale, offset = (np.float32(x) for x in raster_geometry(size))
    px = b[:, :, 0, [0, 1, 3, 2]] * scale + offset
    py = b[:, :, 1, [0, 1, 3, 2]] * scale + offset
    t = px * np.roll(py, -1, axis=-1) - np.roll(px, -1, axis=-1) * py
    ok = v & (np.abs(((t[..., 0] + t[..., 1]) + t[..., 2]) + t[..., 3]) > np.float32(1e-6))
    rows = np.maximum(0, np.minimum(size - 1, np.floor(py.max(-1))) - np.maximum(0, np.ceil(py.min(-1))) + 1)
    row_boxes = int(rows[ok].sum())
    nbytes = b.shape[0] * size * size * 4 + boxes.numel() * 4 + valid.numel()
    t_ops = (row_boxes * RASTER_OPS_PER_ROW_BOX + b.shape[0] * size * size) / PEAK_OPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", row_boxes


def raster_sets() -> dict:
    """Box sets the rasterizer is held to: the seeded scenes (timed), the
    adversarial set of data/boxes.py, and items of 500 boxes (about 290
    valid: more than one 256-record staging pass of the span kernel)."""
    many = [adversarial_boxes(SEED + i, 2, MAX_BB) for i in range(5)]
    sets = {"scenes": box_scenes(SEED, BATCH, MAX_BB), "adversarial": adversarial_boxes(SEED, BATCH, MAX_BB),
            "500 boxes": tuple(np.concatenate([m[i] for m in many], axis=1) for i in (0, 1))}
    return {k: tuple(torch.from_numpy(a).cuda() for a in v) for k, v in sets.items()}


def raster_phase() -> dict:
    sets = raster_sets()
    boxes, valid = sets["scenes"]
    print(f"raster: {int(valid.sum())} valid boxes in {BATCH} scenes of max_bb {MAX_BB}", flush=True)
    diffs, max_err = {}, 0.0
    for name, (b, v) in sets.items():
        for size in RASTER_SIZES:
            got, ref = raster(b, v, size), raster_plain(b, v, size)
            n = int((got != ref).sum())
            max_err = max(max_err, (got - ref).abs().max().item())
            print(f"raster {name} {list(b.shape)} -> [{b.shape[0]},{size},{size}]: {n} differing pixels "
                  f"({int(ref.sum())} set)", flush=True)
            if n or tuple(got.shape) != (b.shape[0], size, size):
                raise RuntimeError(f"raster kernel differs from plain on {name} at size {size}: {n} pixels")
            diffs[f"{name} {size}"] = n
    # The kernels run for less time than the wrapper takes on the host, so
    # events around back-to-back calls time the host (call_ms); the
    # kernels' own time is their device time in a profiled run, summed over
    # both kernels the wrapper launches.
    device = kernel_device_ms(lambda: raster(boxes, valid, 800), RASTER_KERNELS)
    ms = device["total"]
    call_ms = cuda_ms(lambda: raster(boxes, valid, 800))
    plain_ms = cuda_ms(lambda: raster_plain(boxes, valid, 800))
    bound_ms, bound_by, row_boxes = raster_bound_ms(boxes, valid, 800)
    print(f"raster [{BATCH},{MAX_BB},2,4] -> [{BATCH},800,800]: kernels {ms:.4f} ms on the device ("
          + ", ".join(f"{k} {device[k]:.4f}" for k in RASTER_KERNELS)
          + f"), {call_ms:.4f} ms per call back to back, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {row_boxes} row-boxes), roofline share {bound_ms / ms:.3f}", flush=True)
    return {"name": "raster", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/raster.cu",
            "replaces": "driving_dirty_tpu/pallas/raster.py:76 (boxes_to_binary_map_pallas)",
            "design": "exact per-row spans: records kernel + cull/span/float4-fill kernel",
            "shape": [BATCH, MAX_BB, 2, 4], "size": 800, "dtype": "float32",
            "max_abs_err": max_err, "differing_pixels": diffs, "valid_boxes": int(valid.sum()),
            "row_boxes": row_boxes, "ms": ms, "kernel_ms": {k: device[k] for k in RASTER_KERNELS},
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "roofline_share": bound_ms / ms}


def serve(model, requests) -> tuple[list, float]:
    """Answer each request (host uint8 scenes, or a tuple of them and their
    road maps) with host outputs; -> (outputs, seconds)."""
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for req in requests:
        args = [torch.from_numpy(a).pin_memory().to("cuda", non_blocking=True)
                for a in (req if isinstance(req, tuple) else (req,))]
        y = model.predict(*args)
        outs.append({k: v.cpu() for k, v in y.items()} if isinstance(y, dict) else y.cpu())
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def window_report(prof, seconds: float, label: str, smi: str, n: int = REQUESTS,
                  unit: str = "request") -> dict:
    """Throughput, device busy, idle share and the top device ops of one
    profiled window of n requests (or training steps) of BATCH scenes."""
    # user annotations (e.g. Optimizer.step) are mirrored on the device
    # timeline as ranges over kernels counted already: left out
    ops = sorted(((e.key, e.count, device_us(e)) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
                 key=lambda t: -t[2])
    if not ops:
        raise RuntimeError("the profiler traced no device time")
    wall_ms = 1e3 * seconds / n
    busy_ms = sum(us for _, _, us in ops) / 1e3 / n
    sps = n * BATCH / seconds
    print(f"{label} ({smi}): {sps:.1f} scenes/s over {n} {unit}s of {BATCH} under "
          f"torch.profiler; {wall_ms:.3f} ms/{unit} wall, {busy_ms:.3f} ms device-busy, "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    for name, count, us in ops[:10]:
        print(f"  {us / 1e3 / n:9.3f} ms/{unit}  x{count // n:<3d} {name[:90]}")
    return {"scenes_per_s": sps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "top_ops": [[name[:60], us / 1e3 / n] for name, _, us in ops[:5]]}


def request_images(rng, n):
    return [rng.randint(0, 256, size=(BATCH, 6, VIEW_H, VIEW_W, 3), dtype=np.uint8) for _ in range(n)]


def serving_phase(ckpt: Path, smi: str) -> dict:
    """Roadmap serving -> {precision: {"launches", "scenes_per_s", "idle_share", ...}}."""
    requests = request_images(np.random.RandomState(SEED), REQUESTS + 1)
    out = {}
    for precision in (32, 16):
        tf32_line(f"roadmap serving precision {precision}")
        model = load_roadmap_model(str(ckpt), precision=precision, device="cuda")
        prepare_weights.calls = 0
        for req in requests[:2]:
            model.predict(torch.from_numpy(req).cuda())
        torch.cuda.synchronize()
        print(f"roadmap precision {precision}: the trunk's kernel weights built "
              f"{prepare_weights.calls} time(s) over two predict calls", flush=True)
        if prepare_weights.calls != 1:
            raise RuntimeError(f"precision {precision}: prepare_weights ran {prepare_weights.calls} "
                               "times over two predict calls, expected 1")
        reset_launches()
        masks, _ = serve(model, requests[:1])  # warm-up: allocator, cuDNN, first launch
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed, seconds = serve(model, requests[1:])
        launches = expect_launches(f"roadmap precision {precision}", len(requests), 0)["trunk"]
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


class PlainRoIAlign(torch.autograd.Function):
    """RoIAlign's plain versions under autograd: roialign_plain forward,
    roialign_backward_plain (the JAX formulation) backward."""

    @staticmethod
    def forward(ctx, features, rois, output_size, spatial_scale, sampling_ratio, aligned):
        ctx.save_for_backward(rois)
        ctx.geometry = (tuple(features.shape), features.dtype, output_size, spatial_scale, sampling_ratio, aligned)
        return roialign_plain(features, rois, output_size, spatial_scale, sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        return roialign_backward_plain(grad, rois, *ctx.geometry), None, None, None, None, None


def plain_roialign(features, rois, output_size=7, spatial_scale=1.0, sampling_ratio=2, aligned=False):
    return PlainRoIAlign.apply(features, rois, output_size, spatial_scale, sampling_ratio, aligned)


@contextmanager
def plain_kernels():
    """The plain trunk, rasterizer and RoIAlign (forward and backward) in
    place of the kernels."""
    with mock.patch("driving_dirty_tpu_torch.nn.autoencoder.trunk", trunk_plain), \
            mock.patch("driving_dirty_tpu_torch.models.spatial_bb.raster", raster_plain), \
            mock.patch("driving_dirty_tpu_torch.ops.detection.roialign", plain_roialign):
        yield


def reset_launches() -> None:
    trunk.launches = trunk_int8.launches = raster.launches = roialign.launches = 0
    roialign_backward.launches = 0


def expect_launches(what: str, trunks: int, rasters: int, roialigns: int = 0, int8s: int = 0,
                    roialign_backwards: int = 0) -> dict:
    got = {"trunk": trunk.launches, "raster": raster.launches, "roialign": roialign.launches,
           "trunk_int8": trunk_int8.launches, "roialign_backward": roialign_backward.launches}
    want = {"trunk": trunks, "raster": rasters, "roialign": roialigns, "trunk_int8": int8s,
            "roialign_backward": roialign_backwards}
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")
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
    reset_launches()
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
        reset_launches()
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
        reset_launches()
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


def roialign_bound_ms(feats, rois) -> tuple[float, str, int]:
    """-> (bound ms, what binds, feature pixels touched). Bytes: the output
    written once, the rois read once, and each feature pixel that some tap
    of these rois reads, read once; operations ROI_OPS_PER_OUTPUT f32
    operations per output value over 67 TFLOP/s."""
    b, h, w, c = feats.shape
    r = rois.shape[1]
    out = ROI_KW["output_size"]
    ys, xs = sample_coords(rois, h, w, out, ROI_KW["spatial_scale"], ROI_KW["sampling_ratio"], False)
    rows = torch.stack([ys.floor().long(), (ys.floor().long() + 1).clamp(max=h - 1)], -1).reshape(b, r, -1)
    cols = torch.stack([xs.floor().long(), (xs.floor().long() + 1).clamp(max=w - 1)], -1).reshape(b, r, -1)
    touched = torch.zeros((b, h * w), dtype=torch.bool, device=feats.device)
    touched.scatter_(1, (rows[..., :, None] * w + cols[..., None, :]).reshape(b, -1), True)
    pixels = int(touched.sum())
    outputs = b * r * out * out * c
    nbytes = pixels * c * feats.element_size() + outputs * 4 + rois.numel() * 4
    t_ops, t_bytes = outputs * ROI_OPS_PER_OUTPUT / PEAK_OPS[torch.float32], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", pixels


def roialign_library_args(feats, rois):
    """NCHW features and the grid_sample grid of the 14 x 14 sample points of
    every roi ([B, R * 14, 14, 2], normalized for align_corners=True)."""
    b, h, w, _ = feats.shape
    ys, xs = sample_coords(rois, h, w, ROI_KW["output_size"], ROI_KW["spatial_scale"],
                           ROI_KW["sampling_ratio"], False)
    p = ys.shape[-1]
    gx = (xs / (w - 1) * 2 - 1)[:, :, None, :].expand(-1, -1, p, -1)
    gy = (ys / (h - 1) * 2 - 1)[:, :, :, None].expand(-1, -1, -1, p)
    grid = torch.stack([gx, gy], -1).reshape(b, -1, p, 2).to(feats.dtype)
    return feats.permute(0, 3, 1, 2).contiguous(), grid


def roialign_library(feats_nchw, grid):
    """The yardstick, two PyTorch calls: bilinear samples at the roi sample
    points (border padding is the kernel's clipping), then the 2x2 mean of
    each bin. [B, C, R * 7, 7]; timed only, the port never calls it."""
    y = torch.nn.functional.grid_sample(feats_nchw, grid, mode="bilinear", padding_mode="border",
                                        align_corners=True)
    return torch.nn.functional.avg_pool2d(y, 2)


def roialign_design(feats) -> str:
    """The kernel instantiation that roialign launches for these features."""
    v = channels_per_thread(feats)
    return f"{v} channels a thread, 16-B loads" if v > 1 else "1 channel a thread, scalar loads"


def roialign_phase(gen) -> list[dict]:
    records = []
    for b, h, w, c, r in ROI_ODD:
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.rand((b, h, w, c), generator=gen, device="cuda").to(dtype)
            rois = torch.from_numpy(detection_rois(SEED + r, b, r, 2 * max(h, w))).cuda()
            hold(f"roialign {str(dtype)[6:]} {[b, h, w, c]} R={r} ({roialign_design(feats)})",
                 roialign(feats, rois, **ROI_KW), roialign_plain(feats, rois, **ROI_KW), ROI_TOL)
    for dtype in (torch.float32, torch.bfloat16):  # 4 B off 16-B alignment
        b, h, w, c, r = ROI_ODD[0][:3] + (32, 67)
        off = 4 // torch.tensor([], dtype=dtype).element_size()
        feats = torch.rand(b * h * w * c + off, generator=gen, device="cuda").to(dtype)[off:].view(b, h, w, c)
        rois = torch.from_numpy(detection_rois(SEED + r, b, r, 2 * max(h, w))).cuda()
        hold(f"roialign {str(dtype)[6:]} {[b, h, w, c]} R={r}, data 4 B off 16-B alignment "
             f"({roialign_design(feats)})", roialign(feats, rois, **ROI_KW),
             roialign_plain(feats, rois, **ROI_KW), ROI_TOL)
    rois = torch.from_numpy(detection_rois(SEED, BATCH, ROIS)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.rand(ROI_FEATS, generator=gen, device="cuda").to(dtype)
        name = f"roialign {str(dtype)[6:]} {list(ROI_FEATS)} R={ROIS} ({roialign_design(feats)})"
        rec = hold(name, roialign(feats, rois, **ROI_KW), roialign_plain(feats, rois, **ROI_KW), ROI_TOL)
        ms = kernel_device_ms(lambda: roialign(feats, rois, **ROI_KW), ("roialign_kernel",))["total"]
        call_ms = cuda_ms(lambda: roialign(feats, rois, **ROI_KW))
        plain_ms = cuda_ms(lambda: roialign_plain(feats, rois, **ROI_KW))
        nchw, grid = roialign_library_args(feats, rois)
        lib = roialign_library(nchw, grid)
        lib = lib.reshape(BATCH, ROI_FEATS[3], ROIS, 7, 7).permute(0, 2, 3, 4, 1).float()
        library_err = (lib - roialign_plain(feats, rois, **ROI_KW)).abs().max().item()
        library_ms = cuda_ms(lambda: roialign_library(nchw, grid))
        bound_ms, bound_by, pixels = roialign_bound_ms(feats, rois)
        print(f"{name}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms per call back to back, "
              f"plain {plain_ms:.3f} ms, grid_sample+avg_pool2d {library_ms:.4f} ms (two calls; "
              f"max |diff| {library_err:.3e} from plain, its grid in {str(dtype)[6:]}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {pixels} feature pixels touched of "
              f"{BATCH * ROI_FEATS[1] * ROI_FEATS[2]}), roofline share {bound_ms / ms:.3f}", flush=True)
        records.append({
            "name": "roialign", "route": "cuda", "source": "driving_dirty_tpu_torch/csrc/roialign.cu",
            "replaces": "driving_dirty_tpu/pallas/roialign.py:84 (roi_align_fused)",
            "design": roialign_design(feats),
            "path": "detection", "shape": list(ROI_FEATS), "rois": ROIS, "dtype": str(dtype)[6:],
            **{k: rec[k] for k in ("max_abs_err", "tol", "mean_abs_err", "max_abs_plain")},
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_calls": "grid_sample + avg_pool2d", "library_max_abs_diff": library_err,
            "bound_ms": bound_ms, "bound_by": bound_by, "touched_pixels": pixels,
            "roofline_share": bound_ms / ms})
        del feats, nchw, grid, lib
        torch.cuda.empty_cache()
    return records


def roialign_backward_bound_ms(grad, shape, dtype) -> tuple[float, str]:
    """-> (bound ms, what binds). Bytes: g read once, dF written once, the
    rois read once, over 3.35 TB/s. Operations: every tap of every sample of
    every bin, ROI_BWD_OPS_PER_TAP f32 operations a channel, over 67
    TFLOP/s."""
    b, r, out, _, c = grad.shape
    s = ROI_KW["sampling_ratio"]
    dF = shape[0] * shape[1] * shape[2] * shape[3]
    nbytes = grad.numel() * 4 + dF * torch.tensor([], dtype=dtype).element_size() + b * r * 16
    ops = b * r * out * out * s * s * 4 * c * ROI_BWD_OPS_PER_TAP
    t_ops, t_bytes = ops / PEAK_OPS[torch.float32], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def roialign_backward_design(grad) -> str:
    """The load width that roialign_backward launches B3-bwd with for g."""
    return "16-B loads of g" if grad_channels_per_load(grad) == 4 else "one float of g a load"


def hold_backward(label: str, grad, rois, shape, dtype) -> dict:
    """B3-bwd twice (the same bits both times) and against its plain
    version."""
    got = roialign_backward(grad, rois, shape, dtype, **ROI_KW)
    again = roialign_backward(grad, rois, shape, dtype, **ROI_KW)
    if not torch.equal(got, again):
        raise RuntimeError(f"{label}: two launches gave different dF "
                           f"({int((got != again).sum())} elements)")
    return hold(f"{label}, bit-equal over two launches", got,
                roialign_backward_plain(grad, rois, shape, dtype, **ROI_KW), ROI_BWD_TOL[dtype])


def roialign_backward_phase(gen) -> list[dict]:
    """B3-bwd: the odd shapes of phase 6 and a gradient 4 B off 16-B
    alignment against the plain version; then at the training path's shape,
    [8, 400, 400, 32] features and 512 rois an image, in f32 and bf16: the
    plain version, two launches bit-equal, the device time (torch.profiler),
    the time per call back to back, the plain version's, and the bound."""
    records = []
    for b, h, w, c, r in ROI_ODD:
        rois = torch.from_numpy(detection_rois(SEED + r, b, r, 2 * max(h, w))).cuda()
        grad = torch.randn((b, r, 7, 7, c), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            hold_backward(f"roialign_backward {str(dtype)[6:]} {[b, h, w, c]} R={r} "
                          f"({roialign_backward_design(grad)})", grad, rois, (b, h, w, c), dtype)
    b, h, w, c, r = ROI_ODD[0][:3] + (32, 67)
    grad = torch.randn(b * r * 49 * c + 1, generator=gen, device="cuda")[1:].view(b, r, 7, 7, c)
    rois = torch.from_numpy(detection_rois(SEED + r, b, r, 2 * max(h, w))).cuda()
    hold_backward(f"roialign_backward float32 {[b, h, w, c]} R={r}, g 4 B off 16-B alignment "
                  f"({roialign_backward_design(grad)})", grad, rois, (b, h, w, c), torch.float32)
    rois = torch.from_numpy(detection_rois(SEED, BATCH, ROI_SAMPLED)).cuda()
    grad = torch.randn((BATCH, ROI_SAMPLED, 7, 7, ROI_FEATS[3]), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        name = (f"roialign_backward {str(dtype)[6:]} {list(ROI_FEATS)} R={ROI_SAMPLED} "
                f"({roialign_backward_design(grad)})")
        rec = hold_backward(name, grad, rois, ROI_FEATS, dtype)
        fn = lambda: roialign_backward(grad, rois, ROI_FEATS, dtype, **ROI_KW)  # noqa: E731
        ms = kernel_device_ms(fn, ("roialign_bwd_kernel",))["total"]
        call_ms = cuda_ms(fn)
        plain_ms = cuda_ms(lambda: roialign_backward_plain(grad, rois, ROI_FEATS, dtype, **ROI_KW))
        bound_ms, bound_by = roialign_backward_bound_ms(grad, ROI_FEATS, dtype)
        print(f"{name}: kernel {ms:.4f} ms on the device, {call_ms:.4f} ms per call back to back, "
              f"plain (the JAX formulation on cuBLAS) {plain_ms:.3f} ms, no single PyTorch call computes "
              f"it; bound {bound_ms:.4f} ms ({bound_by}), roofline share {bound_ms / ms:.3f}", flush=True)
        records.append({
            "name": "roialign_backward", "route": "cuda",
            "source": "driving_dirty_tpu_torch/csrc/roialign_bwd.cu",
            "replaces": "driving_dirty_tpu/ops/detection.py:613 (_roi_align_bwd, XLA: the Pallas kernel "
                        "driving_dirty_tpu/pallas/roialign.py:84 has no backward)",
            "design": roialign_backward_design(grad),
            "path": "detection training", "shape": list(ROI_FEATS), "rois": ROI_SAMPLED, "dtype": str(dtype)[6:],
            **{k: rec[k] for k in ("max_abs_err", "tol", "mean_abs_err", "max_abs_plain")},
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
            "library_calls": "none (no single PyTorch call)",
            "bound_ms": bound_ms, "bound_by": bound_by, "roofline_share": bound_ms / ms})
    del grad
    torch.cuda.empty_cache()
    return records


def found_share(got, ref) -> float:
    """Share of ref's valid detections that got also returns (same label,
    IoU >= 0.99, any slot), over a batch of host detection dicts."""
    found = total = 0
    for j in range(ref["valid"].shape[0]):
        gv = got["valid"][j]
        gb, gl = got["boxes"][j][gv].float(), got["labels"][j][gv]
        for box, label in zip(ref["boxes"][j][ref["valid"][j]].float(), ref["labels"][j][ref["valid"][j]]):
            lt, rb = torch.maximum(gb[:, :2], box[:2]), torch.minimum(gb[:, 2:], box[2:])
            inter = (rb - lt).clamp(min=0).prod(-1)
            union = (box[2:] - box[:2]).prod() + (gb[:, 2:] - gb[:, :2]).prod(-1) - inter
            found += bool(((inter / union.clamp(min=1e-9) >= 0.99) & (gl == label)).any())
            total += 1
    return found / max(total, 1)


def check_detections(d, label: str) -> None:
    boxes, scores, labels, valid = d["boxes"], d["scores"].float(), d["labels"], d["valid"]
    ok = (tuple(boxes.shape) == (BATCH, 100, 4) and valid.dtype == torch.bool
          and bool(torch.isfinite(boxes).all()) and boxes.min() >= 0 and boxes.max() <= DET_SIZE
          and bool(((scores >= 0) & (scores <= 1)).all()) and not bool(scores[~valid].any())
          and bool(((labels[valid] >= 0) & (labels[valid] <= 8)).all()))
    if not ok:
        raise RuntimeError(f"{label}: bad detections {tuple(boxes.shape)}, "
                           f"{int(valid.sum())} valid")


def detection_requests(n):
    rng = np.random.RandomState(SEED + 3)
    return [(request_images(rng, 1)[0], detection_scenes(SEED + 10 + i, BATCH, MAX_BB, DET_SIZE)["road"])
            for i in range(n)]


def detection_batches():
    """VAL_BATCHES labelled batches of BATCH scenes on the card: uint8 views
    and seeded detection scenes (boxes, categories, road)."""
    rng = np.random.RandomState(SEED + 4)
    out = []
    for i in range(VAL_BATCHES):
        batch = {"images": request_images(rng, 1)[0],
                 **detection_scenes(SEED + 20 + i, BATCH, MAX_BB, DET_SIZE)}
        out.append({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    return out


def check_against_plain(model, x, road, precision: int, label: str) -> dict:
    """RPN outputs, RoIAlign on the kernel path's rois, the class posteriors
    on those rois, and the detections, against the plain kernels."""
    head = model.head
    with torch.no_grad():
        feats = model.backbone_features(x, road)
        obj, dl = head.rpn_forward(feats)
        rois, _, _ = head.proposals(obj, dl)
        pooled = det.batched_roi_align(feats, rois, **ROI_KW)
        cls = torch.softmax(head.box_predictions(head.roi_features(feats, rois))[0], -1)
        with plain_kernels():
            feats_p = model.backbone_features(x, road)
            obj_p, dl_p = head.rpn_forward(feats_p)
            cls_p = torch.softmax(head.box_predictions(head.roi_features(feats_p, rois))[0], -1)
            dets_p = {k: v.cpu() for k, v in model.predict(x, road).items()}
        dets = {k: v.cpu() for k, v in model.predict(x, road).items()}
    rec = {"objectness_err": hold(f"{label} RPN objectness", obj, obj_p, DET_TOL[precision])["max_abs_err"],
           "deltas_err": hold(f"{label} RPN deltas", dl, dl_p, DET_TOL[precision])["max_abs_err"],
           "roialign_err": hold(f"{label} RoIAlign on the path's rois", pooled,
                                roialign_plain(feats, rois, **ROI_KW), ROI_TOL)["max_abs_err"],
           "posterior_err": hold(f"{label} class posteriors", cls, cls_p, DET_TOL[precision])["max_abs_err"]}
    share = found_share(dets, dets_p)
    print(f"{label}: {share:.4f} of the plain run's {int(dets_p['valid'].sum())} valid detections "
          f"found in the kernel run's {int(dets['valid'].sum())}", flush=True)
    if precision == 32 and share < DET_AGREEMENT:
        raise RuntimeError(f"{label}: detections agree {share} < {DET_AGREEMENT} with the plain kernels")
    return {**rec, "detections_found": share}


def check_host_val_metrics(model, batches, label: str) -> list[dict]:
    out = []
    bmask = np.ones(BATCH, bool)
    for b in batches:
        reset_launches()
        m = model.host_val_metrics(b, bmask)
        torch.cuda.synchronize()
        expect_launches(f"{label} host_val_metrics", 2, 0, 2)
        if not {"val_ats", "val_det_kept", "val_rpn_recall", "val_prop_cov"} <= set(m) or \
                not all(np.isfinite(v) and w > 0 for v, w in m.values()):
            raise RuntimeError(f"{label}: host_val_metrics gave {m}")
        print(f"{label} host_val_metrics: " + ", ".join(f"{k} {v:.6f} (weight {w:g})"
                                                        for k, (v, w) in sorted(m.items())), flush=True)
        out.append(m)
    return out


def detection_phase(tmp: Path, smi: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    ckpt = tmp / "faster_rcnn_rm.ckpt"
    save_task_ckpt(ckpt, FasterRCNNRoadMap(DET_HPARAMS, device="cuda", generator=gen))
    torch.cuda.empty_cache()
    requests = detection_requests(REQUESTS + 1)
    batches = detection_batches()
    out = {}
    for precision in (32, 16):
        label = f"faster_rcnn_rm precision {precision}"
        tf32_line(label)
        model = load_detection_task(str(ckpt), precision=precision)
        if not isinstance(model, FasterRCNNRoadMap):
            raise RuntimeError(f"load_detection_task gave a {type(model).__name__}")
        reset_launches()
        checks = det.nms_fixed.checks
        outs, _ = serve(model, requests[:1])  # warm-up: allocator, cuDNN autotuning
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed, seconds = serve(model, requests[1:])
        launches = expect_launches(f"{label} predict", len(requests), 0, len(requests))
        nms_checks = (det.nms_fixed.checks - checks) / len(requests)
        for o in outs + timed:
            check_detections(o, label)
        rec = window_report(prof, seconds, f"{label} serve", smi)
        print(f"{label}: {nms_checks:.1f} NMS convergence checks (host readbacks) per request; "
              f"{int(timed[0]['valid'].sum())} valid detections in the first timed request", flush=True)
        del prof
        x, road = (torch.from_numpy(a).cuda() for a in requests[0])
        plain = check_against_plain(model, x, road, precision, label)
        val = check_host_val_metrics(model, batches, label)
        out[f"faster_rcnn_rm_{precision}"] = {"predict_launches": launches, **rec,
                                              "nms_checks_per_request": nms_checks, **plain,
                                              "host_val_metrics": val}
        del model
        torch.cuda.empty_cache()

    label = "faster_rcnn precision 32"
    tf32_line(label)
    model = BBFasterRCNN(DET_HPARAMS, device="cuda", generator=gen).eval().requires_grad_(False)
    b = batches[0]
    model.predict(b["images"])  # warm-up: cuDNN autotuning
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = {k: v.cpu() for k, v in model.predict(b["images"]).items()}
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = expect_launches(f"{label} predict", 1, 0, 1)
    check_detections(dets, label)
    print(f"{label}: one predict of {BATCH} scenes {wall_ms:.3f} ms wall ({smi})", flush=True)
    plain = check_against_plain(model, b["images"], None, 32, label)
    val = check_host_val_metrics(model, batches[:1], label)
    out["faster_rcnn"] = {"predict_launches": launches, "predict_wall_ms": wall_ms, **plain,
                          "host_val_metrics": val}
    del model
    torch.cuda.empty_cache()
    return out


def agreement(a, b) -> float:
    return (a == b).float().mean().item()


def p8_window(model, label: str, requests, smi: str, roialigns_per_request: int = 0) -> tuple:
    """One warm-up request (it calibrates) and the timed ones under
    torch.profiler: one calibration, one int8 weight layout, B1-int8 once a
    request and bf16 B1 never, counted from 0 around the whole run. ->
    (warm-up outputs, timed outputs, window report, launches)."""
    Int8TrunkMixin.calibrations = prepare_int8_weights.calls = 0
    reset_launches()
    outs, _ = serve(model, requests[:1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed, seconds = serve(model, requests[1:])
    n = len(requests)
    launches = expect_launches(f"{label} predict", 0, 0, roialigns_per_request * n, int8s=n)
    expect(f"{label} calibrations", Int8TrunkMixin.calibrations, 1)
    expect(f"{label} int8 weight layouts", prepare_int8_weights.calls, 1)
    print(f"{label}: calibrated once (scales {model._int8_scales}), int8 weights laid out once, "
          f"launches {launches} over {n} requests", flush=True)
    rec = window_report(prof, seconds, f"{label} serve", smi)
    del prof
    return outs, timed, rec, launches


@contextmanager
def plain_int8():
    """The plain int8 trunk in place of B1-int8."""
    with mock.patch("driving_dirty_tpu_torch.nn.autoencoder.trunk_int8", trunk_int8_plain):
        yield


def hold_equal(what: str, got, ref) -> int:
    n = int((got != ref).sum())
    print(f"{what}: {n} of {ref.numel()} elements differ from the plain int8 trunk's", flush=True)
    if n or got.shape != ref.shape:
        raise RuntimeError(f"{what}: {n} elements differ from the plain int8 trunk's")
    return n


def beside_p16(label: str, rec: dict, p16: dict) -> None:
    print(f"{label}: precision 8 {rec['scenes_per_s']:.1f} scenes/s, {rec['wall_ms']:.3f} ms/request, device "
          f"busy {rec['device_busy_ms']:.3f} ms, idle share {rec['idle_share']:.3f}; precision 16 "
          f"{p16['scenes_per_s']:.1f} scenes/s, {p16['wall_ms']:.3f} ms/request, device busy "
          f"{p16['device_busy_ms']:.3f} ms, idle share {p16['idle_share']:.3f}", flush=True)


def precision8_phase(tmp: Path, smi: str, p16: dict) -> dict:
    """Precision-8 serving of the full-width RoadMapBCEv2, MultiTask and
    FasterRCNNRoadMap of the serving, box-family and detection phases
    (their checkpoints in tmp): one warm-up request (it calibrates) and
    REQUESTS timed ones of 8 uint8 scenes under torch.profiler (p8_window);
    c3 bit-equal and the outputs within P8_TOL against the same model with
    the plain int8 trunk; > P8_AGREEMENT agreement with the same model at
    precision 16 on the warm-up batch. `p16`: the precision-16 windows of
    the earlier phases, printed beside."""
    out = {}
    torch.backends.cudnn.allow_tf32 = False
    tf32_line("precision 8 serving")

    # roadmap
    requests = request_images(np.random.RandomState(SEED), REQUESTS + 1)
    x = torch.from_numpy(requests[0]).cuda()
    ref16 = load_roadmap_model(str(tmp / "roadmap_bce.ckpt"), precision=16, device="cuda").predict(x)
    torch.cuda.empty_cache()
    model = load_roadmap_model(str(tmp / "roadmap_bce.ckpt"), precision=8, device="cuda")
    outs, _, rec, launches = p8_window(model, "roadmap precision 8", requests, smi)
    with torch.no_grad():
        pano = normalize_images(wide_stitch(x), model.compute_dtype)
        c3 = model.encoder(pano, c3_only=True, **model.enc_int8_kwargs(False))
        logits, _ = model(x)
        with plain_int8():
            c3_plain = model.encoder(pano, c3_only=True, **model.enc_int8_kwargs(False))
            logits_plain, _ = model(x)
    hold_equal("roadmap precision 8 c3", c3, c3_plain)
    logits_err = hold("roadmap precision 8 logits", logits, logits_plain, P8_TOL)["max_abs_err"]
    agree = agreement(outs[0].cuda(), ref16)
    print(f"roadmap precision 8: mask agreement with precision 16 {agree:.6f}", flush=True)
    if agree <= P8_AGREEMENT:
        raise RuntimeError(f"roadmap precision 8: mask agreement {agree} with precision 16")
    beside_p16("roadmap", rec, p16["roadmap"])
    out["roadmap"] = {"launches": launches, **rec, "logits_err": logits_err, "mask_agreement_p16": agree,
                      "scales": model._int8_scales}
    del model, ref16
    torch.cuda.empty_cache()

    # multitask
    requests = request_images(np.random.RandomState(SEED + 1), REQUESTS + 1)
    x = torch.from_numpy(requests[0]).cuda()
    ref16 = load_task_ckpt(str(tmp / "multitask.ckpt"), precision=16).predict(x)
    torch.cuda.empty_cache()
    model = load_task_ckpt(str(tmp / "multitask.ckpt"), precision=8)
    outs, _, rec, launches = p8_window(model, "multitask precision 8", requests, smi)
    with torch.no_grad():
        pano = wide_stitch(normalize_images(x, model.compute_dtype))
        c3 = model.encoder(pano, c3_only=True, **model.enc_int8_kwargs(False))
        rm, box = model(x)
        with plain_int8():
            c3_plain = model.encoder(pano, c3_only=True, **model.enc_int8_kwargs(False))
            rm_plain, box_plain = model(x)
    hold_equal("multitask precision 8 c3", c3, c3_plain)
    errs = {"logits_err": hold("multitask precision 8 roadmap logits", rm, rm_plain, P8_TOL)["max_abs_err"],
            "box_err": hold("multitask precision 8 box_occupancy", box, box_plain, P8_TOL)["max_abs_err"]}
    agree = {"road_mask": agreement(outs[0]["road_mask"].cuda(), ref16["road_mask"]),
             "rounded box_occupancy": agreement(torch.round(outs[0]["box_occupancy"].cuda()),
                                                torch.round(ref16["box_occupancy"]))}
    print(f"multitask precision 8: agreement with precision 16 {agree}", flush=True)
    if min(agree.values()) <= P8_AGREEMENT:
        raise RuntimeError(f"multitask precision 8: agreement {agree} with precision 16")
    beside_p16("multitask", rec, p16["multitask"])
    out["multitask"] = {"launches": launches, **rec, **errs, "agreement_p16": agree}
    del model, ref16
    torch.cuda.empty_cache()

    # faster_rcnn_rm
    requests = detection_requests(REQUESTS + 1)
    x, road = (torch.from_numpy(a).cuda() for a in requests[0])
    m16 = load_detection_task(str(tmp / "faster_rcnn_rm.ckpt"), precision=16)
    with torch.no_grad():
        obj16, _ = m16.head.rpn_forward(m16.backbone_features(x, road))
    dets16 = {k: v.cpu() for k, v in m16.predict(x, road).items()}
    del m16
    torch.cuda.empty_cache()
    model = load_detection_task(str(tmp / "faster_rcnn_rm.ckpt"), precision=8)
    outs, _, rec, launches = p8_window(model, "faster_rcnn_rm precision 8", requests, smi, roialigns_per_request=1)
    for o in outs:
        check_detections(o, "faster_rcnn_rm precision 8")
    with torch.no_grad():
        feats = model.backbone_features(x, road)
        obj, dl = model.head.rpn_forward(feats)
        with plain_int8():
            feats_plain = model.backbone_features(x, road)
            obj_plain, dl_plain = model.head.rpn_forward(feats_plain)
    hold_equal("faster_rcnn_rm precision 8 c3", feats, feats_plain)
    errs = {"objectness_err": hold("faster_rcnn_rm precision 8 RPN objectness", obj, obj_plain, P8_TOL)["max_abs_err"],
            "deltas_err": hold("faster_rcnn_rm precision 8 RPN deltas", dl, dl_plain, P8_TOL)["max_abs_err"]}
    agree = agreement(obj > 0, obj16 > 0)
    share = found_share(outs[0], dets16)
    print(f"faster_rcnn_rm precision 8: RPN objectness sign agreement with precision 16 {agree:.6f}; "
          f"{share:.4f} of the precision-16 run's {int(dets16['valid'].sum())} valid detections found in the "
          f"precision-8 run's {int(outs[0]['valid'].sum())}", flush=True)
    if agree <= P8_AGREEMENT:
        raise RuntimeError(f"faster_rcnn_rm precision 8: objectness sign agreement {agree} with precision 16")
    beside_p16("faster_rcnn_rm", rec, p16["faster_rcnn_rm"])
    out["faster_rcnn_rm"] = {"launches": launches, **rec, **errs, "objectness_agreement_p16": agree,
                             "detections_found_p16": share}
    del model
    torch.cuda.empty_cache()
    return out


def trunk_grad_phase(gen) -> dict:
    """The trunk under autograd at [8, 256, 1836, 3] f32: the kernel forward
    with the op's plain backward (kernels/trunk.py:trunk_vjp) against autograd through the
    plain trunk, for x and all six parameters and one seeded cotangent;
    then both forward + backward timed."""
    x, params = trunk_args(gen, torch.float32, (BATCH, *PANO, 3))
    g = torch.randn((BATCH, *out_hw(*PANO), 32), generator=gen, device="cuda")
    a = [t.clone().requires_grad_() for t in (x, *params)]
    b = [t.clone().requires_grad_() for t in (x, *params)]
    trunk.launches = 0
    trunk(*a).backward(g)
    torch.cuda.synchronize()
    if trunk.launches != 1:
        raise RuntimeError(f"trunk forward + backward launched the kernel {trunk.launches} times, expected 1")
    trunk_plain(*b).backward(g)
    errs = {}
    for name, s, t in zip(("x", "w1", "b1", "w2", "b2", "w3", "b3"), a, b):
        errs[name] = hold(f"trunk gradient {name} {list(t.shape)}", s.grad, t.grad, GRAD_TOL)["max_abs_err"]
    ms = cuda_ms(lambda: trunk(*a).backward(g))
    plain_ms = cuda_ms(lambda: trunk_plain(*b).backward(g))
    print(f"trunk forward + backward f32 {list(x.shape)}: kernel forward + plain backward {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms", flush=True)
    return {"grad_max_abs_err": errs, "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms}


def train_run(model, init, batches, steps: int, label: str, smi: str, plain: bool) -> dict:
    """`steps` Adam steps of model.loss from the weights `init` on
    batches[step % len(batches)], the masked views and dropout drawn from
    one seeded generator; step 0 is a warm-up, steps 1.. run under
    torch.profiler. With plain=True the plain kernels are patched in.
    -> losses, per-step ms, launches and kernel-weight builds, the window
    report and the peak device memory."""
    model.load_state_dict(init)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=LR,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    out = {"loss": [], "step_ms": [], "trunk_launches": [], "weight_builds": []}

    def step(i):
        launches, builds = trunk.launches, prepare_weights.calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, _ = model.loss(batches[i % len(batches)], train=True, generator=gen)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["loss"].append(loss.item())
        out["step_ms"].append(1e3 * dt)
        out["trunk_launches"].append(trunk.launches - launches)
        out["weight_builds"].append(prepare_weights.calls - builds)
        return dt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with plain_kernels() if plain else nullcontext():
        reset_launches()
        prepare_weights.calls = 0
        step(0)  # warm-up: allocator, cuDNN autotuning, Adam state
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window = sum(step(i) for i in range(1, steps))
        counts = expect_launches(f"{label} training", 0 if plain else steps, 0)
    out["launches"] = counts
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["window"] = window_report(prof, window, f"{label}{' (plain kernels)' if plain else ''}", smi,
                                  n=steps - 1, unit="step")
    if not all(np.isfinite(out["loss"])):
        raise RuntimeError(f"{label}: non-finite loss {out['loss']}")
    print(f"{label}{' plain' if plain else ''}: losses {out['loss']}, ms/step {out['step_ms']}, "
          f"trunk launches {out['trunk_launches']}, kernel-weight builds {out['weight_builds']}, "
          f"peak memory {out['peak_memory_gb']:.2f} GB", flush=True)
    return out


def hold_trajectory(label: str, got: list, ref: list, ref_name: str = "the plain kernels'",
                    tols: tuple = LOSS_TOL) -> list:
    """Relative loss errors, the first step's within tols[0], later ones' within tols[1]."""
    errs = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    for step, err in enumerate(errs):
        tol = tols[0] if step == 0 else tols[1]
        if not err <= tol:
            raise RuntimeError(f"{label}: step {step} loss {got[step]} vs {ref_name} {ref[step]} "
                               f"(relative {err} > {tol})")
    print(f"{label}: loss trajectory within {tols} of {ref_name} (relative {errs})", flush=True)
    return errs


def training_phase(tmp: Path, smi: str) -> dict:
    """BasicAE six-to-one pretraining (AE_STEPS Adam steps) at the full
    width of HPARAMS, then RM_STEPS steps of the roadmap_bce fine-tune over
    its frozen encoder, each against the same steps with the plain kernels;
    batches of 8 seeded uint8 scenes, precision 32."""
    tf32_line("training")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out = {"trunk_grad": trunk_grad_phase(gen)}
    torch.cuda.empty_cache()
    rng = np.random.RandomState(SEED + 6)
    images = [torch.from_numpy(r).cuda() for r in request_images(rng, 2)]

    model = BasicAE(AE_HPARAMS, device="cuda", generator=gen)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    ae = train_run(model, init, [{"images": x} for x in images], AE_STEPS, "basic_ae", smi, plain=False)
    if ae["trunk_launches"] != [1] * AE_STEPS or ae["weight_builds"] != [1] * AE_STEPS:
        raise RuntimeError(f"basic_ae: trunk launches {ae['trunk_launches']} and kernel-weight builds "
                           f"{ae['weight_builds']} per step, expected 1 and 1 (Adam writes the weights)")
    ckpt = tmp / "basic_ae.ckpt"
    save_task_ckpt(ckpt, model)
    ae_plain = train_run(model, init, [{"images": x} for x in images], AE_STEPS, "basic_ae", smi, plain=True)
    ae["loss_rel_err"] = hold_trajectory("basic_ae", ae["loss"], ae_plain["loss"])
    out["basic_ae"], out["basic_ae_plain"] = ae, ae_plain
    del model, init
    torch.cuda.empty_cache()

    model = RoadMapBCEv2(dict(HPARAMS, pretrained_path=str(ckpt), unfreeze_epoch_no=1), device="cuda",
                         generator=gen)
    if model.apply_freeze_mask(0) is None:
        raise RuntimeError("roadmap_bce: freeze_mask(0) froze nothing with unfreeze_epoch_no 1")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    roads = [(rng.rand(BATCH, 800, 800) > 0.5).astype(np.float32) for _ in images]
    batches = [{"images": x, "road": torch.from_numpy(r).cuda()} for x, r in zip(images, roads)]
    rm = train_run(model, init, batches, RM_STEPS, "roadmap_bce frozen encoder", smi, plain=False)
    state = model.state_dict()
    moved = [k for k, v in init.items() if k.startswith("encoder.") and "running" not in k
             and not torch.equal(state[k], v)]
    if moved or torch.equal(state["fc1.weight"], init["fc1.weight"]):
        raise RuntimeError(f"roadmap_bce frozen encoder: encoder parameters moved {moved}, "
                           f"or the head did not")
    if rm["trunk_launches"] != [1] * RM_STEPS or rm["weight_builds"] != [1] + [0] * (RM_STEPS - 1):
        raise RuntimeError(f"roadmap_bce: trunk launches {rm['trunk_launches']} and kernel-weight builds "
                           f"{rm['weight_builds']} per step, expected 1 each and one build (frozen weights)")
    print("roadmap_bce frozen encoder: encoder parameters bit-identical after the steps, head moved",
          flush=True)
    rm_plain = train_run(model, init, batches, RM_STEPS, "roadmap_bce frozen encoder", smi, plain=True)
    rm["loss_rel_err"] = hold_trajectory("roadmap_bce frozen encoder", rm["loss"], rm_plain["loss"])
    out["roadmap_bce"], out["roadmap_bce_plain"] = rm, rm_plain
    out["ae_ckpt"] = ckpt
    del model, init, state
    torch.cuda.empty_cache()
    return out


def top_aten_ops(prof, n: int, label: str, k: int = 6) -> list:
    """The k aten operations (by their input shapes) whose kernels take the
    most device time in a window of n steps: which layer a kernel serves."""
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.device_type == DeviceType.CPU and e.key.startswith("aten::") and us:
            rows.append((us / 1e3 / n, e.key, str(e.input_shapes)[:150]))
    rows.sort(key=lambda r: -r[0])
    print(f"{label}: aten operations by device time (including their children):")
    for ms, key, shapes in rows[:k]:
        print(f"  {ms:9.3f} ms/step  {key} {shapes}")
    return [[key, shapes, ms] for ms, key, shapes in rows[:k]]


def staged_train_run(model, init, batches, label: str, smi: str, plain: bool, frozen: int, unfrozen: int,
                     unfreeze: int, counters: dict, top_k: int = 6) -> dict:
    """`frozen` Adam steps (train/optim.py:Adam, the trainer's) with the
    freeze mask of epoch 0 (encoder frozen), then `unfrozen` with the mask
    of epoch `unfreeze` (everything trains), from the weights `init` on
    batches[step % len(batches)], every random draw (dropout, the samplers'
    noise) from one seeded generator. The first step of each stage is its
    warm-up (cuDNN autotunes the shapes new to it); the others run under
    torch.profiler, one window a stage. With plain=True the plain kernels
    are patched in, and no kernel may launch. `counters` {key: () -> count}
    are read around each step. -> losses, per-step ms and counts, the
    encoder at the start, after the frozen steps and at the end, the window
    reports (and, through the kernels, the top aten operations), the
    kernels' launches in all and the peak device memory."""
    model.load_state_dict(init)
    opt = Adam(model.named_parameters(), LR)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    steps = frozen + unfrozen
    out = {"loss": [], "step_ms": [], **{k: [] for k in counters}}

    def encoder():
        return {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("encoder.")}

    def step(i):
        if (model.apply_freeze_mask(0 if i < frozen else unfreeze) is None) != (i >= frozen):
            raise RuntimeError(f"{label}: freeze mask at step {i}")
        if i == frozen:
            out["encoder_frozen"] = encoder()
        before = {k: c() for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(batches[i % len(batches)], train=True, generator=gen)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["loss"].append(loss.item())
        out["step_ms"].append(1e3 * dt)
        for k, c in counters.items():
            out[k].append(c() - before[k])
        return dt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    name = f"{label}{' (plain kernels)' if plain else ''}"
    with plain_kernels() if plain else nullcontext():
        reset_launches()
        prepare_weights.calls = 0
        start = encoder()
        for stage, first, last in (("frozen", 0, frozen), ("unfrozen", frozen, steps)):
            step(first)  # the stage's warm-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
                window = sum(step(i) for i in range(first + 1, last))
            out[f"window_{stage}"] = window_report(prof, window, f"{name}, {stage}", smi, n=last - first - 1,
                                                   unit="step")
            if not plain:
                out[f"top_aten_{stage}"] = top_aten_ops(prof, last - first - 1, f"{name}, {stage}", k=top_k)
            del prof
        out["launches"] = {"trunk": trunk.launches, "raster": raster.launches, "roialign": roialign.launches,
                           "roialign_backward": roialign_backward.launches}
    if plain:
        expect(f"{name} kernel launches", out["launches"], dict.fromkeys(out["launches"], 0))
    out["encoder_start"], out["encoder_end"] = start, encoder()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(out["loss"])):
        raise RuntimeError(f"{label}: non-finite loss {out['loss']}")
    print(f"{name}: losses {out['loss']}, ms/step {out['step_ms']} ({frozen} frozen, {unfrozen} unfrozen), "
          + ", ".join(f"{k} {out[k]}" for k in counters)
          + f", peak memory {out['peak_memory_gb']:.2f} GB", flush=True)
    return out


BOX_COUNTERS = {"trunk_launches": lambda: trunk.launches, "raster_launches": lambda: raster.launches,
                "weight_builds": lambda: prepare_weights.calls}


def box_training_phase(ae_ckpt: Path, smi: str) -> dict:
    """spatial_bb, spatial_rm, multitask and bb_mlp over the BasicAE
    checkpoint `ae_ckpt` (the training phase's, full width): each from one
    init, BOX_FROZEN frozen and BOX_UNFROZEN unfrozen Adam steps through the
    kernels and again with the plain kernels patched in. Checks the loss
    trajectories, the B2 targets, B1 and B2 once a step (B2 never for
    bb_mlp), one kernel-weight layout for the frozen steps and one after
    each update once the encoder trains, and the encoder bit-identical
    while frozen."""
    tf32_line("box training")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    batches = box_batches()
    out = {}
    for cls in BOX_TRAIN_TASKS:
        label = f"{cls.name} training"
        model = cls(dict(BOX_HPARAMS, pretrained_path=str(ae_ckpt)), device="cuda", generator=gen)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        if not isinstance(model, Boxes):
            for i, b in enumerate(batches):
                n = int((box_targets(b, model.raster_size) != raster_plain(b["boxes"], b["box_valid"],
                                                                           model.raster_size)).sum())
                print(f"{label}: batch {i} targets {n} differing pixels from plain", flush=True)
                if n:
                    raise RuntimeError(f"{label}: B2 targets differ from plain in {n} pixels")
        run = staged_train_run(model, init, batches, label, smi, False, BOX_FROZEN, BOX_UNFROZEN,
                               BOX_UNFREEZE, BOX_COUNTERS)
        rasters = 0 if isinstance(model, Boxes) else 1
        expect(f"{label} B1 launches per step", run["trunk_launches"], [1] * (BOX_FROZEN + BOX_UNFROZEN))
        expect(f"{label} B2 launches per step", run["raster_launches"], [rasters] * (BOX_FROZEN + BOX_UNFROZEN))
        # one layout in all while frozen (the first forward); the first
        # unfrozen forward still finds the frozen weights, each later one
        # follows an Adam update of them
        expect(f"{label} kernel-weight builds per step", run["weight_builds"],
               [1] + [0] * BOX_FROZEN + [1] * (BOX_UNFROZEN - 1))
        moved = [n for n, v in run["encoder_start"].items() if not torch.equal(v, run["encoder_frozen"][n])]
        expect(f"{label} encoder parameters changed while frozen", moved, [])
        trunk_moved = [n for n in ("encoder.c1.weight", "encoder.c3.weight")
                       if not torch.equal(run["encoder_frozen"][n], run["encoder_end"][n])]
        expect(f"{label} trunk weights moved once unfrozen", trunk_moved, ["encoder.c1.weight", "encoder.c3.weight"])
        plain = staged_train_run(model, init, batches, label, smi, True, BOX_FROZEN, BOX_UNFROZEN,
                               BOX_UNFREEZE, BOX_COUNTERS)
        run["loss_rel_err"] = hold_trajectory(label, run["loss"], plain["loss"])
        for r in (run, plain):
            for k in ("encoder_start", "encoder_frozen", "encoder_end"):
                del r[k]
        print(f"{label} ({smi}): " + "; ".join(
            f"{stage} {run[f'window_{stage}']['scenes_per_s']:.1f} scenes/s, "
            f"{run[f'window_{stage}']['wall_ms']:.3f} ms a step (plain kernels "
            f"{plain[f'window_{stage}']['wall_ms']:.3f}), idle share {run[f'window_{stage}']['idle_share']:.3f}"
            for stage in ("frozen", "unfrozen")) + f"; peak {run['peak_memory_gb']:.2f} GB; encoder "
              "bit-identical through the frozen steps", flush=True)
        out[cls.name], out[f"{cls.name}_plain"] = run, plain
        del model, init
        torch.cuda.empty_cache()
    return out


def det_first_step(model, init, batch, label: str) -> dict:
    """The first training step by parts, the kernels against the plain
    kernels from the weights `init` with one draw of noise: the RPN losses,
    the RoI losses on the plain run's sampled rois (DET_STEP0_TOL each),
    and the count of post-NMS proposal slots that differ."""
    model.load_state_dict(init)
    model.train()
    gt = model._targets(batch)
    noise = model.head.draw_noise(BATCH, gt[0].shape[1], torch.Generator(device="cuda").manual_seed(SEED + 11),
                                  "cuda")
    road = batch["road"] if model.uses_roadmap else None
    head = model.head
    runs = {}
    with torch.no_grad():
        for name, ctx in (("kernel", nullcontext), ("plain", plain_kernels)):
            with ctx():
                feats = model.backbone_features(batch["images"], road)
                obj, dl = head.rpn_forward(feats)
                rpn = head.rpn_loss(obj, dl, gt[0], gt[1], noise["rpn"])
                rois, rv, _ = head.proposals(obj, dl)
                runs[name] = (feats, rpn, rois, rv, head.sample_proposals(rois, rv, *gt, noise["roi"]))
        sampled = runs["plain"][4]
        roi = {"kernel": head.roi_loss(runs["kernel"][0], sampled)}
        with plain_kernels():
            roi["plain"] = head.roi_loss(runs["plain"][0], sampled)
    rec = {}
    for i, key in enumerate(("loss_objectness", "loss_rpn_box_reg")):
        got, ref = runs["kernel"][1][i].item(), runs["plain"][1][i].item()
        rec[key] = (got, ref)
    for i, key in enumerate(("loss_classifier", "loss_box_reg")):
        rec[key] = (roi["kernel"][i].item(), roi["plain"][i].item())
    for key, (got, ref) in rec.items():
        err = abs(got - ref) / max(abs(ref), 1e-30)
        if not err <= DET_STEP0_TOL:
            raise RuntimeError(f"{label} first step: {key} {got} against plain {ref} (relative {err})")
    differ = ((runs["kernel"][2] != runs["plain"][2]).any(-1) | (runs["kernel"][3] != runs["plain"][3]))
    n_differ = int(differ.sum())
    print(f"{label} first step, kernels against plain kernels: " + ", ".join(
        f"{k} {g:.7g} / {r:.7g}" for k, (g, r) in rec.items()) + f" (RoI losses on the plain run's sampled "
          f"rois; each within {DET_STEP0_TOL}); {n_differ} of {differ.numel()} post-NMS proposal slots differ",
          flush=True)
    return {"losses": rec, "differing_proposals": n_differ}


DET_COUNTERS = {"trunk_launches": lambda: trunk.launches, "roialign_launches": lambda: roialign.launches,
                "roialign_backward_launches": lambda: roialign_backward.launches,
                "weight_builds": lambda: prepare_weights.calls, "nms_checks": lambda: det.nms_fixed.checks}


def device_ms_per_call(fn, calls: int = 10, tries: int = 3) -> float:
    """Device time per call of fn(): every kernel and copy it runs, from
    torch.profiler over `calls` calls after a warm-up. Now and then the
    profiler hands back a window with no device activity at all (seen once
    in a whole run, on B3's 0.05-ms calls, which other runs traced): such a
    window is taken again, up to `tries` in all, and the retry printed."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
        if us:
            if attempt:
                print(f"device_ms_per_call: {attempt} profiler window(s) traced no device time before this one",
                      flush=True)
            return us / 1e3 / calls
    raise RuntimeError(f"the profiler traced no device time in {tries} windows")


def det_stage_ms(model, batch, smi: str) -> dict:
    """Each stage of a detection training step alone, everything trainable,
    f32, batch 8: its device time (torch.profiler) and its time on the
    stream (CUDA events over back-to-back calls; the stages with host
    readbacks, NMS, include them)."""
    model.apply_freeze_mask(DET_UNFREEZE)
    model.train()
    head, enc = model.head, model.encoder
    gt = model._targets(batch)
    road = batch["road"] if model.uses_roadmap else None
    noise = head.draw_noise(BATCH, gt[0].shape[1], torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    params = [enc.c1.weight, enc.c1.bias, enc.c2.weight, enc.c2.bias, enc.c3.weight, enc.c3.bias]
    with torch.no_grad():
        x = model._backbone_input(batch["images"], road)
        feats = model.backbone_features(batch["images"], road)
        obj, dl = head.rpn_forward(feats)
        cells = det.base_anchors(head.cfg.anchor_sizes, head.cfg.anchor_ratios)
        fs, st = head.cfg.feat_size, head.cfg.feat_stride
        labels, _ = det.match_labels_grid(cells, fs, fs, st, gt[0], gt[1])
        rois, rv, _ = head.proposals(obj, dl)
        sampled = head.sample_proposals(rois, rv, *gt, noise["roi"])
        pooled = det.batched_roi_align(feats, sampled["rois"], output_size=7, spatial_scale=0.5)
    xg = x.detach().requires_grad_()
    g3 = torch.randn_like(feats)
    gp = torch.randn_like(pooled)
    flat = pooled.permute(0, 1, 4, 2, 3).reshape(BATCH, ROI_SAMPLED, -1).detach()

    def box_mlp():
        cls, reg = head.box_predictions(torch.relu(head.box_fc2(torch.relu(head.box_fc1(flat)))))
        (cls.sum() + reg.sum()).backward()

    stages = {
        "B1 forward [8, 800, 800, 3]": lambda: trunk(x.detach(), *[p.detach() for p in params]),
        "B1 forward + its op's backward (plain recompute, cuDNN dgrad and wgrad)":
            lambda: trunk(xg, *params).backward(g3),
        "RPN convs forward + backward": lambda: sum(t.sum() for t in head.rpn_forward(feats.detach())).backward(),
        "match_labels_grid (2.4M anchors x 100 GT an image)":
            lambda: det.match_labels_grid(cells, fs, fs, st, gt[0], gt[1]),
        "sample_balanced, RPN (exact top-k over 2.4M an image)":
            lambda: det.sample_balanced(noise["rpn"], labels, 256, 0.5),
        "proposals: top-2000, decode, NMS (host readbacks)": lambda: head.proposals(obj, dl),
        "sample_proposals (1100 candidates an image)":
            lambda: head.sample_proposals(rois, rv, *gt, noise["roi"]),
        "B3 forward, 512 rois an image": lambda: det.batched_roi_align(feats, sampled["rois"], output_size=7,
                                                                        spatial_scale=0.5),
        "B3-bwd, 512 rois an image": lambda: roialign_backward(gp, sampled["rois"], tuple(feats.shape),
                                                                feats.dtype, **ROI_KW),
        "box MLP forward + backward (4096 rows)": box_mlp,
    }
    out = {}
    for name, fn in stages.items():
        out[name] = {"device_ms": device_ms_per_call(fn), "stream_ms": cuda_ms(fn, budget_ms=200.0)}
        print(f"{model.name} training stage ({smi}): device {out[name]['device_ms']:9.3f} ms, on the stream "
              f"{out[name]['stream_ms']:9.3f} ms  {name}", flush=True)
    model.zero_grad(set_to_none=True)
    return out


def det_training_phase(ae_ckpt: Path, smi: str) -> dict:
    """faster_rcnn_rm and faster_rcnn over the BasicAE checkpoint `ae_ckpt`
    at the JAX package's DetectionConfig defaults: the first step by parts
    against the plain kernels, then DET_FROZEN frozen and DET_UNFROZEN
    unfrozen Adam steps through the kernels and again with the plain
    kernels. Checks the launches a step (B1 and B3 once; B3-bwd once for
    faster_rcnn_rm, and for faster_rcnn once the encoder trains), one
    kernel-weight layout while frozen and one after each update once the
    encoder trains, the encoder bit-identical while frozen, the losses;
    then times each stage of a faster_rcnn_rm step."""
    tf32_line("detection training")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    batches = detection_batches()
    out = {}
    for cls in DET_TRAIN_TASKS:
        label = f"{cls.name} training"
        model = cls(dict(DET_HPARAMS, pretrained_path=str(ae_ckpt)), device="cuda", generator=gen)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        first = det_first_step(model, init, batches[0], label)
        run = staged_train_run(model, init, batches, label, smi, False, DET_FROZEN, DET_UNFROZEN,
                               DET_UNFREEZE, DET_COUNTERS, top_k=12)
        steps = DET_FROZEN + DET_UNFROZEN
        bwd = [1] * steps if model.uses_roadmap else [0] * DET_FROZEN + [1] * DET_UNFROZEN
        expect(f"{label} B1 launches per step", run["trunk_launches"], [1] * steps)
        expect(f"{label} B3 launches per step", run["roialign_launches"], [1] * steps)
        expect(f"{label} B3-bwd launches per step", run["roialign_backward_launches"], bwd)
        expect(f"{label} kernel-weight builds per step", run["weight_builds"],
               [1] + [0] * DET_FROZEN + [1] * (DET_UNFROZEN - 1))
        moved = [n for n, v in run["encoder_start"].items() if not torch.equal(v, run["encoder_frozen"][n])]
        expect(f"{label} encoder parameters changed while frozen", moved, [])
        trunk_moved = [n for n in ("encoder.c1.weight", "encoder.c3.weight")
                       if not torch.equal(run["encoder_frozen"][n], run["encoder_end"][n])]
        expect(f"{label} trunk weights moved once unfrozen", trunk_moved, ["encoder.c1.weight", "encoder.c3.weight"])
        plain = staged_train_run(model, init, batches, label, smi, True, DET_FROZEN, DET_UNFROZEN,
                               DET_UNFREEZE, DET_COUNTERS, top_k=12)
        errs = [abs(a - b) / abs(b) for a, b in zip(run["loss"], plain["loss"])]
        if not all(e <= LOSS_TOL[1] for e in errs[1:]):
            raise RuntimeError(f"{label}: losses {run['loss']} against plain {plain['loss']} (relative {errs})")
        print(f"{label}: losses against the plain kernels' relative {errs} (steps 1.. within {LOSS_TOL[1]})",
              flush=True)
        run["loss_rel_err"], run["first_step"] = errs, first
        for r in (run, plain):
            for k in ("encoder_start", "encoder_frozen", "encoder_end"):
                del r[k]
        print(f"{label} ({smi}): " + "; ".join(
            f"{stage} {run[f'window_{stage}']['scenes_per_s']:.1f} scenes/s, "
            f"{run[f'window_{stage}']['wall_ms']:.3f} ms a step (plain kernels "
            f"{plain[f'window_{stage}']['wall_ms']:.3f}), idle share {run[f'window_{stage}']['idle_share']:.3f}"
            for stage in ("frozen", "unfrozen")) + f"; first step {run['step_ms'][0]:.1f} ms (cuDNN autotuning); "
              f"peak {run['peak_memory_gb']:.2f} GB; encoder bit-identical through the frozen steps", flush=True)
        if model.uses_roadmap:
            run["stage_ms"] = det_stage_ms(model, batches[0], smi)
        out[cls.name], out[f"{cls.name}_plain"] = run, plain
        del model, init
        torch.cuda.empty_cache()
    return out


def metrics_records(root: Path, task: str) -> list[dict]:
    """Every metrics.jsonl record of a run (all versions, in order)."""
    recs = []
    for path in sorted(root.glob(f"{task}/version_*/tb/metrics.jsonl")):
        recs += [json.loads(line) for line in path.read_text().splitlines()]
    return recs


def range_idle(prof, name: str) -> dict:
    """{"idle_share", "ms", "busy_ms"} of the profiled range `name` (a
    record_function on the host): its wall time, the time in it during which
    a kernel or copy ran on the card, and the share in which none did."""
    ranges = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU]
    if len(ranges) != 1:
        raise RuntimeError(f"the profiler traced {len(ranges)} ranges named {name!r}")
    t0, t1 = ranges[0].time_range.start, ranges[0].time_range.end
    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > t0 and e.time_range.start < t1)
    if not spans:
        raise RuntimeError(f"the profiler traced no device time in {name!r}")
    busy, end = 0.0, t0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"idle_share": 1 - busy / (t1 - t0), "ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3}


def cli_run(label: str, main, argv: list, smi: str, ranges: tuple = ()) -> tuple:
    """main(argv) with the trunk's launch count set to 0 just before and read
    just after; under torch.profiler when `ranges` names the profiled ranges
    whose device idle share is wanted. -> (main's result, its measures)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prof_ctx = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if ranges else nullcontext()
    t0 = time.perf_counter()
    with prof_ctx as prof:
        result = main(argv)
        torch.cuda.synchronize()
    rec = {"seconds": time.perf_counter() - t0, "trunk_launches": trunk.launches,
           "trunk_int8_launches": trunk_int8.launches,
           "raster_launches": raster.launches, "roialign_launches": roialign.launches,
           "roialign_backward_launches": roialign_backward.launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi,
           "ranges": {name: range_idle(prof, name) for name in ranges}}
    print(f"{label} ({smi}): {rec['seconds']:.1f} s, B1 launches {rec['trunk_launches']}, B1-int8 launches "
          f"{rec['trunk_int8_launches']}, peak memory "
          f"{rec['peak_memory_gb']:.2f} GB" + "".join(
              f"; '{name}' {r['ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms, idle share {r['idle_share']:.3f}"
              for name, r in rec["ranges"].items()), flush=True)
    return result, rec


def fit_measures(label: str, root: Path, task: str, rec: dict) -> dict:
    """The trainer's own numbers from its metrics.jsonl: scenes/s per epoch,
    median step_ms, train losses by step."""
    recs = metrics_records(root, task)
    rec["scenes_per_s_by_epoch"] = [r["scenes_per_sec"] for r in recs if "scenes_per_sec" in r]
    step_ms = [r["step_ms"] for r in recs if "step_ms" in r]
    rec["step_ms"] = step_ms
    rec["median_step_ms"] = statistics.median(step_ms)
    rec["losses"] = {r["step"]: r["train_loss"] for r in recs if "train_loss" in r}
    rec["cost_flops"] = next((r["cost_flops"] for r in recs if "cost_flops" in r), None)
    rec["train_seconds"] = recs[-1]["time"] - recs[0]["time"]  # first step's log to the last record
    if not all(np.isfinite(list(rec["losses"].values()))):
        raise RuntimeError(f"{label}: non-finite losses {rec['losses']}")
    print(f"{label} ({rec['card']}): scenes/s by epoch {rec['scenes_per_s_by_epoch']}, median step_ms "
          f"{rec['median_step_ms']:.3f} over {len(step_ms)} steps ({', '.join(f'{t:.1f}' for t in step_ms)}; an "
          f"epoch's first includes its loader's start), first-step FLOPs {rec['cost_flops']}, "
          f"{rec['train_seconds']:.1f} s from the first step's log to the last record, "
          f"losses {[rec['losses'][k] for k in sorted(rec['losses'])]}", flush=True)
    return rec


@contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms, and torch's deterministic ones with
    a warning for each op that has none (printed once, at the end)."""
    prev = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])
        ops = sorted({str(w.message).split(".")[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
        print(f"deterministic algorithms: {len(ops)} kinds of op without one"
              + "".join(f"\n  {op}" for op in ops), flush=True)


def pinned_on_step_thread(iterator, device, size: int = 2):
    """device_prefetch as it was before its staging thread: each batch
    pinned on the consumer's thread, then copied non_blocking."""
    buf = []
    for item in iterator:
        buf.append(tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            device, non_blocking=True), item))
        if len(buf) > size:
            yield buf.pop(0)
    yield from buf


def prefetch_ab(tmp: Path, data: Path, ae_ckpt: Path, smi: str) -> list:
    """PREFETCH_AB: median step_ms of each run, the epochs' first steps
    (which wait for their loader's first batch) left out."""
    h = dict(link=str(data), samples_per_scene=CLI_SAMPLES, num_labeled_scenes=CLI_SCENES, batch_size=BATCH,
             pretrained_path=str(ae_ckpt), unfreeze_epoch_no=CLI_EPOCHS, output_img_freq=0, seed=SEED)
    out = []
    for i, how in enumerate(PREFETCH_AB):
        task = RoadMapBCEv2(h, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
        root = tmp / f"prefetch_ab_{i}"
        patch = (nullcontext() if how == "staged"
                 else mock.patch.object(trainer_module, "device_prefetch", pinned_on_step_thread))
        with patch:
            trainer_module.Trainer(max_epochs=CLI_EPOCHS, limit_train_batches=CLI_BATCHES, log_every_n_steps=1,
                                   enable_checkpointing=False, enable_progress_bar=False, seed=SEED,
                                   default_root_dir=str(root)).fit(task)
        step_ms = [r["step_ms"] for r in metrics_records(root, "roadmap_bce") if "step_ms" in r]
        steady = [t for k, t in enumerate(step_ms) if k % CLI_BATCHES]
        out.append({"prefetch": how, "median_step_ms": statistics.median(steady), "step_ms": step_ms})
        print(f"roadmap_bce frozen, device_prefetch {how} ({smi}): median step {out[-1]['median_step_ms']:.3f} ms "
              f"over {len(steady)} steps after each epoch's first ({', '.join(f'{t:.2f}' for t in step_ms)})",
              flush=True)
        shutil.rmtree(root)
        del task
        torch.cuda.empty_cache()
    return out


@contextmanager
def launches_per_call(cls, methods=("loss", "val_metrics", "log_images")):
    """Each outermost call of `cls`'s `methods` (a training step, a
    validation batch, an image log) appends (method, B1 launches, B2
    launches) to the yielded list; a call made inside another (the default
    val_metrics calls loss) counts in the outer one."""
    calls, depth = [], [0]

    def wrap(name, fn):
        def counted(self, *args, **kwargs):
            before = (trunk.launches, raster.launches)
            depth[0] += 1
            try:
                return fn(self, *args, **kwargs)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    calls.append((name, trunk.launches - before[0], raster.launches - before[1]))
        return counted

    with ExitStack() as stack:
        for m in methods:
            stack.enter_context(mock.patch.object(cls, m, wrap(m, getattr(cls, m))))
        yield calls


def staged_cli(label: str, main, argv: list, cls, smi: str, rasters: int, images: int) -> tuple:
    """A CLI run of CLI_EPOCHS epochs of CLI_BATCHES steps with the encoder
    frozen in epoch 0 (--unfreeze_epoch_no 1), each epoch's training loop
    under torch.profiler. Checks B1 once and B2 `rasters` times in each
    training step and validation batch, B1 and B2 once in each of `images`
    log_images calls, one kernel-weight layout in all of the frozen epoch
    and one after each Adam update of the trained one (the next forward,
    the last one validation's), and the encoder bit-identical through epoch
    0 and moved in epoch 1. -> (fit, its measures)."""
    marks = []
    apply_freeze_mask = cls.apply_freeze_mask

    def spy(task, epoch):
        marks.append((prepare_weights.calls,
                      {n: p.detach().clone() for n, p in task.named_parameters() if n.startswith("encoder.")}))
        return apply_freeze_mask(task, epoch)

    prepare_weights.calls = 0
    with mock.patch.object(cls, "apply_freeze_mask", spy), launches_per_call(cls) as calls:
        fit, rec = cli_run(label, main, argv, smi, ranges=tuple(f"epoch {e} train" for e in range(CLI_EPOCHS)))
    steps = CLI_EPOCHS * CLI_BATCHES
    kinds = ("loss", "val_metrics", "log_images")
    expect(f"{label} training steps, validation batches, log_images calls",
           [sum(c[0] == k for c in calls) for k in kinds], [steps, CLI_EPOCHS, images])
    expect(f"{label} (B1, B2) launches per training step, validation batch, log_images call",
           [sorted({c[1:] for c in calls if c[0] == k}) for k in kinds],
           [[(1, rasters)], [(1, rasters)], [(1, 1)] if images else []])
    expect(f"{label} B1, B2 launches", (rec["trunk_launches"], rec["raster_launches"]),
           (steps + CLI_EPOCHS + images, rasters * (steps + CLI_EPOCHS) + images))
    builds = [marks[1][0] - marks[0][0], prepare_weights.calls - marks[1][0]]
    expect(f"{label} kernel-weight builds by epoch", builds, [1, CLI_BATCHES])
    moved = [n for n, v in marks[0][1].items() if not torch.equal(v, marks[1][1][n])]
    expect(f"{label} encoder parameters changed in the frozen epoch", moved, [])
    trained = dict(fit.task.named_parameters())
    if all(torch.equal(v, trained[n]) for n, v in marks[1][1].items()):
        raise RuntimeError(f"{label}: the encoder did not move after the unfreeze")
    print(f"{label}: B1, B2 launches {rec['trunk_launches']}, {rec['raster_launches']} "
          f"({steps} steps, {CLI_EPOCHS} validation batches, {images} log_images calls: "
          f"(B1, B2) per call {[(1, rasters), (1, rasters), (1, 1)][:3 if images else 2]}); encoder "
          f"parameters bit-identical through epoch 0, moved in epoch 1; kernel-weight builds by epoch "
          f"{builds}", flush=True)
    rec["weight_builds_by_epoch"] = builds
    return fit, rec


@contextmanager
def det_launches_per_call(cls):
    """Each training step (Trainer._train_step: the loss, its backward and
    Adam), validation loss (val_metrics) and host validation
    (host_val_metrics: predict and the diagnostics pass) appends (kind, B1,
    B3, B3-bwd launches) to the yielded list."""
    calls, depth = [], [0]

    def counts():
        return trunk.launches, roialign.launches, roialign_backward.launches

    def wrap(kind, fn):
        def counted(*args, **kwargs):
            before = counts()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    calls.append((kind, *(a - b for a, b in zip(counts(), before))))
        return counted

    with mock.patch.object(trainer_module.Trainer, "_train_step",
                           wrap("step", trainer_module.Trainer._train_step)), \
            mock.patch.object(cls, "val_metrics", wrap("val_metrics", cls.val_metrics)), \
            mock.patch.object(cls, "host_val_metrics", wrap("host_val_metrics", cls.host_val_metrics)):
        yield calls


DET_CALL_LAUNCHES = {"step": (1, 1, 1), "val_metrics": (1, 1, 0), "host_val_metrics": (2, 2, 0)}


def det_staged_cli(label: str, argv: list, smi: str) -> tuple:
    """cli.faster_rcnn --variant rm for CLI_EPOCHS epochs of CLI_BATCHES
    steps, the encoder frozen in epoch 0 (--unfreeze_epoch_no 1), each
    epoch's training loop under torch.profiler. Checks (B1, B3, B3-bwd)
    launches of (1, 1, 1) in each training step and (3, 3, 0) in each
    validation batch (its loss (1, 1, 0), predict and the diagnostics (2,
    2, 0)), one kernel-weight layout in all of the frozen epoch and one after
    each Adam update of the trained one, and the encoder bit-identical
    through epoch 0 and moved in epoch 1. -> (fit, its measures)."""
    cls = FasterRCNNRoadMap
    marks = []
    apply_freeze_mask = cls.apply_freeze_mask

    def spy(task, epoch):
        marks.append((prepare_weights.calls,
                      {n: p.detach().clone() for n, p in task.named_parameters() if n.startswith("encoder.")}))
        return apply_freeze_mask(task, epoch)

    prepare_weights.calls = 0
    with mock.patch.object(cls, "apply_freeze_mask", spy), det_launches_per_call(cls) as calls:
        fit, rec = cli_run(label, cli_faster_rcnn.main, argv, smi,
                           ranges=tuple(f"epoch {e} train" for e in range(CLI_EPOCHS)))
    steps = CLI_EPOCHS * CLI_BATCHES
    expect(f"{label} training steps, validation losses, host validations",
           [sum(c[0] == k for c in calls) for k in DET_CALL_LAUNCHES], [steps, CLI_EPOCHS, CLI_EPOCHS])
    expect(f"{label} (B1, B3, B3-bwd) launches per call",
           {k: sorted({tuple(c[1:]) for c in calls if c[0] == k}) for k in DET_CALL_LAUNCHES},
           {k: [v] for k, v in DET_CALL_LAUNCHES.items()})
    expect(f"{label} B1, B3, B3-bwd launches",
           (rec["trunk_launches"], rec["roialign_launches"], rec["roialign_backward_launches"]),
           (steps + 3 * CLI_EPOCHS, steps + 3 * CLI_EPOCHS, steps))
    builds = [marks[1][0] - marks[0][0], prepare_weights.calls - marks[1][0]]
    expect(f"{label} kernel-weight builds by epoch", builds, [1, CLI_BATCHES])
    moved = [n for n, v in marks[0][1].items() if not torch.equal(v, marks[1][1][n])]
    expect(f"{label} encoder parameters changed in the frozen epoch", moved, [])
    trained = dict(fit.task.named_parameters())
    if all(torch.equal(v, trained[n]) for n, v in marks[1][1].items()):
        raise RuntimeError(f"{label}: the encoder did not move after the unfreeze")
    print(f"{label}: B1, B3, B3-bwd launches {rec['trunk_launches']}, {rec['roialign_launches']}, "
          f"{rec['roialign_backward_launches']} ({steps} steps of (1, 1, 1), {CLI_EPOCHS} validation batches of "
          f"(3, 3, 0)); encoder parameters bit-identical through epoch 0, moved in epoch 1; kernel-weight builds "
          f"by epoch {builds}", flush=True)
    rec["weight_builds_by_epoch"] = builds
    return fit, rec


def hold_resume(label: str, root: Path, task: str, ref: dict, stop: int, smi: str) -> dict:
    """The losses of a run stopped at `stop` steps and resumed (all versions
    under root) against the uninterrupted run's `ref`: equal within
    RESUME_TOL from the resume on."""
    steps = CLI_EPOCHS * CLI_BATCHES
    losses = {r["step"]: r["train_loss"] for r in metrics_records(root, task) if "train_loss" in r}
    expect(f"{label} stopped + resumed steps", sorted(losses), list(range(steps)))
    gaps = {k: abs(losses[k] - ref[k]) / abs(ref[k]) for k in range(steps)}
    before = max(gaps[k] for k in range(stop))
    after = max(gaps[k] for k in range(stop, steps))
    print(f"{label} resume ({smi}): steps {stop}..{steps - 1} after the resume within {after:.3e} of the "
          f"uninterrupted run's losses (tolerance {RESUME_TOL}); steps 0..{stop - 1} before it, the same "
          f"steps twice: {before:.3e}", flush=True)
    if not after <= RESUME_TOL:
        raise RuntimeError(f"{label}: resumed losses {gaps} exceed {RESUME_TOL}")
    return {"max_rel_gap_after_resume": after, "max_rel_gap_before": before, "rel_gaps": gaps}


class Tee(io.StringIO):
    """Standard output that is also kept."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def expect(label: str, got, want) -> None:
    if got != want:
        raise RuntimeError(f"{label}: {got}, expected {want}")


def det_cli_runs(tmp: Path, box_argv: list, smi: str) -> dict:
    """cli.faster_rcnn over the basic_ae encoder of the trainer phase, with
    its flags `box_argv` (the synthetic dataset, batch 8, precision 32,
    CLI_EPOCHS epochs of CLI_BATCHES steps, --unfreeze_epoch_no 1):
    --variant rm frozen in epoch 0 and trained in epoch 1; the same run
    under deterministic algorithms, uninterrupted and stopped by --max_steps
    and resumed (losses within RESUME_TOL); rm at precision 16 (B1, B3 and
    B3-bwd in bf16) and --variant plain (frozen: no B3-bwd) for 2 steps
    each."""
    steps = CLI_EPOCHS * CLI_BATCHES
    out = {}
    dtypes = []
    launch = trunk_module._launch

    def spy_launch(x, params, stages):
        dtypes.append(x.dtype)
        return launch(x, params, stages)

    det_argv = box_argv + ["--variant", "rm"]
    root_det = tmp / "cli_det"
    fit, rec = det_staged_cli("cli.faster_rcnn --variant rm", det_argv + ["--default_root_dir", str(root_det)], smi)
    out["faster_rcnn_rm"] = fit_measures("cli.faster_rcnn --variant rm", root_det, "faster_rcnn_rm", rec)
    del fit
    shutil.rmtree(root_det)
    torch.cuda.empty_cache()

    root_dr = tmp / "cli_det_resume"
    with deterministic_algorithms():
        fit, ref = cli_run("cli.faster_rcnn, deterministic", cli_faster_rcnn.main,
                           det_argv + ["--default_root_dir", str(tmp / "cli_det_det")], smi)
        expect("cli.faster_rcnn, deterministic B1, B3, B3-bwd launches",
               (ref["trunk_launches"], ref["roialign_launches"], ref["roialign_backward_launches"]),
               (steps + 3 * CLI_EPOCHS, steps + 3 * CLI_EPOCHS, steps))
        ref = fit_measures("cli.faster_rcnn, deterministic", tmp / "cli_det_det", "faster_rcnn_rm", ref)
        del fit
        torch.cuda.empty_cache()
        fit, stop = cli_run("cli.faster_rcnn --max_steps", cli_faster_rcnn.main,
                            det_argv + ["--default_root_dir", str(root_dr), "--max_steps", str(CLI_AE_STOP)], smi)
        expect("cli.faster_rcnn --max_steps stop", fit.stop_reason, f"max_steps={CLI_AE_STOP} reached")
        expect("cli.faster_rcnn --max_steps B1, B3, B3-bwd launches (5 steps, 1 validation batch)",
               (stop["trunk_launches"], stop["roialign_launches"], stop["roialign_backward_launches"]),
               (CLI_AE_STOP + 3, CLI_AE_STOP + 3, CLI_AE_STOP))
        last = fit.last_ckpt_path
        del fit
        torch.cuda.empty_cache()
        fit, resumed = cli_run("cli.faster_rcnn resumed", cli_faster_rcnn.main,
                               det_argv + ["--default_root_dir", str(root_dr), "--resume_from_checkpoint", last],
                               smi)
    expect("cli.faster_rcnn resumed B1, B3, B3-bwd launches",
           (resumed["trunk_launches"], resumed["roialign_launches"], resumed["roialign_backward_launches"]),
           (steps - CLI_AE_STOP + 3, steps - CLI_AE_STOP + 3, steps - CLI_AE_STOP))
    del fit
    torch.cuda.empty_cache()
    out["faster_rcnn_rm_resume"] = {**hold_resume("cli.faster_rcnn", root_dr, "faster_rcnn_rm", ref["losses"],
                                                  CLI_AE_STOP, smi),
                                    "uninterrupted": ref, "stopped": stop, "resumed": resumed}
    shutil.rmtree(root_dr)
    shutil.rmtree(tmp / "cli_det_det")

    roi_dtypes = []
    roi_call = roialign_module._call

    def spy_roi_call(name, dtype, *args):
        roi_dtypes.append((name, dtype))
        return roi_call(name, dtype, *args)

    root_d16 = tmp / "cli_det16"
    argv = det_argv[:det_argv.index("--precision")] + ["--precision", "16"] + det_argv[det_argv.index("--precision") + 2:]
    with mock.patch.object(trunk_module, "_launch", spy_launch), \
            mock.patch.object(roialign_module, "_call", spy_roi_call):
        fit, rec = cli_run("cli.faster_rcnn --precision 16", cli_faster_rcnn.main,
                           argv + ["--default_root_dir", str(root_d16), "--max_steps", "2"], smi)
    expect("cli.faster_rcnn --precision 16 B1, B3, B3-bwd launches",
           (rec["trunk_launches"], rec["roialign_launches"], rec["roialign_backward_launches"]), (2, 2, 2))
    expect("cli.faster_rcnn --precision 16 trunk dtypes", dtypes, [torch.bfloat16] * 2)
    expect("cli.faster_rcnn --precision 16 RoIAlign kernels and feature dtypes", roi_dtypes,
           [("dd_roialign_forward", torch.bfloat16), ("dd_roialign_backward", torch.bfloat16)] * 2)
    out["faster_rcnn_rm_16"] = fit_measures("cli.faster_rcnn --precision 16", root_d16, "faster_rcnn_rm", rec)
    del fit
    shutil.rmtree(root_d16)
    torch.cuda.empty_cache()

    root_dp = tmp / "cli_det_plain"
    fit, rec = cli_run("cli.faster_rcnn --variant plain", cli_faster_rcnn.main,
                       box_argv + ["--variant", "plain", "--default_root_dir", str(root_dp), "--max_steps", "2"], smi)
    expect("cli.faster_rcnn --variant plain B1, B3, B3-bwd launches (2 frozen steps)",
           (rec["trunk_launches"], rec["roialign_launches"], rec["roialign_backward_launches"]), (2, 2, 0))
    out["faster_rcnn"] = fit_measures("cli.faster_rcnn --variant plain", root_dp, "faster_rcnn", rec)
    del fit
    shutil.rmtree(root_dp)
    torch.cuda.empty_cache()

    return out


def trainer_phase(tmp: Path, smi: str, bare: dict) -> dict:
    """The main-path CLIs at the full width of AE_HPARAMS: cli.basic_ae
    (uninterrupted; stopped by --max_steps and resumed), cli.roadmap over its
    encoder (frozen epoch 0, unfrozen epoch 1), cli.run_test on the roadmap
    checkpoint at precision 32 and 8, and cli.roadmap at precision 16 and 8;
    beside the bare loop's figures of the training phase (`bare`)."""
    tf32_line("trainer")
    t_phase = time.perf_counter()
    data = tmp / "cli_data"
    generate(str(data), scenes=CLI_SCENES, samples=CLI_SAMPLES, labeled_scenes=CLI_SCENES, seed=SEED)
    print(f"trainer: synthetic dataset in {time.perf_counter() - t_phase:.1f} s; "
          f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB free on its disk", flush=True)
    common = ["--link", str(data), "--samples_per_scene", str(CLI_SAMPLES), "--batch_size", str(BATCH),
              "--precision", "32", "--max_epochs", str(CLI_EPOCHS), "--limit_train_batches", str(CLI_BATCHES),
              "--log_every_n_steps", "1", "--output_img_freq", "0", "--seed", str(SEED)]
    ae_argv = common + ["--num_unlabeled_scenes", str(CLI_SCENES), "--hidden_dim", str(AE_HPARAMS["hidden_dim"]),
                        "--latent_dim", str(AE_HPARAMS["latent_dim"])]
    steps = CLI_EPOCHS * CLI_BATCHES
    out = {}

    # 1. basic_ae, uninterrupted: B1 once a train step and once a validation
    # batch; deterministic algorithms here and in 2 (see RESUME_TOL)
    root_a = tmp / "cli_ae"
    with deterministic_algorithms():
        fit, rec = cli_run("cli.basic_ae", cli_basic_ae.main, ae_argv + ["--default_root_dir", str(root_a)],
                           smi, ranges=tuple(f"epoch {e} train" for e in range(CLI_EPOCHS)))
    expect("cli.basic_ae stop", fit.stop_reason, None)
    expect("cli.basic_ae B1 launches", rec["trunk_launches"], steps + CLI_EPOCHS)
    out["basic_ae"] = fit_measures("cli.basic_ae", root_a, "basic_ae", rec)
    expect("cli.basic_ae steps", sorted(rec["losses"]), list(range(steps)))
    ae_ckpt = root_a / "basic_ae" / "last.ckpt"
    del fit
    torch.cuda.empty_cache()

    # 2. the same run stopped by --max_steps, then resumed from its last.ckpt
    root_b = tmp / "cli_ae_resume"
    with deterministic_algorithms():
        fit, stop = cli_run("cli.basic_ae --max_steps", cli_basic_ae.main,
                            ae_argv + ["--default_root_dir", str(root_b), "--max_steps", str(CLI_AE_STOP)], smi)
        expect("cli.basic_ae --max_steps stop", fit.stop_reason, f"max_steps={CLI_AE_STOP} reached")
        expect("cli.basic_ae --max_steps B1 launches", stop["trunk_launches"], CLI_AE_STOP + 1)
        last = fit.last_ckpt_path
        del fit
        torch.cuda.empty_cache()
        fit, resumed = cli_run("cli.basic_ae resumed", cli_basic_ae.main,
                               ae_argv + ["--default_root_dir", str(root_b), "--resume_from_checkpoint", last], smi)
    expect("cli.basic_ae resumed B1 launches", resumed["trunk_launches"], steps - CLI_AE_STOP + 1)
    del fit
    torch.cuda.empty_cache()
    out["basic_ae_resume"] = {**hold_resume("cli.basic_ae", root_b, "basic_ae", out["basic_ae"]["losses"],
                                            CLI_AE_STOP, smi), "stopped": stop, "resumed": resumed}
    shutil.rmtree(root_b)

    # 3. roadmap_bce over that encoder: frozen in epoch 0, trained in epoch 1
    rm_argv = common + ["--variant", "bce_v2", "--num_labeled_scenes", str(CLI_SCENES),
                        "--pretrained_path", str(ae_ckpt), "--unfreeze_epoch_no", "1"]
    root_rm = tmp / "cli_rm"
    fit, rec = staged_cli("cli.roadmap", cli_roadmap.main, rm_argv + ["--default_root_dir", str(root_rm)],
                          RoadMapBCEv2, smi, rasters=0, images=0)
    out["roadmap_bce"] = fit_measures("cli.roadmap", root_rm, "roadmap_bce", rec)
    rm_ckpt = fit.last_ckpt_path
    del fit
    torch.cuda.empty_cache()

    # 4. run_test scores the labeled scenes with the roadmap checkpoint,
    # at precision 32 and then 8 (calibrated on the first batch: B1-int8
    # once a batch and once for the warm-up, bf16 B1 never)
    rt_argv = ["--rm_ckpt_path", rm_ckpt, "--link", str(data), "--num_labeled_scenes", str(CLI_SCENES),
               "--samples_per_scene", str(CLI_SAMPLES), "--batch_size", str(BATCH)]
    batches = CLI_SCENES * CLI_SAMPLES // BATCH
    masks = {}
    for precision in (32, 8):
        label = "cli.run_test" + ("" if precision == 32 else " --precision 8")
        masks[precision] = tmp / f"run_test_{precision}.npz"
        Int8TrunkMixin.calibrations = prepare_int8_weights.calls = 0
        argv = rt_argv + ["--out", str(masks[precision])] + ([] if precision == 32 else ["--precision", "8"])
        res, rec = cli_run(label, cli_run_test.main, argv, smi, ranges=("run_test predict",))
        expect(f"{label} scenes", res["n_scenes"], CLI_SCENES * CLI_SAMPLES)
        if precision == 32:
            expect(f"{label} B1 launches", (rec["trunk_launches"], rec["trunk_int8_launches"]), (batches + 1, 0))
        else:
            expect(f"{label} B1, B1-int8 launches", (rec["trunk_launches"], rec["trunk_int8_launches"]),
                   (0, batches + 1))
            expect(f"{label} calibrations, int8 weight layouts",
                   (Int8TrunkMixin.calibrations, prepare_int8_weights.calls), (1, 1))
        if not 0 <= res["avg_ts"] <= 1:
            raise RuntimeError(f"{label}: avg_ts {res['avg_ts']}")
        print(f"{label} ({smi}): {res['scenes_per_sec']:.1f} scenes/s, avg_ts {res['avg_ts']:.4f} over "
              f"{res['n_scenes']} scenes", flush=True)
        out["run_test" if precision == 32 else "run_test_8"] = {**rec, **res}
    with np.load(masks[32]) as a, np.load(masks[8]) as b:
        agree = float((a["masks"] == b["masks"]).mean())
    print(f"cli.run_test --precision 8: masks agree with precision 32's on {agree:.6f} of pixels", flush=True)
    if agree <= P8_AGREEMENT:
        raise RuntimeError(f"cli.run_test --precision 8: mask agreement {agree} with precision 32")
    out["run_test_8"]["mask_agreement_p32"] = agree
    shutil.rmtree(root_rm)
    torch.cuda.empty_cache()

    # 5. roadmap at precision 16: B1's bf16 kernel
    dtypes = []
    launch = trunk_module._launch

    def spy_launch(x, params, stages):
        dtypes.append(x.dtype)
        return launch(x, params, stages)

    root_16 = tmp / "cli_rm16"
    with mock.patch.object(trunk_module, "_launch", spy_launch):
        fit, rec = cli_run("cli.roadmap --precision 16", cli_roadmap.main,
                           rm_argv[:rm_argv.index("--precision")] + ["--precision", "16"]
                           + rm_argv[rm_argv.index("--precision") + 2:]
                           + ["--default_root_dir", str(root_16), "--max_steps", "2"], smi)
    expect("cli.roadmap --precision 16 B1 launches", rec["trunk_launches"], 2)
    expect("cli.roadmap --precision 16 trunk dtypes", dtypes, [torch.bfloat16] * 2)
    out["roadmap_bce_16"] = fit_measures("cli.roadmap --precision 16", root_16, "roadmap_bce", rec)
    del fit
    shutil.rmtree(root_16)
    torch.cuda.empty_cache()

    # 5b. roadmap at precision 8: training is bf16 (B1's bf16 kernel in each
    # step) and, never calibrated, so is validation, after the one message
    dtypes.clear()
    root_8 = tmp / "cli_rm8"
    argv = rm_argv[:rm_argv.index("--precision")] + ["--precision", "8"] + rm_argv[rm_argv.index("--precision") + 2:]
    for flag, value in (("--max_epochs", "1"), ("--limit_train_batches", "2")):
        argv[argv.index(flag) + 1] = value
    RoadMapBCEv2._warned_uncalibrated = False
    tee = Tee()
    with mock.patch.object(trunk_module, "_launch", spy_launch), redirect_stdout(tee):
        fit, rec = cli_run("cli.roadmap --precision 8", cli_roadmap.main,
                           argv + ["--default_root_dir", str(root_8)], smi)
    messages = tee.getvalue().count("--precision 8 without calibrated scales")
    expect("cli.roadmap --precision 8 B1, B1-int8 launches (2 steps, 1 validation batch)",
           (rec["trunk_launches"], rec["trunk_int8_launches"]), (3, 0))
    expect("cli.roadmap --precision 8 trunk dtypes", dtypes, [torch.bfloat16] * 3)
    expect("cli.roadmap --precision 8 uncalibrated messages", messages, 1)
    out["roadmap_bce_8"] = fit_measures("cli.roadmap --precision 8", root_8, "roadmap_bce", rec)
    out["roadmap_bce_8"]["uncalibrated_messages"] = messages
    del fit
    shutil.rmtree(root_8)
    torch.cuda.empty_cache()

    # 6. the box-family CLIs over the basic_ae encoder, frozen in epoch 0:
    # spatial_rm (log_images every CLI_IMG_FREQ batches), multitask and
    # bb_mlp; then multitask under deterministic algorithms (see
    # RESUME_TOL), uninterrupted and stopped by --max_steps and resumed;
    # and multitask at precision 16
    box_argv = common + ["--num_labeled_scenes", str(CLI_SCENES), "--pretrained_path", str(ae_ckpt),
                         "--unfreeze_epoch_no", "1"]
    for name, main, cls, extra, rasters, images in (
            ("spatial_rm", cli_spatial_bb.main, BBSpatialRoadMap, ["--variant", "rm"], 1,
             CLI_EPOCHS * CLI_BATCHES // CLI_IMG_FREQ),
            ("multitask", cli_multitask.main, MultiTask, [], 1, 0),
            ("bb_mlp", cli_bb_mlp.main, Boxes, [], 0, 0)):
        label = f"cli.{'spatial_bb' if name == 'spatial_rm' else name}"
        argv = extra + box_argv + ["--default_root_dir", str(tmp / f"cli_{name}")]
        if images:
            argv[argv.index("--output_img_freq") + 1] = str(CLI_IMG_FREQ)
        fit, rec = staged_cli(label, main, argv, cls, smi, rasters, images)
        out[name] = fit_measures(label, tmp / f"cli_{name}", name, rec)
        del fit
        shutil.rmtree(tmp / f"cli_{name}")
        torch.cuda.empty_cache()

    root_mr = tmp / "cli_multitask_resume"
    with deterministic_algorithms():
        fit, ref = cli_run("cli.multitask, deterministic", cli_multitask.main,
                           box_argv + ["--default_root_dir", str(tmp / "cli_multitask_det")], smi)
        expect("cli.multitask, deterministic B1, B2 launches", (ref["trunk_launches"], ref["raster_launches"]),
               (steps + CLI_EPOCHS,) * 2)
        ref = fit_measures("cli.multitask, deterministic", tmp / "cli_multitask_det", "multitask", ref)
        del fit
        torch.cuda.empty_cache()
        fit, stop = cli_run("cli.multitask --max_steps", cli_multitask.main,
                            box_argv + ["--default_root_dir", str(root_mr), "--max_steps", str(CLI_AE_STOP)], smi)
        expect("cli.multitask --max_steps stop", fit.stop_reason, f"max_steps={CLI_AE_STOP} reached")
        expect("cli.multitask --max_steps B1, B2 launches", (stop["trunk_launches"], stop["raster_launches"]),
               (CLI_AE_STOP + 1, CLI_AE_STOP + 1))
        last = fit.last_ckpt_path
        del fit
        torch.cuda.empty_cache()
        fit, resumed = cli_run("cli.multitask resumed", cli_multitask.main,
                               box_argv + ["--default_root_dir", str(root_mr), "--resume_from_checkpoint", last],
                               smi)
    expect("cli.multitask resumed B1, B2 launches", (resumed["trunk_launches"], resumed["raster_launches"]),
           (steps - CLI_AE_STOP + 1,) * 2)
    del fit
    torch.cuda.empty_cache()
    out["multitask_resume"] = {**hold_resume("cli.multitask", root_mr, "multitask", ref["losses"], CLI_AE_STOP, smi),
                               "uninterrupted": ref, "stopped": stop, "resumed": resumed}
    shutil.rmtree(root_mr)
    shutil.rmtree(tmp / "cli_multitask_det")

    dtypes.clear()
    root_mt16 = tmp / "cli_multitask16"
    argv = box_argv[:box_argv.index("--precision")] + ["--precision", "16"] + box_argv[box_argv.index("--precision") + 2:]
    with mock.patch.object(trunk_module, "_launch", spy_launch):
        fit, rec = cli_run("cli.multitask --precision 16", cli_multitask.main,
                           argv + ["--default_root_dir", str(root_mt16), "--max_steps", "2"], smi)
    expect("cli.multitask --precision 16 B1, B2 launches", (rec["trunk_launches"], rec["raster_launches"]), (2, 2))
    expect("cli.multitask --precision 16 trunk dtypes", dtypes, [torch.bfloat16] * 2)
    out["multitask_16"] = fit_measures("cli.multitask --precision 16", root_mt16, "multitask", rec)
    del fit
    shutil.rmtree(root_mt16)
    torch.cuda.empty_cache()

    # 6b. cli.faster_rcnn over the same encoder
    out.update(det_cli_runs(tmp, box_argv, smi))

    # 7. device_prefetch's staging thread against pinning on the step's thread
    out["prefetch_ab"] = prefetch_ab(tmp, data, ae_ckpt, smi)
    shutil.rmtree(root_a)  # the roadmap and box runs' pretrained_path, read until here

    # the trainer against the bare loop of the training phase (same widths,
    # batch and precision; the bare loop has no data loading, logging,
    # validation or checkpoints)
    for name, b in (("basic_ae", bare["basic_ae"]), ("roadmap_bce", bare["roadmap_bce"])):
        t = out[name]
        idle = ", ".join(f"{r['idle_share']:.3f}" for r in t["ranges"].values())
        print(f"{name} ({smi}): trainer {t['scenes_per_s_by_epoch']} scenes/s by epoch, median step "
              f"{t['median_step_ms']:.3f} ms, idle share by epoch {idle}, peak {t['peak_memory_gb']:.2f} GB; "
              f"bare loop {b['window']['scenes_per_s']:.1f} scenes/s, {b['window']['wall_ms']:.3f} ms a step, "
              f"idle share {b['window']['idle_share']:.3f}, peak {b['peak_memory_gb']:.2f} GB", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"trainer phase: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 10: decode and host metrics
# ---------------------------------------------------------------------------

def native_headers() -> dict:
    """{header: whether g++ finds it} for the native decoder's headers."""
    out = {}
    for header in NATIVE_HEADERS:
        proc = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"], input=f"#include <cstdio>\n#include <{header}>\n",
                              capture_output=True, text=True)
        out[header] = proc.returncode == 0
    return out


@contextmanager
def decoder(native: bool):
    """The dataset decodes natively where it builds (native=True) or through
    PIL (DD_NATIVE_DECODE=0), probed anew; DECODES counts from 0."""
    old = os.environ.get("DD_NATIVE_DECODE")
    os.environ["DD_NATIVE_DECODE"] = "1" if native else "0"
    dataset_module._native = False
    for k in dataset_module.DECODES:
        dataset_module.DECODES[k] = 0
    try:
        yield dataset_module._native_decoder()
    finally:
        if old is None:
            del os.environ["DD_NATIVE_DECODE"]
        else:
            os.environ["DD_NATIVE_DECODE"] = old
        dataset_module._native = False


def decode_bytes_phase(data: Path, nat) -> dict:
    """Every view and ego map of the synthetic dataset decoded natively and
    by PIL: the bytes that differ, and the host ms an image each way."""
    files = sorted(data.glob("scene_*/sample_*/*.jpeg")) + sorted(data.glob("scene_*/sample_*/ego.png"))
    differing, ms = 0, {"native": 0.0, "pil": 0.0}
    for path in files:
        shape = (800, 800) if path.suffix == ".png" else (VIEW_H, VIEW_W)
        t0 = time.perf_counter()
        a = nat.decode_image(str(path), *shape, raw_uint8=True)
        t1 = time.perf_counter()
        with Image.open(path) as im:
            b = np.asarray(im.convert("RGB"), np.uint8)
        t2 = time.perf_counter()
        ms["native"] += 1e3 * (t1 - t0)
        ms["pil"] += 1e3 * (t2 - t1)
        differing += int((a != b).sum())
    return {"files": len(files), "differing_bytes": differing,
            "ms_per_image": {k: v / len(files) for k, v in ms.items()}}


def first_step_wait(label: str, data: Path, ae_ckpt: Path, tmp: Path, smi: str) -> dict:
    """One cli.roadmap epoch of DECODE_STEPS steps over the frozen encoder:
    its first step_ms (the loader's start: the first batch's decode) beside
    the median of the others."""
    root = tmp / "cli_decode"
    argv = ["--link", str(data), "--samples_per_scene", str(CLI_SAMPLES), "--batch_size", str(BATCH),
            "--precision", "32", "--max_epochs", "1", "--limit_train_batches", str(DECODE_STEPS),
            "--limit_val_batches", "1", "--log_every_n_steps", "1", "--output_img_freq", "0", "--seed", str(SEED),
            "--variant", "bce_v2", "--num_labeled_scenes", str(CLI_SCENES), "--pretrained_path", str(ae_ckpt),
            "--default_root_dir", str(root)]
    fit, rec = cli_run(label, cli_roadmap.main, argv, smi)
    del fit
    step_ms = [r["step_ms"] for r in metrics_records(root, "roadmap_bce") if "step_ms" in r]
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    out = {"first_step_ms": step_ms[0], "median_other_ms": statistics.median(step_ms[1:]), "step_ms": step_ms,
           "decodes": dict(dataset_module.DECODES)}
    print(f"{label} ({smi}): first step {out['first_step_ms']:.1f} ms, the others' median "
          f"{out['median_other_ms']:.1f} ms; decodes {out['decodes']}", flush=True)
    return out


def ats_timing(smi: str) -> dict:
    """metrics/threat.py:ats_bounding_boxes on the host, the native IoU loop
    against the Python one, on the detection phase's scenes: each image's
    valid ground-truth boxes against a copy jittered by 0.2 m plus as many
    random boxes. The two values must be equal."""
    pairs = []
    rng = np.random.RandomState(SEED + 30)
    for batch in detection_batches():
        boxes, valid = batch["boxes"].cpu().numpy(), batch["box_valid"].cpu().numpy()
        for b, v in zip(boxes, valid):
            gt = b[v].astype(np.float64)
            pred = np.concatenate([gt + rng.normal(0, 0.2, gt.shape), gt[::-1] + rng.normal(0, 3.0, gt.shape)])
            pairs.append((pred, gt))
    if threat_module._native_iou() is None:
        raise RuntimeError("the native IoU loop (metrics/_native.py) did not build")
    out = {"images": len(pairs), "boxes_per_image": float(np.mean([len(g) for _, g in pairs]))}
    values = {}
    for name, patch in (("native", nullcontext()), ("python", mock.patch.object(threat_module, "_native_iou",
                                                                                lambda: None))):
        with patch:
            t0 = time.perf_counter()
            values[name] = [threat_module.ats_bounding_boxes(p, g) for p, g in pairs]
            out[f"{name}_ms_per_call"] = 1e3 * (time.perf_counter() - t0) / len(pairs)
    if values["native"] != values["python"]:
        raise RuntimeError("ats_bounding_boxes: the native and the Python IoU loops disagree")
    out["mean_ats"] = float(np.mean(values["native"]))
    print(f"ats_bounding_boxes ({smi}, host): native {out['native_ms_per_call']:.3f} ms, Python "
          f"{out['python_ms_per_call']:.3f} ms a call over {len(pairs)} images of "
          f"{out['boxes_per_image']:.1f} boxes; equal values (mean {out['mean_ats']:.4f})", flush=True)
    return out


def decode_phase(tmp: Path, smi: str, rm_ckpt: Path, ae_ckpt: Path) -> dict:
    """Phase 10: which decoder the dataset uses on this machine and why, its
    bytes against PIL's, cli.run_test at precision 32 and 8 and the first
    step of a cli.roadmap epoch with each decoder (PIL alone where the
    native one does not build), and the host box threat score."""
    t_phase = time.perf_counter()
    data = tmp / "cli_data"
    if not data.exists():
        generate(str(data), scenes=CLI_SCENES, samples=CLI_SAMPLES, labeled_scenes=CLI_SCENES, seed=SEED)
    headers = native_headers()
    with decoder(True) as nat:
        build_error = dataset_module.native_error()
    print(f"decode ({smi}): headers {headers}; native decoder "
          f"{'built' if nat is not None else 'unavailable'}" + (f"; build error: {build_error}" if build_error else ""),
          flush=True)
    out = {"headers": headers, "native": nat is not None, "build_error": build_error}
    if nat is not None:
        out["bytes"] = decode_bytes_phase(data, nat)
        print(f"decode ({smi}): {out['bytes']['differing_bytes']} bytes differ from PIL over "
              f"{out['bytes']['files']} files; host ms an image native {out['bytes']['ms_per_image']['native']:.3f}, "
              f"PIL {out['bytes']['ms_per_image']['pil']:.3f}", flush=True)
    else:
        print(f"decode ({smi}): bytes against PIL not measured (no native decoder)", flush=True)
    backends = (True, False) if nat is not None else (False,)
    rt_argv = ["--rm_ckpt_path", str(rm_ckpt), "--link", str(data), "--num_labeled_scenes", str(CLI_SCENES),
               "--samples_per_scene", str(CLI_SAMPLES), "--batch_size", str(BATCH)]
    for native in backends:
        name = "native" if native else "pil"
        for precision in (32, 8):
            label = f"cli.run_test --precision {precision}, {name} decode"
            with decoder(native):
                res, rec = cli_run(label, cli_run_test.main, rt_argv + ["--precision", str(precision)], smi,
                                   ranges=("run_test predict",))
                decodes = dict(dataset_module.DECODES)
            if decodes["native" if native else "pil"] == 0 or decodes["pil" if native else "native"]:
                raise RuntimeError(f"{label}: decodes {decodes}")
            idle = rec["ranges"]["run_test predict"]["idle_share"]
            print(f"{label} ({smi}): {res['scenes_per_sec']:.1f} scenes/s, idle share {idle:.3f}, "
                  f"decodes {decodes}", flush=True)
            out[f"run_test_{precision}_{name}"] = {"scenes_per_s": res["scenes_per_sec"], "idle_share": idle,
                                                   "decodes": decodes}
            torch.cuda.empty_cache()
        with decoder(native):
            out[f"first_step_{name}"] = first_step_wait(f"cli.roadmap epoch, {name} decode", data, ae_ckpt,
                                                        tmp, smi)
    out["ats"] = ats_timing(smi)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"decode phase: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 11: export and serve
# ---------------------------------------------------------------------------

def hold_artifact(label: str, kind: str, precision: int, rec: dict) -> None:
    """A served answer against the model's own predict on the same f32
    inputs (scripts/serve_artifacts.py measured them). At precision 32 the
    two must be equal: they run the same operations and kernels on the same
    inputs. At 16 and 8, the serving phases' bars."""
    if precision == 32 and not rec["exact"]:
        raise RuntimeError(f"{label}: outputs differ from predict's: {rec}")
    if kind in ("roadmap", "multitask"):
        bar = MASK_AGREEMENT.get(precision, P8_AGREEMENT)
        if rec["mask_agreement"] < bar:
            raise RuntimeError(f"{label}: masks agree with predict on {rec['mask_agreement']} < {bar}")
    if kind in ("multitask", "spatial") and rec["occupancy_err"] > BOX_TOL[precision] * rec["occupancy_max"]:
        raise RuntimeError(f"{label}: box occupancy {rec['occupancy_err']} from predict's")
    if kind == "detection" and rec["found_share"] < DET_AGREEMENT:
        raise RuntimeError(f"{label}: found {rec['found_share']} of predict's detections")


def deploy_phase(tmp: Path, smi: str) -> dict:
    """Phase 11: the checkpoints of phases 4, 5 and 7 (and a spatial_rm one
    from a seed) exported at batch 8, then loaded and served in a fresh
    process (scripts/serve_artifacts.py), whose numbers are held here: no
    model module imported by the loads, each artifact's kernels launched as
    its model's path launches them, its answers against the model's own
    predict, the HTTP round trip, and swap_params (a second checkpoint's
    masks; a drifted state refused)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    save_task_ckpt(tmp / "spatial_rm.ckpt", BBSpatialRoadMap(BOX_HPARAMS, device="cuda", generator=gen))
    save_task_ckpt(tmp / "roadmap_bce_2.ckpt", RoadMapBCEv2(HPARAMS, device="cuda", generator=gen))
    torch.cuda.empty_cache()
    calib = {"images": request_images(np.random.RandomState(SEED + 41), 1)[0],
             "road": detection_scenes(SEED + 42, BATCH, MAX_BB, DET_SIZE)["road"]}
    np.savez(tmp / "calib.npz", **calib)
    exporters = {"roadmap": ddx.export_roadmap, "detection": ddx.export_detection,
                 "multitask": ddx.export_multitask, "spatial": ddx.export_spatial}
    spec = {"artifacts": [], "calib": str(tmp / "calib.npz"), "swap": str(tmp / "roadmap_bce_2.ckpt"),
            "out": str(tmp / "deploy.json"), "batch": BATCH, "requests": DEPLOY_REQUESTS, "pool": DEPLOY_POOL,
            "seed": SEED + 43}
    exports = {}
    for (kind, precision), ckpt in DEPLOY_EXPORTS.items():
        name, art = f"{kind}_{precision}", tmp / f"{kind}_{precision}.ddx"
        kw = {}
        if precision == 8:
            kw = {"calib": calib} if kind == "detection" else {"calib_images": calib["images"]}
        t0 = time.perf_counter()
        meta = exporters[kind](str(tmp / ckpt), str(art), batch_size=BATCH, precision=precision, device="cuda",
                               **kw)
        exports[name] = {"seconds": time.perf_counter() - t0, "mb": art.stat().st_size / 1e6, "task": meta["task"]}
        print(f"export {meta['task']} precision {precision} ({smi}): {exports[name]['mb']:.1f} MB in "
              f"{exports[name]['seconds']:.1f} s", flush=True)
        spec["artifacts"].append({"name": name, "kind": kind, "precision": precision, "path": str(art),
                                  "ckpt": str(tmp / ckpt)})
        torch.cuda.empty_cache()
    (tmp / "deploy_spec.json").write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, "-m", "driving_dirty_tpu_torch.scripts.serve_artifacts",
                           str(tmp / "deploy_spec.json")], cwd=Path(__file__).resolve().parent, timeout=900)
    for a in spec["artifacts"]:
        Path(a["path"]).unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"scripts/serve_artifacts.py failed (exit {proc.returncode})")
    out = json.loads((tmp / "deploy.json").read_text())
    if out["model_modules_after_load"]:
        raise RuntimeError(f"loading the artifacts imported {out['model_modules_after_load']}")
    for name, rec in out["artifacts"].items():
        kind, precision = DEPLOY_NAMES[name]
        expect(f"{name} artifact (B1, B1-int8, B3) launches a request", tuple(rec["launches_per_request"]),
               DEPLOY_LAUNCHES[(kind, precision)])
        hold_artifact(f"{name} artifact", kind, precision, rec)
        rec.update(exports[name])
    if not (out["http"]["masks_equal_served"] and out["http"]["healthz_task"] == "roadmap_bce"):
        raise RuntimeError(f"HTTP round trip: {out['http']}")
    swap = out["swap"]
    if not (swap["exact"] and swap["changed_share"] > 0 and swap["drifted_state_refused"]):
        raise RuntimeError(f"swap_params: masks equal to the second checkpoint's predict, changed by the "
                           f"swap and a drifted state refused, got {swap}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"deploy phase: {out['seconds']:.1f} s", flush=True)
    return out


# Mesh phase (12): ranks spawned by parallel/launch.py on cuda:0, which
# they share over gloo (the one card allows no other layout), at the full
# width of AE_HPARAMS / HPARAMS, each against the one-process run of the
# same global batches from the same seed: BasicAE dp=2 (dropout and the
# six-to-one mask on: the global draws), roadmap_bce with its encoder
# frozen at dp=1 x tp=2 (the head's fc1 column-parallel, the encoder's
# fc1.fc row-parallel), multitask dp=2 (B2 in each rank's loss); validation
# off (limit_val_batches 0), so B1 (and B2) launch once a step. Every data
# rank sums the gradients once a step (none without a second data rank),
# and every rank ends with rank 0's weights, bit for bit (each takes the
# same summed gradient). Then cli.roadmap --gpus 2 --model_parallel 2
# --device cuda:0, stopped by --max_steps and resumed in one process,
# against the uninterrupted 2-rank run within RESUME_TOL. Two ranks on one
# card give no scaling figure.
MESH_RANKS = 2
MESH_RUNS = (("basic_ae", 3, 1), ("roadmap_bce", 3, 2), ("multitask", 2, 1),
             ("spatial_rm", 3, 2))  # (task, steps, model axis)
MESH_RASTER = ("multitask", "spatial_rm")  # the runs whose loss rasterizes its targets (B2)
# spatial_rm's shards a rank at tp=2 (the reference geometry): every conv of
# the heads with 8k output channels cut on them (dim 0 of OIHW, dim 1 of a
# transposed conv's [in, out, kh, kw]), with its bias; up_conv_5 (8 -> 1)
# and the encoder whole
_SPATIAL_CUTS = {**{f"space_map_cnn.{v}_conv.weight": [16, 3, 1, 50] for v in ("fl", "fr", "bl", "br")},
                 "space_map_cnn.f_conv.weight": [16, 3, 52, 1], "space_map_cnn.b_conv.weight": [16, 3, 52, 1],
                 "space_map_cnn.out_conv.weight": [16, 32, 3, 3], "box_merge.ss_conv.weight": [16, 32, 1, 24],
                 "box_merge.ss_deconv.weight": [32, 16, 2, 2], "box_merge.rm_conv_1.weight": [16, 1, 7, 7],
                 "box_merge.rm_conv_2.weight": [16, 32, 3, 3], "box_merge.up_conv_1.weight": [96, 32, 7, 7],
                 "box_merge.up_conv_2.weight": [64, 16, 7, 7], "box_merge.up_conv_3.weight": [32, 8, 7, 7],
                 "box_merge.up_conv_4.weight": [16, 4, 7, 7]}
MESH_SHARDS = {"roadmap_bce": {"encoder.fc1.fc.weight": [128, 470016], "fc1.weight": [320000, 64],
                               "fc1.bias": [320000]},
               "spatial_rm": {**_SPATIAL_CUTS, **{k.replace(".weight", ".bias"): [v[1] if "up_conv" in k or "deconv" in k
                                                                                   else v[0]]
                                                  for k, v in _SPATIAL_CUTS.items()}}}
# The tp runs that train a replicated parameter (spatial_rm's up_conv_5, 8
# -> 1; roadmap_bce trains only its cut fc1): Adam averages its gradient
# over 'model' once a step (collectives.py:mean_over_model), so the ranks'
# copies stay bit-equal under cuDNN's default algorithms, which need not
# give two ranks the same bits for the same inputs
MESH_REPLICATED = ("spatial_rm",)
MESH_CLI_STEPS, MESH_CLI_STOP = 4, 2
# Losses against one process's, relative, at every step: the same math on
# the same global batch, only the sums split over the ranks (PR 13's runs
# measured at most 1.2e-7 at the first step and 8.2e-6 after). Bars of 1e-4
# leave 12x room over the largest; LOSS_TOL's 5e-2 for later steps (set for
# another kernel's run) would pass ranks that each stepped on their own
# half-batch gradient.
MESH_LOSS_TOL = (1e-4, 1e-4)
# Rank 0's final weights against one process's: |w_rank - w_one| over
# |w_one - w_init|, all parameters as one vector, that is the error of the
# update the fit made. Phase 12 measured 1.3e-5 for roadmap_bce and 3.1e-6
# for multitask (encoders frozen, the heads' gradients well conditioned;
# PR 13, NVIDIA H100 80GB HBM3, 700.00 W): bars of 1e-4. BasicAE measured
# 0.248: its first Adam steps move by +-lr the weights whose gradient is
# float noise, and the sum order picks the sign; its bar is 0.5, and what holds
# its ranks to the global gradient is the count of sums and the ranks'
# equal weights, with the losses.
MESH_STATE_TOL = {"basic_ae": 0.5, "roadmap_bce": 1e-4, "multitask": 1e-4, "spatial_rm": 1e-4}


def gloo_cuda_probe() -> dict:
    """A rank's all_reduce, all_gather and broadcast of CUDA tensors over
    the world's gloo group."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty(4, device="cuda") for _ in range(n)]
    dist.all_gather(parts, torch.full((4,), float(r), device="cuda"))
    b = torch.full((4,), float(r + 7), device="cuda")
    dist.broadcast(b, src=0)
    return {"all_reduce": x.tolist(), "all_gather": [p.tolist() for p in parts], "broadcast": b.tolist(),
            "device": str(x.device)}


def mesh_rank(specs: list) -> list:
    """A spawned rank: TF32 off as in every phase, then each spec's fit."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return [launch.fit_worker(spec) for spec in specs]


def mesh_specs(tmp: Path, ae_ckpt: Path) -> list:
    """The fits of MESH_RUNS on seeded batches of BATCH scenes: the training
    phase's views (with random road maps), and box_scenes for multitask and
    spatial_rm (over the training phase's BasicAE `ae_ckpt`)."""
    rng = np.random.RandomState(SEED + 6)
    images = request_images(rng, 2)
    roads = [(rng.rand(BATCH, 800, 800) > 0.5).astype(np.float32) for _ in images]
    boxes = [box_scenes(SEED + 1 + i, BATCH, MAX_BB) for i in range(2)]
    labeled = [{"images": x, "road": r, "boxes": b, "box_valid": v} for x, r, (b, v) in zip(images, roads, boxes)]
    tasks = {"basic_ae": (BasicAE, AE_HPARAMS, [{"images": x} for x in images]),
             "roadmap_bce": (RoadMapBCEv2, dict(HPARAMS, unfreeze_epoch_no=1),
                             [{k: b[k] for k in ("images", "road")} for b in labeled]),
             "multitask": (MultiTask, BOX_HPARAMS, labeled),
             "spatial_rm": (BBSpatialRoadMap, dict(BOX_HPARAMS, pretrained_path=str(ae_ckpt)), labeled)}
    specs = []
    for name, steps, model in MESH_RUNS:
        cls, hparams, batches = tasks[name]
        specs.append({"task": cls, "hparams": dict(hparams, learning_rate=LR), "seed": SEED + 12,
                      "batches": [batches[i % len(batches)] for i in range(steps)], "model_parallel": model,
                      "time_reduce": True, "device": "cuda", "state": True,
                      "trainer": dict(max_epochs=1, limit_val_batches=0, log_every_n_steps=1,
                                      enable_checkpointing=False, enable_progress_bar=False,
                                      default_root_dir=str(tmp / "mesh" / name))})
    return specs


def update_error(spec: dict, state: dict, one: dict) -> float:
    """|state - one| / |one - init| over every parameter of the task as one
    vector, init the weights fit_worker builds the task with."""
    gen = torch.Generator(device="cuda").manual_seed(spec["seed"])
    init = dict(spec["task"](spec["hparams"], device="cuda", generator=gen).named_parameters())
    num = den = 0.0
    for k, w0 in init.items():
        w, w1 = state[k].double(), one[k].double()
        num += float((w - w1).square().sum())
        den += float((w1 - w0.detach().cpu().double()).square().sum())
    return (num / den) ** 0.5


def mesh_losses(root: str, task: str) -> tuple[list, list]:
    recs = metrics_records(Path(root), task)
    return ([r["train_loss"] for r in recs if "train_loss" in r], [r["step_ms"] for r in recs if "step_ms" in r])


def mesh_phase(tmp: Path, smi: str, ae_ckpt: Path) -> dict:
    """Phase 12 (see MESH_RANKS): gloo's collectives on CUDA tensors, the
    three fits on MESH_RANKS ranks of cuda:0 against one process, and the
    2-rank cli.roadmap stop / one-process resume."""
    tf32_line("mesh")
    t_phase = time.perf_counter()
    out = {"card": smi}
    probe = launch.spawn(gloo_cuda_probe, MESH_RANKS, device="cuda:0")
    n = MESH_RANKS
    for r, p in enumerate(probe):
        want = {"all_reduce": [n * (n + 1) / 2] * 4, "all_gather": [[float(i)] * 4 for i in range(n)],
                "broadcast": [7.0] * 4, "device": "cuda:0"}
        expect(f"mesh: gloo collectives of CUDA tensors on rank {r}", p, want)
    print(f"mesh: gloo takes CUDA tensors for all_reduce, all_gather and broadcast ({n} ranks on cuda:0), "
          f"so parallel/collectives.py stages nothing through the host itself", flush=True)
    out["gloo_cuda"] = probe

    # the global dropout draw: each dp=2 rank draws the decoder's widest
    # mask for the global batch's 8 rows, as one process does, and keeps 4
    g = torch.Generator(device="cuda").manual_seed(SEED)
    width = 64 * 128 * 153  # the decoder's fc2 outputs at 256 x 306 views
    draw = {rows: cuda_ms(lambda: torch.rand((rows, width), device="cuda", generator=g))
            for rows in (BATCH, BATCH // 2)}
    out["dropout_draw_ms"] = {"global_8_rows": draw[BATCH], "local_4_rows": draw[BATCH // 2]}
    print(f"mesh: the decoder's widest dropout draw ({smi}): {draw[BATCH]:.4f} ms for the global batch's 8 "
          f"rows (what each dp=2 rank draws), {draw[BATCH // 2]:.4f} ms for its own 4", flush=True)

    specs = mesh_specs(tmp, ae_ckpt)
    t0 = time.perf_counter()
    ranks = launch.spawn(mesh_rank, MESH_RANKS, (specs,), device="cuda:0")
    out["spawned_s"] = time.perf_counter() - t0
    for i, (spec, (name, steps, model)) in enumerate(zip(specs, MESH_RUNS)):
        root = spec["trainer"]["default_root_dir"]
        losses, step_ms = mesh_losses(root, spec["task"].name)
        one = launch.fit_worker(dict(spec, model_parallel=1, trainer=dict(spec["trainer"], default_root_dir=root + "_one")))
        one_losses, one_ms = mesh_losses(root + "_one", spec["task"].name)
        label = f"mesh {name} dp={MESH_RANKS // model} x tp={model}"
        expect(f"{label} steps", len(losses), steps)
        err = hold_trajectory(label, losses, one_losses, "one process's", MESH_LOSS_TOL)
        per_rank = [rank[i] for rank in ranks]
        for r, got in enumerate(per_rank):
            expect(f"{label} rank {r} gradient sums", got["grad_reduce"]["calls"], steps if model == 1 else 0)
            expect(f"{label} rank {r} replicated gradients' means over 'model'", got["tp_comm"]["mean"]["calls"],
                   steps if name in MESH_REPLICATED else 0)
            if r:
                expect(f"{label} rank {r} final weights equal to rank 0's",
                       [k for k, v in got.pop("state").items() if not torch.equal(v, per_rank[0]["state"][k])], [])
        state_err = update_error(spec, per_rank[0].pop("state"), one.pop("state"))
        print(f"{label}: rank 0's final weights against one process's, |w - w_one| / |w_one - w_init| "
              f"{state_err:.3e} (tolerance {MESH_STATE_TOL[name]}); every rank's equal to rank 0's", flush=True)
        if not state_err <= MESH_STATE_TOL[name]:
            raise RuntimeError(f"{label}: final weights {state_err} from one process's > {MESH_STATE_TOL[name]}")
        want = (steps, steps if name in MESH_RASTER else 0)  # (B1, B2) launches
        for r, got in enumerate(per_rank + [one]):
            expect(f"{label} {'one-process' if r == len(per_rank) else f'rank {r}'} launches",
                   (got["launches"]["trunk"], got["launches"]["raster"]), want)
        if name in MESH_SHARDS:
            for r, got in enumerate(per_rank):
                expect(f"{label} rank {r} shard shapes", got["shard_shapes"], MESH_SHARDS[name])
        red = per_rank[0]["grad_reduce"]
        rec = {"losses": losses, "one_process_losses": one_losses, "loss_rel_err": err,
               "state_update_rel_err": state_err,
               "step_ms": step_ms, "one_process_step_ms": one_ms,
               "median_step_ms": statistics.median(step_ms[1:]),
               "one_process_median_step_ms": statistics.median(one_ms[1:]),
               "grad_reduce_calls": red["calls"],
               "grad_reduce_bytes_per_step": red["bytes"] / max(red["calls"], 1), "grad_reduce_ms": red["ms"],
               "grad_reduce_median_ms": statistics.median(red["ms"][1:]) if len(red["ms"]) > 1 else 0.0,
               "peak_memory_gb": [got["peak_memory_gb"] for got in per_rank],
               "one_process_peak_memory_gb": one["peak_memory_gb"],
               "launches": [got["launches"] for got in per_rank], "shard_shapes": per_rank[0]["shard_shapes"],
               "backend": per_rank[0]["backend"],
               "tp_comm_per_step": {kind: {k: v / steps for k, v in per_rank[0]["tp_comm"][kind].items()}
                                    for kind in ("gather", "sum", "mean")}}
        tp = rec["tp_comm_per_step"]
        if model > 1:
            print(f"{label} ({smi}): the 'model' axis a step on rank 0 (card synced around each): "
                  f"{tp['gather']['calls']:.0f} gathers of {tp['gather']['bytes'] / 1e6:.1f} MB in "
                  f"{tp['gather']['ms']:.1f} ms, {tp['sum']['calls']:.0f} sums of {tp['sum']['bytes'] / 1e6:.1f} MB "
                  f"in {tp['sum']['ms']:.1f} ms, {tp['mean']['calls']:.0f} means of the replicated gradients "
                  f"of {tp['mean']['bytes'] / 1e6:.4f} MB in {tp['mean']['ms']:.1f} ms", flush=True)
        print(f"{label} ({smi}; {MESH_RANKS} ranks share one card over {rec['backend']}: no scaling figure): "
              f"median ms a step {rec['median_step_ms']:.1f} (steps after the first) against "
              f"{rec['one_process_median_step_ms']:.1f} in one process; gradient all-reduce "
              f"{rec['grad_reduce_bytes_per_step'] / 1e6:.1f} MB a step, median {rec['grad_reduce_median_ms']:.1f} "
              f"ms after the first (each: {', '.join(f'{t:.1f}' for t in red['ms'])}); peak memory per rank "
              f"{', '.join(f'{g:.2f}' for g in rec['peak_memory_gb'])} GB (one process "
              f"{rec['one_process_peak_memory_gb']:.2f} GB); launches per rank {rec['launches']}"
              + (f"; shards a rank {rec['shard_shapes']}" if rec["shard_shapes"] else ""), flush=True)
        out[name] = rec
        torch.cuda.empty_cache()
    out["cli"] = mesh_cli(tmp, smi, ae_ckpt)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"mesh phase: {out['seconds']:.1f} s", flush=True)
    return out


def mesh_cli(tmp: Path, smi: str, ae_ckpt: Path) -> dict:
    """cli.roadmap --gpus 2 --model_parallel 2 --device cuda:0 (the encoder
    frozen): uninterrupted, and stopped at MESH_CLI_STOP then resumed in one
    process under deterministic algorithms."""
    data = tmp / "cli_data"
    if not data.exists():
        generate(str(data), scenes=CLI_SCENES, samples=CLI_SAMPLES, labeled_scenes=CLI_SCENES, seed=SEED)
    argv = ["--link", str(data), "--samples_per_scene", str(CLI_SAMPLES), "--batch_size", str(BATCH),
            "--max_epochs", "1", "--limit_train_batches", str(MESH_CLI_STEPS), "--limit_val_batches", "1",
            "--log_every_n_steps", "1", "--output_img_freq", "0", "--seed", str(SEED), "--variant", "bce_v2",
            "--num_labeled_scenes", str(CLI_SCENES), "--pretrained_path", str(ae_ckpt),
            "--unfreeze_epoch_no", "1"]
    ranks = ["--gpus", str(MESH_RANKS), "--model_parallel", str(MESH_RANKS), "--device", "cuda:0"]
    t0 = time.perf_counter()
    ref = cli_roadmap.main(argv + ranks + ["--default_root_dir", str(tmp / "mesh_cli")])
    expect("mesh cli.roadmap stop", ref.stop_reason, None)
    ref_losses = {r["step"]: r["train_loss"] for r in metrics_records(tmp / "mesh_cli", "roadmap_bce")
                  if "train_loss" in r}
    expect("mesh cli.roadmap steps", sorted(ref_losses), list(range(MESH_CLI_STEPS)))
    root = tmp / "mesh_cli_resume"
    stopped = cli_roadmap.main(argv + ranks + ["--default_root_dir", str(root), "--max_steps", str(MESH_CLI_STOP)])
    expect("mesh cli.roadmap --max_steps stop", stopped.stop_reason, f"max_steps={MESH_CLI_STOP} reached")
    with deterministic_algorithms():
        _, resumed = cli_run("mesh cli.roadmap resumed in one process", cli_roadmap.main,
                             argv + ["--default_root_dir", str(root), "--device", "cuda",
                                     "--resume_from_checkpoint", stopped.last_ckpt_path], smi)
    expect("mesh cli.roadmap resumed B1 launches", resumed["trunk_launches"], MESH_CLI_STEPS - MESH_CLI_STOP + 1)
    losses = {r["step"]: r["train_loss"] for r in metrics_records(root, "roadmap_bce") if "train_loss" in r}
    expect("mesh cli.roadmap stopped + resumed steps", sorted(losses), list(range(MESH_CLI_STEPS)))
    gaps = {k: abs(losses[k] - ref_losses[k]) / abs(ref_losses[k]) for k in losses}
    after = max(gaps[k] for k in range(MESH_CLI_STOP, MESH_CLI_STEPS))
    print(f"mesh cli.roadmap ({smi}): 2 ranks (dp=1 x tp=2) stopped at step {MESH_CLI_STOP}, resumed in one "
          f"process: steps {MESH_CLI_STOP}..{MESH_CLI_STEPS - 1} within {after:.3e} of the uninterrupted 2-rank "
          f"run (tolerance {RESUME_TOL}); before the stop {max(gaps[k] for k in range(MESH_CLI_STOP)):.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not after <= RESUME_TOL:
        raise RuntimeError(f"mesh cli.roadmap: resumed losses {gaps} exceed {RESUME_TOL}")
    return {"rel_gaps": gaps, "max_rel_gap_after_resume": after, "resumed": resumed,
            "seconds": time.perf_counter() - t0}


# Phase 12c: cli.submit's grid of roadmap_bce (unfreeze_epoch_no 0 and 20)
# on the trainer phase's synthetic dataset, SUBMIT_STEPS steps and one
# validation batch a trial (B1 once each), over the training phase's
# BasicAE: in this process, then as concurrent trials asked for 2 at a time
# on the one card, which submit clamps to 1 (printed) and runs as a
# subprocess pinned to CUDA_VISIBLE_DEVICES=0.
SUBMIT_TRIALS, SUBMIT_STEPS = 2, 2


def submit_phase(tmp: Path, smi: str, ae_ckpt: Path) -> dict:
    """Phase 12c (see SUBMIT_TRIALS): each trial's return code, finite
    val_loss and B1 launches (in process), the clamp and the pinning."""
    tf32_line("submit")
    t_phase = time.perf_counter()
    data = tmp / "cli_data"
    if not data.exists():
        generate(str(data), scenes=CLI_SCENES, samples=CLI_SAMPLES, labeled_scenes=CLI_SCENES, seed=SEED)
    argv = ["--model", "roadmap_bce", "--link", str(data), "--samples_per_scene", str(CLI_SAMPLES),
            "--num_labeled_scenes", str(CLI_SCENES), "--pretrained_path", str(ae_ckpt), "--batch_size", str(BATCH),
            "--max_epochs", "1", "--limit_train_batches", str(SUBMIT_STEPS), "--limit_val_batches", "1",
            "--log_every_n_steps", "1", "--output_img_freq", "0", "--seed", str(SEED), "--device", "cuda",
            "--logs_save_path", str(tmp / "submit")]
    fit, trials = cli_common.fit_from_args, []

    def counted(task_cls, args):
        reset_launches()
        result = fit(task_cls, args)
        torch.cuda.synchronize()
        trials.append({"trunk_launches": trunk.launches, "raster_launches": raster.launches,
                       "best_val_loss": result.best_val_loss, "stop_reason": result.stop_reason})
        return result

    t0 = time.perf_counter()
    with mock.patch.object(cli_common, "fit_from_args", counted):
        results = cli_submit.main(argv + ["--tt_name", "grid", "--nb_hopt_trials", str(SUBMIT_TRIALS)])
    in_process_s = time.perf_counter() - t0
    expect("submit in-process trials", len(results), SUBMIT_TRIALS)
    for i, rec in enumerate(trials):
        if not np.isfinite(rec["best_val_loss"]):
            raise RuntimeError(f"submit trial {i}: val_loss {rec['best_val_loss']}")
        expect(f"submit trial {i} stop", rec["stop_reason"], None)
        expect(f"submit trial {i} (B1, B2) launches", (rec["trunk_launches"], rec["raster_launches"]),
               (SUBMIT_STEPS + 1, 0))
    print(f"submit ({smi}): {SUBMIT_TRIALS} roadmap_bce trials in process "
          f"{[r['best_val_loss'] for r in trials]} val_loss, B1 launches "
          f"{[r['trunk_launches'] for r in trials]}, {in_process_s:.1f} s", flush=True)

    said = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(said):
        fanout = cli_submit.main(argv + ["--tt_name", "fanout", "--nb_hopt_trials", "1", "--on_cluster",
                                         "--parallel_trials", "2"])
    fanout_s = time.perf_counter() - t0
    print(said.getvalue(), end="", flush=True)
    if "clamping --parallel_trials 2 -> 1" not in said.getvalue():
        raise RuntimeError("submit: --parallel_trials 2 on one card was not clamped to 1")
    expect("submit exit code", cli_submit.exit_code(fanout), 0)
    for r in fanout:
        log = Path(r["log"]).read_text()
        if r["rc"] != 0 or r["val_loss"] is None or not np.isfinite(r["val_loss"]):
            raise RuntimeError(f"submit trial {r['trial']}: rc {r['rc']}, val_loss {r['val_loss']}:\n{log[-3000:]}")
        expect(f"submit trial {r['trial']} CUDA_VISIBLE_DEVICES", r["cuda_visible_devices"], "0")
    print(f"submit ({smi}): --parallel_trials 2 clamped to 1 on this card; trial 0 as a subprocess with "
          f"CUDA_VISIBLE_DEVICES=0: rc 0, val_loss {fanout[0]['val_loss']}, {fanout[0]['seconds']} s "
          f"({fanout_s:.1f} s with the summary)", flush=True)
    out = {"in_process": trials, "in_process_s": in_process_s, "fanout": fanout, "fanout_s": fanout_s,
           "seconds": time.perf_counter() - t_phase}
    print(f"submit phase: {out['seconds']:.1f} s", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = device_line()
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    build.load_libraries(("trunk", "trunk_int8", "raster", "roialign", "roialign_bwd"))
    print(f"built trunk.cu, trunk_int8.cu, raster.cu, roialign.cu and roialign_bwd.cu in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOG.items():
        print(f"ptxas [{name}]:\n{log.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    records = kernel_phase(gen)
    int8_recs = int8_phase(gen)
    int8_variant_recs = int8_variant_phase()
    variant_recs = probe_phase()
    tf32_line("kernel phases")
    raster_rec = raster_phase()
    roialign_recs = roialign_phase(gen)
    roialign_bwd_recs = roialign_backward_phase(gen)

    build.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD) as tmp:
        ckpt = Path(tmp) / "roadmap_bce.ckpt"
        save_task_ckpt(ckpt, RoadMapBCEv2(HPARAMS, device="cuda", generator=gen))
        torch.cuda.empty_cache()
        served = serving_phase(ckpt, smi)
        boxes = box_phase(Path(tmp), smi)
        detection = detection_phase(Path(tmp), smi)
        p16 = {"roadmap": served[16], "multitask": boxes["multitask_16"],
               "faster_rcnn_rm": detection["faster_rcnn_rm_16"]}
        precision8 = precision8_phase(Path(tmp), smi, p16)
        training = training_phase(Path(tmp), smi)
        box_training = box_training_phase(training["ae_ckpt"], smi)
        det_training = det_training_phase(training["ae_ckpt"], smi)
        trainer = trainer_phase(Path(tmp), smi, training)
        decode = decode_phase(Path(tmp), smi, ckpt, training["ae_ckpt"])
        deploy = deploy_phase(Path(tmp), smi)
        mesh = mesh_phase(Path(tmp), smi, training["ae_ckpt"])
        submit = submit_phase(Path(tmp), smi, training["ae_ckpt"])

    box_names = [cls.name for cls in BOX_TRAIN_TASKS]
    box_clis = ("spatial_rm", "multitask", "bb_mlp")
    for r in records:
        precision = 32 if r["dtype"] == "float32" else 16
        if r["path"] == "roadmap":
            r["launches"] = served[precision]["launches"]
        else:
            r["launches"] = detection[f"faster_rcnn_rm_{precision}"]["predict_launches"]["trunk"]
    raster_rec["launches"] = boxes["multitask_32"]["launches"]["raster"]
    raster_rec["training_launches"] = {k: box_training[k]["launches"]["raster"] for k in box_names}
    raster_rec["cli_launches"] = {k: trainer[k]["raster_launches"] for k in box_clis}
    raster_rec["mesh_launches_per_rank"] = {name: [r["raster"] for r in mesh[name]["launches"]] for name in MESH_RASTER}
    records.append(raster_rec)
    det_names = [cls.name for cls in DET_TRAIN_TASKS]
    det_clis = ("faster_rcnn_rm", "faster_rcnn")
    for r in roialign_recs:
        precision = 32 if r["dtype"] == "float32" else 16
        r["launches"] = detection[f"faster_rcnn_rm_{precision}"]["predict_launches"]["roialign"]
        r["training_launches"] = {k: sum(det_training[k]["roialign_launches"]) for k in det_names}
        r["cli_launches"] = {k: trainer[k]["roialign_launches"]
                             for k in (det_clis if precision == 32 else ("faster_rcnn_rm_16",))}
    for r in roialign_bwd_recs:  # the detection-training path: phase 8c's faster_rcnn_rm steps
        precision = 32 if r["dtype"] == "float32" else 16
        r["launches"] = sum(det_training["faster_rcnn_rm"]["roialign_backward_launches"])
        r["launches_on"] = "faster_rcnn_rm training, 3 frozen and 2 unfrozen steps"
        r["training_launches"] = {k: det_training[k]["roialign_backward_launches"] for k in det_names}
        r["cli_launches"] = {k: trainer[k]["roialign_backward_launches"]
                             for k in (det_clis if precision == 32 else ("faster_rcnn_rm_16",))}
    for r in int8_recs:
        served8 = precision8["faster_rcnn_rm" if r["path"] == "detection" else "roadmap"]
        r["launches"] = served8["launches"]["trunk_int8"]
        r["launches_on"] = ("faster_rcnn_rm" if r["path"] == "detection" else "roadmap") + " precision-8 serving"
        if r["path"] == "roadmap":
            r["cli_launches"] = {"run_test_8": trainer["run_test_8"]["trunk_int8_launches"],
                                 "roadmap_bce_8": trainer["roadmap_bce_8"]["trunk_int8_launches"]}
    # the launches a request of the artifacts of phase 11 that run each kernel
    art = {name: rec["launches_per_request"] for name, rec in deploy["artifacts"].items()}
    for r in records:
        if r["name"] == "trunk":
            names = (("roadmap_32",) if r["dtype"] == "float32" else ("roadmap_16",)) if r["path"] == "roadmap" \
                else (("detection_32",) if r["dtype"] == "float32" else ("detection_16",))
            if r["path"] == "roadmap" and r["dtype"] == "float32":
                names += ("multitask_32", "spatial_32")
            r["artifact_launches_per_request"] = {n: art[n][0] for n in names}
    for r in int8_recs:
        if r["path"] == "roadmap":
            r["artifact_launches_per_request"] = {"roadmap_8": art["roadmap_8"][1]}
    for r in roialign_recs:
        name = "detection_32" if r["dtype"] == "float32" else "detection_16"
        r["artifact_launches_per_request"] = {name: art[name][2]}
    records += int8_recs + int8_variant_recs + roialign_recs + roialign_bwd_recs + variant_recs
    f32_path = next(r for r in records if r.get("path") == "roadmap" and r["dtype"] == "float32")
    f32_path["cli_launches"] = {k: trainer[k]["trunk_launches"]
                                for k in ("basic_ae", "roadmap_bce", "run_test", *box_clis)}
    f32_path["training_launches"] = {k: box_training[k]["launches"]["trunk"] for k in box_names}
    f32_path["mesh_launches_per_rank"] = {name: [r["trunk"] for r in mesh[name]["launches"]]
                                          for name, _, _ in MESH_RUNS}
    f32_path["submit_launches_per_trial"] = [t["trunk_launches"] for t in submit["in_process"]]
    bf16_path = next(r for r in records if r.get("path") == "roadmap" and r["dtype"] == "bfloat16")
    bf16_path["cli_launches"] = {k: trainer[k]["trunk_launches"]
                                 for k in ("roadmap_bce_16", "roadmap_bce_8", "multitask_16")}
    f32_det = next(r for r in records if r.get("path") == "detection" and r["name"] == "trunk"
                   and r["dtype"] == "float32")
    f32_det["training_launches"] = {k: sum(det_training[k]["trunk_launches"]) for k in det_names}
    f32_det["cli_launches"] = {k: trainer[k]["trunk_launches"] for k in det_clis}
    bf16_det = next(r for r in records if r.get("path") == "detection" and r["name"] == "trunk"
                    and r["dtype"] == "bfloat16")
    bf16_det["cli_launches"] = {"faster_rcnn_rm_16": trainer["faster_rcnn_rm_16"]["trunk_launches"]}
    print(json.dumps({"serving": served, "box_family": boxes, "detection": detection,
                      "precision8": precision8, "training": training, "box_training": box_training,
                      "det_training": det_training, "trainer": trainer, "decode": decode, "deploy": deploy,
                      "mesh": mesh, "submit": submit},
                     default=str))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

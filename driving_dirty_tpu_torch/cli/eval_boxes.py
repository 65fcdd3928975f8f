"""Evaluate a detection checkpoint (driving_dirty_tpu/cli/eval_boxes.py):
restore a faster_rcnn or faster_rcnn_rm checkpoint, detect on the labeled
scenes, turn the pixel AABBs back into meter-space corner boxes
(ops/coords.py:aabb_to_corners) and score the average box threat score
(metrics/threat.py:ats_bounding_boxes) against the ground truth, on the host.

    python -m driving_dirty_tpu_torch.cli.eval_boxes --ckpt_path <ckpt> \
        --link <data> [--batch_size 2] [--device cuda]

Takes the framework's .ckpt files (either package writes them). With
--precision 8 the int8 trunk's static scales are calibrated on the
loader's first batch (its road maps fused for faster_rcnn_rm) before the
timed loop.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from driving_dirty_tpu_torch.data.dataset import LABELED_SCENES, NUM_SAMPLE_PER_SCENE, LabeledDataset
from driving_dirty_tpu_torch.data.pipeline import Loader, device_prefetch
from driving_dirty_tpu_torch.export import DETECTION_TASKS, load_task_ckpt
from driving_dirty_tpu_torch.metrics.threat import ats_bounding_boxes
from driving_dirty_tpu_torch.ops.coords import aabb_to_corners


def load_detection_task(ckpt_path, precision=None, device=None):
    """Checkpoint -> a faster_rcnn or faster_rcnn_rm model on `device`
    (default cuda), for inference; a checkpoint whose meta names no task is
    a faster_rcnn_rm one."""
    return load_task_ckpt(ckpt_path, precision, classes=DETECTION_TASKS, device=device,
                          default_task="faster_rcnn_rm")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_path", required=True)
    ap.add_argument("--link", type=str, default="/scratch/ab8690/DLSP20Dataset/data")
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--samples_per_scene", type=int, default=NUM_SAMPLE_PER_SCENE)
    ap.add_argument("--num_labeled_scenes", type=int, default=len(LABELED_SCENES))
    ap.add_argument("--limit_batches", type=int, default=None)
    ap.add_argument("--score_thresh", type=float, default=0.5,
                    help="minimum detection score to count a box")
    ap.add_argument("--precision", type=int, default=None, choices=[8, 16, 32],
                    help="override checkpoint precision; 8 = the static-scale int8 trunk "
                         "(calibrated on the first batch)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    model = load_detection_task(args.ckpt_path, args.precision, args.device)
    device = next(model.parameters()).device
    ds = LabeledDataset(args.link, f"{args.link}/annotation.csv",
                        LABELED_SCENES[: args.num_labeled_scenes],
                        samples_per_scene=args.samples_per_scene, raw_uint8=True)
    loader = Loader(ds, args.batch_size, shuffle=False, num_workers=4)

    if model.int8_trunk:
        first, _ = next(iter(loader))
        road = first.get("road")
        model.calibrate_int8(torch.from_numpy(first["images"]).to(device),
                             None if road is None else torch.from_numpy(road).to(device))

    scores, n_scenes = [], 0
    t0 = time.perf_counter()
    for i, (batch, bmask) in enumerate(device_prefetch(iter(loader), device)):
        if args.limit_batches is not None and i >= args.limit_batches:
            break
        dets = model.predict(batch["images"], batch["road"])
        boxes_m = aabb_to_corners(dets["boxes"].cpu().numpy())  # [b, D, 2, 4]
        valid = (dets["valid"] & (dets["scores"] > args.score_thresh)).cpu().numpy()
        gt = batch["boxes"].cpu().numpy()
        gt_valid = batch["box_valid"].cpu().numpy()
        for j, real in enumerate(bmask.tolist()):
            if not real:
                continue
            n_scenes += 1
            gt_j = gt[j][gt_valid[j]]
            if len(gt_j) == 0:
                continue
            scores.append(float(ats_bounding_boxes(boxes_m[j][valid[j]], gt_j)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    avg = float(np.mean(scores)) if scores else 0.0
    print(f"scenes: {n_scenes}  scenes/sec: {n_scenes / dt:.3f}  avg_box_ts: {avg:.4f}")
    return {"avg_box_ts": avg, "n_scenes": n_scenes, "scenes_per_sec": n_scenes / dt if dt else 0}


if __name__ == "__main__":
    main()

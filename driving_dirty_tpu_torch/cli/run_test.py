"""Roadmap checkpoint inference (driving_dirty_tpu/cli/run_test.py): restore a
roadmap checkpoint, predict 800x800 masks for the labeled scenes (stitch ->
encoder -> head -> threshold), score the threat metric against the ground
truth, and report scenes/sec.

    python -m driving_dirty_tpu_torch.cli.run_test --rm_ckpt_path <ckpt> \
        --link <data> [--batch_size 1] [--out masks.npz] [--device cuda]

Takes the framework's .ckpt files (either package writes them). The
reference's Lightning rm.ckpt import is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import from_jax
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.data.dataset import LABELED_SCENES, NUM_SAMPLE_PER_SCENE, LabeledDataset
from driving_dirty_tpu_torch.data.pipeline import Loader, device_prefetch
from driving_dirty_tpu_torch.metrics.threat import ts_road_map
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2


def load_roadmap_model(ckpt_path, precision=None, device=None):
    """-> a RoadMapBCEv2 for inference (eval mode, no gradients) on `device`
    (default cuda) with the checkpoint's weights."""
    device = resolve_device(device)
    blob = ckpt_io.load(ckpt_path)
    if not blob["params"]:
        raise ValueError(f"{ckpt_path}: no params — not a framework checkpoint")
    hparams = dict(blob["hparams"] or {})
    hparams.setdefault("pretrained_path", None)
    if precision is not None:
        hparams["precision"] = precision
    model = RoadMapBCEv2(hparams, device=device)
    sd = from_jax(blob["params"], blob["state"])
    # a checkpoint without BN state keeps the fresh running stats, as the
    # JAX package does
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing if not k.endswith(("running_mean", "running_var"))]
    if bad or unexpected:
        raise KeyError(f"{ckpt_path}: missing {bad}, unexpected {unexpected}")
    return model.eval().requires_grad_(False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rm_ckpt_path", type=str, required=True)
    ap.add_argument("--link", type=str, default="/scratch/ab8690/DLSP20Dataset/data")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--samples_per_scene", type=int, default=NUM_SAMPLE_PER_SCENE)
    ap.add_argument("--num_labeled_scenes", type=int, default=len(LABELED_SCENES))
    ap.add_argument("--limit_batches", type=int, default=None)
    ap.add_argument("--out", type=str, default=None, help="npz path for predicted masks")
    ap.add_argument("--precision", type=int, default=None, choices=[8, 16, 32],
                    help="override checkpoint precision (8 is not ported yet)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_roadmap_model(args.rm_ckpt_path, args.precision, device)

    ds = LabeledDataset(
        args.link,
        f"{args.link}/annotation.csv",
        LABELED_SCENES[: args.num_labeled_scenes],
        samples_per_scene=args.samples_per_scene,
        raw_uint8=True,
    )
    loader = Loader(ds, args.batch_size, shuffle=False, num_workers=4)

    # warm-up outside the timed loop (kernel build and load, allocator)
    model.predict(torch.zeros((args.batch_size, 6, 256, 306, 3), device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    masks, ts_scores = [], []
    n_scenes = 0
    t0 = time.perf_counter()
    for i, (batch, bmask) in enumerate(device_prefetch(iter(loader), device)):
        if args.limit_batches is not None and i >= args.limit_batches:
            break
        pred = model.predict(batch["images"])
        for j, valid in enumerate(bmask.tolist()):
            if not valid:
                continue
            ts_scores.append(float(ts_road_map(batch["road"][j], pred[j])))
            n_scenes += 1
            if args.out:
                masks.append(pred[j].to(torch.uint8).cpu().numpy())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    sps = n_scenes / dt if dt > 0 else 0.0
    avg_ts = float(np.mean(ts_scores)) if ts_scores else float("nan")
    print(f"scenes: {n_scenes}  scenes/sec: {sps:.3f}  avg_ts: {avg_ts:.4f}")
    if args.out and masks:
        np.savez_compressed(args.out, masks=np.stack(masks))
        print(f"masks written to {args.out}")
    return {"scenes_per_sec": sps, "avg_ts": avg_ts, "n_scenes": n_scenes}


if __name__ == "__main__":
    main()

"""Export a checkpoint to a self-contained .ddx serving artifact
(driving_dirty_tpu/cli/export.py).

The artifact carries the torch.export program (the kernels as
torch.library ops), the weights and the metadata; a serving process needs
only `cli.serve` / `export.load`, on the device type it was traced for.

    python -m driving_dirty_tpu_torch.cli.export --rm_ckpt_path <ckpt> \
        --out model.ddx [--batch_size 8] [--precision 8 --calib_link <data>] [--device cuda]
    python -m driving_dirty_tpu_torch.cli.export --kind detection \
        --rm_ckpt_path fr.ckpt --out det.ddx

--device (default cuda) takes the place of the JAX CLI's --platforms.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rm_ckpt_path", required=True,
                    help="framework .ckpt or raw Lightning rm.ckpt")
    ap.add_argument("--kind", default="roadmap",
                    choices=["roadmap", "detection", "spatial", "multitask"],
                    help="roadmap: views -> 800x800 mask; detection: a "
                         "faster_rcnn[_rm] ckpt -> fixed-shape detections; "
                         "spatial: a spatial_bb/spatial_rm ckpt -> occupancy "
                         "probabilities; multitask: -> road mask + box "
                         "occupancy from one shared encoder pass")
    ap.add_argument("--out", required=True, help=".ddx artifact path")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--precision", type=int, default=None, choices=[8, 16, 32])
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the program is traced for and serves on (cuda or cpu)")
    ap.add_argument("--calib_link", default=None,
                    help="dataset root for int8 calibration (--precision 8)")
    args = ap.parse_args(argv)

    calib = None
    if args.precision == 8:
        if args.calib_link is None:
            ap.error("--precision 8 needs --calib_link for scale calibration")
        from driving_dirty_tpu_torch.data.dataset import LABELED_SCENES, LabeledDataset
        from driving_dirty_tpu_torch.data.pipeline import Loader

        ds = LabeledDataset(args.calib_link, f"{args.calib_link}/annotation.csv",
                            LABELED_SCENES[:1], samples_per_scene=args.batch_size, raw_uint8=True)
        first, _ = next(iter(Loader(ds, args.batch_size, shuffle=False, num_workers=1)))
        # the road channel too: the faster_rcnn_rm trunk input fuses it, so
        # its int8 calibration needs the same (images, road) pair
        calib = {"images": first["images"], "road": first.get("road")}

    from driving_dirty_tpu_torch import export as ddx

    kw = dict(batch_size=args.batch_size, precision=args.precision, device=args.device)
    if args.kind == "detection":
        meta = ddx.export_detection(args.rm_ckpt_path, args.out, calib=calib, **kw)
    else:
        exporter = {"spatial": ddx.export_spatial, "multitask": ddx.export_multitask,
                    "roadmap": ddx.export_roadmap}[args.kind]
        meta = exporter(args.rm_ckpt_path, args.out,
                        calib_images=None if calib is None else calib["images"], **kw)
    print(f"exported {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB "
          f"batch={meta['batch_size']} precision={meta['precision']} device={meta['device']}")
    return meta


if __name__ == "__main__":
    main()

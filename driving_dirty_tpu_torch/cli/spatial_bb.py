"""Train a spatial occupancy box model over a pretrained encoder
(driving_dirty_tpu/cli/spatial_bb.py):

    python -m driving_dirty_tpu_torch.cli.spatial_bb --variant rm \
        --link <data> --pretrained_path <basic_ae last.ckpt> [--mse_loss]

--variant: plain (spatial_bb) or rm (spatial_rm, the default: the road map
is an input branch). Every step rasterizes its targets with kernel B2 and
runs the trunk as kernel B1; the encoder trains from --unfreeze_epoch_no.
`export.load_task_ckpt` loads the checkpoint for `predict`.
"""
import argparse

from driving_dirty_tpu_torch.cli.common import run_task
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap

VARIANTS = {"plain": BBSpatialModel, "rm": BBSpatialRoadMap}


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--variant", type=str, default="rm", choices=VARIANTS)
    ns, rest = pre.parse_known_args(argv)
    return run_task(VARIANTS[ns.variant], rest)


if __name__ == "__main__":
    main()

"""Train the coordinate-regression MLP box model over a pretrained encoder
(driving_dirty_tpu/cli/bb_mlp.py):

    python -m driving_dirty_tpu_torch.cli.bb_mlp --link <data> \
        --pretrained_path <basic_ae last.ckpt>

Each step runs the trunk as kernel B1; the targets are the padded boxes
themselves, so no raster is made.
"""
from driving_dirty_tpu_torch.cli.common import run_task
from driving_dirty_tpu_torch.models.bb_mlp import Boxes


def main(argv=None):
    return run_task(Boxes, argv)


if __name__ == "__main__":
    main()

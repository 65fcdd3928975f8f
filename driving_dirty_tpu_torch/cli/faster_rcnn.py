"""Train a Faster-RCNN box model over a pretrained encoder
(driving_dirty_tpu/cli/faster_rcnn.py):

    python -m driving_dirty_tpu_torch.cli.faster_rcnn --variant rm \
        --link <data> --pretrained_path <basic_ae last.ckpt> --max_epochs 10

--variant: plain (faster_rcnn) or rm (faster_rcnn_rm, the default: the road
map is fused into the trunk's input). Every step runs the trunk as kernel
B1 and RoIAlign as kernel B3, and B3-bwd wherever the pooled features need
a gradient (every rm step; plain steps once the encoder trains, from
--unfreeze_epoch_no). `cli.eval_boxes` and `export.load_task_ckpt` load the
checkpoint for `predict`.
"""
import argparse

from driving_dirty_tpu_torch.cli.common import run_task
from driving_dirty_tpu_torch.models.faster_rcnn import BBFasterRCNN, FasterRCNNRoadMap

VARIANTS = {"plain": BBFasterRCNN, "rm": FasterRCNNRoadMap}


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--variant", type=str, default="rm", choices=VARIANTS)
    ns, rest = pre.parse_known_args(argv)
    return run_task(VARIANTS[ns.variant], rest)


if __name__ == "__main__":
    main()

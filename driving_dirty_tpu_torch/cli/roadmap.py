"""Fine-tune a roadmap model over a pretrained encoder
(driving_dirty_tpu/cli/roadmap.py):

    python -m driving_dirty_tpu_torch.cli.roadmap --variant bce_v2 \
        --link <data> --pretrained_path <basic_ae last.ckpt> --max_epochs 20

--variant: mse (roadmap_mse), bce_v1 (roadmap_bce_v1) or bce_v2
(roadmap_bce, the default). `cli.run_test --rm_ckpt_path` scores the
checkpoint.
"""
import argparse

from driving_dirty_tpu_torch.cli.common import run_task
from driving_dirty_tpu_torch.models.roadmap import RoadMap, RoadMapBCE, RoadMapBCEv2

VARIANTS = {"mse": RoadMap, "bce_v1": RoadMapBCE, "bce_v2": RoadMapBCEv2}


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--variant", type=str, default="bce_v2", choices=VARIANTS)
    ns, rest = pre.parse_known_args(argv)
    return run_task(VARIANTS[ns.variant], rest)


if __name__ == "__main__":
    main()

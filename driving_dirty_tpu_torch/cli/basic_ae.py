"""Pretrain the six-to-one autoencoder (driving_dirty_tpu/cli/basic_ae.py):

    python -m driving_dirty_tpu_torch.cli.basic_ae --link <data> \
        --max_epochs 5 --batch_size 32 [--device cuda]

Checkpoints go to <default_root_dir>/basic_ae/version_N/{last,best}.ckpt,
with basic_ae/last.ckpt linking the newest; `cli.roadmap --pretrained_path`
takes one.
"""
from driving_dirty_tpu_torch.cli.common import run_task
from driving_dirty_tpu_torch.models.basic_ae import BasicAE


def main(argv=None):
    return run_task(BasicAE, argv)


if __name__ == "__main__":
    main()

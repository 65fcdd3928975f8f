"""Train the joint roadmap + box-occupancy model (BASELINE config 5) over a
pretrained encoder (driving_dirty_tpu/cli/multitask.py):

    python -m driving_dirty_tpu_torch.cli.multitask --link <data> \
        --pretrained_path <basic_ae last.ckpt> [--box_loss_weight 1.0]

One encoder pass a step (kernel B1) feeds both heads; kernel B2 rasterizes
the box targets. `export.load_task_ckpt` loads the checkpoint for
`predict`. `--gpus 8 --model_parallel 2`, as in the JAX package, trains
on a (4, 2) mesh: rm_head and the encoder's fc1 cut over 'model'
(cli/common.py, train/trainer.py).
"""
from driving_dirty_tpu_torch.cli.common import run_task
from driving_dirty_tpu_torch.models.multitask import MultiTask


def main(argv=None):
    return run_task(MultiTask, argv)


if __name__ == "__main__":
    main()

"""Shared CLI machinery (driving_dirty_tpu/cli/common.py): the trainer flags
of the reference's Lightning 0.7.5 scripts and the per-model runner.

Every flag of the JAX package's parser is accepted, with these meanings
here:

  --gpus N        N ranks on this node (one process each). None or 1 trains
                  in this process; more spawns N ranks
                  (parallel/launch.py), each running this entry point with
                  its rank, and returns rank 0's FitResult without its
                  task. Under a launcher (torchrun: WORLD_SIZE, RANK,
                  LOCAL_RANK) the process joins the launcher's world.
  --num_nodes N   N nodes, found through DD_COORDINATOR_ADDRESS,
                  DD_NUM_PROCESSES and DD_PROCESS_ID as the JAX package
                  finds them (parallel/mesh.py:node_rendezvous); each node
                  spawns its --gpus ranks.
  --model_parallel M   the 'model' axis of the (data, model) mesh over the
                  world's ranks: the task's sharding rules cut its large
                  Linear layers (roadmap, multitask) or its heads' conv
                  channels (spatial_bb, spatial_rm) over M ranks
                  (train/trainer.py).
  --device        where to train: cuda (the default) or cpu. There is no
                  fallback: without a card, cuda raises. Ranks of cuda take
                  cuda:LOCAL_RANK and NCCL (the card must exist); cuda:K
                  puts every rank on card K, over gloo, as asked.
  --remat         accepted; the port's trunk always recomputes in its
                  backward (kernels/trunk.py:trunk_vjp).
  --distributed_backend   accepted and ignored, as in the JAX package.
  --precision 8   trains in bf16, as 16 does (int8 is inference-only);
                  validation runs the trunk in bf16 after a one-time
                  message, since the trainer never calibrates the int8
                  scales (as in the JAX package).

The JAX package's XLA compilation cache and platform-environment handling
have no counterpart here.
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import sys

import numpy as np
import torch
import torch.distributed as dist

from driving_dirty_tpu_torch.parallel import launch
from driving_dirty_tpu_torch.parallel import mesh as mesh_lib
from driving_dirty_tpu_torch.train.trainer import Trainer

REFERENCE_SEED = 20200505  # every reference entry point seeds with this


def add_trainer_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    g = parser.add_argument_group("trainer")
    g.add_argument("--max_epochs", type=int, default=1000)
    g.add_argument("--max_steps", type=int, default=None,
                   help="stop (with a resumable checkpoint) after N optimizer steps")
    g.add_argument("--gpus", type=int, default=None,
                   help="ranks on this node, one process each (more than 1 spawns them)")
    g.add_argument("--num_nodes", type=int, default=1)
    g.add_argument("--model_parallel", type=int, default=1,
                   help="size of the 'model' mesh axis (tensor parallelism of the task's "
                        "sharding rules)")
    g.add_argument("--precision", type=int, default=32, choices=[8, 16, 32],
                   help="16 -> bfloat16 compute where supported; 8 -> bfloat16 training "
                        "and the int8 trunk at calibrated inference")
    g.add_argument("--resume_from_checkpoint", type=str, default=None)
    g.add_argument("--default_root_dir", type=str, default="logs")
    g.add_argument("--version", type=int, default=None,
                   help="pin the experiment version (writes into <root>/<task>/version_N); "
                        "default: the next free version. A resumed run keeps its "
                        "checkpoint's version.")
    g.add_argument("--limit_train_batches", type=int, default=None)
    g.add_argument("--limit_val_batches", type=int, default=None)
    g.add_argument("--log_every_n_steps", type=int, default=50)
    g.add_argument("--seed", type=int, default=REFERENCE_SEED)
    g.add_argument("--profile_dir", type=str, default=None)
    g.add_argument("--checkpoint_every_n_steps", type=int, default=None)
    g.add_argument("--walltime_minutes", type=float, default=None,
                   help="stop with a resumable checkpoint ~5 min before this budget "
                        "(test-tube's minutes_to_checkpoint_before_walltime)")
    g.add_argument("--debug", action="store_true",
                   help="raise on the first non-finite loss or gradient")
    g.add_argument("--gradient_clip_val", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    g.add_argument("--accumulate_grad_batches", type=int, default=1,
                   help="optimizer step every N batches (effective batch = N * batch_size)")
    g.add_argument("--distributed_backend", type=str, default=None,
                   help="accepted for reference-script compatibility and ignored")
    g.add_argument("--num_workers", type=int, default=None,
                   help="decode pool threads (default: min(48, 4*cpus); the reference hardcoded 4)")
    g.add_argument("--uint8_pipeline", type=int, default=1, choices=[0, 1],
                   help="ship camera images to the device as raw uint8 and normalize there; "
                        "0 = host-side float32 /255")
    g.add_argument("--remat", type=int, default=None, choices=[0, 1],
                   help="accepted; the trunk always recomputes in its backward")
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    return parser


def trainer_from_args(args) -> Trainer:
    """A Trainer over the world this process joined (a mesh of its ranks and
    --model_parallel), or over one device."""
    return Trainer(
        num_devices=dist.get_world_size() if dist.is_initialized() else None,
        model_parallel=getattr(args, "model_parallel", 1),
        max_epochs=args.max_epochs,
        default_root_dir=args.default_root_dir,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        log_every_n_steps=args.log_every_n_steps,
        seed=args.seed,
        profile_dir=args.profile_dir,
        debug_nans=getattr(args, "debug", False),
        checkpoint_every_n_steps=getattr(args, "checkpoint_every_n_steps", None),
        max_steps=getattr(args, "max_steps", None),
        walltime_minutes=getattr(args, "walltime_minutes", None),
        gradient_clip_val=getattr(args, "gradient_clip_val", 0.0),
        accumulate_grad_batches=getattr(args, "accumulate_grad_batches", 1),
        version=getattr(args, "version", None),
        device=getattr(args, "device", None),
    )


def _rank_run(task_cls, args):
    """One spawned rank of `fit_from_args` -> its FitResult without the task."""
    return dataclasses.replace(fit_from_args(task_cls, args), task=None)


def run_task(task_cls, argv=None, description=None):
    """A per-model entry point: parser = trainer flags + the model's flags,
    then `fit_from_args`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=description or task_cls.__name__)
    parser = add_trainer_args(parser)
    parser = task_cls.add_model_specific_args(parser)
    return fit_from_args(task_cls, parser.parse_args(argv))


def fit_from_args(task_cls, args):
    """Seed random and numpy, build the task on the device from a generator
    seeded with --seed (alike on every rank), fit. With --gpus > 1 or
    --num_nodes > 1 and no launcher, this process spawns the node's ranks,
    which run this function on the same `args`, and returns rank 0's
    FitResult (task None). cli/submit.py runs each trial through here."""
    gpus = args.gpus or 1
    if not dist.is_initialized() and not mesh_lib.launched() and (gpus > 1 or args.num_nodes > 1):
        nodes = mesh_lib.node_rendezvous(args.num_nodes)
        init, world, first = (None, gpus, 0) if nodes is None else (nodes[0], nodes[1] * gpus, nodes[2] * gpus)
        return launch.spawn(_rank_run, gpus, (task_cls, args), device=args.device,
                            init_method=init, world=world, first_rank=first)[0]
    mesh_lib.initialize_distributed(args.num_nodes, device=args.device)  # a launcher's world
    random.seed(args.seed)
    np.random.seed(args.seed)
    trainer = trainer_from_args(args)
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(args.seed)
    task = task_cls(args, device=trainer.device, generator=gen)
    return trainer.fit(task, resume_from=args.resume_from_checkpoint)

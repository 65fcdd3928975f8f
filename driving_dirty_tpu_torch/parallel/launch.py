"""Starting the ranks of a world on one host (torch.multiprocessing, spawn).

`spawn(fn, nprocs, args)` starts `nprocs` processes; each joins the world
(parallel/mesh.py:join) through a file rendezvous in a new temporary
directory, runs `fn(*args)` and leaves the world. It returns every rank's
value in rank order; a rank that raises fails the call, and the others are
stopped. `fn` must be importable by the new processes (a module-level
function). The CLIs (cli/common.py:run_task) spawn their `--gpus` ranks
here, the tests and chip_smoke.py theirs.

For ranks of several nodes, `world`, `first_rank` and `init_method` place
this node's ranks in the larger world (the coordinator's rendezvous).

`fit_worker(spec)` is a rank's body for training a task on batches held in
memory (`MemoryLoader`) through train/trainer.py, in one process or on
every rank of a spawned world alike: the tests and chip_smoke.py hold a
data x model run against the one-process run with it.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.parallel import mesh as mesh_lib


def _rank_main(local_rank, fn, args, device, init_method, world, first_rank, out, threads):
    if threads:
        torch.set_num_threads(threads)
    rank = first_rank + local_rank
    mesh_lib.join(init_method, world, rank, local_rank, device)
    value = fn(*args)  # a rank that raises ends here; the parent stops the others
    with open(os.path.join(out, f"rank{local_rank}.pkl"), "wb") as f:
        pickle.dump(value, f)
    dist.barrier()  # every rank done with its collectives before any leaves the group
    dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), *, device=None, threads: int | None = None,
          init_method: str | None = None, world: int | None = None, first_rank: int = 0) -> list:
    """Run `fn(*args)` on `nprocs` new ranks on `device` (None or "cuda": a
    card per rank, and no card raises; one named card for all; "cpu") ->
    their return values in rank order. `threads`: torch's intra-op threads a
    rank (default on the CPU: this process's CPUs shared out, at least one)."""
    device = resolve_device(device)
    if threads is None and device.type == "cpu":
        threads = max(1, len(os.sched_getaffinity(0)) // nprocs)
    out = tempfile.mkdtemp(prefix="dd_ranks_")
    try:
        init = init_method or f"file://{os.path.join(out, 'rdzv')}"
        mp.start_processes(_rank_main, nprocs=nprocs, start_method="spawn", join=True,
                           args=(fn, tuple(args), str(device), init, world or nprocs, first_rank, out,
                                 threads))
        values = []
        for r in range(nprocs):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                values.append(pickle.load(f))
        return values
    finally:
        shutil.rmtree(out, ignore_errors=True)


class MemoryLoader:
    """Global batches ({name: array}) held in memory, yielded in their
    order as data/pipeline.py:Loader yields them: (batch, mask of its valid
    rows, all True); a resumed epoch skips the batches it consumed, and
    `shard` splits them over the data ranks as Loader.shard does."""

    def __init__(self, batches):
        self.batches = list(batches)
        self._skip = 0
        self._shard = None

    def set_epoch(self, epoch: int, base_seed: int | None = None, skip_batches: int = 0):
        self._skip = int(skip_batches)

    def shard(self, rank: int, size: int, whole_batches: bool = False):
        """Data-parallel rank `rank` of `size`: its rows of every batch (the
        batch size must divide by `size`), or with `whole_batches` the
        batches rank, rank + size, ... whole."""
        n = len(next(iter(self.batches[0].values()))) if self.batches else 0
        if size > 1 and not whole_batches and n % size:
            raise ValueError(f"a global batch of {n} does not divide over {size} data-parallel ranks")
        self._shard = (int(rank), int(size), bool(whole_batches)) if size > 1 else None

    def __iter__(self):
        skip, self._skip = self._skip, 0
        batches, rows = self.batches[skip:], slice(None)
        if self._shard is not None:
            rank, size, whole = self._shard
            if whole:
                batches = batches[rank::size]
            else:
                k = len(next(iter(batches[0].values()))) // size if batches else 0
                rows = slice(rank * k, (rank + 1) * k)
        for b in batches:
            b = {name: v[rows] for name, v in b.items()}
            yield b, np.ones(len(next(iter(b.values()))), bool)


def _launch_counts() -> dict:
    from driving_dirty_tpu_torch.kernels.raster import raster
    from driving_dirty_tpu_torch.kernels.roialign import roialign, roialign_backward
    from driving_dirty_tpu_torch.kernels.trunk import trunk

    return {"trunk": trunk.launches, "raster": raster.launches, "roialign": roialign.launches,
            "roialign_backward": roialign_backward.launches}


def fit_worker(spec: dict) -> dict:
    """Train one task on this rank (or alone) as `spec` says -> what the
    fit gave and measured here.

    spec: "task" (a task class), "hparams", "seed" (of the generator the
    task is built from, alike on every rank), "drop_p" (None, or the
    DenseBlocks' dropout rate), "batches" (global
    training batches; validation takes "val_batches", default the same),
    "model_parallel" (the mesh's 'model' axis over this world), "trainer"
    (Trainer keyword arguments), "resume" (a checkpoint path or None),
    "state" (return the whole state_dict after the fit), "time_reduce"
    (time the gradient sums), "device" (when alone, default CUDA, which
    raises without a card; a rank takes its own).

    -> best_val_loss, last_ckpt_path, stop_reason, scenes_per_sec,
    launches (each kernel's launches during the fit), grad_reduce (calls,
    bytes, the ms of each call when timed), tp_comm (the 'model'-axis
    gathers and sums of activations, and the means of the replicated
    gradients: calls, bytes, ms in all when timed), fit_s, peak_memory_gb
    (on a card), shard_shapes, the rank's coordinates, the mesh's backend, and
    "state" when asked."""
    from driving_dirty_tpu_torch.nn.autoencoder import DenseBlock
    from driving_dirty_tpu_torch.parallel.collectives import GRAD_REDUCE, TP_COMM, TP_KINDS, reset_tp_comm
    from driving_dirty_tpu_torch.train.trainer import Trainer

    device = mesh_lib.current_device() or resolve_device(spec.get("device"))
    gen = torch.Generator(device=device).manual_seed(int(spec.get("seed", 0)))
    task = spec["task"](spec["hparams"], device=device, generator=gen)
    if spec.get("drop_p") is not None:
        for m in task.modules():
            if isinstance(m, DenseBlock):
                m.drop_p = spec["drop_p"]
    if spec.get("batches") is not None:
        train, val = spec["batches"], spec.get("val_batches") or spec["batches"]
        task.train_loader = lambda: MemoryLoader(train)
        task.val_loader = lambda: MemoryLoader(val)
    world = dist.get_world_size() if dist.is_initialized() else None
    trainer = Trainer(num_devices=world, model_parallel=spec.get("model_parallel", 1), device=device,
                      **spec.get("trainer", {}))
    GRAD_REDUCE.update(calls=0, bytes=0, ms=[], timed=bool(spec.get("time_reduce")))
    reset_tp_comm(timed=bool(spec.get("time_reduce")))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    t0 = time.perf_counter()
    result = trainer.fit(task, resume_from=spec.get("resume"))
    fit_s = time.perf_counter() - t0
    after = _launch_counts()
    mesh = trainer.mesh
    out = {"best_val_loss": result.best_val_loss, "last_ckpt_path": result.last_ckpt_path,
           "stop_reason": result.stop_reason, "scenes_per_sec": result.scenes_per_sec,
           "launches": {k: after[k] - before[k] for k in after}, "fit_s": fit_s,
           "grad_reduce": {k: GRAD_REDUCE[k] for k in ("calls", "bytes", "ms")},
           "tp_comm": {k: dict(TP_COMM[k]) for k in TP_KINDS},
           "shard_shapes": trainer.shard_shapes,
           "rank": (mesh.rank, mesh.dp_rank, mesh.tp_rank) if mesh is not None else (0, 0, 0),
           "backend": mesh.backend if mesh is not None else None}
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if spec.get("state"):
        out["state"] = {k: v.detach().cpu() for k, v in result.task.state_dict().items()}
    return out

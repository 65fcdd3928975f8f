"""driving_dirty_tpu_torch's multi-device pieces on the CPU, over gloo
(parallel/mesh.py, parallel/collectives.py, parallel/launch.py):

  * (i) every training loss under dp=2 against the same global batch in
    one process: basic_ae (BatchNorm, dropout and the six-to-one mask on),
    roadmap_mse, roadmap_bce, spatial_bb, bb_mlp, multitask and
    faster_rcnn_rm (the sampler noise and the roi_loss normalizer), each
    rank on its rows of the batch inside a data-parallel step, the losses
    and the gradients summed over the ranks. Losses rtol 1e-5; BatchNorm's
    running statistics rtol 1e-5, atol 1e-6 (means near 0); gradients by
    relative L2 error per parameter, GRAD_TOL 1e-3 where no training-mode
    BatchNorm lies on the way back (the one process sums the batch in one
    order, the two ranks in halves; measured up to 1.0e-4, basic_ae's
    dc1, whose input is a BatchNorm's output), BN_GRAD_TOL 2e-2 where one
    does: at
    batch 8 its backward, g - mean(g) - xhat mean(g xhat), cancels digits
    that the two sum orders round differently (measured up to 6e-3;
    tests/test_torch_port_box_training.py allows 2.9e-2 between XLA and
    ATen at batch 4). In float64 the same basic_ae step's gradients and
    statistics agree to 1e-10, so these gaps are rounding. The biases ahead of a
    training-mode BatchNorm have a true gradient of 0 and are held within
    1e-6 of the global gradient norm. One BatchNorm layer alone:
    its output rows, the input's gradient rows and the weight's summed
    gradient rtol 1e-5, and the dropout mask's rows equal the one-process
    draw's;
  * (ii) a Linear layer cut column-parallel and row-parallel over tp=2
    (parallel/mesh.py:shard_module): output, input gradient and the
    gathered weight gradient against the whole layer, rtol 1e-5; the
    roadmap, multitask, spatial_bb and spatial_rm rules map to the port's
    layouts (a spatial head's conv weight cut on dim 0, its transposed conv
    weight on dim 1, their biases, the 1-channel last stage whole);
  * (vii) two "nodes" joined through DD_COORDINATOR_ADDRESS /
    DD_NUM_PROCESSES / DD_PROCESS_ID, as tests/test_multihost.py runs the
    JAX package: each takes its rows of a global batch and a sum over both
    gives the global sum;
  * (viii) spatial_bb trains under model_parallel 2 (its heads
    channel-parallel) for max_steps 2 and writes the one-process
    checkpoint; and a preemption signal on one rank stops every rank at
    the same step with a checkpoint.

Ranks are processes started by parallel/launch.py:spawn with one torch
thread each; they meet through a file in the test's temporary directory.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import os
import signal
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.data.pipeline import Loader
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.models.basic_ae import BasicAE
from driving_dirty_tpu_torch.models.bb_mlp import Boxes
from driving_dirty_tpu_torch.models.faster_rcnn import FasterRCNNRoadMap
from driving_dirty_tpu_torch.models.multitask import MultiTask
from driving_dirty_tpu_torch.models.roadmap import RoadMap, RoadMapBCEv2
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap
from driving_dirty_tpu_torch.ops.coords import aabb_to_corners
from driving_dirty_tpu_torch.parallel import collectives as C
from driving_dirty_tpu_torch.parallel import launch
from driving_dirty_tpu_torch.parallel import mesh as mesh_lib
from driving_dirty_tpu_torch.parallel.launch import MemoryLoader
from driving_dirty_tpu_torch.train.task import Task
from driving_dirty_tpu_torch.train.trainer import Trainer

RTOL = 1e-5
STATS_ATOL = 1e-6  # running means near 0 of features of order 1
GRAD_TOL = 1e-3
BN_GRAD_TOL = 2e-2
# the parameters each task's training-mode BatchNorm layers reach in the backward
BN_REACHED = {"basic_ae": ("encoder.", "decoder.fc"), "roadmap_mse": ("",), "roadmap_bce": ("",),
              "bb_mlp": ("",), "multitask": ("encoder.", "rm_head.")}
F64_RTOL = 1e-10
# biases whose true gradient a training-mode BatchNorm makes 0 (basic_ae's
# latent bias too: the decoder's first BatchNorm takes out its shift)
NOISE = ("encoder.fc1.fc.bias", "encoder.fc2.fc.bias")
AE_NOISE = NOISE + ("encoder.fc_z_out.bias", "decoder.fc1.fc.bias", "decoder.fc2.fc.bias")
B = 8
ROAD = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=32, pretrained_path=None, batch_size=B)
SMALL = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78,
             pretrained_path=None, batch_size=B, spatial_geometry="small")
DET = dict(batch_size=B, pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, max_bb=8, image_size=128,
           rpn_pre_nms_top_n=200, rpn_post_nms_top_n=64, box_batch_per_image=32, exact_topk=True)


def spawn(tmp_path, fn, *args, n=2):
    return launch.spawn(fn, n, args, device="cpu", threads=1, init_method=f"file://{tmp_path}/rdzv")


def _views(rng, h, w):
    return rng.randint(0, 256, (B, 6, h, w, 3)).astype(np.uint8)


def _det_batch(rng):
    lo = rng.uniform(0, 80, (B, 8, 2))
    aabb = np.concatenate([lo, lo + rng.uniform(16, 48, (B, 8, 2))], -1).astype(np.float32)
    valid = np.zeros((B, 8), bool)
    valid[:, :6] = True
    valid[-1, 4:] = False
    return {"images": _views(rng, 64, 76), "road": (rng.rand(B, 128, 128) > 0.5).astype(np.float32),
            "boxes": aabb_to_corners(aabb).astype(np.float32), "box_valid": valid,
            "categories": np.where(valid, rng.randint(0, 9, (B, 8)), -1).astype(np.int32)}


def cases():
    """(name, task class, hparams, global batch) of every loss."""
    rng = np.random.RandomState(0)
    road = lambda: (rng.rand(B, 800, 800) > 0.5).astype(np.float32)  # noqa: E731
    boxes, valid = box_scenes(3, B, 100)
    small = {"images": _views(rng, 64, 78), "road": road(), "boxes": boxes, "box_valid": valid}
    return [("basic_ae", BasicAE, dict(hidden_dim=16, latent_dim=8, input_height=16, output_height=16,
                                       batch_size=B), {"images": _views(rng, 16, 306)}),
            ("roadmap_mse", RoadMap, ROAD, {"images": _views(rng, 32, 306), "road": road()}),
            ("roadmap_bce", RoadMapBCEv2, ROAD, {"images": _views(rng, 32, 306), "road": road()}),
            ("spatial_bb", BBSpatialModel, SMALL, small),
            ("bb_mlp", Boxes, dict(SMALL, max_bb=100), small),
            ("multitask", MultiTask, SMALL, small),
            ("faster_rcnn_rm", FasterRCNNRoadMap, DET, _det_batch(rng))]


def rows_of(mesh, n):
    """This data rank's rows of a global batch of n."""
    k = n // mesh.data
    return slice(mesh.dp_rank * k, (mesh.dp_rank + 1) * k)


def loss_and_grads(case, mesh=None):
    """One training-mode loss and backward of the case's task (built from
    seed 0, its draws from a generator of seed 3) on the global batch, or
    on this rank's rows in a data-parallel step with the loss and the
    gradients summed over 'data' -> (loss, {name: grad}, {BN buffer: value})."""
    _, cls, hparams, batch = case
    task = cls(hparams, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    if mesh is not None:
        batch = {k: v[rows_of(mesh, len(v))] for k, v in batch.items()}
    with mesh_lib.data_parallel_step(mesh):
        loss, _ = task.loss({k: torch.from_numpy(v) for k, v in batch.items()}, train=True, generator=gen)
        loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in task.named_parameters() if p.grad is not None}
    loss = loss.detach()
    if mesh is not None:
        C.all_reduce_grads([grads[n] for n in sorted(grads)], mesh.dp_group)
        dist.all_reduce(loss, group=mesh.dp_group)
    stats = {k: v.clone() for k, v in task.state_dict().items() if "running" in k}
    return float(loss), grads, stats


def batchnorm_and_dropout(mesh=None):
    """A BatchNorm layer's output, its input's gradient and its summed
    weight gradient under a seeded upstream gradient, and a dropout draw,
    on the global batch of 8 or on this rank's rows."""
    rng = np.random.RandomState(1)
    x, g = (rng.randn(8, 6).astype(np.float32) * 3 + 1 for _ in range(2))
    rows = slice(None) if mesh is None else rows_of(mesh, 8)
    bn = L.BatchNorm(6, device="cpu")
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    with mesh_lib.data_parallel_step(mesh):
        y = bn(xt)
        (y * torch.from_numpy(g[rows])).sum().backward()
        mask = L.dropout(torch.ones(xt.shape), 0.5, True, torch.Generator().manual_seed(4))
    w_grad = bn.weight.grad.clone()
    if mesh is not None:
        dist.all_reduce(w_grad, group=mesh.dp_group)
    return {"y": y.detach(), "x_grad": xt.grad, "w_grad": w_grad, "running_var": bn.running_var.clone(),
            "mask": mask}


def f64_loss_and_grads(mesh=None):
    """basic_ae's case with its weights, activations and BatchNorm
    statistics in float64."""
    import driving_dirty_tpu_torch.models.basic_ae as BA

    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with mock.patch.object(BA, "compute_dtype", lambda precision: torch.float64):
            return loss_and_grads(cases()[0], mesh)
    finally:
        torch.set_default_dtype(prev)


def one_process():
    return batchnorm_and_dropout(), [loss_and_grads(case) for case in cases()], f64_loss_and_grads()


def rank_main(root):
    """A rank's part of every test of this file (one world for them all)."""
    mesh = mesh_lib.build_mesh()
    dp = (batchnorm_and_dropout(mesh), [loss_and_grads(case, mesh) for case in cases()],
          f64_loss_and_grads(mesh))
    return dp, tp_rank(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the one-process results, each rank's results), the one process
    computed while the ranks run."""
    d = tmp_path_factory.mktemp("mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn, d, rank_main, str(d))
            one = one_process()
            return one, ranks.result()


@pytest.fixture(scope="module")
def dp_runs(runs):
    one, ranks = runs
    return one, [dp for dp, _ in ranks]


@pytest.fixture(scope="module")
def tp_runs(runs):
    return [tp for _, tp in runs[1]]


@pytest.mark.parametrize("i,name", list(enumerate(c[0] for c in cases())))
def test_each_loss_under_dp2_is_the_global_batch_loss(dp_runs, i, name):
    (_, ref, _), ranks = dp_runs
    loss, grads, stats = ref[i]
    for rank in ranks:
        r_loss, r_grads, r_stats = rank[1][i]
        np.testing.assert_allclose(r_loss, loss, rtol=RTOL, err_msg=name)
        for k, v in stats.items():
            np.testing.assert_allclose(r_stats[k], v, rtol=RTOL, atol=STATS_ATOL, err_msg=f"{name} {k}")
        hold_grads(name, r_grads, grads, GRAD_TOL, BN_GRAD_TOL, 1e-6)


def hold_grads(name, got, ref, tol, bn_tol, noise):
    assert sorted(got) == sorted(ref)
    norm = float(torch.sqrt(sum(g.square().sum() for g in ref.values())))
    for n, g in ref.items():
        if n in (AE_NOISE if name == "basic_ae" else NOISE):
            assert float(got[n].abs().max()) <= noise * norm, (name, n)
            continue
        err = float((got[n] - g).norm() / g.norm().clamp(min=1e-30))
        reached = n.startswith(BN_REACHED.get(name, ()))
        assert err <= (bn_tol if reached else tol), (name, n, err)


def test_float64_makes_dp2_equal_to_one_process(dp_runs):
    """The float32 gaps are rounding: in float64 the dp=2 step's gradients
    and BatchNorm statistics agree with the one-process step's to 1e-10.
    BasicAE's loss itself is an f32 mean (models/basic_ae.py), summed in
    an order that follows torch's thread count: rtol 1e-6."""
    (_, _, (loss, grads, stats)), ranks = dp_runs
    for rank in ranks:
        r_loss, r_grads, r_stats = rank[2]
        assert r_grads["encoder.c1.weight"].dtype == torch.float64
        np.testing.assert_allclose(r_loss, loss, rtol=1e-6)
        for k, v in stats.items():
            np.testing.assert_allclose(r_stats[k], v, rtol=F64_RTOL, atol=1e-15, err_msg=k)
        hold_grads("basic_ae", r_grads, grads, F64_RTOL, F64_RTOL, 1e-12)


def test_batchnorm_and_dropout_take_the_global_batch(dp_runs):
    (ref, _, _), ranks = dp_runs
    for r, rank in enumerate(ranks):
        got = rank[0]
        rows = slice(4 * r, 4 * r + 4)
        for k in ("y", "x_grad", "mask"):
            np.testing.assert_allclose(got[k], ref[k][rows], rtol=RTOL, atol=1e-6, err_msg=k)
        for k in ("w_grad", "running_var"):
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
    assert torch.equal(torch.cat([rank[0]["mask"] for rank in ranks]), ref["mask"])


# ----------------------------------------------------------------------------
# tensor parallelism, and what the trainer refuses or agrees on


class _Holder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = L.Linear(12, 10, device="cpu", generator=torch.Generator().manual_seed(5))


def parallel_linear(mode, mesh=None):
    """y = fc(x) for x [3, 12] and loss sum(y * g) -> (y, x's gradient,
    the weight's and the bias's gradients, whole)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 12).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(3, 10).astype(np.float32))
    m = _Holder()
    specs = {}
    if mesh is not None:
        specs = {"fc.weight": (0, "model"), "fc.bias": (0, "model")} if mode == "column" \
            else {"fc.weight": (1, "model")}
        mesh_lib.shard_module(m, mesh, specs)
        assert m.fc.tp[0] == mode
    y = m.fc(x)
    (y * g).sum().backward()
    wg, bg = m.fc.weight.grad, m.fc.bias.grad
    if mesh is not None:
        wg = C.gather_shard(mesh, wg, specs["fc.weight"])
        if "fc.bias" in specs:
            bg = C.gather_shard(mesh, bg, specs["fc.bias"])
    return y.detach(), x.grad, wg, bg


class StopToy(Task, torch.nn.Module):
    """y = w . x on 8 items of batch 2 a step; rank 1 sends itself SIGTERM
    in its second step."""

    name = "stop_toy"

    def __init__(self):
        torch.nn.Module.__init__(self)
        Task.__init__(self, {"learning_rate": 1e-2})
        torch.manual_seed(0)
        self.w = torch.nn.Linear(3, 1)
        self.calls = 0

    def loss(self, batch, *, train, generator=None):
        self.calls += 1
        if train and self.calls == 2 and dist.get_rank() == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return C.batch_mean(self.w(batch["x"]) ** 2), {}

    def train_loader(self):
        x = np.arange(24, dtype=np.float32).reshape(4, 2, 3) / 10
        return MemoryLoader([{"x": v} for v in x])

    def val_loader(self):
        raise NotImplementedError


def tp_rank(root):
    mesh = mesh_lib.build_mesh(model_parallel=2)
    out = {mode: parallel_linear(mode, mesh) for mode in ("column", "row")}
    spatial = BBSpatialModel(SMALL, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = cases()[3][3]
    spatial.train_loader = lambda: MemoryLoader([batch] * 3)
    trainer = Trainer(num_devices=2, model_parallel=2, max_steps=2, limit_val_batches=0, device="cpu",
                      enable_progress_bar=False, default_root_dir=os.path.join(root, "spatial"))
    r = trainer.fit(spatial)
    out["spatial"] = (r.stop_reason, r.last_ckpt_path, trainer.shard_shapes)
    r = Trainer(num_devices=2, max_epochs=3, device="cpu", enable_progress_bar=False,
                default_root_dir=os.path.join(root, "stop")).fit(StopToy())
    out["stop"] = (r.stop_reason, r.last_ckpt_path)
    return out


@pytest.mark.parametrize("mode", ["column", "row"])
def test_parallel_linear_matches_the_whole_layer(tp_runs, mode):
    ref = parallel_linear(mode)
    for rank in tp_runs:
        for name, got, want in zip(("y", "x_grad", "w_grad", "b_grad"), rank[mode], ref):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=f"{mode} {name}")


def spatial_specs(rm: bool) -> dict:
    """The cuts of the JAX rules on a spatial head's port layouts: every conv
    with 8k output channels on dim 0 (OIHW), every transposed conv on dim 1
    ([in, out, kh, kw]), their biases on dim 0; the last stage whole."""
    convs = [f"space_map_cnn.{v}_conv" for v in ("fl", "fr", "bl", "br", "f", "b", "out")] + ["box_merge.ss_conv"]
    convs += ["box_merge.rm_conv_1", "box_merge.rm_conv_2"] if rm else []
    convts = ["box_merge.ss_deconv"] + [f"box_merge.up_conv_{i}" for i in range(1, 5 if rm else 4)]
    specs = {f"{m}.weight": (0, "model") for m in convs} | {f"{m}.weight": (1, "model") for m in convts}
    return specs | {f"{m}.bias": (0, "model") for m in convs + convts}


@pytest.mark.parametrize("cls", [RoadMapBCEv2, MultiTask, BBSpatialModel, BBSpatialRoadMap])
def test_the_jax_rules_land_on_the_port_layouts(cls):
    hparams = ROAD if cls is RoadMapBCEv2 else SMALL
    task = cls(hparams, device="cpu", generator=torch.Generator().manual_seed(0))
    specs = mesh_lib.param_shardings(types.SimpleNamespace(model=2), task, task.param_sharding_rules)
    if cls in (BBSpatialModel, BBSpatialRoadMap):
        assert {n: s for n, s in specs.items() if s} == spatial_specs(cls is BBSpatialRoadMap)
        return
    head = "fc1" if cls is RoadMapBCEv2 else "rm_head"
    assert {n: s for n, s in specs.items() if s} == {f"{head}.weight": (0, "model"), f"{head}.bias": (0, "model"),
                                                     "encoder.fc1.fc.weight": (1, "model")}


def test_spatial_tensor_parallelism_raises_and_one_ranks_signal_stops_all(tp_runs):
    """spatial_bb on tp=2 (which raised before its heads ran channel-parallel)
    stops at max_steps 2 with the one-process checkpoint: its shards are
    half the output channels a rank, the file holds the whole weights."""
    for rank in tp_runs:
        reason, last_spatial, shapes = rank["spatial"]
        assert reason == "max_steps=2 reached"
        assert sorted(shapes) == sorted(spatial_specs(rm=False))
        assert shapes["box_merge.up_conv_1.weight"] == [64, 16, 3, 3]
        assert shapes["space_map_cnn.fl_conv.weight"] == [16, 3, 1, 14]
        reason, last = rank["stop"]
        assert reason == "preemption signal"
    blob = ckpt_io.load(last_spatial)
    assert blob["meta"]["global_step"] == 2
    assert blob["params"]["box_merge"]["up_conv_1"]["w"].shape == (3, 3, 64, 32)
    assert blob["params"]["space_map_cnn"]["fl_conv"]["b"].shape == (32,)
    meta = ckpt_io.load(last)["meta"]
    assert (meta["global_step"], meta["mid_epoch"], meta["batch_in_epoch"]) == (2, True, 2)


NODE = r"""
import numpy as np, torch, torch.distributed as dist
from driving_dirty_tpu_torch.parallel import mesh as mesh_lib
torch.set_num_threads(1)
assert mesh_lib.initialize_distributed(2, device="cpu")
mesh = mesh_lib.build_mesh()
assert (dist.get_world_size(), mesh.data, mesh.model) == (2, 2, 1)
g = np.repeat(np.arange(1, 3, dtype=np.float32), 4)[:, None] * np.ones((8, 4), np.float32)
mine = torch.from_numpy(g[4 * mesh.dp_rank:4 * (mesh.dp_rank + 1)])
assert float(mine[0, 0]) == mesh.dp_rank + 1
total = mine.sum()
dist.all_reduce(total, group=mesh.dp_group)
print(f"node {mesh.rank}: global sum {float(total)} OK", flush=True)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.parametrize("whole_batches", [False, True])
def test_memory_loader_shards_as_the_loader_does(whole_batches):
    """Rows of every global batch (or whole batches rank, rank + 2, ...) of
    a resumed epoch, alike from batches in memory and from a dataset; a
    batch that does not divide over the data ranks raises."""
    items = [{"x": np.full(3, i, np.float32)} for i in range(20)]
    dataset = type("Items", (), {"__len__": lambda self: len(items), "__getitem__": lambda self, i: items[i]})()
    held = [{"x": np.stack([it["x"] for it in items[i:i + 4]])} for i in range(0, 20, 4)]
    for rank in range(2):
        got, want = MemoryLoader(held), Loader(dataset, 4, num_workers=1)
        for loader in (got, want):
            loader.set_epoch(0, skip_batches=1)
            loader.shard(rank, 2, whole_batches=whole_batches)
        got, want = list(got), list(want)
        assert len(got) == len(want) == (2 if whole_batches else 4)
        for (gb, gm), (wb, wm) in zip(got, want):
            np.testing.assert_array_equal(gb["x"], wb["x"])
            np.testing.assert_array_equal(gm, wm)
    with pytest.raises(ValueError, match="does not divide over 3"):
        MemoryLoader(held).shard(0, 3)


def test_two_nodes_join_through_the_coordinator_variables(tmp_path):
    procs = []
    for node in range(2):
        env = dict(os.environ, DD_COORDINATOR_ADDRESS=f"file://{tmp_path}/rdzv", DD_NUM_PROCESSES="2",
                   DD_PROCESS_ID=str(node))
        procs.append(subprocess.Popen([sys.executable, "-c", NODE], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    for node, out in enumerate(outs):
        assert f"node {node}: global sum 48.0 OK" in out, out

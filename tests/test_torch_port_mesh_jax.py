"""driving_dirty_tpu_torch on dp=2 x tp=2 against the JAX Trainer on
`build_mesh(4, 2)` of the conftest's 8 virtual devices, on the CPU:
roadmap_bce here, multitask in tests/test_torch_port_mesh_multitask.py,
spatial_rm and spatial_bb in tests/test_torch_port_spatial_tp_jax*.py.

The JAX task initializes from PRNGKey(0); its weights go into a JAX
single-device checkpoint (step 0, no optimizer state) that both trainers
resume: the JAX one on its mesh, the port's on four ranks spawned by
parallel/launch.py (gloo), whose task's sharding rules cut the head's fc1
(column-parallel) and the encoder's fc1.fc (row-parallel) over 'model'.
So the checkpoint carries the JAX weights into a sharded port model
(checkpoints/convert.py), and a JAX single-device checkpoint resumes on
four ranks. Dropout off on both sides (drop_p = 0), 2 Adam steps on
batches of 4 and one validation batch; roadmap_bce's encoder trains from
step 0 (the row-parallel layer's backward and the BatchNorm statistics
over 'data' are in the step).

Under jit, XLA:CPU makes the JAX package's rasterizer
(ops/maps.py:boxes_to_binary_map) fill the whole map for a valid point box
(ROADMAP.md §C, a fault of the JAX package found in PR 2), and
data/boxes.py:box_scenes holds such boxes: the JAX Trainer's jitted step
would train multitask (and spatial_bb, spatial_rm) on maps of all ones.
Its eager call gives the true maps, which the port's B2 equals exactly
(tests/test_torch_port_raster.py). So for the box tasks the test hands
the JAX task its eager targets with the batch (`_box_targets`, or the
spatial tasks' `_targets`, reads them): the JAX package is not changed,
and both sides train on the true targets.

Tolerances: each step's train_loss and the validation's val_loss rtol 1e-4
(XLA and ATen, and the two meshes, sum in other orders); the parameters
after the 2 steps, gathered whole into the port's last.ckpt by rank
(0, 0), by relative L2 error per leaf as tests/test_torch_port_box_training.py
holds its gradients: 1e-3, or 2.9e-2 for what a training-mode BatchNorm
reaches; the biases ahead of one (true gradient 0, float noise that Adam
turns into steps of about lr) within 3 lr of the JAX values.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import dataclasses
import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.models.multitask import MultiTask as JMultiTask
from driving_dirty_tpu.models.roadmap import RoadMapBCEv2 as JRoadMap
from driving_dirty_tpu.models.spatial_bb import BBSpatialModel as JSpatialBB
from driving_dirty_tpu.models.spatial_bb import BBSpatialRoadMap as JSpatialRM
from driving_dirty_tpu.parallel import mesh as jax_mesh
from driving_dirty_tpu.train.trainer import Trainer as JTrainer
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.models.multitask import MultiTask
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap
from driving_dirty_tpu_torch.parallel import launch

LOSS_RTOL = 1e-4
LEAF_TOL, BN_LEAF_TOL = 1e-3, 2.9e-2
LR = 1e-3
NOISE = ("encoder/fc1/fc/b", "encoder/fc2/fc/b")
B = 4
COMMON = dict(max_epochs=1, log_every_n_steps=1, enable_progress_bar=False)
TASKS = {
    "roadmap_bce": (JRoadMap, RoadMapBCEv2,
                    dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=32, pretrained_path=None,
                         batch_size=B, learning_rate=LR, unfreeze_epoch_no=0),
                    ("",)),  # every parameter is reached by the encoder's BatchNorm
    "multitask": (JMultiTask, MultiTask,
                  dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78,
                       pretrained_path=None, batch_size=B, learning_rate=LR, spatial_geometry="small"),
                  ("encoder/", "rm_head/")),
}
SPATIAL = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78, pretrained_path=None,
               batch_size=B, learning_rate=LR, spatial_geometry="small")
TASKS["spatial_bb"] = (JSpatialBB, BBSpatialModel, SPATIAL, ())  # no BatchNorm; the encoder stays frozen
TASKS["spatial_rm"] = (JSpatialRM, BBSpatialRoadMap, SPATIAL, ())
TARGETS = {"multitask": "_box_targets", "spatial_bb": "_targets", "spatial_rm": "_targets"}  # JAX box targets
ROAD = {"spatial_rm": 152}  # the road input's side at the "small" geometry (its raster size)


class InMemLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        for b in self.batches:
            yield b, np.ones(B, bool)


def batches(name, n):
    rng = np.random.RandomState(0)
    views = (32, 306) if name == "roadmap_bce" else (64, 78)
    out = []
    for i in range(n):
        road = ROAD.get(name, 800)
        b = {"images": rng.randint(0, 256, (B, 6, *views, 3)).astype(np.uint8),
             "road": (rng.rand(B, road, road) > 0.5).astype(np.float32)}
        if name in TARGETS:
            b["boxes"], b["box_valid"] = box_scenes(10 + i, B, 100)
        out.append(b)
    return out


def _losses(root, task, key):
    out = {}
    for path in glob.glob(os.path.join(root, task, "version_*", "tb", "metrics.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if key in rec:
                    out[rec["step"]] = rec[key]
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree, np.float64)


def run_both(name, root):
    """The JAX mesh fit and the port's 4-rank fit from one JAX checkpoint
    -> (JAX last.ckpt, port last.ckpt, the port's rank results)."""
    jcls, pcls, hparams, _ = TASKS[name]
    train, val = batches(name, 3)[:2], batches(name, 3)[2:]
    task = jcls(hparams)
    task.ae.encoder = dataclasses.replace(task.ae.encoder, drop_p=0.0)
    jax_train, jax_val = train, val
    if name in TARGETS:  # the eager targets (see the module docstring)
        eager = getattr(task, TARGETS[name])
        jax_train, jax_val = ([dict(b, box_targets=np.asarray(eager(b))) for b in bs] for bs in (train, val))
        setattr(task, TARGETS[name], lambda batch: batch["box_targets"])
    params, state = task.init(jax.random.PRNGKey(0))
    start = os.path.join(root, "start.ckpt")
    jax_io.save(start, params=params, state=state, hparams=hparams,
                meta={"epoch": 0, "global_step": 0, "mid_epoch": True, "batch_in_epoch": 0, "task": name})
    spec = dict(task=pcls, hparams=hparams, seed=0, drop_p=0.0, batches=train, val_batches=val,
                model_parallel=2, resume=start, trainer=dict(COMMON, default_root_dir=os.path.join(root, "port")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch.spawn, launch.fit_worker, 4, (spec,), device="cpu", threads=1,
                                init_method=f"file://{root}/rdzv")
            task.train_loader = lambda: InMemLoader(jax_train)
            task.val_loader = lambda: InMemLoader(jax_val)
            fit = JTrainer(mesh=jax_mesh.build_mesh(4, 2), default_root_dir=os.path.join(root, "jax"),
                           **COMMON).fit(task, resume_from=start)
            ranks = ranks.result()
    return fit.last_ckpt_path, ranks[0]["last_ckpt_path"], ranks


def hold(name, root, jax_ckpt, port_ckpt, ranks):
    _, _, _, bn_reached = TASKS[name]
    for key in ("train_loss", "val_loss"):
        ref, got = _losses(os.path.join(root, "jax"), name, key), _losses(os.path.join(root, "port"), name, key)
        assert sorted(got) == sorted(ref) and ref, key
        for s in ref:
            np.testing.assert_allclose(got[s], ref[s], rtol=LOSS_RTOL, err_msg=f"{name} {key} step {s}")
    ref, got = ckpt_io.load(jax_ckpt), ckpt_io.load(port_ckpt)
    assert got["meta"]["global_step"] == ref["meta"]["global_step"] == 2
    for (n, g), (rn, r) in zip(_leaves(got["params"]), _leaves(ref["params"])):
        assert n == rn and g.shape == r.shape, (n, rn)
        if n in NOISE:
            assert np.abs(g - r).max() <= 3 * LR, n
            continue
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= (BN_LEAF_TOL if n.startswith(bn_reached) else LEAF_TOL), (n, err)
    assert all(r["rank"][0] == i for i, r in enumerate(ranks))


@pytest.fixture(scope="module")
def roadmap_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_jax"))
    return (root, *run_both("roadmap_bce", root))


def test_roadmap_bce_on_dp2_tp2_matches_the_jax_mesh(roadmap_runs):
    hold("roadmap_bce", *roadmap_runs)


def test_a_jax_single_device_checkpoint_resumes_sharded_on_four_ranks(roadmap_runs):
    root, _, port_ckpt, ranks = roadmap_runs
    assert [r["shard_shapes"] for r in ranks] == [{"encoder.fc1.fc.weight": [16, 58752], "fc1.weight": [320000, 8],
                                                   "fc1.bias": [320000]}] * 4
    assert [tuple(r["rank"][1:]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    blob = ckpt_io.load(port_ckpt)
    assert blob["params"]["fc1"]["w"].shape == (8, 640000)
    assert "torch_generator_cpu" in blob["extra"]

"""Box-family training through driving_dirty_tpu_torch's Trainer against the
JAX package's Trainer, and checkpoints across packages, on the CPU, with
the joint multitask model (BatchNorm state, dropout, two heads).

Small config: the "small" spatial geometry (the synthetic dataset's views
resized to 64 x 78; the 800 x 800 road maps stay), AE hidden 16, latent 8,
batch 2, random init (no pretrained AE), dropout off on both sides
(drop_p = 0, so no step draws anything), the encoder frozen in epoch 0
(unfreeze_epoch_no 1), 2 epochs x 2 batches and one validation batch:

  1. the port's Trainer runs to max_steps=1 and writes a mid-epoch
     last.ckpt (P1);
  2. the JAX Trainer resumes P1 to max_steps=3 (J3, the reference run:
     step 1, epoch 0's validation and checkpoint, the unfreeze, step 2),
     and the port resumes P1 to max_steps=3 (P3), the same way;
  3. the JAX Trainer resumes P3, and the port J3, each to the end (step 3,
     validation): J3 and P3 hold the encoder's Adam moments, and optax
     restores the port's leaves (a leaf count that does not fit raises
     there).

Steps 1 and 2 (train_loss, rm_loss and box_loss) and epoch 0's validation
metrics of the port are held to the JAX reference's, and so is step 3 of
the two crossed runs of 3; their final checkpoints carry the same step
count and Adam hyperparameters, and parameters and BatchNorm statistics
near each other.
Tolerances: losses and validation losses rtol 1e-4 (one f32 step agrees to
~1e-6; BatchNorm's batch statistics at batch 2 lose digits each package
loses differently, tests/test_torch_port_box_training.py); validation
threat scores rtol 1e-3 (a pixel whose probability lies within float error
of 0.5 rounds either way); final parameters and BN statistics by relative
L2 error per leaf, 1e-1, as tests/test_torch_port_trainer_jax.py allows
after Adam's sign-like early steps, except the biases ahead of a
training-mode BatchNorm, whose gradient is float noise: within 9 lr.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from driving_dirty_tpu.models.multitask import MultiTask as JMultiTask
from driving_dirty_tpu.train.trainer import Trainer as JTrainer
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.models.multitask import MultiTask
from driving_dirty_tpu_torch.nn.autoencoder import DenseBlock
from driving_dirty_tpu_torch.train.trainer import Trainer

LOSS_RTOL = 1e-4
TS_RTOL = 1e-3
LEAF_RTOL = 1e-1
LR = 1e-3
NOISE = ("encoder/fc1/fc/b", "encoder/fc2/fc/b")  # ahead of a training-mode BatchNorm
VIEW_HW = (64, 78)
SMALL = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=VIEW_HW[0], ae_input_width=6 * VIEW_HW[1],
             spatial_geometry="small", batch_size=2, learning_rate=LR, pretrained_path=None,
             unfreeze_epoch_no=1, samples_per_scene=4, num_labeled_scenes=3, output_img_freq=0,
             num_workers=2)
COMMON = dict(max_epochs=2, limit_train_batches=2, limit_val_batches=1, log_every_n_steps=1,
              enable_progress_bar=False)


def resize_views(root, hw):
    """Every camera view of a dataset resized to hw (rows, columns)."""
    for path in glob.glob(os.path.join(root, "scene_*", "sample_*", "CAM_*.jpeg")):
        with Image.open(path) as im:
            view = im.resize((hw[1], hw[0]), Image.BILINEAR)
        view.save(path, quality=90)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs of the module docstring -> {name: (root, FitResult)}."""
    d = tmp_path_factory.mktemp("box_resume")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        generate(str(d / "data"), scenes=0, samples=4, labeled_scenes=3, seed=0)
        resize_views(d / "data", VIEW_HW)
        h = dict(SMALL, link=str(d / "data"))

        def jax_fit(name, resume=None, **kw):
            task = JMultiTask(h)
            task.ae.encoder = dataclasses.replace(task.ae.encoder, drop_p=0.0)
            return JTrainer(default_root_dir=str(d / name), **dict(COMMON, **kw)).fit(task, resume_from=resume)

        def port_fit(name, resume, **kw):
            task = MultiTask(h, device="cpu", generator=torch.Generator().manual_seed(0))
            for m in task.modules():
                if isinstance(m, DenseBlock):
                    m.drop_p = 0.0
            return Trainer(default_root_dir=str(d / name), device="cpu", **dict(COMMON, **kw)).fit(
                task, resume_from=resume)

        out = {"port_start": port_fit("port_start", None, max_steps=1)}
        p1 = out["port_start"].last_ckpt_path
        out["jax_ref"] = jax_fit("jax_ref", resume=_copy(p1, d / "jax_ref"), max_steps=3)
        out["port_mid"] = port_fit("port_mid", _copy(p1, d / "port_mid"), max_steps=3)
        j3, p3 = out["jax_ref"].last_ckpt_path, out["port_mid"].last_ckpt_path
        out["jax_end"] = jax_fit("jax_end", resume=_copy(p3, d / "jax_end"))
        out["port_end"] = port_fit("port_end", _copy(j3, d / "port_end"))
        out = {k: (d / k, v) for k, v in out.items()}
    yield out
    shutil.rmtree(d, ignore_errors=True)


def _copy(ckpt, root):
    """A checkpoint copied out of its run, so the resumed run writes into a
    directory of its own."""
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, "start.ckpt")
    shutil.copy(ckpt, dst)
    return dst


def _records(root):
    out = []
    for path in sorted(glob.glob(os.path.join(root, "multitask", "version_*", "tb", "metrics.jsonl"))):
        with open(path) as f:
            out += [json.loads(line) for line in f]
    return out


def _by_step(root, key):
    return {r["step"]: r[key] for r in _records(root) if key in r}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree, np.float64)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    n = np.linalg.norm(ref)
    return np.linalg.norm(got - ref) / n if n else float(np.abs(got).max())


@pytest.mark.parametrize("key", ["train_loss", "train_rm_loss", "train_box_loss"])
def test_port_steps_match_the_jax_trainers(runs, key):
    """Steps 1 and 2 from one checkpoint (P1) in both packages' trainers,
    and step 3 of each package resumed from the other's checkpoint."""
    ref, got = _by_step(runs["jax_ref"][0], key), _by_step(runs["port_mid"][0], key)
    assert sorted(ref) == sorted(got) == [1, 2]
    for s in (1, 2):
        np.testing.assert_allclose(got[s], ref[s], rtol=LOSS_RTOL, err_msg=f"step {s}")
    ref, got = _by_step(runs["jax_end"][0], key), _by_step(runs["port_end"][0], key)
    assert sorted(ref) == sorted(got) == [3]
    np.testing.assert_allclose(got[3], ref[3], rtol=LOSS_RTOL, err_msg="step 3")


@pytest.mark.parametrize("runs_", [("port_mid", "jax_ref"), ("port_end", "jax_end")], ids=["epoch0", "epoch1"])
def test_the_port_validates_as_the_jax_trainer_does(runs, runs_):
    """Each epoch's validation, the port's against the JAX Trainer's: the
    same keys and values."""
    def val(root):
        return next(r for r in _records(root) if "val_loss" in r)

    got, ref = val(runs[runs_[0]][0]), val(runs[runs_[1]][0])
    keys = {k for k in ref if k.startswith("val_")}
    assert keys == {"val_loss", "val_rm_ts_rounded", "val_box_loss", "val_ts_boxes"}
    assert {k for k in got if k.startswith("val_")} == keys and got["step"] == ref["step"]
    for k in keys:
        rtol = LOSS_RTOL if "loss" in k else TS_RTOL
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, err_msg=k)


def test_each_package_finishes_the_others_run(runs):
    """The crossed runs of step 3 end in checkpoints with the same step
    count and Adam hyperparameters, and parameters and BatchNorm statistics
    near each other; the port's checkpoints carry its generator state."""
    ref = ckpt_io.load(runs["jax_end"][1].last_ckpt_path)
    got = ckpt_io.load(runs["port_end"][1].last_ckpt_path)
    for name in ("port_mid", "jax_ref"):
        mid = ckpt_io.load(runs[name][1].last_ckpt_path)
        assert mid["meta"]["mid_epoch"] and mid["meta"]["global_step"] == 3 and mid["meta"]["epoch"] == 1
        assert ("torch_generator_cpu" in mid["extra"]) == (name == "port_mid")
    assert "torch_generator_cpu" in got["extra"]
    assert got["meta"]["global_step"] == ref["meta"]["global_step"] == 4
    g_opt, r_opt = got["opt_state"], ref["opt_state"]
    n = len(list(_leaves(ref["params"])))
    assert len(g_opt) == len(r_opt) == 7 + 2 * n
    for i in range(7):  # count, b1, b2, eps, eps_root, learning_rate, adam count
        assert np.asarray(g_opt[i]) == np.asarray(r_opt[i]), i
    for section in ("params", "state"):
        for (name, g), (rname, r) in zip(_leaves(got[section]), _leaves(ref[section])):
            assert name == rname
            if name in NOISE:
                assert np.abs(g - r).max() <= 9 * LR, name
            else:
                assert _rel_l2(g, r) <= LEAF_RTOL, (section, name, _rel_l2(g, r))

"""driving_dirty_tpu_torch's Trainer against itself on the CPU: exact resume,
the contract of tests/test_resume_exact.py. The trainer's safety
behaviours are in tests/test_torch_port_trainer_safety.py.

A TINY BasicAE (hidden 8, latent 8, batch 2) trains on the synthetic
dataset with its views cut to their top 32 rows (32 x 306: BasicAE masks
306-wide columns; the short views keep the CPU steps cheap), 2 epochs x 2
batches, with dropout and the six-to-one mask drawn from the trainer's
step generator, which the checkpoint carries. A run stopped by max_steps
(mid-epoch, and mid-accumulation-window) or at an epoch's end and resumed
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

from its last.ckpt must log the uninterrupted run's train_loss at every
step it runs, rtol 1e-6: the same steps on the same data in the same order
with the same draws and optimizer state (the weights' round trip through
the JAX layouts is exact).
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.models.basic_ae import BasicAE
from driving_dirty_tpu_torch.train.trainer import Trainer

STEPS = [0, 1, 2, 3]
VIEW_ROWS = 32
TINY = dict(hidden_dim=8, latent_dim=8, input_height=VIEW_ROWS, output_height=VIEW_ROWS, batch_size=2,
            learning_rate=1e-3, samples_per_scene=4, num_unlabeled_scenes=3, output_img_freq=0,
            num_workers=2)


@pytest.fixture(scope="module", autouse=True)
def _quiet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        yield


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Data and every run of this module; removed at the end."""
    d = tmp_path_factory.mktemp("port_trainer")
    generate(str(d / "data"), scenes=3, samples=4, labeled_scenes=0, seed=0)
    crop_views(d / "data", VIEW_ROWS)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def crop_views(root, rows):
    """Keep the top `rows` rows of every camera view of a dataset."""
    for path in glob.glob(os.path.join(root, "scene_*", "sample_*", "CAM_*.jpeg")):
        with Image.open(path) as im:
            view = im.crop((0, 0, im.width, rows))
        view.save(path, quality=90)


def _fit(root, resume=None, **kw):
    base = dict(max_epochs=2, default_root_dir=str(root), limit_train_batches=2, limit_val_batches=1,
                log_every_n_steps=1, enable_progress_bar=False, device="cpu")
    base.update(kw)
    task = BasicAE(dict(link=str(root.parent / "data"), **TINY), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return Trainer(**base).fit(task, resume_from=resume)


def _losses(root):
    """step -> train_loss over every version of the run (a resumed run
    appends to its checkpoint's version)."""
    out = {}
    for path in glob.glob(os.path.join(root, "basic_ae", "version_*", "tb", "metrics.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "train_loss" in rec:
                    out[rec["step"]] = rec["train_loss"]
    return out


@pytest.fixture(scope="module")
def uninterrupted(workdir):
    root = workdir / "a"
    _fit(root)
    losses = _losses(root)
    assert sorted(losses) == STEPS
    return losses


def _same(got, ref, steps):
    assert sorted(got) == steps
    for s in steps:
        np.testing.assert_allclose(got[s], ref[s], rtol=1e-6, err_msg=f"step {s}")


def test_preempt_mid_epoch_then_resume_matches_uninterrupted(workdir, uninterrupted):
    root = workdir / "b"
    rb = _fit(root, max_steps=3)
    assert rb.stop_reason == "max_steps=3 reached"
    blob = ckpt_io.load(rb.last_ckpt_path)
    meta = blob["meta"]
    assert (meta["mid_epoch"], meta["epoch"], meta["batch_in_epoch"], meta["global_step"]) == (True, 1, 1, 3)
    n = len(list(rb.task.parameters()))
    assert len(blob["opt_state"]) == 7 + 2 * n  # inject_hyperparams(adam) over n parameter leaves
    assert set(meta["trainer_state"]) == {"best_val", "plateau_wait", "lr", "seed"}
    assert "torch_generator_cpu" in blob["extra"]
    _same(_losses(root), uninterrupted, [0, 1, 2])
    _fit(root, resume=rb.last_ckpt_path)
    _same(_losses(root), uninterrupted, STEPS)
    assert len(glob.glob(str(root / "basic_ae" / "version_*"))) == 1  # resumed in place
    shutil.rmtree(root)


def test_epoch_boundary_resume_restores_optimizer_and_lr(workdir, uninterrupted):
    root = workdir / "c"
    rc = _fit(root, max_epochs=1)
    blob = ckpt_io.load(rc.last_ckpt_path)
    assert blob["meta"].get("mid_epoch") is None and blob["meta"]["epoch"] == 0
    assert blob["meta"]["trainer_state"]["lr"] == pytest.approx(1e-3)
    assert np.isfinite(blob["meta"]["trainer_state"]["best_val"])
    assert os.path.realpath(root / "basic_ae" / "last.ckpt") == os.path.realpath(rc.last_ckpt_path)
    _fit(root, resume=str(root / "basic_ae" / "last.ckpt"))  # through the task-level link
    _same(_losses(root), uninterrupted, STEPS)
    shutil.rmtree(root)


def test_preempt_resume_exact_under_accumulation(workdir):
    acc = dict(accumulate_grad_batches=2)
    _fit(workdir / "acc_a", **acc)
    ref = _losses(workdir / "acc_a")
    # stopped after step 2: the first half of the second window, mid-epoch
    root = workdir / "acc_b"
    rb = _fit(root, max_steps=3, **acc)
    leaves = ckpt_io.load(rb.last_ckpt_path)["opt_state"]
    assert (int(leaves[0]), int(leaves[1])) == (1, 1)  # MultiSteps mini_step, gradient_step
    _fit(root, resume=rb.last_ckpt_path, **acc)
    _same(_losses(root), ref, STEPS)
    shutil.rmtree(root)
    shutil.rmtree(workdir / "acc_a")

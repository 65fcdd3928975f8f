"""A faster_rcnn_rm run crossing the packages both ways, on the CPU (the
scheme of tests/test_torch_port_box_resume.py), on the dataset and
pretrained BasicAE of tests/test_torch_port_det_cli.py: the port's Trainer
stops after step 0 (P1); the JAX Trainer and the port each resume P1 to
step 3 (J3, P3: steps 1-2, epoch 0's validation, the unfreeze); then each
resumes the other's checkpoint to the end (step 3 and epoch 1's
validation).

The run draws nothing that matters: 256 anchors (one 16-px anchor a cell
of the 32-px layout image) of which the RPN sampler takes all, and 16
proposals + 8 GT slots of which the RoI sampler takes all, so the noise
only orders the samples (across packages a resume is exact only without
draws: the port's generator state has no JAX counterpart). Losses and
validation losses agree to 1e-4 relative (f32 sums in another order, as in
the box resume test); the crossed final checkpoints have the same step
count and Adam hyperparameters, and their parameters lie within 1e-1
relative L2 per leaf (Adam's early sign-like steps, as
tests/test_torch_port_trainer_jax.py allows; a leaf that no loss reached
stays exactly 0 on both sides).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import os
import shutil

import numpy as np
import pytest
import torch

from driving_dirty_tpu.models import faster_rcnn as JF
from driving_dirty_tpu.train.trainer import Trainer as JTrainer
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.models import faster_rcnn as TF
from driving_dirty_tpu_torch.train.trainer import Trainer

from test_torch_port_det_cli import SAMPLES, SCENES, SIZE, _records, workdir  # noqa: F401  (the dataset fixture)

LOSS_RTOL = 1e-4
LEAF_RTOL = 1e-1


RESUME = dict(ae_hidden_dim=8, ae_latent_dim=8, image_size=SIZE, anchor_sizes="16", anchor_ratios="1.0",
              rpn_pre_nms_top_n=128, rpn_post_nms_top_n=16, box_batch_per_image=128, max_bb=8,
              exact_topk=1, batch_size=2, learning_rate=1e-3, unfreeze_epoch_no=1,
              samples_per_scene=SAMPLES, num_labeled_scenes=SCENES, output_img_freq=0, num_workers=2,
              val_ats=0)
COMMON = dict(max_epochs=2, limit_train_batches=2, limit_val_batches=1, log_every_n_steps=1,
              enable_progress_bar=False)


def _copy(ckpt, root):
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, "start.ckpt")
    shutil.copy(ckpt, dst)
    return dst


@pytest.fixture(scope="module")
def runs(workdir):
    """The crossed runs of the module docstring -> {name: (root, FitResult)}."""
    d = workdir / "resume"
    h = dict(RESUME, link=str(workdir / "data"), pretrained_path=str(workdir / "ae.ckpt"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")

        def jax_fit(name, resume, **kw):
            return JTrainer(default_root_dir=str(d / name), **dict(COMMON, **kw)).fit(
                JF.FasterRCNNRoadMap(h), resume_from=resume)

        def port_fit(name, resume, **kw):
            task = TF.FasterRCNNRoadMap(h, device="cpu", generator=torch.Generator().manual_seed(0))
            return Trainer(default_root_dir=str(d / name), device="cpu", **dict(COMMON, **kw)).fit(
                task, resume_from=resume)

        out = {"port_start": port_fit("port_start", None, max_steps=1)}
        p1 = out["port_start"].last_ckpt_path
        out["jax_ref"] = jax_fit("jax_ref", _copy(p1, d / "jax_ref"), max_steps=3)
        out["port_mid"] = port_fit("port_mid", _copy(p1, d / "port_mid"), max_steps=3)
        j3, p3 = out["jax_ref"].last_ckpt_path, out["port_mid"].last_ckpt_path
        out["jax_end"] = jax_fit("jax_end", _copy(p3, d / "jax_end"))
        out["port_end"] = port_fit("port_end", _copy(j3, d / "port_end"))
    return {k: (d / k, v) for k, v in out.items()}


def _by_step(root, key):
    return {r["step"]: r[key] for r in _records(root, "faster_rcnn_rm") if key in r}


def test_each_package_resumes_the_others_run(runs):
    for key in ("train_loss", "train_loss_objectness", "train_loss_classifier"):
        ref, got = _by_step(runs["jax_ref"][0], key), _by_step(runs["port_mid"][0], key)
        assert sorted(ref) == sorted(got) == [1, 2]
        for s in (1, 2):
            np.testing.assert_allclose(got[s], ref[s], rtol=LOSS_RTOL, err_msg=f"{key} step {s}")
        ref, got = _by_step(runs["jax_end"][0], key), _by_step(runs["port_end"][0], key)
        assert sorted(ref) == sorted(got) == [3]
        np.testing.assert_allclose(got[3], ref[3], rtol=LOSS_RTOL, err_msg=f"{key} step 3")
    for a, b in (("port_mid", "jax_ref"), ("port_end", "jax_end")):
        got, ref = _by_step(runs[a][0], "val_loss"), _by_step(runs[b][0], "val_loss")
        assert sorted(got) == sorted(ref) and len(ref) == 1
        for s in ref:
            np.testing.assert_allclose(got[s], ref[s], rtol=LOSS_RTOL, err_msg=f"val_loss {a}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree, np.float64)


def test_crossed_checkpoints_agree(runs):
    ref = ckpt_io.load(runs["jax_end"][1].last_ckpt_path)
    got = ckpt_io.load(runs["port_end"][1].last_ckpt_path)
    assert got["meta"]["global_step"] == ref["meta"]["global_step"] == 4
    assert "torch_generator_cpu" in got["extra"]
    n = len(list(_leaves(ref["params"])))
    assert len(got["opt_state"]) == len(ref["opt_state"]) == 7 + 2 * n
    for i in range(7):  # count, b1, b2, eps, eps_root, learning_rate, adam count
        assert np.asarray(got["opt_state"][i]) == np.asarray(ref["opt_state"][i]), i
    for (name, g), (rname, r) in zip(_leaves(got["params"]), _leaves(ref["params"])):
        assert name == rname
        scale = np.linalg.norm(r)
        err = np.linalg.norm(g - r) / scale if scale else np.abs(g).max()
        assert err <= LEAF_RTOL, (name, err)

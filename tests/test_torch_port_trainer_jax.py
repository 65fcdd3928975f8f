"""Checkpoints across packages: the JAX Trainer and driving_dirty_tpu_torch's
Trainer resume each other's last.ckpt, on the CPU.

roadmap_bce at TINY size (AE hidden 8, latent 8, batch 2, random init, no
pretrained AE), dropout off on both sides (drop_p = 0, so no step draws
anything), the encoder frozen in epoch 0 (unfreeze_epoch_no 1), 2 epochs x
3 batches of the synthetic labeled scenes, their views cut to the top 32
rows (32 x 306; the 800 x 800 road maps stay) to keep the CPU steps cheap:

  1. the JAX Trainer runs to max_steps=2 and writes a mid-epoch last.ckpt;
  2. the JAX Trainer resumes it to the end (the reference run), and the
     port resumes it to max_steps=4 (mid-epoch 1, past the unfreeze) and
     writes its own mid-epoch last.ckpt;
  3. the port resumes its checkpoint to the end, and the JAX Trainer
     resumes the port's checkpoint to the end: optax restores its leaves
     (a leaf count that does not fit raises there).

Every step's train_loss, the final parameters and the final Adam mu and nu
of each run are held to the reference run's; the count and the injected
hyperparameters must be equal. Tolerances: losses rtol 1e-5; parameters
and moments by relative L2 error per leaf, 1e-1. One f32 step of the two
packages agrees to ~1e-6 (XLA and ATen sum the encoder's fc1 and the conv
reductions in other orders), and after the unfreeze Adam's early steps,
about lr / (sqrt(v) + eps) * m with v ~ g^2, scale the gradients' rounding
up to a share of lr on weights whose gradient is small. Measured: losses
within 1.4e-6, parameters within 3.8e-2 (c3's 32 biases; the rest within
1.3e-2), moments within 7.6e-3. A per-parameter Adam count (bias
correction t = 1 at the unfreeze) moves the parameters by ~0.5 and the
losses by far more than 1e-5.
The biases ahead of a training-mode BatchNorm (the encoder's fc1.fc.b and
fc2.fc.b) are the exception: the BatchNorm removes them, so their true
gradient is 0 and what the backward gives is float noise, which Adam turns
into steps of about lr in a direction each package draws from its own
rounding. They are held only to lie within 9 lr of each other (three
unfrozen updates a side, each at most about 1.5 lr), and their moments,
pure noise, are not compared.
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

from driving_dirty_tpu.models.roadmap import RoadMapBCEv2 as JRoadMap
from driving_dirty_tpu.train.trainer import Trainer as JTrainer
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
from driving_dirty_tpu_torch.nn.autoencoder import DenseBlock
from driving_dirty_tpu_torch.train.trainer import Trainer

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-1
# biases ahead of a training-mode BatchNorm: their gradient is float noise
NOISE = ("encoder/fc1/fc/b", "encoder/fc2/fc/b")
TINY = dict(ae_hidden_dim=8, ae_latent_dim=8, ae_input_height=32, batch_size=2, learning_rate=1e-3, pretrained_path=None,
            unfreeze_epoch_no=1, samples_per_scene=4, num_labeled_scenes=3, output_img_freq=0,
            num_workers=2)
COMMON = dict(max_epochs=2, limit_train_batches=3, limit_val_batches=1, log_every_n_steps=1,
              enable_progress_bar=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The five runs of the module docstring -> {name: (root, FitResult)}."""
    d = tmp_path_factory.mktemp("trainer_jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        generate(str(d / "data"), scenes=0, samples=4, labeled_scenes=3, seed=0)
        crop_views(d / "data", TINY["ae_input_height"])
        h = dict(TINY, link=str(d / "data"))

        def jax_fit(name, resume=None, **kw):
            task = JRoadMap(h)
            task.ae.encoder = dataclasses.replace(task.ae.encoder, drop_p=0.0)
            return JTrainer(default_root_dir=str(d / name), **dict(COMMON, **kw)).fit(task, resume_from=resume)

        def port_fit(name, resume, **kw):
            task = RoadMapBCEv2(h, device="cpu", generator=torch.Generator().manual_seed(0))
            for m in task.modules():
                if isinstance(m, DenseBlock):
                    m.drop_p = 0.0
            return Trainer(default_root_dir=str(d / name), device="cpu", **dict(COMMON, **kw)).fit(
                task, resume_from=resume)

        out = {"jax_start": jax_fit("jax_start", max_steps=2)}
        start = out["jax_start"].last_ckpt_path
        out["jax_ref"] = jax_fit("jax_ref", resume=_copy(start, d / "jax_ref"))
        out["port_mid"] = port_fit("port_mid", resume=_copy(start, d / "port_mid"), max_steps=4)
        mid = out["port_mid"].last_ckpt_path
        out["port_end"] = port_fit("port_end", resume=_copy(mid, d / "port_end"))
        out["jax_from_port"] = jax_fit("jax_from_port", resume=_copy(mid, d / "jax_from_port"))
        out = {k: (d / k, v) for k, v in out.items()}
    yield out
    shutil.rmtree(d, ignore_errors=True)


def crop_views(root, rows):
    """Keep the top `rows` rows of every camera view of a dataset."""
    for path in glob.glob(os.path.join(root, "scene_*", "sample_*", "CAM_*.jpeg")):
        with Image.open(path) as im:
            view = im.crop((0, 0, im.width, rows))
        view.save(path, quality=90)


def _copy(ckpt, root):
    """A checkpoint copied out of its run, so the resumed run writes into a
    directory of its own."""
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, "start.ckpt")
    shutil.copy(ckpt, dst)
    return dst


def _losses(root):
    out = {}
    for path in glob.glob(os.path.join(root, "roadmap_bce", "version_*", "tb", "metrics.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "train_loss" in rec:
                    out[rec["step"]] = rec["train_loss"]
    return out


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


@pytest.mark.parametrize("run,steps", [("port_mid", [2, 3]), ("port_end", [4, 5]), ("jax_from_port", [4, 5])])
def test_resumed_losses_match_the_jax_run(runs, run, steps):
    ref = _losses(runs["jax_ref"][0])
    got = _losses(runs[run][0])
    assert sorted(ref) == [2, 3, 4, 5] and sorted(got) == steps
    for s in steps:
        np.testing.assert_allclose(got[s], ref[s], rtol=LOSS_RTOL, err_msg=f"{run} step {s}")


@pytest.mark.parametrize("run", ["port_end", "jax_from_port"])
def test_final_params_and_adam_state_match_the_jax_run(runs, run):
    ref = ckpt_io.load(runs["jax_ref"][1].last_ckpt_path)
    got = ckpt_io.load(runs[run][1].last_ckpt_path)
    assert got["meta"]["global_step"] == ref["meta"]["global_step"] == 6
    names = []
    for (name, g), (rname, r) in zip(_leaves(got["params"]), _leaves(ref["params"])):
        assert name == rname
        names.append(name)
        if name in NOISE:
            assert np.abs(g - r).max() <= 9 * TINY["learning_rate"], name
        else:
            assert _rel_l2(g, r) <= LEAF_RTOL, name
    g_opt, r_opt = got["opt_state"], ref["opt_state"]
    assert len(g_opt) == len(r_opt) == 7 + 2 * len(names)
    for i in range(7):  # count, b1, b2, eps, eps_root, learning_rate, adam count
        assert np.asarray(g_opt[i]) == np.asarray(r_opt[i]), i
    assert int(g_opt[0]) == 6
    for i, name in enumerate(names + names):  # mu, then nu, in the params' flatten order
        if name not in NOISE:
            assert _rel_l2(g_opt[7 + i], r_opt[7 + i]) <= LEAF_RTOL, name


def test_the_port_carries_its_generator_state_and_the_jax_key(runs):
    extra = ckpt_io.load(runs["port_mid"][1].last_ckpt_path)["extra"]
    start = ckpt_io.load(runs["jax_start"][1].last_ckpt_path)["extra"]
    assert "torch_generator_cpu" in extra
    np.testing.assert_array_equal(extra["rng"], start["rng"])

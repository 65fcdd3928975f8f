"""The box-family training CLIs of driving_dirty_tpu_torch (cli.spatial_bb,
cli.multitask, cli.bb_mlp) on the CPU, against the JAX package's parsers
and checkpoint loader:

  * every flag the JAX parser (trainer flags + the model's flags) takes is
    taken here, with the same default; the port adds --device and
    --spatial_geometry, whose defaults are cuda and reference;
  * each CLI trains 2 steps (spatial_bb under both variants) on the
    synthetic dataset (data/synthetic.py, views resized to 64 x 78 for the
    "small" geometry; for spatial_rm the road maps resized to its 152-px
    branch) over a pretrained BasicAE checkpoint, with --device cpu: finite
    losses, a validation batch, the frozen encoder equal to the pretrained
    one bit for bit;
  * cli.multitask with --unfreeze_epoch_no 1 trains the encoder in epoch 1
    only (and 0 reads as 20, as in the JAX package);
  * the c3-only spatial_bb checkpoint holds no BatchNorm state, and the JAX
    package's loader restores it to the port's occupancy maps within rtol
    1e-3 / atol 1e-4 (f32 through the transposed-conv chain, as
    tests/test_torch_port_boxmodels.py allows).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import argparse
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from driving_dirty_tpu.cli.common import add_trainer_args as jax_trainer_args
from driving_dirty_tpu.export import _load_task_ckpt as jax_load_task_ckpt
from driving_dirty_tpu.models import bb_mlp as JBB
from driving_dirty_tpu.models import multitask as JMT
from driving_dirty_tpu.models import spatial_bb as JSB
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.cli import bb_mlp as cli_bb_mlp
from driving_dirty_tpu_torch.cli import multitask as cli_multitask
from driving_dirty_tpu_torch.cli import spatial_bb as cli_spatial_bb
from driving_dirty_tpu_torch.cli.common import add_trainer_args
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.export import load_task_ckpt, save_task_ckpt
from driving_dirty_tpu_torch.models import bb_mlp as BB
from driving_dirty_tpu_torch.models import multitask as MT
from driving_dirty_tpu_torch.models import spatial_bb as SB
from driving_dirty_tpu_torch.models.basic_ae import BasicAE

from test_torch_port_box_resume import resize_views

MODELS = {"spatial_bb": (SB.BBSpatialModel, JSB.BBSpatialModel),
          "spatial_rm": (SB.BBSpatialRoadMap, JSB.BBSpatialRoadMap),
          "multitask": (MT.MultiTask, JMT.MultiTask), "bb_mlp": (BB.Boxes, JBB.Boxes)}
CLIS = {"spatial_bb": (cli_spatial_bb, ["--variant", "plain"]), "spatial_rm": (cli_spatial_bb, []),
        "multitask": (cli_multitask, []), "bb_mlp": (cli_bb_mlp, [])}
VIEW_HW = (64, 78)
RM_ROAD = 152  # the small geometry's road-map branch
SAMPLES, SCENES = 4, 3
TOL = dict(rtol=1e-3, atol=1e-4)


def _parser(add_model, add_trainer=add_trainer_args):
    return add_model(add_trainer(argparse.ArgumentParser()))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny pretrained BasicAE checkpoint for 64 x 468 panoramas, and two
    synthetic labeled datasets of 64 x 78 views: one with 800-px road maps,
    one with the 152-px ones of the small spatial_rm."""
    d = tmp_path_factory.mktemp("box_cli")
    ae = BasicAE(dict(hidden_dim=16, latent_dim=8, input_height=VIEW_HW[0], input_width=6 * VIEW_HW[1],
                      output_height=VIEW_HW[0], output_width=VIEW_HW[1]), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    save_task_ckpt(d / "ae.ckpt", ae)
    generate(str(d / "data"), scenes=0, samples=SAMPLES, labeled_scenes=SCENES, seed=0)
    resize_views(d / "data", VIEW_HW)
    shutil.copytree(d / "data", d / "data_rm")
    for path in glob.glob(str(d / "data_rm" / "scene_*" / "sample_*" / "ego.png")):
        with Image.open(path) as im:
            im.resize((RM_ROAD, RM_ROAD), Image.NEAREST).save(path)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _argv(workdir, name, root, *extra):
    return [*CLIS[name][1], "--link", str(workdir / ("data_rm" if name == "spatial_rm" else "data")),
            "--pretrained_path", str(workdir / "ae.ckpt"),
            *([] if name == "bb_mlp" else ["--spatial_geometry", "small"]),
            "--samples_per_scene", str(SAMPLES), "--num_labeled_scenes", str(SCENES), "--batch_size", "2",
            "--max_epochs", "1", "--limit_train_batches", "2", "--limit_val_batches", "1",
            "--log_every_n_steps", "1", "--num_workers", "2", "--seed", "0", "--device", "cpu",
            "--default_root_dir", str(root), *extra]


def _losses(root, task):
    out = {}
    for path in glob.glob(os.path.join(root, task, "version_*", "tb", "metrics.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "train_loss" in rec:
                    out[rec["step"]] = rec["train_loss"]
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_jax_flag_parses_with_its_default(name):
    port_cls, jax_cls = MODELS[name]
    port, ref = _parser(port_cls.add_model_specific_args), _parser(jax_cls.add_model_specific_args,
                                                                   jax_trainer_args)
    missing = set(ref._option_string_actions) - set(port._option_string_actions)
    assert not missing, f"{name}: the port's CLI lacks {sorted(missing)}"
    got, want = vars(port.parse_args([])), vars(ref.parse_args([]))
    assert {k: got[k] for k in want} == want
    extra = set(got) - set(want)
    assert got["device"] == "cuda" and extra <= {"device", "spatial_geometry"}
    assert ("spatial_geometry" in extra) == (name != "bb_mlp")
    if name != "bb_mlp":
        assert got["spatial_geometry"] == "reference"


@pytest.mark.parametrize("name", sorted(CLIS))
def test_each_cli_trains_two_steps_on_the_cpu(name, workdir, monkeypatch):
    monkeypatch.setenv("DD_NO_TB", "1")
    root = workdir / f"logs_{name}"
    extra = ["--output_img_freq", "1"] if name.startswith("spatial") else ["--output_img_freq", "0"]
    fit = CLIS[name][0].main(_argv(workdir, name, root, *extra))
    assert type(fit.task) is MODELS[name][0] and fit.task.name == name
    assert fit.stop_reason is None and np.isfinite(fit.best_val_loss)
    losses = _losses(root, name)
    assert sorted(losses) == [0, 1] and np.isfinite(list(losses.values())).all()
    ae = ckpt_io.load(workdir / "ae.ckpt")["params"]["encoder"]
    blob = ckpt_io.load(fit.last_ckpt_path)
    assert blob["meta"]["task"] == name and blob["meta"]["global_step"] == 2
    for layer in ("c1", "c2", "c3"):  # frozen until epoch 20
        for k in ("w", "b"):
            np.testing.assert_array_equal(blob["params"]["encoder"][layer][k], ae[layer][k])
    if name.startswith("spatial"):
        assert blob["state"] is None  # the c3-only backbone holds no BatchNorm
    else:
        assert set(blob["state"]["encoder"]) == {"fc1", "fc2"}


def test_multitask_unfreezes_the_encoder_at_the_flags_epoch(workdir, monkeypatch):
    monkeypatch.setenv("DD_NO_TB", "1")
    starts = []  # the encoder's parameters at each epoch's start
    apply_freeze_mask = MT.MultiTask.apply_freeze_mask

    def spy(task, epoch):
        starts.append({n: p.detach().clone() for n, p in task.encoder.named_parameters()})
        return apply_freeze_mask(task, epoch)

    monkeypatch.setattr(MT.MultiTask, "apply_freeze_mask", spy)
    root = workdir / "logs_unfreeze"
    argv = _argv(workdir, "multitask", root, "--unfreeze_epoch_no", "1", "--output_img_freq", "0")
    argv[argv.index("--max_epochs") + 1] = "2"
    fit = cli_multitask.main(argv)
    assert fit.task.unfreeze_epoch_no == 1 and sorted(_losses(root, "multitask")) == [0, 1, 2, 3]
    end = dict(fit.task.encoder.named_parameters())
    assert len(starts) == 2 and all(torch.equal(v, starts[1][n]) for n, v in starts[0].items())
    assert all(not torch.equal(end[n], starts[1][n]) for n in ("c1.weight", "c3.weight", "fc_z_out.weight"))
    args = _parser(MT.MultiTask.add_model_specific_args).parse_args(["--unfreeze_epoch_no", "0"])
    assert MT.MultiTask(dict(vars(args), **{"ae_hidden_dim": 8, "ae_latent_dim": 4, "ae_input_height": 64,
                                            "ae_input_width": 468, "pretrained_path": None}),
                        device="cpu").unfreeze_epoch_no == 20


def test_the_jax_package_restores_a_c3_only_checkpoint(workdir, monkeypatch):
    monkeypatch.setenv("DD_NO_TB", "1")
    root = workdir / "logs_c3"
    fit = cli_spatial_bb.main(_argv(workdir, "spatial_bb", root, "--output_img_freq", "0"))
    port = load_task_ckpt(fit.last_ckpt_path, device="cpu")
    assert type(port) is SB.BBSpatialModel
    jtask, params, state = jax_load_task_ckpt(fit.last_ckpt_path, None, {"spatial_bb": JSB.BBSpatialModel})
    assert set(params["encoder"]) == {"c1", "c2", "c3"}
    images = np.random.RandomState(0).randint(0, 256, (2, 6, *VIEW_HW, 3)).astype(np.uint8)
    got = port.predict(torch.from_numpy(images))
    ref = jax.jit(jtask.predict)(params, state, jnp.asarray(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

"""cli.faster_rcnn of driving_dirty_tpu_torch on the CPU, and detection
checkpoints across the two packages.

  * every flag of the JAX CLI (trainer flags + the model's, both variants)
    parses here with the same default; the port adds --device (default
    cuda);
  * cli.faster_rcnn --variant rm and --variant plain train on the
    synthetic dataset (data/synthetic.py, views resized to 64 x 78 and
    road maps to a 32-px layout image: the `image_size` hparam, which
    both packages read and neither CLI exposes, set as the parser's
    default) over a pretrained BasicAE checkpoint with --device cpu:
    finite losses, a validation with the
    eval-mode losses and the box metrics; the encoder bit-equal to the
    pretrained one while frozen and moved once --unfreeze_epoch_no lets it
    train (epoch 1);
  * param_layouts of both detection tasks follow the JAX params tree, so
    the optimizer's leaves travel in the JAX trainer's order;
  * a faster_rcnn_rm run crossing the packages both ways:
    tests/test_torch_port_det_resume.py (it shares this file's dataset).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import argparse
import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from driving_dirty_tpu.cli.common import add_trainer_args as jax_trainer_args
from driving_dirty_tpu.models import faster_rcnn as JF
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import param_layouts
from driving_dirty_tpu_torch.cli import faster_rcnn as cli_faster_rcnn
from driving_dirty_tpu_torch.cli.common import add_trainer_args
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.export import save_task_ckpt
from driving_dirty_tpu_torch.models import faster_rcnn as TF
from driving_dirty_tpu_torch.models.basic_ae import BasicAE

from test_torch_port_box_resume import resize_views

VIEW_HW = (64, 78)
SIZE = 32  # the layout image and road map side
SAMPLES, SCENES = 4, 3
VARIANTS = {"plain": (TF.BBFasterRCNN, JF.BBFasterRCNN), "rm": (TF.FasterRCNNRoadMap, JF.FasterRCNNRoadMap)}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny pretrained BasicAE checkpoint and a synthetic labeled dataset
    of 64 x 78 views and 32-px road maps."""
    d = tmp_path_factory.mktemp("det_cli")
    ae = BasicAE(dict(hidden_dim=8, latent_dim=8, input_height=VIEW_HW[0], input_width=6 * VIEW_HW[1],
                      output_height=VIEW_HW[0], output_width=VIEW_HW[1]), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    save_task_ckpt(d / "ae.ckpt", ae)
    generate(str(d / "data"), scenes=0, samples=SAMPLES, labeled_scenes=SCENES, seed=0)
    resize_views(d / "data", VIEW_HW)
    for path in glob.glob(str(d / "data" / "scene_*" / "sample_*" / "ego.png")):
        with Image.open(path) as im:
            im.resize((SIZE, SIZE), Image.NEAREST).save(path)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _records(root, task):
    out = []
    for path in sorted(glob.glob(os.path.join(root, task, "version_*", "tb", "metrics.jsonl"))):
        with open(path) as f:
            out += [json.loads(line) for line in f]
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_every_jax_flag_parses_with_its_default(variant):
    port_cls, jax_cls = VARIANTS[variant]
    port = port_cls.add_model_specific_args(add_trainer_args(argparse.ArgumentParser()))
    ref = jax_cls.add_model_specific_args(jax_trainer_args(argparse.ArgumentParser()))
    missing = set(ref._option_string_actions) - set(port._option_string_actions)
    assert not missing, f"{variant}: the port's CLI lacks {sorted(missing)}"
    got, want = vars(port.parse_args([])), vars(ref.parse_args([]))
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"
    assert got["output_img_freq"] == (100 if variant == "rm" else 500)


@pytest.fixture
def small_layout(monkeypatch):
    """The CLIs' parsers default image_size to SIZE (the 800-px layout image
    is slow on the CPU)."""
    for cls, _ in VARIANTS.values():
        add = cls.add_model_specific_args

        def with_size(parser, add=add):
            add(parser)
            parser.set_defaults(image_size=SIZE)
            return parser

        monkeypatch.setattr(cls, "add_model_specific_args", staticmethod(with_size))


def _argv(workdir, root, *extra):
    return ["--link", str(workdir / "data"), "--pretrained_path", str(workdir / "ae.ckpt"),
            "--rpn_pre_nms_top_n", "200", "--rpn_post_nms_top_n", "32",
            "--box_batch_per_image", "32", "--max_bb", "8", "--samples_per_scene", str(SAMPLES),
            "--num_labeled_scenes", str(SCENES), "--batch_size", "2", "--max_epochs", "2",
            "--limit_train_batches", "2", "--limit_val_batches", "1", "--unfreeze_epoch_no", "1",
            "--log_every_n_steps", "1", "--num_workers", "2", "--seed", "0", "--device", "cpu",
            "--default_root_dir", str(root), *extra]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cli_trains_on_the_cpu(variant, workdir, small_layout, monkeypatch):
    """Two epochs of two steps, the encoder frozen in epoch 0 and trained
    in epoch 1; each epoch validates."""
    monkeypatch.setenv("DD_NO_TB", "1")
    starts = []
    cls = VARIANTS[variant][0]
    apply_freeze_mask = cls.apply_freeze_mask

    def spy(task, epoch):
        starts.append({n: p.detach().clone() for n, p in task.encoder.named_parameters()})
        return apply_freeze_mask(task, epoch)

    monkeypatch.setattr(cls, "apply_freeze_mask", spy)
    root = workdir / f"logs_{variant}"
    fit = cli_faster_rcnn.main(["--variant", variant, *_argv(workdir, root)])
    assert type(fit.task) is cls and fit.stop_reason is None and np.isfinite(fit.best_val_loss)
    assert fit.task.cfg.image_size == SIZE
    recs = _records(root, cls.name)
    losses = {r["step"]: r["train_loss"] for r in recs if "train_loss" in r}
    assert sorted(losses) == [0, 1, 2, 3] and np.isfinite(list(losses.values())).all()
    for name in ("loss_classifier", "loss_box_reg", "loss_objectness", "loss_rpn_box_reg"):
        assert all(np.isfinite(r[f"train_{name}"]) for r in recs if "train_loss" in r)
    val = [r for r in recs if "val_loss" in r]
    assert len(val) == 2
    assert {"val_loss_classifier", "val_loss_objectness", "val_det_kept"} <= set(val[0])
    ae = ckpt_io.load(workdir / "ae.ckpt")["params"]["encoder"]
    assert len(starts) == 2
    for layer in ("c1", "c2", "c3"):
        np.testing.assert_array_equal(starts[1][f"{layer}.weight"].permute(2, 3, 1, 0).numpy(), ae[layer]["w"])
    moved = dict(fit.task.encoder.named_parameters())
    assert not torch.equal(moved["c1.weight"], starts[1]["c1.weight"])
    blob = ckpt_io.load(fit.last_ckpt_path)
    assert blob["meta"]["task"] == cls.name and blob["meta"]["global_step"] == 4
    assert set(blob["params"]) == {"encoder", "head"} | ({"mapper_cnn"} if variant == "rm" else set())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_layouts_follow_the_jax_tree(variant):
    """The optimizer's per-parameter leaves: param_layouts' order and
    shapes are jax.tree.leaves' of the JAX task's params."""
    port_cls, jax_cls = VARIANTS[variant]
    h = dict(pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, image_size=SIZE, rpn_head_dilations="2")
    params, _ = jax.jit(jax_cls(h).init)(jax.random.PRNGKey(0))
    port = port_cls(h, device="cpu")
    paths = [".".join(str(k.key) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    shapes = [np.shape(v) for v in jax.tree.leaves(params)]
    layouts = param_layouts(port)
    names = [n.replace(".weight", ".w").replace(".bias", ".b") for n, _ in layouts]
    assert names == paths
    p = dict(port.named_parameters())
    got = [tuple(p[n].permute(perm).shape) if perm else tuple(p[n].shape) for n, perm in layouts]
    assert got == [tuple(s) for s in shapes]


def test_the_default_device_is_cuda_and_raises_without_a_card(workdir, small_layout):
    """Without --device the CLI trains on CUDA; with no card it raises
    before it trains anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = _argv(workdir, workdir / "logs_cuda")
    del argv[argv.index("--device"):argv.index("--device") + 2]
    for variant in sorted(VARIANTS):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_faster_rcnn.main(["--variant", variant, *argv])

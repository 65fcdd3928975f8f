"""driving_dirty_tpu_torch's Trainer on the CPU: the safety behaviours of
tests/test_trainer_safety.py (the task-level link never replaces a regular
file, resume pruning, the checkpoint writer's hook after the write and its
errors), the stops (max_steps, walltime) and their resumable checkpoint,
profile_dir and cost_flops, debug_nans, what a mesh refuses (a spatial_bb
head conv cut on its input channels, a global batch that does not divide over the data
ranks), and validation over a padded final
batch: its weighted mean over the valid rows equals the mean over the whole
set to float rounding (rtol 1e-6), and the host hook's (value, weight)
pairs are weighted by their weights. A toy task (one Linear layer, 8
training and 5 validation items, batch 2).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
import os

import numpy as np
import pytest
import torch

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.data.pipeline import Loader
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel
from driving_dirty_tpu_torch.parallel import launch
from driving_dirty_tpu_torch.train.task import Task
from driving_dirty_tpu_torch.train.trainer import Trainer, _prune_to_template


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("DD_NO_TB", "1")


class _List:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class Toy(Task, torch.nn.Module):
    """y = w . x on 8 training and 5 validation items of batch 2."""

    name = "toy"

    def __init__(self, nan=False):
        torch.nn.Module.__init__(self)
        Task.__init__(self, {"learning_rate": 1e-2})
        self.w = torch.nn.Linear(3, 1)
        self.nan = nan
        x = np.arange(39, dtype=np.float32).reshape(13, 3) / 10
        self.items = [{"x": v} for v in x]
        self.host_rows = []

    def loss(self, batch, *, train, generator=None):
        loss = torch.mean(self.w(batch["x"]) ** 2)
        return (loss * float("nan") if self.nan else loss), {}

    def val_metrics(self, batch, generator=None):
        return {"val_loss": self.loss(batch, train=False)[0], "val_x": batch["x"].mean()}

    def host_val_metrics(self, batch, bmask):
        self.host_rows.append(int(bmask.sum()))
        # (value, weight): a mean over each batch's first row only
        return {"val_first": (float(batch["x"][0, 0]), 1.0)}

    def train_loader(self):
        return Loader(_List(self.items[:8]), 2, shuffle=True, num_workers=1, drop_last=True)

    def val_loader(self):
        return Loader(_List(self.items[8:]), 2, shuffle=False, num_workers=1)


def test_validation_weights_the_padded_tail_out(tmp_path):
    task = Toy()
    r = Trainer(max_epochs=1, default_root_dir=str(tmp_path), device="cpu",
                enable_progress_bar=False, log_every_n_steps=1).fit(task)
    assert r.stop_reason is None and r.last_ckpt_path and r.best_ckpt_path
    recs = [json.loads(x) for x in open(tmp_path / "toy" / "version_0" / "tb" / "metrics.jsonl")]
    val = next(x for x in recs if "val_x" in x)
    x = np.stack([it["x"] for it in task.items[8:]])
    # 5 items in batches of 2, 2 and 1 (+ a pad copy): the pad is sliced off
    np.testing.assert_allclose(val["val_x"], x.mean(), rtol=1e-6)
    assert task.host_rows == [2, 2, 1]
    np.testing.assert_allclose(val["val_first"], np.mean(x[[0, 2, 4], 0]), rtol=1e-6)


@pytest.mark.parametrize("stop", ["max_steps", "walltime"])
def test_stops_write_a_resumable_checkpoint_and_say_why(stop, tmp_path):
    kw = (dict(max_steps=3) if stop == "max_steps"
          else dict(walltime_minutes=1.0, checkpoint_before_walltime_minutes=1.0))
    r = Trainer(max_epochs=5, default_root_dir=str(tmp_path), device="cpu",
                enable_progress_bar=False, **kw).fit(Toy())
    assert r.stop_reason == ("max_steps=3 reached" if stop == "max_steps" else "walltime budget reached")
    meta = ckpt_io.load(r.last_ckpt_path)["meta"]
    steps = 3 if stop == "max_steps" else 1
    assert (meta["mid_epoch"], meta["global_step"], meta["batch_in_epoch"]) == (True, steps, steps)


def test_profile_dir_traces_steps_from_the_third_and_cost_flops_is_logged(tmp_path, monkeypatch):
    monkeypatch.delenv("DD_NO_COST_ANALYSIS", raising=False)
    Trainer(max_epochs=1, default_root_dir=str(tmp_path), device="cpu", enable_progress_bar=False,
            log_every_n_steps=1, profile_dir=str(tmp_path / "prof")).fit(Toy())
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    recs = [json.loads(x) for x in open(tmp_path / "toy" / "version_0" / "tb" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "cost_flops" in r] == [0]
    assert next(r["cost_flops"] for r in recs if "cost_flops" in r) > 0


def test_debug_nans_raises_on_a_non_finite_loss(tmp_path):
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        Trainer(default_root_dir=str(tmp_path), device="cpu", debug_nans=True,
                enable_progress_bar=False).fit(Toy(nan=True))


def refused_fit(case, root):
    """A rank's fit that the trainer refuses -> the error's type and text:
    spatial_bb with a head conv cut on its input channels over 'model'
    (conv layers run column-parallel only), or a global batch of 3 over 2
    data ranks."""
    if case == "spatial_tp":
        task = BBSpatialModel(dict(ae_hidden_dim=8, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78,
                                   pretrained_path=None, spatial_geometry="small"),
                              device="cpu", generator=torch.Generator().manual_seed(0))
        # ss_conv's HWIO weight cut on its input channels (dim 2)
        task.param_sharding_rules = lambda path, leaf: (
            (None, None, "model", None) if path == ("box_merge", "ss_conv", "w") else None)
        trainer = Trainer(num_devices=2, model_parallel=2, device="cpu", default_root_dir=root,
                          enable_progress_bar=False)
    else:
        task = Toy()
        task.train_loader = lambda: Loader(_List(task.items[:9]), 3, num_workers=1, drop_last=True)
        trainer = Trainer(num_devices=2, device="cpu", default_root_dir=root, enable_progress_bar=False)
    try:
        trainer.fit(task)
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["spatial_tp", "indivisible_batch"])
def test_multi_device_arguments_raise(case, tmp_path, monkeypatch):
    """What the mesh refuses, on every rank of a 2-rank world (parallel/
    launch.py): a spatial head's conv cut on its input channels (the
    heads' convs run column-parallel, cut on their output channels, as the
    JAX rules cut them), and a training global batch that does not divide
    over the data ranks raises, as the JAX package's device_put would."""
    monkeypatch.setenv("DD_NO_COST_ANALYSIS", "1")
    got = launch.spawn(refused_fit, 2, (case, str(tmp_path)), device="cpu", threads=1,
                       init_method=f"file://{tmp_path}/rdzv")
    want = (("NotImplementedError", "box_merge.ss_conv: weight on dim 1 with the bias whole is not a parallel Conv2d")
            if case == "spatial_tp" else ("ValueError", "does not divide over 2"))
    for kind, text in got:
        assert kind == want[0] and want[1] in text, (kind, text)


def test_link_latest_preserves_a_regular_file_and_replaces_links(tmp_path):
    task_dir = tmp_path / "roadmap_bce"
    for v in (0, 1):
        (task_dir / f"version_{v}").mkdir(parents=True)
        (task_dir / f"version_{v}" / "last.ckpt").write_bytes(b"%d" % v)
    Trainer._link_latest(str(task_dir / "version_0"), "last.ckpt")
    Trainer._link_latest(str(task_dir / "version_1"), "last.ckpt")
    assert os.path.islink(task_dir / "last.ckpt") and (task_dir / "last.ckpt").read_bytes() == b"1"
    (task_dir / "best.ckpt").write_bytes(b"precious")  # an older layout's real checkpoint
    Trainer._link_latest(str(task_dir / "version_1"), "best.ckpt")
    assert not os.path.islink(task_dir / "best.ckpt")
    assert (task_dir / "best.ckpt").read_bytes() == b"precious"


def test_prune_to_template_drops_extra_and_raises_on_missing():
    template = {"encoder": {"c1": 0, "c2": 0}, "head": {"w": 0}}
    out, pruned = _prune_to_template({"encoder": {"c1": 1, "c2": 2, "fc1": {"w": 3}}, "head": {"w": 4}},
                                     template, "t")
    assert out == {"encoder": {"c1": 1, "c2": 2}, "head": {"w": 4}} and pruned == {"encoder/fc1"}
    with pytest.raises(ValueError, match="missing"):
        _prune_to_template({"encoder": {"c1": 1}}, template, "t")


def test_async_writer_hook_runs_after_the_write_and_errors_surface(tmp_path):
    w = ckpt_io.AsyncWriter()
    path = str(tmp_path / "x.ckpt")
    seen = {}
    t = torch.zeros(3)
    w.save(path, params={"a": t}, hparams={}, meta={}, on_written=lambda: seen.update(existed=os.path.exists(path)))
    t.add_(1)  # the snapshot was taken at save()
    w.wait()
    assert seen == {"existed": True}
    assert ckpt_io.load(path)["params"]["a"].tolist() == [0, 0, 0]
    w.save(str(tmp_path / "missing" / "\0bad"), params={"a": t})
    with pytest.raises(ValueError):
        w.wait()
    w.close()

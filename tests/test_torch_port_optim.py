"""The port's Trainer optimizer against the JAX Trainer's optax chain, on the
CPU: one toy task (two Linear layers, tanh between them, MSE) in both
packages, the same weights and the same in-memory data and order, fit by
driving_dirty_tpu.train.trainer.Trainer and by
driving_dirty_tpu_torch.train.trainer.Trainer. Held: the loss of every step
(which is the loss after each step's update), the final parameters, and
every leaf of the final optimizer state in the checkpoints both trainers
write (count, injected hyperparameters, Adam mu and nu, MultiSteps'
mini_step, gradient_step and accumulated gradients), for plain Adam,
clipping with the global norm above and below the threshold, accumulation
over 2 and 3 micro-batches, a plateau LR drop, and freeze staging across an
unfreeze (the encoder frozen in epoch 0: with a per-parameter Adam count
its first update would use bias correction t = 1 where optax uses t = 4).

Tolerances: losses and parameters rtol 1e-5 of the largest value, optimizer
leaves rtol 1e-5 of each leaf's largest value (plus 1e-12 for all-zero
leaves), integer leaves exact. Both run f32 on 4 x 3 and 3 x 2 matrices,
where XLA and ATen differ by a few f32 ulps a step, and the gradients are
far from float noise, so Adam does not amplify them: measured at most
7.6e-7 on any loss or leaf. A wrong bias correction, clip or accumulation
rule is off by 1e-2 or more; even rounding 1 - b2 in the other precision
(optax takes it in f32 for plain Adam and in double under clipping, 1.3e-5
apart) shows as 1-4e-5.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.data.pipeline import Loader as JLoader
from driving_dirty_tpu.train.task import Task as JTask
from driving_dirty_tpu.train.trainer import Trainer as JTrainer
from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.data.pipeline import Loader
from driving_dirty_tpu_torch.train.task import Task
from driving_dirty_tpu_torch.train.trainer import Trainer

RTOL = 1e-5
LR = 0.05
N_TRAIN, N_VAL, BATCH = 12, 4, 2


def _data():
    rng = np.random.RandomState(3)
    x = rng.randn(N_TRAIN + N_VAL, 4).astype(np.float32)
    y = np.stack([np.sin(x[:, 0] + x[:, 1]), x[:, 2] * x[:, 3]], 1).astype(np.float32)
    items = [{"x": x[i], "y": y[i]} for i in range(len(x))]
    return items[:N_TRAIN], items[N_TRAIN:]


def _weights():
    rng = np.random.RandomState(5)
    return {"enc": {"w": rng.randn(4, 3).astype(np.float32) * 0.5, "b": rng.randn(3).astype(np.float32) * 0.1},
            "head": {"w": rng.randn(3, 2).astype(np.float32) * 0.5, "b": rng.randn(2).astype(np.float32) * 0.1}}


class _List:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class JToy(JTask):
    name = "toy"

    def __init__(self, h):
        super().__init__(h)
        self.train_items, self.val_items = _data()

    def init(self, rng):
        return jax.tree.map(jnp.asarray, _weights()), {}

    def loss(self, params, state, batch, rng, *, train):
        h = jnp.tanh(batch["x"] @ params["enc"]["w"] + params["enc"]["b"])
        y = h @ params["head"]["w"] + params["head"]["b"]
        return jnp.mean((y - batch["y"]) ** 2), (state, {})

    def val_metrics(self, params, state, batch, rng):
        loss, _ = self.loss(params, state, batch, rng, train=False)
        return {"val_loss": 1.0 + 0.0 * loss if self.hparams.flat_val else loss}

    def lr_schedule(self):
        return {"plateau_patience": 0, "factor": 0.5} if self.hparams.flat_val else None

    def freeze_mask(self, params, epoch):
        if epoch >= self.hparams.unfreeze_epoch_no:
            return None
        return {"enc": jax.tree.map(lambda _: False, params["enc"]),
                "head": jax.tree.map(lambda _: True, params["head"])}

    def train_loader(self):
        return JLoader(_List(self.train_items), BATCH, shuffle=True, num_workers=1, drop_last=True)

    def val_loader(self):
        return JLoader(_List(self.val_items), BATCH, shuffle=False, num_workers=1)


class Toy(Task, torch.nn.Module):
    name = "toy"

    def __init__(self, h):
        torch.nn.Module.__init__(self)
        Task.__init__(self, h)
        self.train_items, self.val_items = _data()
        w = _weights()
        self.enc, self.head = torch.nn.Linear(4, 3), torch.nn.Linear(3, 2)
        with torch.no_grad():
            for layer, p in ((self.enc, w["enc"]), (self.head, w["head"])):
                layer.weight.copy_(torch.from_numpy(p["w"].T.copy()))
                layer.bias.copy_(torch.from_numpy(p["b"]))

    def loss(self, batch, *, train, generator=None):
        y = self.head(torch.tanh(self.enc(batch["x"])))
        return torch.mean((y - batch["y"]) ** 2), {}

    def val_metrics(self, batch, generator=None):
        loss, _ = self.loss(batch, train=False)
        return {"val_loss": torch.ones(()) if self.hparams.flat_val else loss}

    def lr_schedule(self):
        return {"plateau_patience": 0, "factor": 0.5} if self.hparams.flat_val else None

    def freeze_mask(self, epoch):
        if epoch >= self.hparams.unfreeze_epoch_no:
            return None
        return {n: not n.startswith("enc.") for n, _ in self.named_parameters()}

    def train_loader(self):
        return Loader(_List(self.train_items), BATCH, shuffle=True, num_workers=1, drop_last=True)

    def val_loader(self):
        return Loader(_List(self.val_items), BATCH, shuffle=False, num_workers=1)


def _losses(root):
    with open(os.path.join(root, "toy", "version_0", "tb", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["train_loss"] for r in recs if "train_loss" in r}


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.dtype.kind in "iu":
        assert got.dtype.kind in "iu" and np.array_equal(got, ref), (what, got, ref)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    tol = RTOL * np.abs(ref).max() + 1e-12
    assert np.abs(got - ref).max() <= tol, (what, np.abs(got - ref).max(), tol)


CASES = {
    "adam": dict(),
    "clip_above": dict(gradient_clip_val=1e-3),      # the global norm is always above: scaled
    "clip_below": dict(gradient_clip_val=1e3),       # never above: untouched
    "accumulate_2": dict(accumulate_grad_batches=2),
    "accumulate_3": dict(accumulate_grad_batches=3, max_epochs=3),
    "plateau": dict(flat_val=True, max_epochs=3),
    "unfreeze": dict(unfreeze_epoch_no=1),
    "unfreeze_clip_accumulate": dict(unfreeze_epoch_no=1, gradient_clip_val=1e-2, accumulate_grad_batches=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_updates_match_optax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("DD_NO_TB", "1")
    monkeypatch.setenv("DD_NO_COST_ANALYSIS", "1")
    kw = dict(CASES[case])
    h = dict(learning_rate=LR, output_img_freq=0, flat_val=kw.pop("flat_val", False),
             unfreeze_epoch_no=kw.pop("unfreeze_epoch_no", 0))
    common = dict(max_epochs=kw.pop("max_epochs", 2), limit_train_batches=3, log_every_n_steps=1,
                  enable_progress_bar=False, seed=11, **kw)
    ja = JTrainer(default_root_dir=str(tmp_path / "jax"), **common).fit(JToy(SimpleNamespace(**h)))
    pt = Trainer(default_root_dir=str(tmp_path / "port"), device="cpu", **common).fit(Toy(h))

    ref_losses, got_losses = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert sorted(got_losses) == sorted(ref_losses) == list(range(3 * common["max_epochs"]))
    _close([got_losses[s] for s in sorted(ref_losses)], [ref_losses[s] for s in sorted(ref_losses)], "losses")

    ref, got = ckpt_io.load(ja.last_ckpt_path), ckpt_io.load(pt.last_ckpt_path)
    for layer in ("enc", "head"):
        for k in ("w", "b"):
            _close(got["params"][layer][k], ref["params"][layer][k], f"{layer}.{k}")
    assert len(got["opt_state"]) == len(ref["opt_state"])
    for i, (g, r) in enumerate(zip(got["opt_state"], ref["opt_state"])):
        _close(g, r, f"opt_state leaf {i}")
    assert got["meta"]["trainer_state"] == pytest.approx(ref["meta"]["trainer_state"], rel=1e-6)
    if case == "plateau":  # halved after each epoch that did not improve: 0.05 -> 0.025 -> 0.0125
        assert got["meta"]["trainer_state"]["lr"] == pytest.approx(LR / 4)
    if case.startswith("unfreeze"):
        # the encoder did not move in the frozen epoch, and moved after
        assert got["opt_state"] and not np.array_equal(got["params"]["enc"]["w"], _weights()["enc"]["w"])

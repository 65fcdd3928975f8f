"""The task protocol, and hparam access shared by every task.

A Task owns its architecture and data and reads its settings from hparams
(a dict or a namespace, as stored in checkpoints). In this package a task is
also an nn.Module that owns its weights, so the methods take batches, not
parameter pytrees (driving_dirty_tpu/train/task.py:45-101). The trainer
(train/trainer.py) owns optimization, checkpoints and logging.

A task may also define `step_variant(global_step)`: the trainer calls it
before every training step, for tasks that switch behaviour by step.
"""
from __future__ import annotations

from types import SimpleNamespace


def hp(hparams, name, default):
    """Hparam with attribute-default fallback, reproducing the reference's
    `__check_hparams` pattern (src/autoencoder/autoencoder.py:32-43)."""
    if hparams is None:
        return default
    if isinstance(hparams, dict):
        return hparams.get(name, default)
    return getattr(hparams, name, default)


def hp_opt(hparams, name, default):
    """Like `hp` but treats a stored None as absent — for flags whose
    argparse default is None so each task can pick its own default."""
    v = hp(hparams, name, None)
    return default if v is None else v


def as_namespace(hparams) -> SimpleNamespace:
    if hparams is None:
        return SimpleNamespace()
    if isinstance(hparams, SimpleNamespace):
        return hparams
    if isinstance(hparams, dict):
        return SimpleNamespace(**hparams)
    return SimpleNamespace(**vars(hparams))


class Task:
    """Protocol; subclass and override. See models/ for implementations."""

    #: name used for checkpoints/logs and the submit registry
    name: str = "task"

    def __init__(self, hparams=None):
        self.hparams = as_namespace(hparams)

    # --- model -----------------------------------------------------------
    def loss(self, batch, *, train: bool, generator=None):
        """-> (loss_scalar, metrics_dict); random draws from `generator`."""
        raise NotImplementedError

    def val_metrics(self, batch, generator=None):
        """-> metrics dict including 'val_loss'. Default: eval-mode loss,
        its random draws (if any) from `generator`."""
        loss, metrics = self.loss(batch, train=False, generator=generator)
        out = {"val_loss": loss}
        out.update({f"val_{k}": v for k, v in metrics.items() if k != "loss"})
        return out

    # --- optimization ----------------------------------------------------
    def learning_rate(self) -> float:
        return hp(self.hparams, "learning_rate", 1e-3)

    def optimizer_name(self) -> str:
        return "adam"

    def lr_schedule(self):
        """None, or dict(plateau_patience=int, factor=float) for
        ReduceLROnPlateau-style scheduling
        (the reference's src/roadmap_model/roadmap_bce_v2.py:156)."""
        return None

    def freeze_mask(self, epoch: int):
        """{parameter name: trainable} for staged fine-tuning, or None
        (everything trains)."""
        return None

    def apply_freeze_mask(self, epoch: int):
        """Set requires_grad from freeze_mask(epoch); -> the mask. A frozen
        parameter gets no gradient, which train/optim.py:Adam reads as
        optax's exact-zero gradient: it and its zero moments stay as they
        are, as the JAX step's stop_gradient leaves them. BatchNorm running
        statistics of frozen layers still move in training mode, as the JAX
        step's model state does."""
        mask = self.freeze_mask(epoch)
        for name, p in self.named_parameters():
            p.requires_grad_(mask is None or mask[name])
        return mask

    # --- data ------------------------------------------------------------
    def train_loader(self):
        raise NotImplementedError

    def val_loader(self):
        raise NotImplementedError

    # --- logging ---------------------------------------------------------
    def log_images(self, batch, step_name: str, generator=None):
        """Optional: {name: [H, W, C] image in [0, 1]} for the image logger."""
        return {}

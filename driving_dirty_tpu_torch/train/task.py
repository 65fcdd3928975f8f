"""The task protocol, and hparam access shared by every task.

A Task owns its architecture and data and reads its settings from hparams
(a dict or a namespace, as stored in checkpoints). In this package a task is
also an nn.Module that owns its weights, so the methods take batches, not
parameter pytrees.
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
    def loss(self, batch, *, train: bool):
        """-> (loss_scalar, metrics_dict)."""
        raise NotImplementedError

    def val_metrics(self, batch):
        """-> metrics dict including 'val_loss'. Default: eval-mode loss."""
        loss, metrics = self.loss(batch, train=False)
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

    # --- data ------------------------------------------------------------
    def train_loader(self):
        raise NotImplementedError

    def val_loader(self):
        raise NotImplementedError

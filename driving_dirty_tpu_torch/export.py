"""Checkpoint entry of the box families (driving_dirty_tpu/export.py:
196-282, the restore half).

`load_task_ckpt` rebuilds a spatial_bb, spatial_rm, multitask, faster_rcnn
or faster_rcnn_rm model from a framework `.ckpt` (either package writes
them) by its `meta["task"]`, ready for `predict` and `val_metrics` (the
detection tasks: `host_val_metrics`); `save_task_ckpt` writes one.
Exporting a `.ddx` serving artifact (`export_spatial`, `export_multitask`,
`export_detection`, `Served`) waits for the export/serve slice (ROADMAP
A.12).
"""
from __future__ import annotations

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights, model_to_jax
from driving_dirty_tpu_torch.core.device import resolve_device
from driving_dirty_tpu_torch.models.faster_rcnn import BBFasterRCNN, FasterRCNNRoadMap
from driving_dirty_tpu_torch.models.multitask import MultiTask
from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap

BOX_TASKS = {cls.name: cls for cls in (BBSpatialModel, BBSpatialRoadMap, MultiTask)}
DETECTION_TASKS = {cls.name: cls for cls in (BBFasterRCNN, FasterRCNNRoadMap)}
TASKS = {**BOX_TASKS, **DETECTION_TASKS}


def load_task_ckpt(ckpt_path, precision=None, classes=None, device=None, default_task=None):
    """Framework .ckpt -> the model its `meta["task"]` names (`default_task`
    when it names none), one of `classes` (name -> class; default every box
    and detection task), on `device` (default cuda), in eval mode with no
    gradients. `precision` overrides the checkpoint's (32, 16 or 8; at 8 the
    model's `predict` calibrates its int8 trunk on its first batch)."""
    classes = TASKS if classes is None else classes
    device = resolve_device(device)
    blob = ckpt_io.load(ckpt_path, opt_state=False)
    task_name = blob["meta"].get("task", default_task)
    if task_name not in classes:
        raise ValueError(f"checkpoint task {task_name!r} is not one of {sorted(classes)}")
    if not blob["params"]:
        raise ValueError(f"{ckpt_path}: no params — not a framework checkpoint")
    hparams = dict(blob["hparams"] or {})
    hparams.setdefault("pretrained_path", None)
    if precision is not None:
        hparams["precision"] = precision
    model = classes[task_name](hparams, device=device)
    load_jax_weights(model, blob["params"], blob["state"], what=str(ckpt_path))
    return model.eval().requires_grad_(False)


def save_task_ckpt(path, model):
    """Write `model` (weights in the JAX layouts, its hparams, meta["task"])
    as a framework .ckpt that either package loads."""
    params, state = model_to_jax(model)
    return ckpt_io.save(path, params=params, state=state, hparams=model.hparams,
                        meta={"task": model.name})

"""Checkpoints of the box families and serving artifacts
(driving_dirty_tpu/export.py).

`load_task_ckpt` rebuilds a spatial_bb, spatial_rm, multitask, faster_rcnn
or faster_rcnn_rm model from a framework `.ckpt` (either package writes
them) by its `meta["task"]`, ready for `predict` and `val_metrics` (the
detection tasks: `host_val_metrics`); `save_task_ckpt` writes one.

The exporters package a checkpointed model's `predict` as a `.ddx`
artifact that serves with no model code:

    .ddx file = zip archive of
      program.pt2   torch.export.save of the program
                    (params in name order..., *inputs) -> outputs, traced
                    at fixed input specs on one device type; the kernels
                    appear in it as the torch.library ops of kernels/ops.py
      params.npz    the params under the JAX package's '/'-joined names
                    and in its layouts (checkpoints/convert.py)
      meta.json     the JAX artifact's fields (task, batch_size, precision,
                    output, inputs, param_names, state_digest,
                    format_version) and framework "torch", the device type
                    it was traced for, and each param's permutation from
                    the JAX layout to the program's

The model STATE (BatchNorm statistics, int8 scales) is baked into the
program as constants; PARAMS are inputs, so a re-fine-tuned checkpoint of
the same shapes swaps in without re-exporting (`Served.swap_params`).

`export_roadmap` (6 camera views -> 800x800 road mask), `export_detection`
(views [+ road map for the rm variant] -> fixed-shape detections),
`export_spatial` (-> occupancy probabilities) and `export_multitask`
(-> road mask and box occupancy) trace on the model's device. `load(path)`
-> a `Served` handle on the device type the program was traced for; it
imports no model module, only the ops (kernels/ops.py). cli/serve.py
drives it one-shot over an .npz of scenes or as an HTTP batch server.
"""
from __future__ import annotations

import hashlib
import io as _io
import json
import zipfile

import numpy as np
import torch

__all__ = ["export_roadmap", "export_detection", "export_spatial", "export_multitask",
           "load", "Served", "FORMAT_VERSION", "load_task_ckpt", "save_task_ckpt"]

FORMAT_VERSION = 2  # the JAX artifact's: named input specs (meta['inputs']) + pytree outputs
IMAGES_SPEC = {"name": "images", "shape": [6, 256, 306, 3], "dtype": "float32", "uint8_scale": True}
ROAD_SPEC = {"name": "road", "shape": [800, 800], "dtype": "float32"}


def _task_classes():
    from driving_dirty_tpu_torch.models.faster_rcnn import BBFasterRCNN, FasterRCNNRoadMap
    from driving_dirty_tpu_torch.models.multitask import MultiTask
    from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap

    box = {cls.name: cls for cls in (BBSpatialModel, BBSpatialRoadMap, MultiTask)}
    det = {cls.name: cls for cls in (BBFasterRCNN, FasterRCNNRoadMap)}
    return {"BOX_TASKS": box, "DETECTION_TASKS": det, "TASKS": {**box, **det}}


def __getattr__(name):
    # BOX_TASKS, DETECTION_TASKS, TASKS: the task classes by name, imported
    # on first use so that `load` and `Served` import no model module
    if name in ("BOX_TASKS", "DETECTION_TASKS", "TASKS"):
        return _task_classes()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def load_task_ckpt(ckpt_path, precision=None, classes=None, device=None, default_task=None):
    """Framework .ckpt -> the model its `meta["task"]` names (`default_task`
    when it names none), one of `classes` (name -> class; default every box
    and detection task), on `device` (default cuda), in eval mode with no
    gradients. `precision` overrides the checkpoint's (32, 16 or 8; at 8 the
    model's `predict` calibrates its int8 trunk on its first batch)."""
    from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
    from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights
    from driving_dirty_tpu_torch.core.device import resolve_device

    classes = _task_classes()["TASKS"] if classes is None else classes
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
    from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
    from driving_dirty_tpu_torch.checkpoints.convert import model_to_jax

    params, state = model_to_jax(model)
    return ckpt_io.save(path, params=params, state=state, hparams=model.hparams,
                        meta={"task": model.name})


# ---------------------------------------------------------------------------
# Serving artifacts
# ---------------------------------------------------------------------------

def _flat_params(params, sort=True):
    """Deterministic (name, leaf) list of a params pytree of nested dicts
    ('/'-joined paths, as checkpoints/io.py names them). Sorted by name =
    the argument order of the exported program; unsorted = the JAX tree
    flatten order (keys sorted at every level)."""
    named = []

    def walk(tree, prefix):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                named.append((f"{prefix}{k}", v))

    walk(params, "")
    if sort:
        named.sort(key=lambda kv: kv[0])
    return named


def _state_digest(state) -> str:
    """Order-stable digest of a model-state pytree (BN statistics), the JAX
    package's: stored in the artifact's meta so that a weight swap can see
    that the incoming checkpoint was fine-tuned past the baked state."""
    h = hashlib.sha1()
    for name, leaf in _flat_params(state or {}):
        h.update(name.encode())
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


def _inverse(perm):
    return None if perm is None else [int(i) for i in np.argsort(perm)]


class _Predict(torch.nn.Module):
    """forward(*inputs) = model.predict(*inputs)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *inputs):
        return self.model.predict(*inputs)


class _Program(torch.nn.Module):
    """The traced program: forward(*params, *inputs) runs model.predict with
    the params taken from the arguments (torch.func.functional_call). The
    model is not a submodule, so its params are no program state; its
    buffers (the state) are registered here and baked in."""

    def __init__(self, model, param_names):
        super().__init__()
        object.__setattr__(self, "_predict", _Predict(model))
        self._param_names = list(param_names)
        self._buffer_names = []
        for i, (name, buf) in enumerate(model.named_buffers()):
            self.register_buffer(f"state_{i}", buf)
            self._buffer_names.append(name)

    def forward(self, *args):
        n = len(self._param_names)
        weights = {f"model.{k}": v for k, v in zip(self._param_names, args[:n])}
        weights.update({f"model.{k}": getattr(self, f"state_{i}")
                        for i, k in enumerate(self._buffer_names)})
        return torch.func.functional_call(self._predict, weights, tuple(args[n:]))


def _export_artifact(model, input_specs, out_path, meta):
    """Trace `model.predict` at the input specs on the model's device,
    serialize it, and zip it with the params (JAX names and layouts) and
    the meta. Returns the meta."""
    from driving_dirty_tpu_torch.checkpoints.convert import host_array, param_places

    places = param_places(model)
    by_name = dict(model.named_parameters())
    device = next(iter(by_name.values())).device
    params = [by_name[torch_name].detach() for _, torch_name, _ in places]
    inputs = [torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]), device=device)
              for s in input_specs]
    model.eval()
    with torch.no_grad():
        program = torch.export.export(_Program(model, [t for _, t, _ in places]),
                                      (*params, *inputs), strict=False)
    meta = dict(meta)
    meta.update(format_version=FORMAT_VERSION, framework="torch", device=device.type,
                param_names=[n for n, _, _ in places],
                param_layouts=[_inverse(perm) for _, _, perm in places],
                inputs=input_specs)
    program.example_inputs = None  # torch.export.save would store them: the params again
    buf = _io.BytesIO()
    torch.export.save(program, buf)
    npz = _io.BytesIO()
    np.savez(npz, **{n: host_array(by_name[t], perm) for n, t, perm in places})
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        z.writestr("program.pt2", buf.getvalue())
        z.writestr("params.npz", npz.getvalue())
        z.writestr("meta.json", json.dumps(meta, indent=1))
    return meta


def _specs(batch_size, with_road):
    specs = [dict(IMAGES_SPEC, shape=[batch_size, *IMAGES_SPEC["shape"]])]
    if with_road:
        specs.append(dict(ROAD_SPEC, shape=[batch_size, *ROAD_SPEC["shape"]]))
    return specs


def _model_state_digest(model):
    """`_state_digest` of the model's state in the JAX layout: its BatchNorm
    statistics, named as the JAX package's state tree names them."""
    from driving_dirty_tpu_torch.checkpoints.convert import to_jax

    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return _state_digest(to_jax(stats)[1])


def _precision(model, precision):
    from driving_dirty_tpu_torch.train.task import hp

    return precision or int(hp(model.hparams, "precision", 32) or 32)


def _calibrate(model, device, images, road=None, what="calibration images"):
    """Calibrate a precision-8 model's static int8 scales on the given batch
    before tracing (the traced program then has no calibration branch); an
    int8 export without one raises."""
    if not model.int8_trunk:
        return
    if images is None:
        raise ValueError(f"--precision 8 export needs {what} (the static activation scales "
                         f"become program constants); pass them")
    images = torch.as_tensor(np.asarray(images), device=device)
    if road is None:
        model.calibrate_int8(images)
    else:
        model.calibrate_int8(images, torch.as_tensor(np.asarray(road), device=device))


def export_roadmap(ckpt_path, out_path, *, batch_size=1, precision=None, device=None,
                   calib_images=None):
    """Export a roadmap checkpoint (framework .ckpt or the reference's
    Lightning rm.ckpt) to a .ddx artifact traced on `device` (default cuda):
    images [b, 6, 256, 306, 3] -> mask [b, 800, 800]. Precision 8 needs
    `calib_images` (a [b, 6, 256, 306, 3] sample) so that the static int8
    scales bake into the program. Returns the meta dict."""
    from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model

    model = load_roadmap_model(ckpt_path, precision, device)
    _calibrate(model, next(model.parameters()).device, calib_images)
    return _export_artifact(model, _specs(batch_size, False), out_path,
                            {"task": model.name, "batch_size": batch_size,
                             "precision": _precision(model, precision),
                             "output": "mask_800x800_float01",
                             "state_digest": _model_state_digest(model)})


def export_detection(ckpt_path, out_path, *, batch_size=1, precision=None, device=None, calib=None):
    """Export a detection checkpoint (faster_rcnn / faster_rcnn_rm) to a
    .ddx artifact: images [b, 6, 256, 306, 3] (+ road [b, 800, 800] for the
    rm variant) -> fixed-shape detections {boxes [b, N, 4] pixel xyxy,
    scores [b, N], labels [b, N], valid [b, N]}. Precision 8 needs `calib`
    ({"images", "road"}: one batch)."""
    from driving_dirty_tpu_torch.cli.eval_boxes import load_detection_task

    model = load_detection_task(ckpt_path, precision, device)
    # the anchors, built now on the model's device, enter the program as a
    # device constant; built inside the trace they would be a host constant
    # copied to the device on every request (38 MB at the default config)
    model.head.anchors(next(model.parameters()).device)
    calib = calib or {}
    _calibrate(model, next(model.parameters()).device, calib.get("images"),
               calib.get("road") if model.uses_roadmap else None, "a calibration batch")
    return _export_artifact(model, _specs(batch_size, model.uses_roadmap), out_path,
                            {"task": model.name, "batch_size": batch_size,
                             "precision": _precision(model, precision),
                             "output": "detections_pixel_xyxy",
                             "state_digest": _model_state_digest(model)})


def export_spatial(ckpt_path, out_path, *, batch_size=1, precision=None, device=None,
                   calib_images=None):
    """Export a spatial occupancy checkpoint (spatial_bb / spatial_rm) to a
    .ddx artifact: images [b, 6, 256, 306, 3] (+ road [b, 800, 800] for the
    rm variant) -> occupancy probabilities [b, 800, 800]."""
    classes = _task_classes()["BOX_TASKS"]
    model = load_task_ckpt(ckpt_path, precision, {k: classes[k] for k in ("spatial_bb", "spatial_rm")},
                           device)
    _calibrate(model, next(model.parameters()).device, calib_images)
    return _export_artifact(model, _specs(batch_size, model.uses_roadmap), out_path,
                            {"task": model.name, "batch_size": batch_size,
                             "precision": _precision(model, precision),
                             "output": "occupancy_800x800_prob",
                             "state_digest": _model_state_digest(model)})


def export_multitask(ckpt_path, out_path, *, batch_size=1, precision=None, device=None,
                     calib_images=None):
    """Export a multitask checkpoint to a .ddx artifact: images [b, 6, 256,
    306, 3] -> {road_mask [b, 800, 800] binary, box_occupancy [b, 800, 800]
    probabilities} from one shared encoder pass."""
    model = load_task_ckpt(ckpt_path, precision,
                           {"multitask": _task_classes()["BOX_TASKS"]["multitask"]}, device)
    _calibrate(model, next(model.parameters()).device, calib_images)
    return _export_artifact(model, _specs(batch_size, False), out_path,
                            {"task": model.name, "batch_size": batch_size,
                             "precision": _precision(model, precision),
                             "output": "road_mask_and_box_occupancy_800x800",
                             "state_digest": _model_state_digest(model)})


class Served:
    """A loaded .ddx artifact: `__call__(*inputs)` runs the exported program
    (torch.export.load's module) with no model code. The params live on the
    device once, in the program's layouts; they are made outside inference
    mode, so the trunk's kernel-weight cache keeps them (kernels/trunk.py:
    cached_layout)."""

    def __init__(self, program, param_arrays, meta, device):
        self._program = program
        self.meta = meta
        self.device = torch.device(device)
        self.batch_size = int(meta["batch_size"])
        self._params = self._to_device(param_arrays)

    @property
    def input_specs(self):
        return self.meta["inputs"]

    def _to_device(self, arrays):
        out = []
        for a, perm in zip(arrays, self.meta["param_layouts"]):
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)
            out.append(t if perm is None else t.permute(perm).contiguous())
        return out

    def swap_params(self, params_pytree, state=None, force=False):
        """Replace the serving weights with a same-shaped params pytree (a
        framework .ckpt's "params", from either package; JAX names and
        layouts) without re-exporting.

        The program BAKES the model state (BN statistics, int8 scales):
        weights can swap, state cannot. Pass the new checkpoint's `state`
        so that a drifted state is seen: if its digest differs from the one
        baked at export, the swap is refused unless force=True."""
        if state is not None and not force:
            baked = self.meta.get("state_digest")
            if baked is not None and _state_digest(state) != baked:
                raise ValueError(
                    "checkpoint state differs from the state baked into this artifact "
                    "(BN statistics / int8 scales drifted during fine-tuning) — re-export "
                    "instead of hot-swapping, or pass force=True to accept the skew")
        named = _flat_params(params_pytree)
        if [n for n, _ in named] != list(self.meta["param_names"]):
            raise ValueError("param tree does not match the exported program")
        for (n, leaf), old, perm in zip(named, self._params, self.meta["param_layouts"]):
            shape = tuple(np.shape(leaf))
            if perm is not None:
                shape = tuple(shape[i] for i in perm)
            if shape != tuple(old.shape):
                raise ValueError(f"shape mismatch for {n}")
        self._params = self._to_device([np.asarray(leaf) for _, leaf in named])

    def _input(self, arr, spec):
        t = torch.as_tensor(arr)
        if spec.get("uint8_scale") and t.dtype == torch.uint8:
            # raw camera bytes: the program is traced at float32, where
            # normalize_images applies no /255; divided on the device by a
            # device tensor (a true division, as the JAX Served's numpy /)
            t = t.to(self.device).to(torch.float32)
            t = torch.div(t, torch.tensor(255.0, device=self.device))
        else:
            t = t.to(device=self.device, dtype=getattr(torch, spec["dtype"]))
        if tuple(t.shape) != tuple(spec["shape"]):
            raise ValueError(f"expected {spec['name']} {tuple(spec['shape'])}, got {tuple(t.shape)}")
        return t

    def __call__(self, *inputs):
        specs = self.meta["inputs"]
        if len(inputs) != len(specs):
            raise ValueError(f"expected {len(specs)} inputs ({[s['name'] for s in specs]}), "
                             f"got {len(inputs)}")
        tensors = [self._input(a, s) for a, s in zip(inputs, specs)]
        with torch.no_grad():
            return self._program(*self._params, *tensors)


def load(path, device=None) -> Served:
    """Load a .ddx artifact of this package on `device` (default: the device
    type it was traced for, cuda:0 for cuda). A device of another type than
    the traced one raises: the program is never moved."""
    from driving_dirty_tpu_torch.kernels import ops  # noqa: F401  registers the ops

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format_version") != FORMAT_VERSION or meta.get("framework") != "torch":
            raise ValueError(f"unsupported .ddx artifact: format {meta.get('format_version')}, "
                             f"framework {meta.get('framework', 'jax')}")
        traced = meta["device"]
        device = torch.device(traced if device is None else device)
        if device.type != traced:
            raise ValueError(f"{path} was traced for {traced}; it does not run on {device} "
                             f"(re-export it there)")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; this artifact was traced for cuda")
        program = torch.export.load(_io.BytesIO(z.read("program.pt2"))).module()
        with np.load(_io.BytesIO(z.read("params.npz"))) as npz:
            params = [npz[n] for n in meta["param_names"]]
    return Served(program, params, meta, device)

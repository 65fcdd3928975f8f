"""The port's detection tasks at precision 16, and their checkpoints across
the two packages (export.save_task_ckpt, export.load_task_ckpt,
cli/eval_boxes.load_detection_task), against the JAX package on the CPU at
the TINY config; setup and tolerances as in
tests/test_torch_port_faster_rcnn.py, whose helpers this file shares.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import numpy as np
import pytest
import torch

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.cli.eval_boxes import load_detection_task as jax_load_detection_task
from driving_dirty_tpu.cli.eval_boxes import main as jax_eval_boxes
from driving_dirty_tpu.data.synthetic import generate
from driving_dirty_tpu.models import faster_rcnn as JF
from driving_dirty_tpu_torch import export
from driving_dirty_tpu_torch.cli.eval_boxes import load_detection_task
from driving_dirty_tpu_torch.cli.eval_boxes import main as eval_boxes
from driving_dirty_tpu_torch.models import faster_rcnn as TF
from test_torch_port_faster_rcnn import (KEY, PAIRS, TINY, _assert_dets_equal, _batch, _found, _jax,
                                         _np, _pair, _torch)


@pytest.mark.parametrize("name", list(PAIRS))
def test_precision16_matches_jax_bf16(name):
    jtask, params, state, predict, port = _pair(name, 16)
    batch = _batch(seed=1)
    jb, tb = _jax(batch), _torch(batch)
    with torch.no_grad():
        feats = port.backbone_features(tb["images"], tb["road"])
        assert feats.dtype == torch.bfloat16
        obj, _ = port.head.rpn_forward(feats)
    feats_ref, _ = jtask.backbone_features(params, state, jb["images"], jb["road"], train=False, rng=KEY)
    obj_ref = np.asarray(jtask.head.rpn_forward(params["head"], feats_ref)[0]).astype(np.float32)
    np.testing.assert_allclose(obj.float().numpy(), obj_ref, rtol=0, atol=2.0 ** -6 * np.abs(obj_ref).max())
    got = {k: _np(v) for k, v in port.predict(tb["images"], tb["road"]).items()}
    ref = {k: np.asarray(v) for k, v in predict(params, state, jb["images"], jb["road"]).items()}
    assert ref["valid"].any()
    assert _found(got, ref) >= 0.9
    m = port.host_val_metrics(tb, np.ones(2, bool))
    assert set(m) == set(jtask.host_val_metrics(params, state, jb, np.ones(2, bool)))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A JAX-written faster_rcnn_rm checkpoint loads in the port
    (load_detection_task, and a checkpoint without a task name defaults to
    faster_rcnn_rm) and detects what the JAX task detects; the port's
    save_task_ckpt writes one that the JAX package restores to the same
    detections."""
    jtask, params, state, predict, _ = _pair("faster_rcnn_rm")
    batch = _batch(seed=2)
    jb, tb = _jax(batch), _torch(batch)
    ref = predict(params, state, jb["images"], jb["road"])
    hparams = dict(TINY, precision=32)
    for i, meta in enumerate(({"task": "faster_rcnn_rm"}, {})):
        ckpt = str(tmp_path / f"jax{i}.ckpt")
        jax_io.save(ckpt, params=params, state=state, hparams=hparams, meta=meta)
        port = load_detection_task(ckpt, device="cpu")
        assert isinstance(port, TF.FasterRCNNRoadMap) and not port.training
        assert not any(p.requires_grad for p in port.parameters())
        _assert_dets_equal(port.predict(tb["images"], tb["road"]), ref)
    written = str(tmp_path / "port.ckpt")
    export.save_task_ckpt(written, port)
    jtask2, params2, state2 = jax_load_detection_task(written)
    assert type(jtask2) is JF.FasterRCNNRoadMap
    again = jax.jit(lambda p, s_, im, rd: jtask2.predict(p, s_, im, rd))(params2, state2, jb["images"], jb["road"])
    _assert_dets_equal(port.predict(tb["images"], tb["road"]), again)
    assert isinstance(export.load_task_ckpt(written, device="cpu"), TF.FasterRCNNRoadMap)
    with pytest.raises(ValueError, match="not one of"):
        export.load_task_ckpt(written, classes=export.BOX_TASKS, device="cpu")


def test_eval_boxes_cli_matches_jax(tmp_path):
    """cli/eval_boxes end to end on a synthetic labelled dataset (256x306
    views laid out into the 128-px image): the same scenes and the same
    average box threat score as the JAX package's CLI, for one
    JAX-written faster_rcnn checkpoint."""
    _, params, state, _, _ = _pair("faster_rcnn")
    data = str(tmp_path / "data")
    generate(data, scenes=1, samples=2, labeled_scenes=2, seed=0)
    ckpt = str(tmp_path / "det.ckpt")
    jax_io.save(ckpt, params=params, state=state, hparams=dict(TINY, precision=32),
                meta={"task": "faster_rcnn"})
    args = ["--ckpt_path", ckpt, "--link", data, "--samples_per_scene", "2",
            "--num_labeled_scenes", "2", "--batch_size", "2", "--score_thresh", "0.05"]
    got = eval_boxes(args + ["--device", "cpu"])
    ref = jax_eval_boxes(args)
    assert got["n_scenes"] == ref["n_scenes"] == 4
    assert got["avg_box_ts"] == pytest.approx(ref["avg_box_ts"], abs=1e-9)

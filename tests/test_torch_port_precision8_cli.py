"""The CLIs at --precision 8 against the JAX package's on the CPU: a
JAX-written tiny roadmap checkpoint at full view size through
cli.run_test, and a faster_rcnn one through cli.eval_boxes, on one
synthetic labelled sample. Each CLI of the port calibrates
once, on its first batch. run_test's masks agree with the JAX CLI's in
> 99% of pixels (the bar of tests/test_torch_port_precision8.py); eval_boxes
scores the same scenes, its average box threat score within 0.05 (with
random weights few detections score; their boxes come from bf16 heads
whose sums run in another order).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import numpy as np
import pytest

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.cli.eval_boxes import main as jax_eval_boxes
from driving_dirty_tpu.cli.run_test import main as jax_run_test
from driving_dirty_tpu.data.synthetic import generate
from driving_dirty_tpu.models import roadmap as JR
from driving_dirty_tpu_torch.cli.eval_boxes import main as eval_boxes
from driving_dirty_tpu_torch.cli.run_test import main as run_test
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin
from test_torch_port_faster_rcnn import TINY as DET_TINY
from test_torch_port_faster_rcnn import _pair as det_pair

KEY = jax.random.PRNGKey(0)
TORCH_THREADS = 2  # the plain int8 trunk's float64 convs at full view size


def test_run_test_and_eval_boxes_clis_at_precision8_match_jax(tmp_path):
    """A JAX-written tiny roadmap checkpoint at full view size and a
    faster_rcnn one (its 128-px layout takes no 800-px road map), on one
    synthetic labelled sample: each CLI calibrates once (on its first batch)
    and agrees with the JAX CLI."""
    data = str(tmp_path / "data")
    generate(data, scenes=1, samples=1, labeled_scenes=1, seed=0)
    hp = dict(ae_hidden_dim=8, ae_latent_dim=6, pretrained_path=None, batch_size=2)
    jtask = JR.RoadMapBCEv2(hp)
    params, state = jtask.init(KEY)
    rm = str(tmp_path / "rm.ckpt")
    jax_io.save(rm, params=params, state=state, hparams=hp, meta={"task": "roadmap_bce"})
    args = ["--rm_ckpt_path", rm, "--link", data, "--num_labeled_scenes", "1", "--samples_per_scene", "1",
            "--batch_size", "1", "--precision", "8"]
    before = Int8TrunkMixin.calibrations
    got = run_test(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    assert Int8TrunkMixin.calibrations == before + 1
    ref = jax_run_test(args + ["--out", str(tmp_path / "jax.npz")])
    assert got["n_scenes"] == ref["n_scenes"] == 1
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a["masks"].shape == b["masks"].shape == (1, 800, 800)
        assert (a["masks"] == b["masks"]).mean() > 0.99

    _, dparams, dstate, _, _ = det_pair("faster_rcnn", 8)
    det = str(tmp_path / "det.ckpt")
    jax_io.save(det, params=dparams, state=dstate, hparams=dict(DET_TINY, precision=32),
                meta={"task": "faster_rcnn"})
    args = ["--ckpt_path", det, "--link", data, "--samples_per_scene", "1", "--num_labeled_scenes", "1",
            "--batch_size", "1", "--score_thresh", "0.05", "--precision", "8"]
    got = eval_boxes(args + ["--device", "cpu"])
    assert Int8TrunkMixin.calibrations == before + 2
    ref = jax_eval_boxes(args)
    assert got["n_scenes"] == ref["n_scenes"] == 1
    assert got["avg_box_ts"] == pytest.approx(ref["avg_box_ts"], abs=0.05)

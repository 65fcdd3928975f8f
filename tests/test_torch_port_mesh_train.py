"""driving_dirty_tpu_torch's Trainer on a mesh against one process, on the
CPU over gloo: four ranks spawned by parallel/launch.py, one world, the
fits of parallel/launch.py:fit_worker on batches held in memory, each
against the same fit in one process (computed while the ranks run).

  * (iv) BasicAE (hidden 16, latent 8, 16 x 306 views, global batch 8),
    dropout and the six-to-one mask on, 2 steps and a validation of 2
    batches, on dp=2 x tp=2 (no rules: the 'model' ranks replicate, and
    the batch splits over 'data' as the JAX package's mesh splits it).
    The first step's loss rtol 1e-5 (the same draws on the global batch,
    sums split in halves). The second within 1e-3: Adam's first update is
    lr * sign(g) on every weight, and where g is float noise (the biases
    ahead of a BatchNorm, and the weights whose gradient rounds near 0)
    the two sum orders flip the sign (measured 1.3e-5; 4e-5 at batch 4
    and 32 x 306 views). The validation loss (whole batches a data rank,
    summed) rtol 1e-3 after those steps (measured 9e-6); every rank ends
    with the same weights;
  * (v) faster_rcnn_rm (the TINY config of tests/test_torch_port_faster_rcnn.py,
    batch 4) on dp=2 x tp=2, as tests/test_mesh_detection.py runs the JAX
    package: its sampler noise drawn for the global batch, roi_loss over
    the global count of samples. The four losses of step 0 rtol 1e-5,
    step 1 rtol 1e-3; the validation's weighted means (host_val_metrics
    included) rtol 1e-3 (measured: all equal);
  * (vi) roadmap_bce, its encoder frozen (unfreeze_epoch_no 1), AE hidden
    16, latent 8, 32 x 306 views, batch 4, on dp=2 x tp=2 (its rules cut
    the head's fc1 and the encoder's fc1.fc): stopped by max_steps=2, its
    mid-epoch last.ckpt (the shards gathered, written by rank (0, 0)) is
    the one-process layout and resumes in one process; steps 2 and 3
    there against the uninterrupted 4-rank run, rtol 1e-6 (the trainer
    tests' bar: the frozen head's gradients are well conditioned, so only
    rounding separates the topologies), the final weights by relative L2
    error per tensor, 1e-5.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.models.basic_ae import BasicAE
from driving_dirty_tpu_torch.models.faster_rcnn import FasterRCNNRoadMap
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2
from driving_dirty_tpu_torch.ops.coords import aabb_to_corners
from driving_dirty_tpu_torch.parallel import launch

FIRST_RTOL, LATER_RTOL, RESUME_RTOL = 1e-5, 1e-3, 1e-6
COMMON = dict(max_epochs=1, log_every_n_steps=1, enable_progress_bar=False)


def _batches(n, b, views, extra=None, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        batch = {"images": rng.randint(0, 256, (b, 6, *views, 3)).astype(np.uint8)}
        out.append({**batch, **(extra(rng) if extra else {})})
    return out


def _det(rng, b=4):
    lo = rng.uniform(0, 80, (b, 8, 2))
    aabb = np.concatenate([lo, lo + rng.uniform(16, 48, (b, 8, 2))], -1).astype(np.float32)
    valid = np.zeros((b, 8), bool)
    valid[:, :6] = True
    valid[-1, 4:] = False
    return {"road": (rng.rand(b, 128, 128) > 0.5).astype(np.float32),
            "boxes": aabb_to_corners(aabb).astype(np.float32), "box_valid": valid,
            "categories": np.where(valid, rng.randint(0, 9, (b, 8)), -1).astype(np.int32)}


def specs(root):
    """name -> the fit_worker spec of each fit (root/<name> its run)."""
    ae = _batches(2, 8, (16, 306))
    det = _batches(2, 4, (64, 76), _det)
    road = _batches(4, 4, (32, 306), lambda rng: {"road": (rng.rand(4, 800, 800) > 0.5).astype(np.float32)})
    rm_h = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=32, pretrained_path=None, batch_size=4,
                unfreeze_epoch_no=1)
    det_h = dict(batch_size=4, pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, max_bb=8,
                 image_size=128, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=64, box_batch_per_image=32,
                 exact_topk=True)
    out = {  # only the roadmap runs need their checkpoints
        "basic_ae": dict(task=BasicAE, batches=ae, hparams=dict(hidden_dim=16, latent_dim=8, input_height=16,
                                                                 output_height=16, batch_size=8),
                         trainer=dict(enable_checkpointing=False)),
        "faster_rcnn_rm": dict(task=FasterRCNNRoadMap, batches=det, hparams=det_h,
                               trainer=dict(enable_checkpointing=False)),
        "roadmap_stop": dict(task=RoadMapBCEv2, batches=road, hparams=rm_h, trainer=dict(max_steps=2)),
        "roadmap_bce": dict(task=RoadMapBCEv2, batches=road, hparams=rm_h),
    }
    for name, spec in out.items():
        spec.update(seed=0, model_parallel=2, state=True, device="cpu",
                    trainer=dict(COMMON, default_root_dir=os.path.join(root, name), **spec.get("trainer", {})))
    return out


def rank_fits(root):
    return {name: launch.fit_worker(spec) for name, spec in specs(root).items()}


def one_fits(root):
    """The one-process fits of basic_ae and faster_rcnn_rm."""
    s = specs(root)
    out = {}
    for name in ("basic_ae", "faster_rcnn_rm"):
        spec = dict(s[name], model_parallel=1)
        spec["trainer"] = dict(spec["trainer"], default_root_dir=os.path.join(root, name + "_one"))
        out[name] = launch.fit_worker(spec)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_train"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DD_NO_TB", "1")
        mp.setenv("DD_NO_COST_ANALYSIS", "1")
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(launch.spawn, rank_fits, 4, (d,), device="cpu", threads=1,
                                init_method=f"file://{d}/rdzv")
            one = one_fits(d)
            ranks = ranks.result()
        spec = dict(specs(d)["roadmap_bce"], model_parallel=1, resume=ranks[0]["roadmap_stop"]["last_ckpt_path"])
        spec["trainer"] = dict(spec["trainer"], default_root_dir=os.path.join(d, "resumed"))
        one["resumed"] = launch.fit_worker(spec)
    return d, one, ranks


def _records(root, task):
    recs = []
    for path in sorted(glob.glob(os.path.join(root, task, "version_*", "tb", "metrics.jsonl"))):
        with open(path) as f:
            recs += [json.loads(line) for line in f]
    return recs


def _train(root, task, key="train_loss"):
    return {r["step"]: r[key] for r in _records(root, task) if key in r}


def _val(root, task):
    return next(r for r in _records(root, task) if "val_loss" in r)


def test_every_rank_ends_with_the_same_whole_weights(runs):
    _, _, ranks = runs
    for name in ("basic_ae", "faster_rcnn_rm", "roadmap_bce"):
        ref = ranks[0][name]["state"]
        for rank in ranks[1:]:
            for k, v in rank[name]["state"].items():
                assert torch.equal(v, ref[k]), (name, rank[name]["rank"], k)
    assert ranks[0]["roadmap_bce"]["shard_shapes"] == {"encoder.fc1.fc.weight": [16, 58752],
                                                       "fc1.weight": [320000, 8], "fc1.bias": [320000]}
    assert ranks[0]["basic_ae"]["shard_shapes"] == {}


@pytest.mark.parametrize("task", ["basic_ae", "faster_rcnn_rm"])
def test_dp2_trains_and_validates_as_one_process(runs, task):
    d, _, _ = runs
    keys = ["train_loss"] if task == "basic_ae" else \
        ["train_loss_classifier", "train_loss_box_reg", "train_loss_objectness", "train_loss_rpn_box_reg"]
    for key in keys:
        got, ref = _train(os.path.join(d, task), task, key), _train(os.path.join(d, task + "_one"), task, key)
        assert sorted(got) == sorted(ref) == [0, 1]
        np.testing.assert_allclose(got[0], ref[0], rtol=FIRST_RTOL, err_msg=key)
        np.testing.assert_allclose(got[1], ref[1], rtol=LATER_RTOL, err_msg=key)
    got, ref = _val(os.path.join(d, task), task), _val(os.path.join(d, task + "_one"), task)
    assert sorted(got) == sorted(ref)
    for k in got:
        if k.startswith("val_"):
            np.testing.assert_allclose(got[k], ref[k], rtol=LATER_RTOL, atol=1e-6, err_msg=k)


def test_a_dp2_tp2_checkpoint_resumes_in_one_process(runs):
    d, one, ranks = runs
    stopped = ranks[0]["roadmap_stop"]
    assert stopped["stop_reason"] == "max_steps=2 reached"
    blob = ckpt_io.load(stopped["last_ckpt_path"])
    assert blob["params"]["fc1"]["w"].shape == (8, 640000)
    assert blob["params"]["encoder"]["fc1"]["fc"]["w"].shape == (117504, 16)
    ref = _train(os.path.join(d, "roadmap_bce"), "roadmap_bce")
    got = _train(os.path.join(d, "resumed"), "roadmap_bce")
    assert sorted(ref) == [0, 1, 2, 3] and sorted(got) == [2, 3]
    for s in (2, 3):
        np.testing.assert_allclose(got[s], ref[s], rtol=RESUME_RTOL, err_msg=f"step {s}")
    want = ranks[0]["roadmap_bce"]["state"]
    for k, v in one["resumed"]["state"].items():
        err = float((v - want[k]).norm() / want[k].norm().clamp(min=1e-30))
        assert err <= 1e-5, (k, err)

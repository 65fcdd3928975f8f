"""The port's detection family (nn/detection.py, models/faster_rcnn.py:
faster_rcnn and faster_rcnn_rm) against the JAX package on the CPU, at the
TINY config of tests/test_faster_rcnn.py (128-px layout image, 64x76
views, 200 pre-NMS and 64 post-NMS proposals, a tiny autoencoder).

The JAX side selects proposals with exact top-k (`exact_topk=True`): its
default lax.approx_max_k has no PyTorch twin, and the port always selects
exactly. JAX initializes; checkpoints/convert.py carries the weights
across; the same numpy batch (uint8 views, a road map, ground-truth boxes
inside the 128-px image so that the diagnostics see matches) goes through
both in eval mode.

Tolerances at precision 32: features, RPN outputs, embeddings and class
posteriors 1e-4 relative / 1e-5 absolute (f32 convs and matmuls summed in
another order); proposals and detections equal on the valid slots (boxes
to 1e-4 px, scores to 1e-5), validity equal everywhere (indices in invalid
slots follow ties at NEG_INF and are not compared); validation metrics
equal to 1e-6. At precision 16 (tests/test_torch_port_faster_rcnn_tasks.py)
both round to bf16 at the same layers from sums taken in another order,
and equal bf16 scores are common, so ties fall differently: RPN objectness
within 2^-6 of its largest value, and at least 90% of the JAX package's
detections found in the port's (same label, IoU >= 0.99).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.models import faster_rcnn as JF
from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights
from driving_dirty_tpu_torch.models import faster_rcnn as TF
from driving_dirty_tpu_torch.ops import detection as TD
from driving_dirty_tpu_torch.ops.coords import aabb_to_corners

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(batch_size=2, pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, max_bb=8,
            image_size=128, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=64,
            box_batch_per_image=32, exact_topk=True)
PAIRS = {"faster_rcnn": (JF.BBFasterRCNN, TF.BBFasterRCNN),
         "faster_rcnn_rm": (JF.FasterRCNNRoadMap, TF.FasterRCNNRoadMap)}


@functools.cache
def _pair(name, precision=32):
    """-> (JAX task, params, state, jitted JAX predict, the port's model)."""
    hparams = dict(TINY, precision=precision)
    jtask = PAIRS[name][0](hparams)
    params, state = jtask.init(KEY)
    port = PAIRS[name][1](hparams, device="cpu")
    load_jax_weights(port, params, state)
    predict = jax.jit(lambda p, s, im, rd: jtask.predict(p, s, im, rd))
    return jtask, params, state, predict, port


@functools.cache
def _batch(seed=0, b=2):
    """uint8 views, a road map and up to 6 labelled boxes an image whose
    pixel AABBs lie inside the 128-px layout image."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 80, (b, 8, 2))
    aabb = np.concatenate([lo, lo + rng.uniform(16, 48, (b, 8, 2))], -1).astype(np.float32)
    valid = np.zeros((b, 8), bool)
    valid[:, :6] = True
    valid[-1, 4:] = False
    cats = np.where(valid, rng.randint(0, 9, (b, 8)), -1).astype(np.int32)
    return {"images": rng.randint(0, 256, (b, 6, 64, 76, 3)).astype(np.uint8),
            "road": (rng.rand(b, 128, 128) > 0.5).astype(np.float32),
            "boxes": aabb_to_corners(aabb).astype(np.float32), "box_valid": valid, "categories": cats}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_dets_equal(got, ref):
    got = {k: _np(v) for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    v = ref["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    assert v.any()
    np.testing.assert_allclose(got["boxes"][v], ref["boxes"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["labels"][v], ref["labels"][v])


def _found(got, ref):
    """Share of the valid JAX detections that the port also returns: same
    label and IoU >= 0.99, in any slot."""
    found = total = 0
    for j in range(ref["valid"].shape[0]):
        gv = got["valid"][j]
        gb, gl = got["boxes"][j][gv], got["labels"][j][gv]
        for box, label in zip(ref["boxes"][j][ref["valid"][j]], ref["labels"][j][ref["valid"][j]]):
            lt, rb = np.maximum(gb[:, :2], box[:2]), np.minimum(gb[:, 2:], box[2:])
            inter = np.clip(rb - lt, 0, None).prod(-1)
            union = (box[2:] - box[:2]).prod() + (gb[:, 2:] - gb[:, :2]).prod(-1) - inter
            found += bool(((inter / np.maximum(union, 1e-9) >= 0.99) & (gl == label)).any())
            total += 1
    return found / max(total, 1)


def test_head_stages_match_jax():
    """Backbone features, RPN outputs, proposals, RoIAlign embeddings,
    forward_eval and forward_diag of the faster_rcnn head."""
    jtask, params, state, _, port = _pair("faster_rcnn")
    batch = _batch()
    jb, tb = _jax(batch), _torch(batch)
    jhead, hp_ = jtask.head, params["head"]
    feats_ref, _ = jax.jit(lambda p, s, im: jtask.backbone_features(p, s, im, None, train=False, rng=KEY))(
        params, state, jb["images"])
    with torch.no_grad():
        feats = port.backbone_features(tb["images"])
        np.testing.assert_allclose(feats.numpy(), np.asarray(feats_ref), **TOL)
        f = torch.from_numpy(np.array(feats_ref))  # both heads on the same features from here
        obj, dl = port.head.rpn_forward(f)
        obj_ref, dl_ref = jhead.rpn_forward(hp_, feats_ref)
        np.testing.assert_allclose(obj.numpy(), np.asarray(obj_ref), **TOL)
        np.testing.assert_allclose(dl.numpy(), np.asarray(dl_ref), **TOL)
        rois, rv, rs = port.head.proposals(obj, dl)
        rois_ref, rv_ref, rs_ref = (np.asarray(t) for t in jax.jit(
            lambda o, d: jhead.proposals(o, d, train=False))(obj_ref, dl_ref))
        np.testing.assert_array_equal(rv.numpy(), rv_ref)
        np.testing.assert_allclose(rois.numpy()[rv_ref], rois_ref[rv_ref], rtol=0, atol=1e-4)
        np.testing.assert_allclose(rs.numpy()[rv_ref], rs_ref[rv_ref], **TOL)
        r = torch.from_numpy(rois_ref)
        emb = port.head.roi_features(f, r)
        emb_ref = jhead.roi_features(hp_, feats_ref, jnp.asarray(rois_ref))
        np.testing.assert_allclose(emb.numpy(), np.asarray(emb_ref), **TOL)
        _assert_dets_equal(port.head.forward_eval(f), jax.jit(jhead.forward_eval)(hp_, feats_ref))
        diag = port.head.forward_diag(f)
        diag_ref = {k: np.asarray(v) for k, v in jax.jit(jhead.forward_diag)(hp_, feats_ref).items()}
        np.testing.assert_array_equal(diag["roi_valid"].numpy(), diag_ref["roi_valid"])
        v = diag_ref["roi_valid"]
        np.testing.assert_allclose(diag["rois"].numpy()[v], diag_ref["rois"][v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(diag["cls"].numpy()[v], diag_ref["cls"][v], **TOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_predict_and_host_val_metrics_match_jax(name):
    jtask, params, state, predict, port = _pair(name)
    batch = _batch()
    jb, tb = _jax(batch), _torch(batch)
    dets = port.predict(tb["images"], tb["road"])
    assert set(dets) == {"boxes", "scores", "labels", "valid"}
    assert tuple(dets["boxes"].shape) == (2, 100, 4)
    _assert_dets_equal(dets, predict(params, state, jb["images"], jb["road"]))
    bmask = np.array([True, True])
    m = port.host_val_metrics(tb, bmask)
    m_ref = jtask.host_val_metrics(params, state, jb, bmask)
    assert set(m) == set(m_ref) >= {"val_ats", "val_det_kept", "val_rpn_recall", "val_prop_cov"}
    for k in m_ref:
        np.testing.assert_allclose(m[k], m_ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
    assert m["val_prop_cov"][0] > 0 and m["val_rpn_recall"][1] == 10.0
    # the padded second image is left out
    m1 = port.host_val_metrics(tb, np.array([True, False]))
    m1_ref = jtask.host_val_metrics(params, state, jb, np.array([True, False]))
    for k in m1_ref:
        np.testing.assert_allclose(m1[k], m1_ref[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_box_fc1_reads_the_nchw_flatten():
    """box_fc1's rows follow torch's NCHW flatten of the pooled features.
    Flattened NHWC instead, the same weights load without complaint and
    the class posteriors move far outside the tolerance."""
    jtask, params, _, _, port = _pair("faster_rcnn")
    rng = np.random.RandomState(5)
    feats = rng.rand(1, 64, 64, 32).astype(np.float32)
    rois = np.concatenate([rng.uniform(0, 80, (1, 20, 2)), rng.uniform(90, 128, (1, 20, 2))], -1)
    rois = rois.astype(np.float32)
    ref = np.asarray(jtask.head.roi_features(params["head"], jnp.asarray(feats), jnp.asarray(rois)))
    f, r = torch.from_numpy(feats), torch.from_numpy(rois)
    with torch.no_grad():
        np.testing.assert_allclose(port.head.roi_features(f, r).numpy(), ref, **TOL)
        pooled = TD.batched_roi_align(f, r, output_size=7, spatial_scale=0.5, sampling_ratio=2)
        nhwc = torch.relu(port.head.box_fc2(torch.relu(port.head.box_fc1(pooled.reshape(1, 20, -1)))))
    assert np.abs(nhwc.numpy() - ref).max() > 100 * (TOL["atol"] + TOL["rtol"] * np.abs(ref).max())


def test_predict_chunks_pad_the_tail_and_unported_options_raise():
    _, _, _, _, port = _pair("faster_rcnn_rm")
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (3, 6, 64, 76, 3)).astype(np.uint8))
    road = torch.from_numpy((rng.rand(3, 128, 128) > 0.5).astype(np.float32))
    whole = port.predict(images, road)
    port.predict_chunk = 2
    try:
        chunked = port.predict(images, road)
    finally:
        port.predict_chunk = TF.BBFasterRCNN.predict_chunk
    for k in whole:
        assert chunked[k].shape[0] == 3
        np.testing.assert_allclose(_np(chunked[k]), _np(whole[k]), rtol=0, atol=2e-5, err_msg=k)
    p8 = TF.BBFasterRCNN(dict(TINY, precision=8), device="cpu")  # precision 8 is ported
    assert p8.int8_trunk and p8.compute_dtype is torch.bfloat16
    with pytest.raises(NotImplementedError):
        TF.BBFasterRCNN(dict(TINY, fast_conv=True), device="cpu")


def test_head_options_and_label_offset_match_jax():
    """Dilated, normed RPN head convs (from string hparams) and label_offset
    1: the weights load under the JAX package's names, the detections (raw
    category ids out) agree, and so do the box targets."""
    hparams = dict(TINY, anchor_sizes="44", anchor_ratios="1.0", rpn_head_dilations="2,4",
                   rpn_head_norm=1, label_offset=1)
    jtask = JF.BBFasterRCNN(hparams)
    params, state = jtask.init(KEY)
    port = TF.BBFasterRCNN(hparams, device="cpu")
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(jtask.cfg) and port.cfg.num_classes == 10
    load_jax_weights(port, params, state)
    assert {"head.rpn_conv_d2.weight", "head.rpn_conv_d4.weight"} <= set(port.state_dict())
    jb, tb = _jax(_batch()), _torch(_batch())
    ref = jax.jit(lambda p, s, im: jtask.predict(p, s, im))(params, state, jb["images"])
    _assert_dets_equal(port.predict(tb["images"]), ref)
    for got, want in zip(port._targets(tb), jtask._targets(jb)):  # gt boxes, validity, shifted labels
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)

"""Precision 8 of RoadMapBCEv2 and FasterRCNNRoadMap
(models/precision.py:Int8TrunkMixin) against the JAX package on the CPU:
`predict` at precision 8 on shared weights, each package calibrating on the
same batch, with the bars of tests/test_torch_port_precision8.py (roadmap
logits within 2^-5 of their largest value besides). For
faster_rcnn_rm the trunk input is the bf16 output of its road-map fusion
conv, which the packages round from sums taken in another order, so the
scales agree within 2^-7 relative (a bf16 ulp is 2^-8); a scale that far
off moves int8 values by a step, so its outputs are compared on JAX's
scales, to the bars of precision 16 in
tests/test_torch_port_faster_rcnn_tasks.py: RPN objectness within 2^-6 of
its largest value, and >= 90% of the JAX detections found (same label, IoU
>= 0.99).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from driving_dirty_tpu.models import roadmap as JR
from driving_dirty_tpu_torch.checkpoints.convert import from_jax
from driving_dirty_tpu_torch.models import roadmap as R
from test_torch_port_boxmodels import _jax, _torch
from test_torch_port_faster_rcnn import _batch as det_batch
from test_torch_port_faster_rcnn import _found, _np
from test_torch_port_faster_rcnn import _pair as det_pair
from test_torch_port_precision8 import TINY, _images

KEY = jax.random.PRNGKey(0)


def test_roadmap_predict_matches_jax():
    jtask = JR.RoadMapBCEv2(dict(TINY, precision=8))
    params, state = jtask.init(KEY)
    rng = np.random.RandomState(8)
    state = jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape) + 0.5, jnp.float32), state)
    port = R.RoadMapBCEv2(dict(TINY, precision=8), device="cpu")
    port.load_state_dict(from_jax(params, state))
    images = _images(9)
    mask_ref = np.asarray(jtask.predict(params, state, jnp.asarray(images.numpy())))
    mask = port.predict(images).numpy()
    np.testing.assert_allclose(port._int8_scales, jtask._int8_scales, rtol=1e-6)
    logits_ref, _, _ = jtask.forward(params, state, jnp.asarray(images.numpy()), train=False, rng=KEY)
    with torch.no_grad():
        logits, _ = port(images)
    ref = np.asarray(logits_ref)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=2.0 ** -5 * np.abs(ref).max())
    assert (mask == mask_ref).mean() > 0.99


def test_faster_rcnn_rm_predict_matches_jax():
    jtask, params, state, predict, port = det_pair("faster_rcnn_rm", 8)
    batch = det_batch(seed=11)
    jb, tb = _jax(batch), _torch(batch)
    jtask.calibrate_int8(params, state, jb["images"], jb["road"])  # the JAX CLI's eager step
    port._int8_scales = None
    port.calibrate_int8(tb["images"], tb["road"])
    # the trunk input here is mapper_cnn's bf16 output, which each package
    # rounds from its own sums: absmaxes a bf16 ulp (2^-8) apart. Scales that
    # far apart move int8 values by a step, so the rest runs on JAX's scales.
    np.testing.assert_allclose(port._int8_scales, jtask._int8_scales, rtol=2.0 ** -7)
    port._int8_scales = jtask._int8_scales
    got = {k: _np(v) for k, v in port.predict(tb["images"], tb["road"]).items()}
    ref = {k: np.asarray(v) for k, v in predict(params, state, jb["images"], jb["road"]).items()}
    assert ref["valid"].any()
    assert _found(got, ref) >= 0.9
    with torch.no_grad():
        obj, _ = port.head.rpn_forward(port.backbone_features(tb["images"], tb["road"]))
    feats_ref, _ = jtask.backbone_features(params, state, jb["images"], jb["road"], train=False, rng=KEY)
    obj_ref = np.asarray(jtask.head.rpn_forward(params["head"], feats_ref)[0]).astype(np.float32)
    np.testing.assert_allclose(obj.float().numpy(), obj_ref, rtol=0, atol=2.0 ** -6 * np.abs(obj_ref).max())

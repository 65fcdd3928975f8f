"""The port's detection primitives against the JAX package on the CPU:
ops/boxes.py, ops/coords.py, ops/maps.py:layout_images_as_map, the anchors,
exact top-k and nms_fixed of ops/detection.py, and the box ATS of
metrics/threat.py.

Inputs are made from numpy seeds and go through both packages.
Tolerances: box ops and coordinates 1e-5 relative / 1e-4 absolute (f32,
the same formulas); the layout image <= 5e-5 absolute on [0, 1] views (the
two resizes sum their taps in another order; 1.2e-5 measured), and one
bf16 ulp at 1 (2^-7) at bf16; anchors exact; NMS keep sets and their order
equal on the valid slots, validity equal everywhere (the indices in
invalid slots follow ties at NEG_INF and are not compared); ATS exact to
1e-12 (both run the same float64 polygon code).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.metrics import threat as JT
from driving_dirty_tpu.ops import boxes as JB
from driving_dirty_tpu.ops import coords as JC
from driving_dirty_tpu.ops import detection as JD
from driving_dirty_tpu.ops.maps import layout_images_as_map as jax_layout
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.metrics import threat as TT
from driving_dirty_tpu_torch.ops import boxes as TB
from driving_dirty_tpu_torch.ops import coords as TC
from driving_dirty_tpu_torch.ops import detection as TD
from driving_dirty_tpu_torch.ops.maps import layout_images_as_map

TOL = dict(rtol=1e-5, atol=1e-4)
GOLDENS = json.loads((Path(__file__).parent / "goldens" / "detection_goldens.json").read_text())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _boxes(rng, n, size=100.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size / 3
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[3] = [5, 5, 5, 9]  # zero width: area 0
    np.testing.assert_allclose(TB.area(_t(a)).numpy(), np.asarray(JB.area(jnp.asarray(a))), **TOL)
    np.testing.assert_allclose(TB.pairwise_iou(_t(a), _t(b)).numpy(),
                               np.asarray(JB.pairwise_iou(jnp.asarray(a), jnp.asarray(b))), **TOL)
    anchors = _boxes(rng, 40)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        enc = TB.encode(_t(a), _t(anchors), w)
        np.testing.assert_allclose(enc.numpy(), np.asarray(JB.encode(jnp.asarray(a), jnp.asarray(anchors), w)),
                                   **TOL)
        deltas = (rng.randn(40, 4) * 3).astype(np.float32)  # some past the exp clamp
        np.testing.assert_allclose(
            TB.decode(_t(deltas), _t(anchors), w).numpy(),
            np.asarray(JB.decode(jnp.asarray(deltas), jnp.asarray(anchors), w)), **TOL)
    x = (rng.randn(50) * 0.3).astype(np.float32)
    np.testing.assert_allclose(TB.smooth_l1(_t(x)).numpy(), np.asarray(JB.smooth_l1(jnp.asarray(x))), **TOL)
    big = (rng.rand(20, 4) * 300 - 100).astype(np.float32)
    np.testing.assert_array_equal(TB.clip_to_image(_t(big), 128).numpy(),
                                  np.asarray(JB.clip_to_image(jnp.asarray(big), 128)))


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_coords_match_jax(kind):
    boxes, _ = box_scenes(1, batch=2, max_bb=20)
    conv = _t if kind == "torch" else np.asarray

    def back(x):
        return x.numpy() if kind == "torch" else x

    for flip in (True, False):
        np.testing.assert_allclose(back(TC.meters_to_pixels(conv(boxes), flip)),
                                   np.asarray(JC.meters_to_pixels(jnp.asarray(boxes), flip)), **TOL)
        aabb = back(TC.corners_to_aabb(conv(boxes), flip))
        np.testing.assert_allclose(aabb, np.asarray(JC.corners_to_aabb(jnp.asarray(boxes), flip)), **TOL)
        np.testing.assert_allclose(back(TC.aabb_to_corners(conv(aabb), flip)),
                                   np.asarray(JC.aabb_to_corners(jnp.asarray(aabb), flip)), **TOL)


@pytest.mark.parametrize("size,hw", [(128, (64, 76)), (800, (256, 306))])
def test_layout_images_as_map_matches_jax(size, hw):
    x = np.random.RandomState(size).rand(2, 6, *hw, 3).astype(np.float32)
    got = layout_images_as_map(_t(x), size)
    ref = np.asarray(jax_layout(jnp.asarray(x), size))
    assert tuple(got.shape) == ref.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-5)
    got16 = layout_images_as_map(_t(x).bfloat16(), size)
    assert got16.dtype == torch.bfloat16
    ref16 = np.asarray(jax_layout(jnp.asarray(x, jnp.bfloat16), size)).astype(np.float32)
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=0, atol=2.0 ** -7)


def test_layout_needs_antialias_on_the_rotated_views():
    """The rotated back and front views shrink (306 -> 266 rows): without
    antialiasing the resize differs from jax.image.resize by far more than
    the tolerance, so the antialias flag is what the test above pins."""
    x = np.random.RandomState(1).rand(1, 6, 256, 306, 3).astype(np.float32)
    ref = np.asarray(jax_layout(jnp.asarray(x), 800))
    v = _t(x)[:, 4].permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(torch.rot90(v, 1, (2, 3)), size=(266, 400), mode="bilinear",
                                            align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref[:, 266:532, :400]).max() > 0.05


def test_anchors_match_jax():
    for sizes, ratios in (((32, 64, 128, 256, 512), (0.5, 1.0, 2.0)), ((44,), (1.0,))):
        cells = TD.base_anchors(sizes, ratios)
        np.testing.assert_array_equal(cells, np.asarray(JD.base_anchors(sizes, ratios)))
        np.testing.assert_array_equal(TD.grid_anchors(7, 5, 2, cells),
                                      np.asarray(JD.grid_anchors(7, 5, 2, cells)))


def test_top_k_orders_ties_as_lax_top_k():
    rng = np.random.RandomState(2)
    x = rng.randint(0, 5, (3, 200)).astype(np.float32)  # many ties
    x[:, 50:120] = TD.NEG_INF
    v, i = TD.top_k(_t(x), 150)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 150)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def _assert_same_keep(got, ref):
    (gi, gv), (ri, rv) = [tuple(np.asarray(t) for t in pair) for pair in (got, ref)]
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gi[rv], ri[rv])


@pytest.mark.parametrize("fixed_depth", [0, 3])
def test_nms_fixed_matches_jax_on_random_candidates(fixed_depth):
    rng = np.random.RandomState(3)
    b, k = 3, 300
    boxes = np.stack([_boxes(rng, k, 200.0) for _ in range(b)])
    scores = rng.rand(b, k).astype(np.float32)
    scores[:, ::7] = TD.NEG_INF   # masked candidates
    scores[1, 10:20] = 0.5        # equal scores
    scores[2] = TD.NEG_INF        # an image with no candidate
    got = TD.nms_fixed(_t(boxes), _t(scores), 0.5, 100, fixed_depth=fixed_depth)
    f = jax.jit(jax.vmap(lambda bb, ss: JD.nms_fixed(bb, ss, 0.5, 100, fixed_depth=fixed_depth)))
    ref = f(jnp.asarray(boxes), jnp.asarray(scores))
    _assert_same_keep(got, ref)
    assert got[1][0].any() and not got[1][2].any()
    # unbatched call, as the JAX package's
    _assert_same_keep(TD.nms_fixed(_t(boxes[0]), _t(scores[0]), 0.5, 100, fixed_depth=fixed_depth),
                      jax.tree.map(lambda t: t[0], ref))


def test_nms_fixed_matches_goldens():
    for case in GOLDENS["nms"] + [GOLDENS["batched_class_nms"]]:
        boxes = np.asarray(case["boxes"], np.float32)
        if "labels" in case:
            boxes = boxes + np.asarray(case["labels"], np.float32)[:, None] * 1000.0
        idx, valid = TD.nms_fixed(_t(boxes), torch.tensor(case["scores"], dtype=torch.float32),
                                  case["iou_threshold"], len(boxes))
        assert idx.numpy()[valid.numpy()].tolist() == case["keep"], case.get("name")


def _chain(k, w=10.0, d=2.0):
    """The adversarial chain of tests/test_nms_adversarial.py: IoU(i, i+1)
    2/3, IoU(i, i+2) 3/7, scores descending; greedy keeps the even boxes."""
    x0 = np.arange(k, dtype=np.float32) * d
    boxes = np.stack([x0, np.zeros(k, np.float32), x0 + w, np.ones(k, np.float32)], 1)
    return boxes, np.linspace(1.0, 0.5, k).astype(np.float32)


def test_nms_fixed_adversarial_chain_cap_and_antichain():
    k = 600
    boxes, scores = _chain(k)
    idx, valid = TD.nms_fixed(_t(boxes), _t(scores), 0.5, k)
    kept = sorted(idx.numpy()[valid.numpy()].tolist())
    ref = jax.jit(lambda b, s: JD.nms_fixed(b, s, 0.5, k))(jnp.asarray(boxes), jnp.asarray(scores))
    assert kept == sorted(np.asarray(ref[0])[np.asarray(ref[1])].tolist())
    depth_ok = TD.NMS_MAX_ITERS - 8
    assert [i for i in kept if i < depth_ok] == list(range(0, depth_ok, 2))
    iou = TB.pairwise_iou(_t(boxes[kept]), _t(boxes[kept])).numpy()
    np.fill_diagonal(iou, 0.0)
    assert iou.max() <= 0.5 + 1e-6
    # uncapped, the chain gives exactly greedy
    idx, valid = TD.nms_fixed(_t(boxes[:200]), _t(scores[:200]), 0.5, 200, max_iters=200)
    assert sorted(idx.numpy()[valid.numpy()].tolist()) == list(range(0, 200, 2))


def test_ats_bounding_boxes_matches_jax():
    boxes, valid = box_scenes(4, batch=2, max_bb=40)
    a, b = boxes[0][valid[0]], boxes[1][valid[1]]
    b_shifted = b + np.float32(0.3)
    for x, y in ((a, a), (a, b), (b, b_shifted), (a[:0], b)):
        assert TT.ats_bounding_boxes(x, y) == pytest.approx(JT.ats_bounding_boxes(x, y), abs=1e-12)
    assert TT.ats_bounding_boxes(a[1:], a[1:]) == pytest.approx(1.0)  # a[0] has zero area
    np.testing.assert_allclose(TT._pairwise_iou_matrix(b, b_shifted),
                               JT._pairwise_iou_matrix(b, b_shifted), rtol=0, atol=1e-12)

"""The port's anchor matchers and balanced sampler (ops/detection.py:
match_anchors, match_labels_grid, match_subset, blocked_top_k,
sample_balanced) against the JAX package on the CPU, and the matcher and
sampler goldens of tests/goldens/detection_goldens.json.

Inputs come from numpy seeds: a small anchor grid (40 x 40 cells, stride
2, anchors 8/16/32 x {0.5, 1, 2}) and GT boxes on integer pixels, so exact
IoU ties occur, with padded (invalid) and zero-area boxes and an image with
no valid box. The JAX matchers run jitted, as the JAX model runs them.

Tolerances: best IoUs 1e-6 absolute (the same f32 formula). Labels and
matched indices are equal except at anchors whose IoU lies within 1e-5 of
0.3 or 0.7 or of a GT's best IoU (found in float64 on the host): there the
grid matcher's cross-multiplied tests (`inter * (1 + t) >= t * s_ag`)
meet XLA:CPU's fma contraction, and an ulp decides the label; those
anchors are counted and bounded (at most 0.5% of the grid; 0.17% at these
seeds, none of which differed). blocked_top_k: values equal, the port's
indices the flat lax.top_k's (lower index first among equal values). sample_balanced, with the same uniform noise on both
sides (the JAX sampler's own draw, recomputed from its key): take and
is_pos equal everywhere, indices equal where take holds (filler slots are
ties at NEG_INF, which the JAX package's blocked top-k orders by block).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.ops import detection as JD
from driving_dirty_tpu_torch.ops import detection as TD

GOLDENS = json.loads((Path(__file__).parent / "goldens" / "detection_goldens.json").read_text())
FEAT, STRIDE = 40, 2
CELLS = TD.base_anchors((8, 16, 32), (0.5, 1.0, 2.0))
NEAR = 1e-5
MAX_NEAR_SHARE = 0.005


def _gt(seed, b=3, g=8):
    """[b, g, 4] integer-pixel GT boxes in the 80-px image (some past its
    edge, one of zero area), validity [b, g]; the last image has none."""
    rng = np.random.RandomState(seed)
    lo = rng.randint(-4, 70, (b, g, 2))
    boxes = np.concatenate([lo, lo + rng.randint(2, 40, (b, g, 2))], -1).astype(np.float32)
    boxes[0, 1, 2:] = boxes[0, 1, :2]  # zero area
    valid = rng.rand(b, g) < 0.8
    valid[0, :2] = True
    valid[-1] = False
    return boxes, valid


def _anchors():
    return TD.grid_anchors(FEAT, FEAT, STRIDE, CELLS)


def _near(anchors, gt, valid):
    """Anchors whose float64 IoU with a valid GT lies within NEAR of 0.3, of
    0.7 or of that GT's best IoU."""
    a = anchors.astype(np.float64)[:, None]
    g = gt.astype(np.float64)[None]
    wh = np.clip(np.minimum(a[..., 2:], g[..., 2:]) - np.maximum(a[..., :2], g[..., :2]), 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[..., 2] - x[..., 0], 0, None) * np.clip(x[..., 3] - x[..., 1], 0, None)
    union = area(a) + area(g) - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
    iou = np.where(valid[None], iou, 0.0)
    best = iou.max(0)
    close = (np.abs(iou - 0.3) < NEAR) | (np.abs(iou - 0.7) < NEAR) | ((np.abs(iou - best) < NEAR) & (best > 0))
    return (close & valid[None]).any(1)


def _jax_grid(gt, valid):
    fn = jax.jit(jax.vmap(lambda b, v: JD.match_labels_grid(CELLS, FEAT, FEAT, STRIDE, b, v)))
    labels, best = fn(jnp.asarray(gt), jnp.asarray(valid))
    return np.asarray(labels), np.asarray(best)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_labels_grid_matches_jax(seed):
    """Grid labels and per-GT best IoUs against the JAX grid matcher, and
    the port's grid labels against its generic matcher (the oracle)."""
    gt, valid = _gt(seed)
    labels, best = TD.match_labels_grid(CELLS, FEAT, FEAT, STRIDE, torch.from_numpy(gt), torch.from_numpy(valid))
    ref_labels, ref_best = _jax_grid(gt, valid)
    np.testing.assert_allclose(best.numpy(), ref_best, rtol=0, atol=1e-6)
    anchors = _anchors()
    near_total = 0
    for i in range(len(gt)):
        near = _near(anchors, gt[i], valid[i])
        near_total += int(near.sum())
        got = labels[i].numpy()
        oracle = TD.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gt[i]),
                                  torch.from_numpy(valid[i]))[0].numpy()
        for what, other in (("JAX grid", ref_labels[i]), ("generic oracle", oracle)):
            differ = got != other
            assert not (differ & ~near).any(), (what, i, np.flatnonzero(differ & ~near)[:10])
        assert (got == 1).any() == valid[i].any()
    assert near_total <= MAX_NEAR_SHARE * labels.numel(), near_total
    assert (labels[-1] == 0).all()  # no valid GT: every anchor negative


def test_match_labels_grid_bounds_its_row_blocks(monkeypatch):
    """Row blocks of any height give the same labels."""
    gt, valid = _gt(2)
    args = (CELLS, FEAT, FEAT, STRIDE, torch.from_numpy(gt), torch.from_numpy(valid))
    whole = TD.match_labels_grid(*args)
    monkeypatch.setattr(TD, "GRID_BLOCK_ELEMS", 7 * FEAT * len(CELLS) * gt.shape[0] * gt.shape[1])
    blocked = TD.match_labels_grid(*args)
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


@pytest.mark.parametrize("seed", [0, 3])
def test_match_anchors_and_subset_match_jax(seed):
    """The generic matcher (labels, matched GT, best IoU) in blocks smaller
    than the grid, and match_subset on a subset, against the JAX package."""
    gt, valid = _gt(seed)
    anchors = _anchors()
    for i in range(len(gt) - 1):
        a, g, v = torch.from_numpy(anchors), torch.from_numpy(gt[i]), torch.from_numpy(valid[i])
        labels, idx, best = TD.match_anchors(a, g, v, block_size=5000)
        r_labels, r_idx, r_best = (np.asarray(t) for t in jax.jit(
            lambda a_, g_, v_: JD.match_anchors(a_, g_, v_, block_size=5000))(anchors, gt[i], valid[i]))
        near = _near(anchors, gt[i], valid[i])
        np.testing.assert_allclose(best.numpy(), r_best, rtol=0, atol=1e-6)
        assert not ((labels.numpy() != r_labels) & ~near).any()
        assert not ((idx.numpy() != r_idx) & ~near).any()
        _, gt_best = TD.match_labels_grid(CELLS, FEAT, FEAT, STRIDE, g[None], v[None])
        sub = np.random.RandomState(seed + i).choice(len(anchors), 256, replace=False)
        got = TD.match_subset(a[sub], g, v, gt_best[0]).numpy()
        ref = np.asarray(jax.jit(JD.match_subset)(anchors[sub], gt[i], valid[i], np.asarray(gt_best[0])))
        np.testing.assert_array_equal(got, ref)
        forced_or_matched = (labels.numpy()[sub] == 1) & ~near[sub]
        np.testing.assert_array_equal(got[forced_or_matched], idx.numpy()[sub][forced_or_matched])


@pytest.mark.parametrize("n,k", [(200_003, 300), (1000, 256), (70_000, 70_000)])
def test_blocked_top_k_matches_jax(n, k):
    """Above the JAX package's 65536-element block (so it splits), with
    many equal values: the same values; the port's indices are the flat
    lax.top_k's."""
    vals = (np.random.RandomState(n).randint(0, 997, n) / 997.0).astype(np.float32)
    got_v, got_i = TD.blocked_top_k(torch.from_numpy(vals), k)
    ref_v, ref_i = (np.asarray(t) for t in JD.blocked_top_k(jnp.asarray(vals), k))
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_array_equal(vals[ref_i], ref_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(vals), k)[1]))
    batched_v, batched_i = TD.blocked_top_k(torch.from_numpy(np.stack([vals, vals[::-1].copy()])), k)
    assert torch.equal(batched_v[0], got_v) and torch.equal(batched_i[0], got_i)


def _labels(seed, n, n_pos, n_neg):
    labels = np.full(n, -1, np.int32)
    labels[:n_pos] = 1
    labels[n_pos:n_pos + n_neg] = 0
    np.random.RandomState(seed).shuffle(labels)
    return labels


@pytest.mark.parametrize("n,n_pos,n_neg,num,pf", [
    (100_000, 40, 90_000, 256, 0.5),   # the RPN's: above the JAX block size, scarce positives
    (100_000, 5000, 90_000, 256, 0.5),  # positives in surplus
    (1_064, 300, 700, 512, 0.25),       # the RoI sampler's: proposals plus GT
    (300, 20, 100, 256, 0.5),           # scarce negatives
    (100, 30, 60, 256, 0.25),           # fewer candidates than slots: padded filler
])
def test_sample_balanced_matches_jax(n, n_pos, n_neg, num, pf):
    """Three images, each with its own JAX key; the port gets each key's
    uniform draw as its noise."""
    keys = jax.random.split(jax.random.PRNGKey(n + n_pos), 3)
    labels = np.stack([_labels(s, n, n_pos, n_neg) for s in range(3)])
    noise = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    ref = jax.jit(jax.vmap(lambda k, lab: JD.sample_balanced(k, lab, num, pf, approx=False)))(
        keys, jnp.asarray(labels))
    r_idx, r_pos, r_take = (np.asarray(t) for t in ref)
    idx, is_pos, take = TD.sample_balanced(torch.from_numpy(noise), torch.from_numpy(labels), num, pf)
    np.testing.assert_array_equal(take.numpy(), r_take)
    np.testing.assert_array_equal(is_pos.numpy(), r_pos)
    np.testing.assert_array_equal(idx.numpy()[r_take], r_idx[r_take])
    assert idx.shape == (3, num)
    assert r_take.sum(1).tolist() == [min(num, min(n_pos, int(num * pf)) + n_neg)] * 3


def test_matcher_golden():
    """The hand-derived matcher golden: best IoUs, labels (the two tied
    anchors of gt 2 forced positive) and matched GT, through match_anchors
    and, for the matched GT, match_subset."""
    g = GOLDENS["matcher"]
    anchors = torch.tensor(g["anchors"], dtype=torch.float32)
    gt = torch.tensor(g["gt_boxes"], dtype=torch.float32)
    valid = torch.ones(len(g["gt_boxes"]), dtype=torch.bool)
    labels, idx, best = TD.match_anchors(anchors, gt, valid, g["high_thresh"], g["low_thresh"])
    np.testing.assert_allclose(best.numpy(), g["ious_to_best_gt"], atol=1e-6)
    np.testing.assert_array_equal(labels.numpy(), g["labels"])
    np.testing.assert_array_equal(idx.numpy(), g["matched_gt"])
    gt_best = TD.pairwise_iou(anchors, gt).amax(dim=0)
    np.testing.assert_array_equal(TD.match_subset(anchors, gt, valid, gt_best).numpy(), g["matched_gt"])


def test_sampler_counts_golden():
    """BalancedPositiveNegativeSampler counts under scarce positives,
    scarce negatives and surplus positives, for two noise draws."""
    g = GOLDENS["sampler_scarcity"]
    for case in g["cases"]:
        n = case["n_pos_avail"] + case["n_neg_avail"] + case["n_ignore"]
        labels = np.full(n, -1, np.int32)
        labels[:case["n_pos_avail"]] = 1
        labels[case["n_pos_avail"]:case["n_pos_avail"] + case["n_neg_avail"]] = 0
        np.random.RandomState(0).shuffle(labels)
        for seed in (0, 5):
            noise = torch.rand(n, generator=torch.Generator().manual_seed(seed))
            idx, is_pos, take = TD.sample_balanced(noise, torch.from_numpy(labels), g["num_samples"],
                                                   g["positive_fraction"])
            idx, is_pos, take = idx.numpy(), is_pos.numpy(), take.numpy()
            assert take.sum() == case["expect_total"], case
            assert (is_pos & take).sum() == case["expect_pos"], case
            assert (labels[idx[is_pos & take]] == 1).all()
            assert (labels[idx[~is_pos & take]] == 0).all()

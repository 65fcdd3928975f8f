"""Synthetic mini-dataset generator (driving_dirty_tpu/data/synthetic.py,
the same bytes for the same arguments): random JPEGs + ego.png +
annotation.csv in the on-disk layout, enough to drive every loader and the
train -> checkpoint -> run_test path.

Usage: python -m driving_dirty_tpu_torch.data.synthetic --out <dir> \
          [--scenes 2] [--samples 4] [--labeled-scenes 2] [--seed 0]

Scene ids: unlabeled 0..scenes-1; labeled continue from 106 to mirror the real
split boundary (data_helper-style ids are arbitrary ints encoded in dirnames).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from driving_dirty_tpu_torch.data.dataset import IMAGE_H, IMAGE_NAMES, IMAGE_W


def _save_jpeg(path, arr):
    from PIL import Image

    Image.fromarray((arr * 255).astype(np.uint8)).save(path, quality=90)


# --- layout-aligned box painting -------------------------------------------
#
# The detection gate needs an image<->box correspondence a conv detector can
# actually learn. The round-3 generator painted a blob at the SAME view-local
# position in all six views; after ops.maps.layout_images_as_map tiles the
# views into the 800x800 square, those blobs land at six positions UNRELATED
# to the GT box's pixel AABB — with a ~9 px receptive-field c3 trunk the
# evidence at the box location is pure noise, and 45 epochs of val_ats = 0.0
# was the CORRECT output for that task (VERDICT r3 item 1c). The fix: invert
# the layout transform and paint each box's pixel AABB into the exact view
# pixels that layout_images_as_map will place at that AABB, colored by
# category so the classifier head has signal too.
#
# Tile geometry mirrors ops/maps.py:layout_images_as_map(size=800):
#   rows of heights [266, 266, 268], two 400-wide columns,
#   grid [[BL, FL], [B(ccw), F(cw)], [BR(flip), FR(flip)]];
# camera indices follow IMAGE_NAMES order (FL=0, F=1, FR=2, BL=3, B=4, BR=5).
_LAYOUT_TILES = (
    # (cam, y0, h, x0, w, orient)
    (3, 0, 266, 0, 400, "id"),      # CAM_BACK_LEFT
    (0, 0, 266, 400, 400, "id"),    # CAM_FRONT_LEFT
    (4, 266, 266, 0, 400, "ccw"),   # CAM_BACK  (rot90 CCW before resize)
    (1, 266, 266, 400, 400, "cw"),  # CAM_FRONT (rot90 CW before resize)
    (5, 532, 268, 0, 400, "flip"),  # CAM_BACK_RIGHT  (flipped both axes)
    (2, 532, 268, 400, 400, "flip"),  # CAM_FRONT_RIGHT
)

# distinct RGB per category 1..8 (0 = background, never painted by default)
_CATEGORY_COLORS = np.array(
    [
        [1.0, 0.1, 0.1], [0.1, 1.0, 0.1], [0.1, 0.1, 1.0], [1.0, 1.0, 0.1],
        [1.0, 0.1, 1.0], [0.1, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 0.6, 0.1],
    ]
)
# color for category 0 when paint_cat0 generates it (the label_offset A/B
# needs category-0 GT boxes to measure the reference's category-0/background
# collision — bb_fast_rcnn.py:69,172-188). Saturated pink: as separable from
# the tint/gradient background as the 8 category colors (a first attempt
# used mid-range brown [0.55, 0.27, 0.07], which is inside the background
# color distribution — BOTH A/B arms stalled because ~1/9 of boxes carried
# no visual evidence).
_CAT0_COLOR = np.array([1.0, 0.3, 0.6])


def _invert_orient(orient, oy0, oy1, ox0, ox1):
    """Oriented-view rect -> original-view rect (float, exclusive upper)."""
    if orient == "id":
        return oy0, oy1, ox0, ox1
    if orient == "ccw":  # out[i, j] = in[j, W-1-i]  (in 256x306 -> out 306x256)
        return ox0, ox1, IMAGE_W - oy1, IMAGE_W - oy0
    if orient == "cw":  # out[i, j] = in[H-1-j, i]
        return IMAGE_H - ox1, IMAGE_H - ox0, oy0, oy1
    # flip both axes
    return IMAGE_H - oy1, IMAGE_H - oy0, IMAGE_W - ox1, IMAGE_W - ox0


def paint_layout_rect(views, x0, y0, x1, y1, color, size=800):
    """Paint `color` into the camera views exactly where the layout transform
    will place the pixel rect [x0, x1) x [y0, y1) of the square layout image.

    `views`: list/dict-values of six [IMAGE_H, IMAGE_W, 3] float arrays in
    IMAGE_NAMES order. Coordinates are layout-image pixels (x = col, y = row),
    i.e. the frame of ops.coords.corners_to_aabb targets.
    """
    assert size == 800, "tile geometry is precomputed for the 800px layout"
    for cam, ty0, th, tx0, tw, orient in _LAYOUT_TILES:
        cx0, cx1 = max(x0, tx0), min(x1, tx0 + tw)
        cy0, cy1 = max(y0, ty0), min(y1, ty0 + th)
        if cx1 <= cx0 or cy1 <= cy0:
            continue
        oh, ow = (IMAGE_W, IMAGE_H) if orient in ("ccw", "cw") else (IMAGE_H, IMAGE_W)
        # tile-local -> oriented-view coords (undo the bilinear resize scale)
        oy0, oy1 = (cy0 - ty0) * oh / th, (cy1 - ty0) * oh / th
        ox0, ox1 = (cx0 - tx0) * ow / tw, (cx1 - tx0) * ow / tw
        vy0, vy1, vx0, vx1 = _invert_orient(orient, oy0, oy1, ox0, ox1)
        ry0, ry1 = int(np.floor(vy0)), int(np.ceil(vy1))
        rx0, rx1 = int(np.floor(vx0)), int(np.ceil(vx1))
        ry0, ry1 = max(0, ry0), min(IMAGE_H, max(ry1, ry0 + 1))
        rx0, rx1 = max(0, rx0), min(IMAGE_W, max(rx1, rx0 + 1))
        views[cam][ry0:ry1, rx0:rx1, :] = color


def _make_scene(root, scene_id, n_samples, rng, labeled, rows, fixed_road=False,
                structured=False, paint_boxes=False, road_from_tint=False,
                road_noise=None, paint_scale=(30.0, 150.0), paint_cat0=False):
    for s in range(n_samples):
        d = os.path.join(root, f"scene_{scene_id}", f"sample_{s}")
        os.makedirs(d, exist_ok=True)
        # structured: per-sample global tint + gradient shared by all six
        # views, so the masked view is PREDICTABLE from the other five — the
        # signal the AE pretext task needs to show a real val-MSE drop
        # (pure noise has no cross-view correlation to learn). Box painting
        # is done below per-view; keep the arrays around for it.
        tint = rng.rand(3) * 0.5 if structured else None
        imgs = {}
        for name in IMAGE_NAMES:
            if structured:
                gx = np.linspace(0, 0.4, IMAGE_W)[None, :, None]
                img = tint[None, None, :] + gx + rng.rand(IMAGE_H, IMAGE_W, 3) * 0.08
                img = np.clip(img, 0, 1)
            else:
                img = rng.rand(IMAGE_H, IMAGE_W, 3) * 0.5 + 0.25
            imgs[name] = img
        if labeled:
            from PIL import Image

            ego = np.full((800, 800, 3), 255, np.uint8)
            if road_from_tint:
                # Re-armed roadmap gate target (VERDICT r3 item 3): the road
                # blob's position is a FUNCTION OF THE IMAGES — tint buckets
                # pick one of a 3x3 grid of positions — so the task tests
                # representation transfer (a constant prediction can't ace
                # it, unlike the old fixed blob that saturated TS at 1.0).
                # Requires structured=True (tint must be visible in views).
                assert structured, "road_from_tint needs structured images"
                gi = min(int(tint[0] / 0.5 * 3), 2)
                gj = min(int(tint[1] / 0.5 * 3), 2)
                r0, c0 = 100 + gi * 200, 100 + gj * 200
            elif fixed_road:
                # deterministic blob so a model can actually FIT the target
                # (the random-position blob is uncorrelated with the images)
                r0, c0 = 300, 300
            else:
                r0, c0 = rng.randint(100, 500, 2)
            ego[r0 : r0 + 200, c0 : c0 + 200] = 128  # a road blob (non-white)
            if road_noise is not None:
                # Irreducible label noise caps achievable TS at a computable
                # mid-range ceiling so the gate carries information at both
                # ends (VERDICT r3 weak 2: a metric at 1.0 registers no
                # regressions). p_drop on road pixels -> white, p_add on
                # background -> gray. With a 200x200 blob, p=(0.2, 0.01):
                # optimal TS = 0.8*A / (A + 0.8*A + 0.01*(640000-A) - 0.8*A)
                #            = 32000 / 46000 ~= 0.70.
                p_drop, p_add = road_noise
                flip = rng.rand(800, 800)
                road_px = (ego[..., 0] == 128)
                ego[road_px & (flip < p_drop)] = 255
                ego[(~road_px) & (flip < p_add)] = 128
            Image.fromarray(ego).save(os.path.join(d, "ego.png"))
            views = [imgs[n] for n in IMAGE_NAMES]
            for _ in range(rng.randint(1, 5)):
                cx, cy = rng.uniform(-30, 30, 2)
                if paint_boxes:
                    # Box extents from `paint_scale` (px, log-uniform),
                    # near-axis-aligned so pixel AABBs match the sampled
                    # shape. Two measured failure modes (scripts/
                    # probe_det_learn.py) shape the gate's choice of range:
                    # (1) anchor types with no labeled examples at painted
                    # cells undergo score inflation through the shared RPN
                    # feature (pos_in_top2000 0.08 -> 0.00 while AUC climbs
                    # to 0.91) — boxes must span the anchor set in use;
                    # (2) the reference-parity c3 trunk has an ~11 px
                    # receptive field, so for boxes much larger than it all
                    # interior cells are indistinguishable and pre-NMS top-k
                    # selection degenerates into a tie lottery over ~200k
                    # anchors (AUC 0.81, recall 0) — a LEARNABILITY gate
                    # must keep boxes within the RF (~10-18 px with small
                    # anchors to match).
                    s_px = np.exp(rng.uniform(*np.log(paint_scale)))
                    if paint_scale[0] == paint_scale[1]:
                        # degenerate range = single-scale mode: square,
                        # axis-aligned — one anchor type suffices and the
                        # task isolates localization from scale selection
                        ratio, ang = 1.0, 0.0
                    else:
                        ratio = np.exp(rng.uniform(np.log(0.5), np.log(2.0)))
                        ang = rng.choice([0.0, np.pi / 2]) + rng.randn() * 0.06
                    w = s_px / np.sqrt(ratio) / 20.0  # half-extent, meters
                    h = s_px * np.sqrt(ratio) / 20.0
                    lim = 38.0 - max(w, h)
                    cx, cy = np.clip([cx, cy], -lim, lim)
                else:
                    w, h = rng.uniform(1, 3), rng.uniform(2, 5)
                    ang = rng.uniform(0, np.pi)
                R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
                local = np.array([[+w, +w, -w, -w], [+h, -h, +h, -h]])
                pts = R @ local + np.array([[cx], [cy]])
                # painted mode keeps categories off 0: the pipeline feeds raw
                # category ids where 0 collides with the background label
                # (reference quirk, bb_fast_rcnn.py:172-188) and eval drops
                # class 0 — a category-0 GT box is undetectable by design, so
                # a learnability gate must not generate any
                lo = 0 if (paint_boxes and paint_cat0) else 1
                category = int(rng.randint(lo, 9)) if paint_boxes else int(rng.randint(0, 9))
                rows.append(
                    dict(
                        scene=scene_id,
                        sample=s,
                        category_id=category,
                        action_id=int(rng.randint(0, 4)),
                        fl_x=pts[0, 0], fr_x=pts[0, 1], bl_x=pts[0, 2], br_x=pts[0, 3],
                        fl_y=pts[1, 0], fr_y=pts[1, 1], bl_y=pts[1, 2], br_y=pts[1, 3],
                    )
                )
                if paint_boxes:
                    # paint the box's pixel AABB into the exact view pixels the
                    # layout transform maps onto it (see paint_layout_rect),
                    # colored by category — so detection evidence appears at
                    # the target location in the detector's input, within the
                    # trunk's receptive field, with class signal
                    px = pts[0] * 10.0 + 400.0
                    py = -pts[1] * 10.0 + 400.0  # corners_to_aabb y-flip
                    color = (_CAT0_COLOR if category == 0
                             else _CATEGORY_COLORS[category - 1])
                    paint_layout_rect(
                        views, px.min(), py.min(), px.max(), py.max(), color,
                    )
        for name, img in imgs.items():
            _save_jpeg(os.path.join(d, name), img)


def generate(out, scenes=2, samples=4, labeled_scenes=2, seed=0, fixed_road=False,
             structured=False, paint_boxes=False, road_from_tint=False,
             road_noise=None, paint_scale=(30.0, 150.0), paint_cat0=False):
    import pandas as pd

    rng = np.random.RandomState(seed)
    os.makedirs(out, exist_ok=True)
    rows: list[dict] = []
    for i in range(scenes):
        _make_scene(out, i, samples, rng, labeled=False, rows=rows,
                    structured=structured)
    for i in range(labeled_scenes):
        _make_scene(out, 106 + i, samples, rng, labeled=True, rows=rows,
                    fixed_road=fixed_road, structured=structured,
                    paint_boxes=paint_boxes, road_from_tint=road_from_tint,
                    road_noise=road_noise, paint_scale=paint_scale,
                    paint_cat0=paint_cat0)
    pd.DataFrame(rows).to_csv(os.path.join(out, "annotation.csv"), index=False)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--labeled-scenes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-road", action="store_true",
                    help="deterministic road blob (learnable target for "
                         "convergence runs; random per-sample otherwise)")
    ap.add_argument("--structured", action="store_true",
                    help="cross-view-correlated images (tint+gradient) so the "
                         "AE pretext task has signal to learn")
    ap.add_argument("--paint-boxes", action="store_true",
                    help="paint GT boxes into the camera views so detection "
                         "has an image->box correspondence to learn")
    ap.add_argument("--road-from-tint", action="store_true",
                    help="road blob position determined by the per-sample "
                         "tint (image-dependent target; needs --structured)")
    ap.add_argument("--road-noise", type=float, nargs=2, default=None,
                    metavar=("P_DROP", "P_ADD"),
                    help="flip road pixels to background (P_DROP) and "
                         "background to road (P_ADD): caps achievable TS "
                         "at a mid-range ceiling")
    a = ap.parse_args(argv)
    generate(a.out, a.scenes, a.samples, a.labeled_scenes, a.seed,
             fixed_road=a.fixed_road, structured=a.structured,
             paint_boxes=a.paint_boxes, road_from_tint=a.road_from_tint,
             road_noise=tuple(a.road_noise) if a.road_noise else None)
    print(f"synthetic dataset written to {a.out}")


if __name__ == "__main__":
    main()

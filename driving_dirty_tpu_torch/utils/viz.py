"""Plotting and image-logging helpers (driving_dirty_tpu/utils/viz.py).

The functions the reference imports but never defines: `plot_image`,
`plot_all_boxes_new`, `log_bb_images` and `log_fast_rcnn_images`, and
`draw_box`, which pins the meter-to-pixel plot transform (px = m * 10 +
400, y negated, corner order fl fr br bl through [0, 1, 3, 2, 0]).

Host-side only (matplotlib's Agg backend): each returns an HWC uint8 or
float array for train/logging.py's `log_image`, and nothing here touches a
training step. matplotlib is imported inside the functions, so importing
this module needs only numpy; a host without matplotlib (the H100
machine has none) can import it but not plot, and nothing on the card's
path calls it.
"""
from __future__ import annotations

import numpy as np


def _fig_to_array(fig):
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def draw_box(ax, corners, color):
    """Plot one [2, 4] meter-space corner box on `ax`."""
    corners = np.asarray(corners)
    seq = corners[:, [0, 1, 3, 2, 0]]  # fl -> fr -> br -> bl -> fl
    ax.plot(seq[0] * 10 + 400, -seq[1] * 10 + 400, color=color)


def plot_image(image_hwc):
    """Render an [H, W, C] (or [H, W]) array as a matplotlib image -> RGB array."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 4), dpi=100)
    ax.imshow(np.asarray(image_hwc), cmap=None if np.ndim(image_hwc) == 3 else "gray")
    ax.axis("off")
    return _fig_to_array(fig)


def plot_all_boxes_new(boxes, valid=None, color="red", size=800):
    """Render [N, 2, 4] meter-space boxes on an 800x800 BEV canvas -> RGB
    array (how the reference's box MLP shows predicted and target boxes)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    boxes = np.asarray(boxes)
    fig, ax = plt.subplots(figsize=(4, 4), dpi=100)
    ax.set_xlim(0, size)
    ax.set_ylim(size, 0)
    ax.set_aspect("equal")
    for i, box in enumerate(boxes):
        if valid is not None and not valid[i]:
            continue
        draw_box(ax, box, color)
    ax.axis("off")
    return _fig_to_array(fig)


def log_bb_images(logger, step, x_pano, target_img, pred_img, step_name):
    """The coordinate-regression task's three logged images: the stitched
    input and the target and predicted box plots."""
    logger.log_image(f"{step_name}_input_images", np.asarray(x_pano), step)
    logger.log_image(f"{step_name}_target_boxes", np.asarray(target_img) / 255.0, step)
    logger.log_image(f"{step_name}_pred_boxes", np.asarray(pred_img) / 255.0, step)


def log_fast_rcnn_images(
    logger, step, image_hwc, pred_boxes, pred_categories, target_boxes,
    target_categories, road_image, step_name, pred_valid=None, target_valid=None,
):
    """Predicted (red) and target (green) boxes over the square layout
    image, beside the road map."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(8, 4), dpi=100)
    axes[0].imshow(np.clip(np.asarray(image_hwc), 0, 1))
    for i, box in enumerate(np.asarray(pred_boxes)):
        if pred_valid is not None and not pred_valid[i]:
            continue
        draw_box(axes[0], box, "red")
    for i, box in enumerate(np.asarray(target_boxes)):
        if target_valid is not None and not target_valid[i]:
            continue
        draw_box(axes[0], box, "green")
    axes[0].axis("off")
    axes[1].imshow(np.asarray(road_image), cmap="gray")
    axes[1].axis("off")
    arr = _fig_to_array(fig)
    logger.log_image(f"{step_name}_detections", arr / 255.0, step)
    return arr

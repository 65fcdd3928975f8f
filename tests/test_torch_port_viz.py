"""driving_dirty_tpu_torch/utils/viz.py and utils/raster_pil.py against the
JAX package's (driving_dirty_tpu/utils/viz.py, utils/raster_pil.py), on
the CPU:

  * each plot (an RGB image, a gray map, seeded box scenes on the BEV
    canvas, and the two logging helpers' arrays through a recording
    logger) equals the JAX package's for the same inputs, pixel for pixel
    (one matplotlib draws both);
  * the port's PIL oracle equals the JAX package's on seeded scenes
    (data/boxes.py:box_scenes, valid boxes only), and the port's plain B2
    (kernels/raster.py on CPU tensors) agrees with it as the JAX package
    holds its own rasterizer to the PIL fill
    (tests/test_reference_utils_parity.py): at least 99% of the pixels
    equal, every differing pixel next to the edge of one of the boxes
    drawn alone (PIL's scan-line boundary rule differs from the exact
    point-in-polygon fill on edge pixels only; where two boxes nearly
    touch, PIL's inclusive edges can close the one-pixel gap between them).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import numpy as np
import pytest
import torch

from driving_dirty_tpu.utils import raster_pil as JR
from driving_dirty_tpu.utils import viz as JV
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.kernels.raster import raster
from driving_dirty_tpu_torch.utils import raster_pil as R
from driving_dirty_tpu_torch.utils import viz as V

class Recorder:
    def __init__(self):
        self.images = {}

    def log_image(self, name, array, step):
        self.images[name] = (np.asarray(array), step)


def _scene(seed=0):
    boxes, valid = box_scenes(seed, 1, 100)
    return boxes[0], valid[0]


def test_plot_image_is_the_jax_packages():
    rng = np.random.RandomState(0)
    for image in (rng.rand(32, 48, 3).astype(np.float32), rng.rand(40, 40).astype(np.float32)):
        got, ref = V.plot_image(image), JV.plot_image(image)
        assert got.dtype == np.uint8 and got.shape == ref.shape and got.shape[-1] == 3
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_plot_all_boxes_is_the_jax_packages(seed):
    boxes, valid = _scene(seed)
    got = V.plot_all_boxes_new(boxes, valid, color="green")
    np.testing.assert_array_equal(got, JV.plot_all_boxes_new(boxes, valid, color="green"))
    assert not np.array_equal(got, V.plot_all_boxes_new(boxes[:0]))  # the boxes are drawn


def test_the_logging_helpers_log_the_jax_packages_arrays():
    rng = np.random.RandomState(1)
    boxes, valid = _scene(2)
    pano = rng.rand(16, 96, 3)
    target, pred = V.plot_all_boxes_new(boxes, valid), V.plot_all_boxes_new(boxes[::-1], valid[::-1], "red")
    image, road = rng.rand(64, 64, 3), (rng.rand(32, 32) > 0.5).astype(np.float32)
    got, ref = Recorder(), Recorder()
    for mod, log in ((V, got), (JV, ref)):
        mod.log_bb_images(log, 3, pano, target, pred, "val")
        arr = mod.log_fast_rcnn_images(log, 3, image, boxes[:5], None, boxes[5:9], None, road, "val",
                                       pred_valid=valid[:5], target_valid=valid[5:9])
        assert arr.dtype == np.uint8
    assert sorted(got.images) == sorted(ref.images) == ["val_detections", "val_input_images", "val_pred_boxes",
                                                         "val_target_boxes"]
    for name, (a, step) in got.images.items():
        assert step == ref.images[name][1] == 3
        np.testing.assert_array_equal(a, ref.images[name][0], err_msg=name)


def _near_an_edge(ref, width=1):
    """Pixels within `width` of a pixel whose 4-neighbour differs in `ref`."""
    edge = np.zeros(ref.shape, bool)
    edge[1:] |= ref[1:] != ref[:-1]
    edge[:-1] |= ref[1:] != ref[:-1]
    edge[:, 1:] |= ref[:, 1:] != ref[:, :-1]
    edge[:, :-1] |= ref[:, 1:] != ref[:, :-1]
    near = edge.copy()
    for _ in range(width):
        grown = near.copy()
        grown[1:] |= near[:-1]
        grown[:-1] |= near[1:]
        grown[:, 1:] |= near[:, :-1]
        grown[:, :-1] |= near[:, 1:]
        near = grown
    return near


def _near_a_box_edge(boxes, pixels):
    """Whether each (row, col) of `pixels` lies next to the edge of a box of
    `boxes` drawn alone by PIL (only boxes whose pixel extent comes within
    2 px of one are drawn)."""
    near = np.zeros(len(pixels), bool)
    for box in boxes:
        col, row = box[0] * 10 + 400, 799 - (box[1] * 10 + 400)
        close = ((pixels[:, 1] >= col.min() - 2) & (pixels[:, 1] <= col.max() + 2)
                 & (pixels[:, 0] >= row.min() - 2) & (pixels[:, 0] <= row.max() + 2))
        if close.any():
            edge = _near_an_edge(R.boxes_to_binary_map_pil(box[None]))
            near |= close & edge[pixels[:, 0], pixels[:, 1]]
    return near


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_pil_oracle_is_the_jax_packages_and_holds_the_plain_b2(seed):
    boxes, valid = box_scenes(seed, 4, 100)
    maps = raster(torch.from_numpy(boxes), torch.from_numpy(valid), 800).numpy()
    for i in range(len(boxes)):
        ref = R.boxes_to_binary_map_pil(boxes[i][valid[i]])
        np.testing.assert_array_equal(ref, JR.boxes_to_binary_map_pil(boxes[i][valid[i]]))
        assert ref.shape == (800, 800) and ref.dtype == np.float32 and ref.any()
        differ = maps[i] != ref
        assert differ.mean() <= 0.01, (seed, i, differ.mean())
        pixels = np.argwhere(differ & ~_near_an_edge(ref))
        assert _near_a_box_edge(boxes[i][valid[i]], pixels).all(), (seed, i, pixels)

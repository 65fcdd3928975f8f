"""The box rasterizer of driving_dirty_tpu_torch (ops/maps.py, the plain
version of kernel B2, and its wrapper kernels/raster.py) and the map
converters, against the JAX package on the CPU.

Every comparison is exact: the rasterizer is a {0,1} map from the same
float32 edge tests, so one differing pixel is a fault. The JAX sides are
ops/maps.boxes_to_binary_map at sizes 800, 152, 148 and 157, and the Pallas
kernel pallas/raster.boxes_to_binary_map_pallas at 800 under
pltpu.force_tpu_interpret_mode(), as tests/test_pallas_raster.py runs it.
The CUDA kernel is held against the plain version on the card
(tests/test_torch_port_gpu.py).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from driving_dirty_tpu.ops import maps as JM
from driving_dirty_tpu.pallas.raster import boxes_to_binary_map_pallas
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.kernels.raster import raster
from driving_dirty_tpu_torch.ops import maps as M

SIZES = [800, 152, 148, 157]


def _case(name):
    """[N, 2, 4] boxes and [N] valid: a scene with every edge case of
    data/boxes.py (zero area, reversed winding, axis-aligned on 0.1 m, a
    real invalid box, zero padding, boxes crossing the map edge), an
    all-invalid one, and a single box."""
    boxes, valid = box_scenes(7, batch=1, max_bb=16)
    boxes, valid = boxes[0], valid[0]
    if name == "all_invalid":
        valid = np.zeros_like(valid)
    elif name == "one_box":
        boxes, valid = boxes[3:4], valid[3:4]
    return boxes, valid


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", ["scene", "all_invalid", "one_box"])
def test_plain_raster_equals_jax(case, size):
    boxes, valid = _case(case)
    ref = np.asarray(JM.boxes_to_binary_map(jnp.asarray(boxes), jnp.asarray(valid), size=size))
    got = M.boxes_to_binary_map(torch.from_numpy(boxes), torch.from_numpy(valid), size=size)
    assert got.dtype == torch.float32 and tuple(got.shape) == (size, size)
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "all_invalid":
        assert ref.sum() == 0
    else:
        assert ref.sum() > 0


@pytest.mark.parametrize("case", ["scene", "all_invalid", "one_box"])
def test_plain_raster_equals_pallas_interpret(case):
    boxes, valid = _case(case)
    # the valid zero-area box is left out here: the jitted Pallas wrapper
    # counts it (test_pallas_wrapper_counts_a_valid_point_box)
    valid[0] = False
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(boxes_to_binary_map_pallas(jnp.asarray(boxes), jnp.asarray(valid)))
    got = M.boxes_to_binary_map(torch.from_numpy(boxes), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_pallas_wrapper_counts_a_valid_point_box():
    """A parity fault of the JAX package, pinned (ROADMAP C): under jit,
    XLA:CPU contracts px*nby - nbx*py into an fma, so the doubled area of a
    valid box whose four corners coincide comes out ~1e-3 instead of 0,
    passes the > 1e-6 degeneracy test, and, with all edges zero, fills the
    whole map. The eager jnp version and the port give an empty map, as
    ops/maps.py specifies."""
    boxes, valid = _case("scene")
    point, ok = jnp.asarray(boxes[:1]), jnp.asarray(valid[:1])
    assert valid[0] and np.ptp(boxes[0], axis=1).max() == 0
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(boxes_to_binary_map_pallas(point, ok))
    assert pallas.min() == 1.0
    assert np.asarray(JM.boxes_to_binary_map(point, ok)).max() == 0.0
    assert M.boxes_to_binary_map(torch.from_numpy(boxes[:1]), torch.from_numpy(valid[:1])).max() == 0


def test_edge_cases_count_as_specified():
    """The zero-area and the invalid box add nothing; the reversed and the
    axis-aligned box fill; an edge through pixel centres counts them."""
    boxes, valid = _case("scene")
    n = int(valid.sum())

    def alone(i, v=True):
        return M.boxes_to_binary_map(torch.from_numpy(boxes[i:i + 1]),
                                     torch.tensor([v])).sum().item()

    assert alone(0) == 0                       # zero area, valid
    assert alone(n, v=False) == 0              # real box, invalid
    assert alone(n, v=True) > 0                # ... which would fill if valid
    assert alone(1) > 0                        # wound the other way
    x0, y0 = boxes[2, 0, 2], boxes[2, 1, 3]    # axis-aligned, corners on 0.1 m
    length, width = boxes[2, 0, 0] - x0, boxes[2, 1, 0] - y0
    # at 800 px every corner lies within float error of a pixel centre, and
    # the inclusive edge test counts the border: (10 l + 1) x (10 w + 1)
    assert alone(2) == round(10 * length + 1) * round(10 * width + 1)


def test_batched_wrapper_on_cpu_is_the_plain_version():
    boxes, valid = box_scenes(3, batch=3, max_bb=16)
    got = raster(torch.from_numpy(boxes), torch.from_numpy(valid), 157)
    assert tuple(got.shape) == (3, 157, 157)
    for b in range(3):
        ref = JM.boxes_to_binary_map(jnp.asarray(boxes[b]), jnp.asarray(valid[b]), size=157)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
    # N = 0 and B = 0 give empty maps of the right shape
    assert raster(torch.zeros(2, 0, 2, 4), torch.zeros(2, 0, dtype=torch.bool), 9).sum() == 0
    assert tuple(raster(torch.zeros(0, 4, 2, 4), torch.zeros(0, 4, dtype=torch.bool), 9).shape) == (0, 9, 9)


def test_raster_rejects_what_it_does_not_take():
    boxes, valid = torch.zeros(1, 2, 2, 4), torch.ones(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError):
        raster(boxes.to("meta"), valid.to("meta"), 8)
    with pytest.raises(ValueError):
        M.boxes_to_binary_map(boxes, valid, size=0)
    with pytest.raises(ValueError):
        M.boxes_to_binary_map(torch.zeros(1, 2, 3, 4), valid, size=8)


def test_pixels_a_box_sets_lie_within_its_bounding_rectangle_plus_two():
    """The pixels a box sets lie within its bounding rectangle widened by
    2 px, checked on the plain version for cars, trucks and slivers at two
    sizes. (csrc/raster.cu does not rely on it: it finds each box's span in
    every row of the map, so no margin has to hold for its exactness.)"""
    rng = np.random.RandomState(11)
    boxes, _ = box_scenes(5, batch=1, max_bb=64)
    boxes = boxes[0, 3:60]
    sliver = rng.uniform(-40, 40, (40, 2, 1)) + np.stack(
        [rng.uniform(-20, 20, (40, 4)), rng.uniform(-1e-3, 1e-3, (40, 4))], axis=1)
    boxes = np.concatenate([boxes, sliver.astype(np.float32)])
    for size in (800, 157):
        scale, offset = (np.float32(v) for v in M.raster_geometry(size))
        maps = M.boxes_to_binary_map(torch.from_numpy(boxes)[:, None],
                                     torch.ones(len(boxes), 1, dtype=torch.bool), size=size).numpy()
        for box, m in zip(boxes, maps):
            rows, cols = np.nonzero(m)
            if rows.size == 0:
                continue
            yy = (size - 1) - rows  # pre-flip rows
            px, py = box[0] * scale + offset, box[1] * scale + offset
            assert yy.min() >= py.min() - 2 and yy.max() <= py.max() + 2
            assert cols.min() >= px.min() - 2 and cols.max() <= px.max() + 2


def test_map_converters_match_jax():
    rng = np.random.RandomState(2)
    ego = rng.choice(np.float32([0, 250 / 255, 0.5, 1]), size=(3, 12, 10)).astype(np.float32)
    ego[:, :3] = 1.0  # pure white rows
    road = M.convert_map_to_road_map(torch.from_numpy(ego)).numpy()
    np.testing.assert_array_equal(road, np.asarray(JM.convert_map_to_road_map(jnp.asarray(ego))))
    for binary in (True, False):
        got = M.convert_map_to_lane_map(torch.from_numpy(ego), binary).numpy()
        ref = np.asarray(JM.convert_map_to_lane_map(jnp.asarray(ego), binary))
        np.testing.assert_array_equal(got, ref)

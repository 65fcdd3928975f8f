"""The port's native host helpers against the JAX package's and PIL on the
CPU: the libjpeg/libpng decoder (data/_native.py, data/native/loader.cpp),
the dataset's choice of decode backend (data/dataset.py), and the IoU loop
and host rasterizer (metrics/_native.py, metrics/native/iou.cpp) under
metrics/threat.py:ats_bounding_boxes.

Inputs come from the synthetic dataset generator (seed 3) and numpy seeds.
Tolerances: none. Decoded bytes and f32 pixels equal the JAX decoder's and
PIL's exactly (the same libjpeg and libpng calls); dataset items are equal
across backends; the IoU matrix and raster maps equal the JAX native
library's bit for bit (the same source and flags); the box threat score
equals the JAX package's exactly on the native and the Python paths.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import os
from unittest import mock

import numpy as np
import pytest

from driving_dirty_tpu.data import _native as jax_native
from driving_dirty_tpu.metrics import _native as jax_iou
from driving_dirty_tpu.metrics import threat as JT
from driving_dirty_tpu_torch.data import _native as native
from driving_dirty_tpu_torch.data import dataset as ds
from driving_dirty_tpu_torch.data.synthetic import generate
from driving_dirty_tpu_torch.metrics import _native as iou
from driving_dirty_tpu_torch.metrics import threat as TT


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_native_data")
    generate(str(d), scenes=1, samples=2, labeled_scenes=1, seed=3)
    return str(d)


def _pil(path, raw_uint8):
    from PIL import Image

    with Image.open(path) as im:
        a = np.asarray(im.convert("RGB"), np.uint8)
    return a if raw_uint8 else a.astype(np.float32) / 255.0


@pytest.mark.parametrize("raw_uint8", [True, False])
@pytest.mark.parametrize("name,h,w", [("scene_0/sample_0/CAM_FRONT.jpeg", 256, 306),
                                      ("scene_106/sample_1/CAM_BACK_LEFT.jpeg", 256, 306),
                                      ("scene_106/sample_0/ego.png", 800, 800)])
def test_decode_image_equals_jax_decoder_and_pil(data_root, name, h, w, raw_uint8):
    p = os.path.join(data_root, name)
    got = native.decode_image(p, h, w, raw_uint8=raw_uint8)
    assert got.dtype == (np.uint8 if raw_uint8 else np.float32) and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jax_native.decode_image(p, h, w, raw_uint8=raw_uint8))
    np.testing.assert_array_equal(got, _pil(p, raw_uint8))


@pytest.mark.parametrize("raw_uint8", [True, False])
def test_decode_batch_equals_jax_decoder_and_pil(data_root, raw_uint8):
    paths = [os.path.join(data_root, "scene_0", "sample_1", n) for n in ds.IMAGE_NAMES]
    out = np.empty((6, ds.IMAGE_H, ds.IMAGE_W, 3), np.uint8 if raw_uint8 else np.float32)
    got = native.decode_batch(paths, ds.IMAGE_H, ds.IMAGE_W, raw_uint8=raw_uint8, nthreads=2, out=out)
    assert got is out
    np.testing.assert_array_equal(got, jax_native.decode_batch(paths, ds.IMAGE_H, ds.IMAGE_W,
                                                               raw_uint8=raw_uint8))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], _pil(p, raw_uint8))


def test_missing_corrupt_and_misshapen_files_raise_oserror(tmp_path, data_root):
    with pytest.raises(OSError, match="open"):
        native.decode_image(str(tmp_path / "nope.jpeg"), 4, 4)
    bad = tmp_path / "bad.jpeg"
    bad.write_bytes(b"\xff\xd8not a real jpeg stream")
    with pytest.raises(OSError, match="decode"):
        native.decode_image(str(bad), 4, 4)
    front = os.path.join(data_root, "scene_0", "sample_0", "CAM_FRONT.jpeg")
    with pytest.raises(OSError, match="shape"):
        native.decode_image(front, 128, 128)
    with pytest.raises(OSError, match="open"):
        native.decode_batch([front, str(tmp_path / "nope.jpeg")], 256, 306)


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_dataset_items_equal_across_backends_and_counted(data_root, monkeypatch, raw_uint8):
    """Items do not depend on the backend (DD_NATIVE_DECODE on and off), and
    `DECODES` counts what each backend decoded: the six views and the ego
    map natively, everything through PIL with DD_NATIVE_DECODE=0."""

    def items(env):
        monkeypatch.setenv("DD_NATIVE_DECODE", env)
        monkeypatch.setattr(ds, "_native", False)  # probe again under the new env
        monkeypatch.setattr(ds, "DECODES", {"native": 0, "pil": 0})
        u = ds.UnlabeledDataset(data_root, np.arange(1), samples_per_scene=2, raw_uint8=raw_uint8)
        ui = ds.UnlabeledDataset(data_root, np.arange(1), first_dim="image", samples_per_scene=2,
                                 raw_uint8=raw_uint8)
        lab = ds.LabeledDataset(data_root, os.path.join(data_root, "annotation.csv"), np.arange(106, 107),
                                samples_per_scene=2, raw_uint8=raw_uint8)
        return (u[1], ui[3], lab[0]), dict(ds.DECODES), ds.native_error()

    (nu, nui, nl), n_counts, n_err = items("1")
    (pu, pui, pl), p_counts, p_err = items("0")
    assert n_counts == {"native": 6 + 1 + 6 + 1, "pil": 0} and n_err is None
    assert p_counts == {"native": 0, "pil": 14} and p_err == "DD_NATIVE_DECODE=0"
    np.testing.assert_array_equal(nu, pu)
    np.testing.assert_array_equal(nui[0], pui[0])
    assert nui[1] == pui[1]
    for k in nl:
        np.testing.assert_array_equal(nl[k], pl[k], err_msg=k)
    assert nu.dtype == (np.uint8 if raw_uint8 else np.float32)


def test_an_odd_file_falls_back_to_pil(data_root, tmp_path, monkeypatch):
    """A view of another size is refused by the native decoder and decoded
    by PIL, as the JAX package does."""
    from PIL import Image

    monkeypatch.setattr(ds, "DECODES", {"native": 0, "pil": 0})
    small = tmp_path / "small.jpeg"
    Image.fromarray(np.full((10, 12, 3), 77, np.uint8)).save(small)
    got = ds._load_image(str(small), raw_uint8=True, shape=(ds.IMAGE_H, ds.IMAGE_W))
    assert got.shape == (10, 12, 3) and ds.DECODES == {"native": 0, "pil": 1}
    np.testing.assert_array_equal(got, _pil(str(small), True))


def test_build_error_keeps_the_compiler_message(tmp_path):
    from driving_dirty_tpu_torch.kernels import build

    src = tmp_path / "broken.cpp"
    src.write_text('#include "no_such_header_anywhere.h"\n')
    with pytest.raises(RuntimeError, match="no_such_header_anywhere"):
        build.host_library("dd_broken_test", src)


def _boxes(rng, n, spread=20.0):
    centre = rng.uniform(-spread, spread, (n, 2, 1))
    size = rng.uniform(0.5, 5.0, (n, 2, 1))
    corners = np.array([[-1, 1, -1, 1], [1, 1, -1, -1]], np.float64)[None] * size / 2
    return centre + corners + rng.normal(0, 0.2, (n, 2, 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_pair_iou_equals_jax_native(seed):
    rng = np.random.RandomState(seed)
    b1, b2 = _boxes(rng, 40), _boxes(rng, 35)
    cond = rng.rand(40, 35) > 0.3
    got = iou.masked_pair_iou(b1, b2, cond)
    np.testing.assert_array_equal(got, jax_iou.masked_pair_iou(b1, b2, cond))
    assert (got[~cond] == 0).all() and got.max() > 0


@pytest.mark.parametrize("size", [800, 157])
def test_rasterize_boxes_equals_jax_native(size):
    rng = np.random.RandomState(size)
    boxes = _boxes(rng, 30, spread=35.0)
    valid = rng.rand(30) > 0.2
    for v in (valid, None):
        got = iou.rasterize_boxes(boxes, v, size)
        np.testing.assert_array_equal(got, jax_iou.rasterize_boxes(boxes, v, size))
    assert got.sum() > 0


@pytest.mark.parametrize("seed", [2, 3])
def test_ats_bounding_boxes_equals_jax_on_both_paths(seed):
    """The native loop and the Python loop give the JAX package's score."""
    rng = np.random.RandomState(seed)
    gt = _boxes(rng, 25)
    pred = np.concatenate([gt[:15] + rng.normal(0, 0.15, (15, 2, 4)), _boxes(rng, 10)])
    ref = JT.ats_bounding_boxes(pred, gt)
    assert TT._native_iou() is iou
    native_score = TT.ats_bounding_boxes(pred, gt)
    with mock.patch.object(TT, "_native_iou", lambda: None):
        python_score = TT.ats_bounding_boxes(pred, gt)
    assert 0 < ref < 1
    assert native_score == python_score == ref

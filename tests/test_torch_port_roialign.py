"""RoIAlign (kernel B3's plain version, kernels/roialign.py:roialign_plain,
and its callers ops/detection.py:roi_align / batched_roi_align) against the
JAX package on the CPU: its XLA path (ops/detection.py:batched_roi_align)
and its Pallas kernel (pallas/roialign.py:roi_align_fused through
batched_roi_align_fused, in interpret mode, as
tests/test_pallas_roialign.py runs it).

Seeded features in [0, 1) and rois of 0 to 60 px that cross the map's edge,
one of zero size, spatial_scale 0.5, R = 16 and 33. Tolerance 1e-5 absolute
and relative (f32; the plain version gathers and lerps each sample, the XLA
path contracts interpolation matrices, so the sums run in another order).
bf16 features against the JAX package's bf16 path: 2^-7 absolute (the JAX
path rounds its interpolation weights and row pass to bf16, the port keeps
f32 weights; a few bf16 ulps of values below 1).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import driving_dirty_tpu.pallas.roialign as pr
from driving_dirty_tpu.ops import detection as JD
from driving_dirty_tpu_torch.kernels import roialign as K
from driving_dirty_tpu_torch.ops import detection as TD

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDENS = json.loads((Path(__file__).parent / "goldens" / "detection_goldens.json").read_text())


@pytest.fixture()
def interpret_kernel(monkeypatch):
    orig = pr.roi_align_fused
    monkeypatch.setattr(pr, "roi_align_fused", lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _inputs(r, b=2, h=40, w=37, c=32, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(b, h, w, c).astype(np.float32)
    xy = rng.rand(b, r, 2) * 100 - 10     # pixel space is 2x the map (spatial_scale 0.5)
    wh = rng.rand(b, r, 2) * 60
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, 0] = [30, 30, 30, 30]         # zero size
    rois[-1, 1] = [-20, 60, 90, 100]      # crosses three edges
    return feats, rois


def _port(feats, rois, **kw):
    return TD.batched_roi_align(torch.from_numpy(feats), torch.from_numpy(rois), **kw).numpy()


@pytest.mark.parametrize("r", [16, 33])
def test_plain_matches_xla_and_pallas(interpret_kernel, r):
    feats, rois = _inputs(r)
    kw = dict(output_size=7, spatial_scale=0.5, sampling_ratio=2)
    launches = K.roialign.launches
    got = _port(feats, rois, **kw)
    assert K.roialign.launches == launches  # a CPU tensor never reaches the kernel
    assert got.dtype == np.float32 and got.shape == (2, r, 7, 7, 32)
    ref = np.asarray(JD.batched_roi_align(jnp.asarray(feats), jnp.asarray(rois), **kw))
    np.testing.assert_allclose(got, ref, **TOL)
    fused = np.asarray(JD.batched_roi_align_fused(jnp.asarray(feats), jnp.asarray(rois), **kw))
    np.testing.assert_allclose(got, fused, **TOL)
    # the zero-size roi samples one point: every bin holds its bilinear value
    assert np.ptp(got[0, 0], axis=(0, 1)).max() == 0.0


@pytest.mark.parametrize("aligned,out,s,c", [(True, 7, 2, 32), (False, 5, 3, 24), (False, 1, 1, 3)])
def test_plain_matches_xla_other_settings(aligned, out, s, c):
    feats, rois = _inputs(9, h=21, w=30, c=c, seed=1)
    kw = dict(output_size=out, spatial_scale=0.25, sampling_ratio=s, aligned=aligned)
    ref = np.asarray(JD.batched_roi_align(jnp.asarray(feats), jnp.asarray(rois), **kw))
    np.testing.assert_allclose(_port(feats, rois, **kw), ref, **TOL)
    one = TD.roi_align(torch.from_numpy(feats[1]), torch.from_numpy(rois[1]), **kw).numpy()
    np.testing.assert_allclose(one, ref[1], **TOL)


def test_plain_matches_jax_bf16():
    feats, rois = _inputs(16)
    kw = dict(output_size=7, spatial_scale=0.5, sampling_ratio=2)
    got = TD.batched_roi_align(torch.from_numpy(feats).bfloat16(), torch.from_numpy(rois), **kw)
    assert got.dtype == torch.float32
    ref = np.asarray(JD.batched_roi_align(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(rois), **kw))
    np.testing.assert_allclose(got.numpy(), ref.astype(np.float32), rtol=0, atol=2.0 ** -7)
    # against the same bf16 features in f32, the plain version is f32-exact
    exact = _port(np.asarray(torch.from_numpy(feats).bfloat16().float()), rois, **kw)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=0)


def test_plain_matches_goldens():
    f = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)  # f[y][x] = 4y + x
    for case in GOLDENS["roi_align"]:
        out = TD.batched_roi_align(f, torch.tensor([[case["roi"]]]), output_size=case["output_size"],
                                   sampling_ratio=case["sampling_ratio"])
        assert out.item() == pytest.approx(case["expected"]), case["name"]


def test_wrapper_rejects_other_devices():
    feats, rois = _inputs(2)
    with pytest.raises(ValueError):
        K.roialign(torch.from_numpy(feats).to("meta"), torch.from_numpy(rois).to("meta"))


@pytest.mark.parametrize("dtype,c,offset,width", [
    (torch.float32, 32, 0, 4), (torch.float32, 4, 0, 4), (torch.bfloat16, 32, 0, 8),
    (torch.bfloat16, 8, 0, 8), (torch.float32, 3, 0, 1), (torch.bfloat16, 24, 0, 8),
    (torch.bfloat16, 12, 0, 1), (torch.float32, 32, 1, 1), (torch.bfloat16, 32, 2, 1),
])
def test_channels_per_thread_picks_16_byte_loads_where_they_fit(dtype, c, offset, width):
    """The kernel instantiation the wrapper launches: 16 B of channels a
    thread where C splits into them and the data starts on 16 B, else one."""
    buf = torch.zeros(2 * 5 * 7 * c + offset, dtype=dtype)
    feats = buf[offset:].view(2, 5, 7, c)
    assert feats.is_contiguous() and (feats.data_ptr() % 16 == 0) == (offset == 0)
    assert K.channels_per_thread(feats) == width

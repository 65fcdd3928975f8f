"""RoIAlign's backward (kernels/roialign.py: roialign_backward_plain, the
plain version of kernel B3-bwd, and the CPU autograd of `roialign`)
against the JAX package on the CPU: jax.vjp of ops/detection.py:roi_align,
whose custom VJP (_roi_align_bwd) computes dF = sum_r By_r^T g_r Bx_r with
the forward's bin interpolation matrices.

Inputs from numpy seeds: NHWC features, rois of data/boxes.py:
detection_rois (sides 16-512 px, some across the image's edge, so sample
coordinates clip to the last row or column, and every 50th of zero size),
random cotangents; `aligned`, other output sizes and sampling ratios, a
single roi and an image with none.

Tolerances: the plain backward against the jitted JAX VJP (as the JAX
model runs it) within 1e-5 of max|JAX| in f32 and 2^-8 in bf16: the same
two contractions in the same dtypes (By, Bx, g and u rounded to bf16 as
the JAX package rounds them), whose sums XLA reorders under jit (measured
2.2e-6 in f32; in bf16 8.7e-4, where a reordered u rounds to the
neighbouring bf16 value; eagerly both are bit-equal).
The CPU autograd of `roialign` (roialign_plain, a gather: its backward
sums sample by sample, as B3-bwd does) against the plain backward within
1e-5 of max|plain| (the sample-level sums lie within 6.4e-6 of the
largest value from a float64 sum where 1001 rois crowd a 21 x 30 map, the
plain version's within 2.2e-7). The gradient golden of tests/goldens/detection_goldens.json
to 1e-6. The rois get no gradient.
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
from driving_dirty_tpu_torch.data.boxes import detection_rois
from driving_dirty_tpu_torch.kernels import roialign as RA
from driving_dirty_tpu_torch.ops import detection as TD

GOLDENS = json.loads((Path(__file__).parent / "goldens" / "detection_goldens.json").read_text())
JAX_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
AUTOGRAD_TOL = 1e-5
CASES = [
    ((2, 23, 31, 5, 17), dict(spatial_scale=0.5)),
    ((1, 40, 40, 32, 64), dict(spatial_scale=0.5, aligned=True)),
    ((2, 16, 19, 3, 9), dict(output_size=5, sampling_ratio=3, spatial_scale=0.25)),
    ((1, 12, 9, 8, 1), dict(spatial_scale=1.0)),
]


def _inputs(b, h, w, c, r, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.rand(b, h, w, c).astype(np.float32)
    rois = detection_rois(seed, b, r, size=2 * max(h, w))
    return feats, rois, rng


def _jax_vjp(feats, rois, g, dtype, kw):
    """jax.vjp of roi_align for each image -> (dF [B, H, W, C] f32, d rois)."""
    def one(f, r, gi):
        _, vjp = jax.vjp(lambda f_, r_: JD.roi_align(f_, r_, **kw), f.astype(dtype), r)
        df, dr = vjp(gi)
        return df.astype(jnp.float32), dr

    df, dr = jax.jit(jax.vmap(one))(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(g))
    assert not np.asarray(dr).any()  # no gradient to the rois
    return np.asarray(df)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", CASES)
def test_plain_backward_matches_jax_vjp(shape, kw, dtype):
    b, h, w, c, r = shape
    feats, rois, rng = _inputs(*shape)
    out = kw.get("output_size", 7)
    g = rng.randn(b, r, out, out, c).astype(np.float32)
    ref = _jax_vjp(feats, rois, g, getattr(jnp, dtype), kw)
    got = RA.roialign_backward(torch.from_numpy(g), torch.from_numpy(rois), (b, h, w, c),
                               getattr(torch, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=JAX_TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("shape,kw", CASES)
def test_cpu_autograd_matches_the_plain_backward(shape, kw):
    """roialign on a CPU tensor is roialign_plain under ordinary autograd;
    its gradient is the plain backward's, and the rois get none."""
    b, h, w, c, r = shape
    feats, rois, rng = _inputs(*shape, seed=1)
    out = kw.get("output_size", 7)
    g = torch.from_numpy(rng.randn(b, r, out, out, c).astype(np.float32))
    f = torch.from_numpy(feats).requires_grad_()
    rt = torch.from_numpy(rois)
    TD.batched_roi_align(f, rt, **kw).backward(g)
    ref = RA.roialign_backward_plain(g, rt, (b, h, w, c), torch.float32, **kw)
    assert (f.grad - ref).abs().max().item() <= AUTOGRAD_TOL * ref.abs().max().item()


def test_backward_of_no_rois_is_zero():
    feats, rois, _ = _inputs(2, 8, 8, 4, 3)
    got = RA.roialign_backward(torch.zeros((2, 0, 7, 7, 4)), torch.from_numpy(rois[:, :0]), (2, 8, 8, 4),
                               torch.float32)
    assert got.shape == (2, 8, 8, 4) and not got.any()


def test_roialign_gradient_golden():
    """f[y][x] = 4y + x, roi [0.5, 0.5, 2.5, 2.5], out 1, ratio 2: the four
    samples sit on pixels (1,1), (1,2), (2,1), (2,2), each of weight 1/4."""
    f = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    for case in GOLDENS["roi_align"]:
        if "grad_nonzero" not in case:
            continue
        roi = torch.tensor([[case["roi"]]], dtype=torch.float32)
        kw = dict(output_size=case["output_size"], sampling_ratio=case["sampling_ratio"])
        expect = np.zeros((4, 4))
        for key, v in case["grad_nonzero"].items():
            y, x = map(int, key.split(","))
            expect[y, x] = v
        plain = RA.roialign_backward(torch.ones((1, 1, 1, 1, 1)), roi, (1, 4, 4, 1), torch.float32, **kw)
        np.testing.assert_allclose(plain[0, ..., 0].numpy(), expect, atol=1e-6)
        ff = f.clone().requires_grad_()
        RA.roialign(ff, roi, **kw).sum().backward()
        np.testing.assert_allclose(ff.grad[0, ..., 0].numpy(), expect, atol=1e-6)

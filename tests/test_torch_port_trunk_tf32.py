"""The f32 trunk kernel's split-TF32 arithmetic, emulated on the CPU.

csrc/trunk.cu takes every f32 product of the trunk's convs on the tensor
cores as three TF32 products, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, with
(hi, lo) = kernels/trunk.py:tf32_split(v): hi rounded to nearest with ties
away from zero, as cvt.rna.tf32.f32 rounds, and lo = v - hi truncated to
TF32. There is no card here, so this file shows before the card that the
split meets the f32 tolerance: the trunk's three convs run on split
operands (each partial conv in f32: a product of two TF32 values is exact
in f32, as in the mma) and are held against the JAX package's xla_trunk at
f32 within 2e-4 x max|ref|, the tolerance that chip_smoke.py and
tests/test_torch_port_gpu.py hold the kernel to; one TF32 product alone
(hi*hi) misses it. Inputs and weights come from a seed with numpy.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from driving_dirty_tpu.pallas.trunk import xla_trunk
from driving_dirty_tpu_torch.kernels import trunk as K

TOL = 2e-4  # of max|ref|, as on the card
LOW13 = 0x1FFF  # the mantissa bits a TF32 value leaves zero


def _bits(t):
    return t.view(torch.int32)


def test_tf32_split_rounds_hi_to_nearest_away_and_truncates_lo():
    ulp = 2.0 ** -10  # TF32 ulp at 1
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 1 + ulp / 2 + 2.0 ** -20, 0.0])
    hi, lo = K.tf32_split(v)
    assert hi.tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + ulp, 0.0]  # ties away from zero
    assert lo.tolist() == [-ulp / 2, ulp / 2, ulp / 4, -ulp / 4, -(ulp / 2 - 2.0 ** -20), 0.0]
    # lo = v - hi keeps only its top 11 significant bits: 1 + 3*2^-22 - (1 + 2^-10) truncates
    hi, lo = K.tf32_split(torch.tensor([1 + 3 * 2.0 ** -22]))
    assert hi.item() == 1.0 and lo.item() == 3 * 2.0 ** -22
    hi, lo = K.tf32_split(torch.tensor([1 + 2.0 ** -11 + 2.0 ** -23]))
    exact = (1 + 2.0 ** -11 + 2.0 ** -23) - (1 + 2.0 ** -10)  # -(2^-11 - 2^-23): 13 significant bits
    assert hi.item() == 1 + 2.0 ** -10 and abs(lo.item()) < abs(exact) and abs(lo.item() - exact) < 2.0 ** -22


def test_tf32_split_keeps_f32_accuracy():
    rng = np.random.RandomState(0)
    v = (rng.randn(100_000) * np.exp2(rng.randint(-30, 30, 100_000))).astype(np.float32)
    hi, lo = K.tf32_split(torch.from_numpy(v))
    assert not (_bits(hi) & LOW13).any() and not (_bits(lo) & LOW13).any()  # both TF32
    v64, hi64, lo64 = (np.float64(a) for a in (v, hi.numpy(), lo.numpy()))
    assert (np.abs(v64 - hi64) <= 2.0 ** -11 * np.abs(v64)).all()  # hi: within half a TF32 ulp
    assert (np.abs(v64 - (hi64 + lo64)) <= 2.0 ** -21 * np.abs(v64)).all()


def _args(seed, shape):
    """Seeded numpy input and weights (HWIO, as xla_trunk takes them)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    shapes = [(3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,)]
    return x, [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]


def _trunk(x, ws, products):
    """The trunk on NCHW f32 tensors, each conv's product as the sum of
    `products` partial convs of split operands, (a, b) -> a_lo*b_hi,
    a_hi*b_lo, a_hi*b_hi: 3 is the kernel's split TF32, 1 TF32 alone."""
    y = x
    for (w, b), stride in zip(zip(ws[0::2], ws[1::2]), (1, 1, 2)):
        (yh, yl), (wh, wl) = K.tf32_split(y), K.tf32_split(w)
        pairs = ((yl, wh), (yh, wl), (yh, wh))[3 - products:]
        acc = sum(F.conv2d(a, k, stride=stride, padding=1) for a, k in pairs)
        y = F.relu(acc + b[:, None, None])
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 17, 35, 3), (1, 64, 96, 3)])
def test_split_tf32_trunk_matches_xla_trunk(shape):
    x, ws = _args(0, shape)
    ref = np.asarray(xla_trunk(jnp.asarray(x), *[jnp.asarray(w) for w in ws]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if w.ndim == 4 else w) for w in ws]
    got = _trunk(xt, wt, 3)
    assert got.shape == ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale
    assert np.abs(_trunk(xt, wt, 1) - ref).max() > TOL * scale  # one TF32 product alone misses it

"""The encoder conv trunk of driving_dirty_tpu_torch (kernels/trunk.py).

On the CPU: `trunk_plain`, the plain version that stands beside the CUDA
kernel, against the JAX package's `xla_trunk` and its Pallas `fused_trunk`
(interpret mode, as tests/test_pallas_trunk.py runs it), and at odd sizes,
which only the port's kernel takes, against `xla_trunk`. The CUDA kernel
itself is held against `trunk_plain` on the card
(tests/test_torch_port_gpu.py).

Tolerances: f32 atol = rtol = 2e-4 (sums reassociated over K <= 288, the
bound tests/test_pallas_trunk.py uses); bf16 2^-6 of the output scale
(c1 and c2 are rounded to bf16 in each version, at slightly different
points, from sums taken in another order).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.pallas.trunk import fused_trunk, xla_trunk
from driving_dirty_tpu_torch.kernels import trunk as K


def _args(seed, shape):
    """Seeded numpy input and weights (HWIO, as the JAX functions take)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    shapes = [(3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,)]
    return x, [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]


def _port(x, ws, dtype):
    """Run trunk_plain on the numpy args; conv weights HWIO -> OIHW."""
    t = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if w.ndim == 4 else w) for w in ws]
    out = K.trunk_plain(torch.from_numpy(x).to(dtype), *t)
    return out.float().numpy()


def _jax(fn, x, ws, dtype):
    out = fn(jnp.asarray(x, dtype), *[jnp.asarray(w) for w in ws])
    return np.asarray(out.astype(jnp.float32))


def _close(got, ref, dtype):
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(16, 24), (32, 48), (8, 306)])
def test_trunk_plain_matches_xla_and_fused(hw, dtype):
    x, ws = _args(0, (2, *hw, 3))
    got = _port(x, ws, getattr(torch, dtype))
    assert got.shape == (2, hw[0] // 2, hw[1] // 2, 32)
    _close(got, _jax(xla_trunk, x, ws, getattr(jnp, dtype)), dtype)
    _close(got, _jax(fused_trunk, x, ws, getattr(jnp, dtype)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(17, 35), (9, 24)])
def test_trunk_plain_odd_sizes_match_xla(hw, dtype):
    x, ws = _args(1, (2, *hw, 3))
    got = _port(x, ws, getattr(torch, dtype))
    assert got.shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 32)
    _close(got, _jax(xla_trunk, x, ws, getattr(jnp, dtype)), dtype)


def test_trunk_on_cpu_is_the_plain_version():
    x, ws = _args(2, (1, 10, 14, 3))
    t = [torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if w.ndim == 4 else w) for w in ws]
    launches = K.trunk.launches
    assert torch.equal(K.trunk(torch.from_numpy(x), *t), K.trunk_plain(torch.from_numpy(x), *t))
    assert K.trunk.launches == launches

"""The trunk under autograd (kernels/trunk.py:TrunkFunction) against the JAX
package's trunk gradients, on the CPU.

The Function runs here with `trunk_plain` as its forward (on the card it
gets the B1 kernel's launch); its backward recomputes `trunk_plain` and
differentiates it, as pallas/trunk.py's custom VJP runs jax.vjp(xla_trunk).
The reference is jax.grad of pallas/trunk.py:xla_trunk for a seeded
cotangent, with the same numpy weights (HWIO there, OIHW here).

Tolerance: f32, max |error| <= 1e-4 * max |reference| per gradient. Each
gradient is a sum of up to 64 * 96 * 288 products, taken by XLA and by
ATen in other orders: about sqrt(n) f32 ulps (measured at most 1.2e-6 of
the largest value at 64 x 96); 1e-4 leaves room and still fails a missing term, a transposed
layout or a wrong stride at once (errors of order 1). The plain forward
and the ordinary autograd through it must equal the Function's bit for
bit: the same operations in the same order.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.pallas.trunk import xla_trunk
from driving_dirty_tpu_torch.kernels.trunk import TrunkFunction, trunk, trunk_plain

REL_TOL = 1e-4
NAMES = ("x", "w1", "b1", "w2", "b2", "w3", "b3")


def _inputs(shape, seed=0):
    """x NHWC, HWIO weights and biases, and a cotangent, as numpy f32."""
    rng = np.random.RandomState(seed)
    b, h, w, _ = shape
    x = rng.rand(*shape).astype(np.float32)
    shapes = [(3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,)]
    params = [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]
    g = rng.randn(b, (h + 1) // 2, (w + 1) // 2, 32).astype(np.float32)
    return x, params, g


def _torch_args(x, params, requires_grad=(True,) * 7):
    ts = [torch.from_numpy(x)] + [torch.from_numpy(p.transpose(3, 2, 0, 1).copy() if p.ndim == 4 else p)
                                  for p in params]
    return [t.clone().requires_grad_(r) for t, r in zip(ts, requires_grad)]


@pytest.mark.parametrize("shape", [(2, 17, 35, 3), (1, 64, 96, 3)])
def test_function_gradients_match_jax_grad_of_xla_trunk(shape):
    x, params, g = _inputs(shape)

    def loss(*args):
        return jnp.sum(xla_trunk(*args) * g)

    ref = jax.grad(loss, argnums=tuple(range(7)))(jnp.asarray(x), *map(jnp.asarray, params))
    args = _torch_args(x, params)
    out = TrunkFunction.apply(trunk_plain, *args)
    out.backward(torch.from_numpy(g))
    for name, t, r in zip(NAMES, args, ref):
        got = t.grad.numpy()
        if got.ndim == 4 and name != "x":
            got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        r = np.asarray(r)
        assert got.shape == r.shape, name
        assert np.abs(got - r).max() <= REL_TOL * np.abs(r).max(), name


def test_function_equals_ordinary_autograd_and_forwards_once():
    """The forward is called once per apply and never by the backward (on
    the card: B1 launches once a step); values and gradients equal plain
    autograd through trunk_plain bit for bit, for the inputs that ask."""
    x, params, g = _inputs((2, 9, 14, 3), seed=1)
    calls = []

    def forward(*args):
        calls.append(1)
        return trunk_plain(*args)

    needs = (False, True, True, False, True, True, True)
    a = _torch_args(x, params, needs)
    out = TrunkFunction.apply(forward, *a)
    out.backward(torch.from_numpy(g))
    assert len(calls) == 1
    b = _torch_args(x, params, needs)
    ref = trunk_plain(*b)
    ref.backward(torch.from_numpy(g))
    assert torch.equal(out, ref)
    for name, s, t, need in zip(NAMES, a, b, needs):
        assert (s.grad is None) == (not need), name
        if need:
            assert torch.equal(s.grad, t.grad), name


def test_cpu_trunk_is_plain_with_ordinary_autograd():
    x, params, g = _inputs((1, 8, 10, 3), seed=2)
    a, b = _torch_args(x, params), _torch_args(x, params)
    out = trunk(*a)
    assert out.grad_fn is not None and "TrunkFunction" not in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    TrunkFunction.apply(trunk_plain, *b).backward(torch.from_numpy(g))
    for name, s, t in zip(NAMES, a, b):
        assert torch.equal(s.grad, t.grad), name


def test_function_under_no_grad_builds_no_graph():
    x, params, _ = _inputs((1, 6, 6, 3), seed=3)
    with torch.no_grad():
        out = TrunkFunction.apply(trunk_plain, *_torch_args(x, params))
    assert out.grad_fn is None and not out.requires_grad

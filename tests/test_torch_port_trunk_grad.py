"""The trunk under autograd (kernels/trunk.py:trunk, the op
`torch.ops.driving_dirty.trunk_train`) against the JAX package's trunk
gradients, on the CPU.

Under autograd `trunk` calls the op `torch.ops.driving_dirty.trunk_train`:
on a CPU tensor its forward is `trunk_stages` (on the card B1-save, which
also writes c1 and c2), and its backward `trunk_bwd_plain` on the saved
tensors (on the card B1-bwd), where pallas/trunk.py's custom VJP runs
jax.vjp(xla_trunk).
The reference is jax.grad of pallas/trunk.py:xla_trunk for a seeded
cotangent, with the same numpy weights (HWIO there, OIHW here).

Tolerance: f32, max |error| <= 1e-4 * max |reference| per gradient. Each
gradient is a sum of up to 64 * 96 * 288 products, taken by XLA and by
ATen in other orders: about sqrt(n) f32 ulps (measured at most 1.2e-6 of
the largest value at 64 x 96); 1e-4 leaves room and still fails a missing term, a transposed
layout or a wrong stride at once (errors of order 1). The plain forward
and the ordinary autograd through it must equal the op's bit for bit:
the same operations in the same order.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.pallas.trunk import xla_trunk
from driving_dirty_tpu_torch.kernels import trunk as K
from driving_dirty_tpu_torch.kernels.trunk import trunk, trunk_plain

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
    out = trunk(*args)
    out.backward(torch.from_numpy(g))
    for name, t, r in zip(NAMES, args, ref):
        got = t.grad.numpy()
        if got.ndim == 4 and name != "x":
            got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        r = np.asarray(r)
        assert got.shape == r.shape, name
        assert np.abs(got - r).max() <= REL_TOL * np.abs(r).max(), name


def test_function_equals_ordinary_autograd_and_forwards_once(monkeypatch):
    """The op's forward runs once a call (its stages, which it saves), and
    its backward runs no forward: `trunk_bwd_plain` once on the saved
    tensors and never `trunk_plain` (on the card: B1-save launches once a
    step, B1-bwd once); values and gradients equal plain autograd through
    trunk_plain bit for bit, for the inputs that ask."""
    x, params, g = _inputs((2, 9, 14, 3), seed=1)
    plain, stages, bwd_plain = K.trunk_plain, K.trunk_stages, K.trunk_bwd_plain
    calls = []

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append((name, torch.is_grad_enabled()))  # the forward runs with grad off
            return fn(*args, **kwargs)
        return call

    def refuse(*args):
        raise AssertionError("the trunk's backward recomputed trunk_plain")

    monkeypatch.setattr(K, "trunk_plain", refuse)
    monkeypatch.setattr(K, "trunk_stages", counted("stages", stages))
    monkeypatch.setattr(K, "trunk_bwd_plain", counted("bwd", bwd_plain))
    needs = (False, True, True, False, True, True, True)
    a = _torch_args(x, params, needs)
    out = trunk(*a)
    assert calls == [("stages", False)]
    out.backward(torch.from_numpy(g))
    assert [name for name, _ in calls] == ["stages", "bwd"]
    monkeypatch.undo()
    b = _torch_args(x, params, needs)
    ref = plain(*b)
    ref.backward(torch.from_numpy(g))
    assert torch.equal(out, ref)
    for name, s, t, need in zip(NAMES, a, b, needs):
        assert (s.grad is None) == (not need), name
        if need:
            assert torch.equal(s.grad, t.grad), name


def test_cpu_trunk_is_plain_with_ordinary_autograd():
    """On a CPU tensor the op is `trunk_plain`, and its gradients for every
    input are ordinary autograd's through it, bit for bit."""
    x, params, g = _inputs((1, 8, 10, 3), seed=2)
    a, b = _torch_args(x, params), _torch_args(x, params)
    out = trunk(*a)
    assert "driving_dirty_trunk" in type(out.grad_fn).__name__  # the op's backward
    out.backward(torch.from_numpy(g))
    ref = trunk_plain(*b)
    ref.backward(torch.from_numpy(g))
    assert torch.equal(out, ref)
    for name, s, t in zip(NAMES, a, b):
        assert torch.equal(s.grad, t.grad), name


def test_function_under_no_grad_builds_no_graph():
    x, params, _ = _inputs((1, 6, 6, 3), seed=3)
    with torch.no_grad():
        out = trunk(*_torch_args(x, params))
    assert out.grad_fn is None and not out.requires_grad

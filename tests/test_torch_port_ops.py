"""The port's torch.library ops (kernels/ops.py: B1 `trunk`, B1-int8
`trunk_int8`, B3 `roialign`, and `nms`) on the CPU: torch.library.opcheck
(schema, fake tensors, autograd registration, AOT dispatch) for each, each
op against its plain function, the gradients through the B1 and B3 ops
against the autograd the port used before them, and NMS against the JAX
package.

Inputs are made from numpy seeds at small shapes. Tolerances: none where
the op runs the same plain code (outputs and gradients bit-equal, NMS keep
sets equal); B3's gradient against the JAX formulation of its backward
(roialign_backward_plain, B3-bwd's plain version) within 1e-5 of the
largest value (f32 sums in another order).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.ops import detection as JD
from driving_dirty_tpu_torch.kernels import ops
from driving_dirty_tpu_torch.kernels.roialign import (roialign, roialign_backward_plain, roialign_op,
                                                      roialign_plain)
from driving_dirty_tpu_torch.kernels.trunk import trunk, trunk_op, trunk_plain
from driving_dirty_tpu_torch.kernels.trunk_int8 import trunk_int8, trunk_int8_op, trunk_int8_plain
from driving_dirty_tpu_torch.ops import detection as TD
from driving_dirty_tpu_torch.ops import quant


def _trunk_args(shape, seed=0, dtype=torch.float32, requires_grad=False):
    rng = np.random.RandomState(seed)
    arrays = [rng.rand(*shape)] + [rng.randn(*s) * 0.2 for s in
                                   ((32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,))]
    ts = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    ts[0] = ts[0].to(dtype)
    return [t.requires_grad_(requires_grad) for t in ts]


def _roi_args(b=2, h=12, w=15, c=8, r=9, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)
    lo = rng.uniform(-4, 20, (b, r, 2))
    rois = torch.from_numpy(np.concatenate([lo, lo + rng.uniform(0, 14, (b, r, 2))], -1).astype(np.float32))
    return feats, rois


def _nms_args(seed=0, b=2, k=60):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (b, k, 2))], -1).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    scores[:, -5:] = TD.NEG_INF
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def test_every_op_is_registered_in_one_namespace():
    assert sorted(ops.OPS) == ["nms", "roialign", "trunk", "trunk_int8"]
    for name in ops.OPS:
        assert hasattr(torch.ops.driving_dirty, name)


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("shape", [(2, 9, 14, 3), (1, 7, 7, 3)])
def test_opcheck_trunk(shape, requires_grad):
    torch.library.opcheck(trunk_op, tuple(_trunk_args(shape, requires_grad=requires_grad)))


@pytest.mark.parametrize("static", [True, False])
def test_opcheck_trunk_int8(static):
    args = _trunk_args((2, 9, 11, 3), seed=1, dtype=torch.bfloat16)
    scales = list(quant.calibrate_trunk(args[1:], args[0].float())) if static else None
    torch.library.opcheck(trunk_int8_op, (*args, scales))


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_roialign(dtype, requires_grad):
    feats, rois = _roi_args(dtype=dtype)
    torch.library.opcheck(roialign_op, (feats.requires_grad_(requires_grad), rois, 3, 0.5, 2, False))


@pytest.mark.parametrize("fixed_depth", [0, 6])
def test_opcheck_nms(fixed_depth):
    boxes, scores = _nms_args()
    torch.library.opcheck(TD.nms_op, (boxes, scores, 0.5, 20, TD.NMS_MAX_ITERS, fixed_depth))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_equal_their_plain_functions(dtype):
    args = _trunk_args((2, 11, 13, 3), seed=2, dtype=dtype)
    assert torch.equal(trunk(*args), trunk_plain(*args))
    assert torch.equal(torch.ops.driving_dirty.trunk(*args), trunk_plain(*args))
    x16 = args[0].to(torch.bfloat16)
    scales = quant.calibrate_trunk(args[1:], x16.float())
    assert torch.equal(trunk_int8(x16, *args[1:], scales), trunk_int8_plain(x16, *args[1:], scales))
    assert torch.equal(trunk_int8(x16, *args[1:], None), trunk_int8_plain(x16, *args[1:], None))
    feats, rois = _roi_args(dtype=dtype, seed=3)
    assert torch.equal(roialign(feats, rois, 7, 0.5, 2), roialign_plain(feats, rois, 7, 0.5, 2))


def test_fakes_give_shapes_and_dtypes_of_odd_sizes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((3, 17, 35, 3), dtype=torch.bfloat16)
        w = [torch.empty(s) for s in ((32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,))]
        out = trunk_op(x, *w)
        assert out.shape == (3, 9, 18, 32) and out.dtype == torch.bfloat16
        assert trunk_int8_op(x, *w, [1.0, 2.0, 3.0]).shape == (3, 9, 18, 32)
        pooled = roialign_op(torch.empty((3, 9, 18, 32), dtype=torch.bfloat16), torch.empty((3, 5, 4)), 7, 0.5,
                             2, False)
        assert pooled.shape == (3, 5, 7, 7, 32) and pooled.dtype == torch.float32
        idx, valid = TD.nms_op(torch.empty((2, 4, 30, 4)), torch.empty((2, 4, 30)), 0.5, 11, 128, 0)
        assert idx.shape == valid.shape == (2, 4, 11)
        assert idx.dtype == torch.int64 and valid.dtype == torch.bool


def test_trunk_op_gradients_equal_plain_autograd():
    """The op's backward (trunk_vjp) gives ordinary autograd's gradients
    through trunk_plain bit for bit, for the inputs that ask, and none for
    the others."""
    needs = (True, True, False, True, True, False, True)
    a = _trunk_args((2, 10, 12, 3), seed=4)
    b = _trunk_args((2, 10, 12, 3), seed=4)
    for t, need in zip(a + b, needs + needs):
        t.requires_grad_(need)
    g = torch.from_numpy(np.random.RandomState(5).randn(2, 5, 6, 32).astype(np.float32))
    out = trunk(*a)
    assert "driving_dirty_trunk" in type(out.grad_fn).__name__
    out.backward(g)
    ref = trunk_plain(*b)
    ref.backward(g)
    assert torch.equal(out, ref)
    for s, t, need in zip(a, b, needs):
        assert (s.grad is None) == (not need)
        if need:
            assert torch.equal(s.grad, t.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roialign_op_gradients_equal_plain_autograd(dtype):
    """On the CPU the op's backward is the gradient of roialign_plain (what
    ordinary autograd through it gave before the op); the rois get none;
    it agrees with the JAX formulation of the backward."""
    feats, rois = _roi_args(seed=6, dtype=dtype)
    rois.requires_grad_()
    f1, f2 = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    g = torch.from_numpy(np.random.RandomState(7).randn(2, 9, 7, 7, 8).astype(np.float32))
    out = roialign(f1, rois, 7, 0.5, 2)
    out.backward(g)
    roialign_plain(f2, rois.detach(), 7, 0.5, 2).backward(g)
    assert rois.grad is None
    assert f1.grad.dtype == dtype and torch.equal(f1.grad, f2.grad)
    if dtype == torch.float32:
        jax_form = roialign_backward_plain(g, rois.detach(), tuple(feats.shape), dtype, 7, 0.5, 2)
        assert (jax_form - f1.grad).abs().max() <= 1e-5 * jax_form.abs().max()


@pytest.mark.parametrize("fixed_depth", [0, 5])
def test_nms_op_equals_jax(fixed_depth):
    boxes, scores = _nms_args(seed=8)
    before = TD.nms_fixed.checks
    idx, valid = TD.nms_fixed(boxes, scores, 0.5, 30, fixed_depth=fixed_depth)
    assert (TD.nms_fixed.checks > before) == (fixed_depth == 0)
    f = jax.jit(jax.vmap(lambda b, s: JD.nms_fixed(b, s, 0.5, 30, fixed_depth=fixed_depth)))
    ref_idx, ref_valid = (np.asarray(a) for a in f(jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy())))
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(np.where(ref_valid, idx.numpy(), -1), np.where(ref_valid, ref_idx, -1))


def test_export_traces_every_op():
    """torch.export of a function of all four ops keeps them as op calls."""

    class M(torch.nn.Module):
        def forward(self, x, w1, b1, w2, b2, w3, b3, rois, boxes, scores):
            c3 = trunk(x, w1, b1, w2, b2, w3, b3)
            q = trunk_int8(x.to(torch.bfloat16), w1, b1, w2, b2, w3, b3, (0.5, 0.25, 0.125))
            pooled = roialign(c3 + q.float(), rois, 3, 0.5, 2)
            return pooled, TD.nms_fixed(boxes, scores, 0.5, 7)

    args = (*_trunk_args((2, 10, 12, 3), seed=9), _roi_args(h=5, w=6, c=32, r=4)[1], *_nms_args(k=20))
    ep = torch.export.export(M(), args, strict=False)
    called = {n.target.name() for n in ep.graph.nodes if n.op == "call_function"
              and hasattr(n.target, "name") and n.target.name().startswith("driving_dirty::")}
    assert called == {"driving_dirty::trunk", "driving_dirty::trunk_int8", "driving_dirty::roialign",
                      "driving_dirty::nms"}
    got, ref = ep.module()(*args), M()(*args)
    assert torch.equal(got[0], ref[0]) and all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))

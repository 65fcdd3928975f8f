"""The trunk's backward from the forward's saved activations
(kernels/trunk.py: `trunk_bwd_plain`, B1-bwd's plain version, and the ops
`torch.ops.driving_dirty.trunk_train` / `trunk_bwd`) against the JAX
package, on the CPU.

The reference is jax.vjp of driving_dirty_tpu/pallas/trunk.py:xla_trunk
(the backward that fused_trunk's custom VJP runs) for a seeded cotangent,
with the same numpy weights (HWIO there, OIHW here); the port's side reads
c1, c2 and c3 from `trunk_stages`, as B1-save writes them on the card.
Tolerance: f32, max |error| <= 1e-4 * max |reference| per gradient, for the
reason stated in tests/test_torch_port_trunk_grad.py (sums of up to
64 * 96 * 288 products taken in other orders; a missing term, a transposed
layout or a wrong stride errs by order 1). Through the ops, the forward
and backward equal ordinary autograd through `trunk_plain` bit for bit:
the same ATen operations in the same order.

B1-bwd itself runs only on the card (tests/test_torch_port_gpu.py,
chip_smoke.py); here its dgrad weight layout (`prepare_bwd_weights`) is
decoded index by index, as the kernel addresses it, back to the
transposed, tap-flipped OIHW weights.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.pallas.trunk import xla_trunk
from driving_dirty_tpu_torch.kernels import trunk as K

REL_TOL = 1e-4
NAMES = ("x", "w1", "b1", "w2", "b2", "w3", "b3")
ALL = (True,) * 7
NO_X = (False,) + (True,) * 6
ONLY_W3 = (False,) * 5 + (True, True)


def _inputs(shape, seed=0):
    """x NHWC, HWIO weights and biases, and a cotangent, as numpy f32."""
    rng = np.random.RandomState(seed)
    b, h, w, _ = shape
    x = rng.rand(*shape).astype(np.float32)
    shapes = [(3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,)]
    params = [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]
    g = rng.randn(b, (h + 1) // 2, (w + 1) // 2, 32).astype(np.float32)
    return x, params, g


def _torch(x, params, dtype=torch.float32, requires_grad=(False,) * 7):
    ts = [torch.from_numpy(x).to(dtype)] + [torch.from_numpy(p.transpose(3, 2, 0, 1).copy() if p.ndim == 4 else p)
                                            for p in params]
    return [t.clone().requires_grad_(r) for t, r in zip(ts, requires_grad)]


def _to_jax_layout(name, t):
    got = t.detach().float().numpy()
    return got.transpose(2, 3, 1, 0) if got.ndim == 4 and name != "x" else got  # OIHW -> HWIO


@pytest.mark.parametrize("needs", [ALL, NO_X, ONLY_W3], ids=["all", "x_off", "only_w3_b3"])
@pytest.mark.parametrize("shape", [(2, 17, 35, 3), (1, 64, 96, 3), (1, 9, 14, 3)])
def test_plain_backward_from_saved_activations_matches_jax_vjp(shape, needs):
    x, params, g = _inputs(shape)
    _, vjp = jax.vjp(xla_trunk, jnp.asarray(x), *map(jnp.asarray, params))
    ref = vjp(jnp.asarray(g))
    args = _torch(x, params)
    c1, c2, c3 = K.trunk_stages(*args)
    got = K.trunk_bwd_plain(torch.from_numpy(g), *args, c1, c2, c3, needs)
    for name, t, r, need in zip(NAMES, got, ref, needs):
        if not need:
            assert t is None, name
            continue
        r = np.asarray(r)
        got_np = _to_jax_layout(name, t)
        assert got_np.shape == r.shape, name
        assert t.dtype == args[NAMES.index(name)].dtype, name
        assert np.abs(got_np - r).max() <= REL_TOL * np.abs(r).max(), name


@pytest.mark.parametrize("needs", [ALL, NO_X, ONLY_W3, (True,) + (False,) * 6, (False, True, False, False, True,
                                                                            False, False)],
                         ids=["all", "x_off", "only_w3_b3", "only_x", "w1_b2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_forward_and_backward_equal_ordinary_autograd(dtype, needs):
    """trunk() under autograd (trunk_train, then trunk_bwd on the saved
    tensors) against autograd through trunk_plain, bit for bit; the inputs
    that ask get a gradient of their dtype, the others none."""
    x, params, g = _inputs((2, 11, 15, 3), seed=3)
    a, b = _torch(x, params, dtype, needs), _torch(x, params, dtype, needs)
    out = K.trunk(*a)
    assert "driving_dirty_trunk_train" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g).to(dtype))
    ref = K.trunk_plain(*b)
    ref.backward(torch.from_numpy(g).to(dtype))
    assert torch.equal(out, ref)
    for name, s, t, need in zip(NAMES, a, b, needs):
        assert (s.grad is None) == (not need), name
        if need:
            assert s.grad.dtype == s.dtype and torch.equal(s.grad, t.grad), name


def test_train_op_saves_the_stages_and_its_backward_reads_them():
    """trunk_train's outputs are (c3, c1, c2) of trunk_stages; c1 and c2
    take no gradient; under no_grad, or with no input asking, trunk()
    takes the inference op, whose own backward still gives autograd's
    gradients."""
    x, params, g = _inputs((1, 9, 14, 3), seed=4)
    args = _torch(x, params, requires_grad=NO_X)
    c3, c1, c2 = K.trunk_train_op(*args)
    stages = K.trunk_stages(*args)
    assert all(torch.equal(s, t) for s, t in zip((c1, c2, c3), stages))
    assert c3.requires_grad and not c1.requires_grad and not c2.requires_grad
    with torch.no_grad():
        out = K.trunk(*args)
    assert out.grad_fn is None and torch.equal(out, c3)
    frozen = _torch(x, params)
    assert K.trunk(*frozen).grad_fn is None
    direct = torch.ops.driving_dirty.trunk(*args)
    assert "driving_dirty_trunk_default" in type(direct.grad_fn).__name__
    direct.backward(torch.from_numpy(g))
    ref = _torch(x, params, requires_grad=NO_X)
    K.trunk_plain(*ref).backward(torch.from_numpy(g))
    for name, s, t in zip(NAMES[1:], args[1:], ref[1:]):
        assert torch.equal(s.grad, t.grad), name


@pytest.mark.parametrize("requires_grad", [False, True])
def test_opcheck_trunk_train(requires_grad):
    x, params, _ = _inputs((2, 9, 14, 3), seed=5)
    torch.library.opcheck(K.trunk_train_op, tuple(_torch(x, params, requires_grad=(requires_grad,) * 7)))


@pytest.mark.parametrize("needs", [ALL, ONLY_W3], ids=["all", "only_w3_b3"])
def test_opcheck_trunk_bwd(needs):
    x, params, g = _inputs((1, 7, 10, 3), seed=6)
    args = _torch(x, params)
    c1, c2, c3 = K.trunk_stages(*args)
    torch.library.opcheck(K.trunk_bwd_op, (torch.from_numpy(g), *args, c1, c2, c3, list(needs)))


def test_plain_backward_of_an_empty_batch_is_zero():
    x, params, g = _inputs((1, 6, 6, 3), seed=7)
    args = _torch(x[:0], params)
    c1, c2, c3 = K.trunk_stages(*args)
    got = K.trunk_bwd_plain(torch.from_numpy(g[:0]), *args, c1, c2, c3, ALL)
    assert got[0].shape == (0, 6, 6, 3)
    assert all(not t.any() and t.shape == p.shape for t, p in zip(got[1:], args[1:]))


def _dgrad_b(frag):
    """Read the B operand of a 32 -> 32 dgrad in float32 (36 k-steps of
    m16n8k8) as the kernel does: k-step s, n-pair p, lane (g, tg) loads the
    uint4 at (2s + p) * 32 + 4g + tg, whose floats are (b0, b1) of n-tile 2p
    and of 2p + 1, b_e = B[8s + tg + 4e][8 (2p + tile) + g]. frag: a 1-D
    numpy array. -> B [288, 32] of its dtype."""
    f = frag.reshape(-1, 4)
    b = np.zeros((288, 32), frag.dtype)
    for s in range(36):
        for p in range(2):
            for g in range(8):
                for tg in range(4):
                    word = f[(2 * s + p) * 32 + 4 * g + tg]
                    for tile in range(2):
                        for e in range(2):
                            b[8 * s + tg + 4 * e, 8 * (2 * p + tile) + g] = word[2 * tile + e]
    return b


def _dgrad_b16(frag):
    """Read the B operand of a 32 -> 32 dgrad in bfloat16 (18 k-steps of
    m16n8k16) as the kernel does: k-step s, n-pair p, lane (g, tg) loads the
    uint4 at (2s + p) * 32 + 4g + tg, whose eight bf16 values are, for
    n-tile 2p and then 2p + 1, b0 = B[16s + 2tg + e][n] and b1 = B[16s + 8 +
    2tg + e][n] (e = 0, 1), n = 8 (2p + tile) + g. frag: a 1-D numpy array.
    -> B [288, 32] of its dtype."""
    f = frag.reshape(-1, 8)
    b = np.zeros((288, 32), frag.dtype)
    for s in range(18):
        for p in range(2):
            for g in range(8):
                for tg in range(4):
                    word = f[(2 * s + p) * 32 + 4 * g + tg]
                    for tile in range(2):
                        for half in range(2):
                            for e in range(2):
                                b[16 * s + 8 * half + 2 * tg + e, 8 * (2 * p + tile) + g] = word[4 * tile + 2 * half + e]
    return b


def _dx_b(frag):
    """The dx B operand as the kernel reads it: the pair at 32 s + 4g + tg
    is (B[8s + tg][g], B[8s + tg + 4][g]), N = 8. frag: a 1-D numpy array.
    -> B [288, 8] of its dtype."""
    f = frag.reshape(-1, 2)
    b = np.zeros((288, 8), frag.dtype)
    for s in range(36):
        for g in range(8):
            for tg in range(4):
                b[8 * s + tg, g], b[8 * s + tg + 4, g] = f[32 * s + 4 * g + tg]
    return b


def _decode(layout, dgrad):
    """(W1's dx B [288, 8], W2's and W3's dgrad B [288, 32]) from a
    prepare_bwd_weights layout given as a 1-D numpy array."""
    parts = np.split(layout, (2304, 2304 + 9216))
    return [_dx_b(parts[0])] + [dgrad(part) for part in parts[1:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dgrad_layout_decodes_to_the_flipped_transposed_weights(dtype):
    """B[k = (ky', kx', o)][n = i] must be w[o][i][2 - ky'][2 - kx'], in
    the values `dtype` rounds the weights to; W1's N = 3 is padded with
    zeros to 8. The layout is in `dtype`: m16n8k8 fragments for float32,
    m16n8k16 fragments of bf16 values for bfloat16."""
    _, params, _ = _inputs((1, 4, 4, 3), seed=8)
    ws = _torch(x=np.zeros((1, 4, 4, 3), np.float32), params=params)[1::2]
    layout = K.prepare_bwd_weights(ws, dtype)
    assert layout.dtype == dtype and layout.shape == (2304 + 2 * 9216,)
    decoded = _decode(layout.float().numpy(), _dgrad_b if dtype == torch.float32 else _dgrad_b16)
    for b, w in zip(decoded, ws):
        wr = w.to(dtype).float().numpy()
        cin = wr.shape[1]
        for k in range(288):
            tap, o = divmod(k, 32)
            ky, kx = divmod(tap, 3)
            np.testing.assert_array_equal(b[k, :cin], wr[o, :, 2 - ky, 2 - kx])
        assert not b[:, cin:].any()


def test_bf16_layout_holds_the_weights_as_bf16_rounds_them():
    """The bf16 layout's bits, decoded as the kernels read them, are those
    of torch's rounding of each f32 weight to bf16 (to nearest, ties to
    even; ties and values a bf16 holds exactly included), bit for bit."""
    _, params, _ = _inputs((1, 4, 4, 3), seed=11)
    ws = _torch(x=np.zeros((1, 4, 4, 3), np.float32), params=params)[1::2]
    ties = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(2.0 ** -3) * (1 + 2.0 ** -8), 0.5, -0.0])
    for w in ws:
        w.view(-1)[:ties.numel()] = ties  # ties to even round down, then up; exact values stay
    assert ws[1].view(-1)[:2].to(torch.bfloat16).float().tolist() == [1.0, 1 + 2.0 ** -6]
    bits = K.prepare_bwd_weights(ws, torch.bfloat16).view(torch.int16).numpy()
    for b, w in zip(_decode(bits, _dgrad_b16), ws):
        want = w.to(torch.bfloat16).view(torch.int16).numpy()
        cin = want.shape[1]
        for k in range(288):
            tap, o = divmod(k, 32)
            ky, kx = divmod(tap, 3)
            np.testing.assert_array_equal(b[k, :cin], want[o, :, 2 - ky, 2 - kx])
        assert not b[:, cin:].any()


def test_dgrad_layout_is_cached_apart_from_the_forward_layout():
    _, params, _ = _inputs((1, 4, 4, 3), seed=9)
    ts = _torch(np.zeros((1, 4, 4, 3), np.float32), params)
    ws, bs = ts[1::2], ts[2::2]
    fwd, bwd = K.prepare_weights.calls, K.prepare_bwd_weights.calls
    first = K.kernel_bwd_weights(ws, torch.float32)
    assert K.kernel_bwd_weights(ws, torch.float32) is first
    K.kernel_weights(ws, bs, torch.float32)
    assert (K.prepare_weights.calls, K.prepare_bwd_weights.calls) == (fwd + 1, bwd + 1)
    ws[2].mul_(2)  # an optimizer's in-place update
    updated = K.kernel_bwd_weights(ws, torch.float32)
    assert K.prepare_bwd_weights.calls == bwd + 2 and not torch.equal(updated, first)
    assert torch.equal(updated, K.prepare_bwd_weights(ws, torch.float32))


def test_trunk_bwd_takes_seven_flags_and_cpu_or_cuda_tensors():
    x, params, g = _inputs((1, 6, 6, 3), seed=10)
    args = _torch(x, params)
    c1, c2, c3 = K.trunk_stages(*args)
    with pytest.raises(ValueError):
        K.trunk_bwd(torch.from_numpy(g), *args, c1, c2, c3, (True,) * 6)
    with pytest.raises(ValueError):
        K.trunk_bwd(torch.from_numpy(g).to("meta"), *[t.to("meta") for t in args], c1.to("meta"),
                    c2.to("meta"), c3.to("meta"), ALL)

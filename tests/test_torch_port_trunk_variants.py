"""The trunk's stage bisection and its weight cache (kernels/trunk.py).

On the CPU: `trunk_variant_plain`, the plain version beside the kernel's
stage switch, against the matching prefix of the JAX package's `xla_trunk`
(the same `lax.conv_general_dilated` calls, sliced at the c3 positions),
and "full" against its Pallas `fused_trunk` (interpret mode, as
tests/test_pallas_trunk.py runs it). `prepare_weights`' layouts invert back
to the OIHW weights, and `kernel_weights` caches them per (tensors, dtype).
The kernel's variants are held against `trunk_variant_plain` on the card
(tests/test_torch_port_gpu.py).

Tolerances as tests/test_torch_port_trunk.py: f32 atol = rtol = 2e-4 (sums
reassociated over K <= 288); bf16 2^-6 of the output scale (c1 and c2
rounded to bf16 in each version, from sums taken in another order). v0
copies the input, so it is exact.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, nn

from driving_dirty_tpu.pallas.trunk import fused_trunk, xla_trunk
from driving_dirty_tpu_torch.kernels import trunk as K

VARIANTS = ("v0", "v1", "v2", "v3", "v4", "full")
SHAPES = [(2, 17, 35, 3), (1, 64, 96, 3)]


def _args(seed, shape):
    """Seeded numpy input and weights (HWIO, as the JAX functions take)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    shapes = [(3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,)]
    return x, [(rng.randn(*s) * 0.2).astype(np.float32) for s in shapes]


def _torch_params(ws):
    """HWIO -> OIHW conv weights, as torch tensors."""
    return [torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if w.ndim == 4 else w) for w in ws]


def _jax_stages(x, ws):
    """c1, c2, c3 by xla_trunk's own convs (pallas/trunk.py:275-285)."""
    def conv(v, wt, bt, stride):
        y = lax.conv_general_dilated(v, wt.astype(v.dtype), (stride, stride), ((1, 1), (1, 1)),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return nn.relu(y + bt.astype(v.dtype))

    c1 = conv(x, ws[0], ws[1], 1)
    c2 = conv(c1, ws[2], ws[3], 1)
    return c1, c2, conv(c2, ws[4], ws[5], 2)


def _jax_variant(x, ws, variant):
    c1, c2, c3 = _jax_stages(x, ws)
    stage = K.VARIANT_STAGES[variant]
    if stage == 0:
        out = x[:, ::2, ::2][..., np.arange(32) % 3]
    else:
        out = (None, c1[:, ::2, ::2], c2[:, ::2, ::2], c3)[stage]
    return np.asarray(out.astype(jnp.float32))


def _close(got, ref, dtype):
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -6 * max(1.0, np.abs(ref).max()))


def test_jax_stages_end_in_xla_trunk():
    x, ws = _args(0, SHAPES[0])
    args = [jnp.asarray(a) for a in (x, *ws)]
    np.testing.assert_array_equal(np.asarray(_jax_stages(args[0], args[1:])[2]),
                                  np.asarray(xla_trunk(*args)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_variant_plain_matches_xla_prefix(shape, variant, dtype):
    x, ws = _args(1, shape)
    got = K.trunk_variant_plain(torch.from_numpy(x).to(getattr(torch, dtype)), *_torch_params(ws),
                                variant=variant).float().numpy()
    assert got.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
    ref = _jax_variant(jnp.asarray(x, getattr(jnp, dtype)), [jnp.asarray(w) for w in ws], variant)
    if variant == "v0":
        np.testing.assert_array_equal(got, ref)
    else:
        _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_variant_matches_fused_trunk(dtype):
    x, ws = _args(2, (2, 16, 24, 3))
    got = K.trunk_variant_plain(torch.from_numpy(x).to(getattr(torch, dtype)), *_torch_params(ws),
                                variant="full").float().numpy()
    ref = fused_trunk(jnp.asarray(x, getattr(jnp, dtype)), *[jnp.asarray(w) for w in ws])
    _close(got, np.asarray(ref.astype(jnp.float32)), dtype)


def test_trunk_variant_on_cpu_is_the_plain_version():
    x, ws = _args(3, (1, 10, 14, 3))
    xt, params = torch.from_numpy(x), _torch_params(ws)
    launches = K.trunk_variant.launches
    for variant in VARIANTS:
        assert torch.equal(K.trunk_variant(xt, *params, variant=variant),
                           K.trunk_variant_plain(xt, *params, variant=variant))
    assert torch.equal(K.trunk_variant(xt, *params, variant="full"), K.trunk(xt, *params))
    assert K.trunk_variant.launches == launches


def test_trunk_variant_rejects_an_unknown_variant():
    x, ws = _args(4, (1, 6, 6, 3))
    for variant in ("v5", "c3", ""):
        with pytest.raises(ValueError):
            K.trunk_variant(torch.from_numpy(x), *_torch_params(ws), variant=variant)
        with pytest.raises(ValueError):
            K.trunk_variant_plain(torch.from_numpy(x), *_torch_params(ws), variant=variant)


def _unfragment(frag, k):
    """Invert kernels/trunk.py:_fragments: -> HWIO-flattened B [k, 32]."""
    if frag.dtype == torch.float32:  # m16n8k8: [step][pair][g][tg][tile][e], k = 8*step + 4*e + tg
        kp = k + (-k % 8)
        b = frag.reshape(kp // 8, 2, 8, 4, 2, 2).permute(0, 5, 3, 1, 4, 2).reshape(kp, 32)
    else:  # m16n8k16: [step][pair][g][tg][tile][half][e], k = 16*step + 8*half + 2*tg + e
        kp = k + (-k % 16)
        b = frag.reshape(kp // 16, 2, 8, 4, 2, 2, 2).permute(0, 5, 3, 6, 1, 4, 2).reshape(kp, 32)
    assert not b[k:].any()
    return b[:k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepared_layout_inverts_to_the_oihw_weights(dtype):
    _, ws = _args(5, (1, 4, 4, 3))
    params = _torch_params(ws)
    dt = getattr(torch, dtype)
    weights, biases = K.prepare_weights(params[0::2], params[1::2], dt)
    assert biases.dtype == torch.float32 and biases.shape == (96,)
    assert torch.equal(biases, torch.cat([b.to(dt).float() for b in params[1::2]]))
    sizes = (32 * 32, 288 * 32, 288 * 32)  # c1's K = 27 padded to a whole k-step
    assert weights.dtype == dt and weights.shape == (sum(sizes),)
    for part, w, cin in zip(torch.split(weights, sizes), params[0::2], (3, 32, 32)):
        b = _unfragment(part, 9 * cin)
        assert torch.equal(b.reshape(3, 3, cin, 32).permute(3, 2, 0, 1), w.to(dt))


def test_kernel_weights_are_cached_until_a_weight_changes():
    _, ws = _args(6, (1, 4, 4, 3))
    params = _torch_params(ws)
    wts, bs = params[0::2], params[1::2]
    calls = K.prepare_weights.calls
    first = K.kernel_weights(wts, bs, torch.bfloat16)
    again = K.kernel_weights(wts, bs, torch.bfloat16)
    assert K.prepare_weights.calls == calls + 1
    assert all(a is b for a, b in zip(first, again))
    f32 = K.kernel_weights(wts, bs, torch.float32)  # another dtype, another entry
    assert K.prepare_weights.calls == calls + 2 and f32[0].dtype == torch.float32
    wts[1].mul_(2)  # in place, as load_state_dict's copy_ is
    updated = K.kernel_weights(wts, bs, torch.bfloat16)
    assert K.prepare_weights.calls == calls + 3
    assert updated[0] is not first[0] and not torch.equal(updated[0], first[0])
    assert torch.equal(updated[0], K.prepare_weights(wts, bs, torch.bfloat16)[0])
    bs[2].add_(1)
    assert not torch.equal(K.kernel_weights(wts, bs, torch.bfloat16)[1], updated[1])


def test_kernel_weights_do_not_outlive_their_tensors():
    _, ws = _args(7, (1, 4, 4, 3))
    params = _torch_params(ws)
    K.kernel_weights(params[0::2], params[1::2], torch.bfloat16)
    del params  # new tensors may now take the freed ids
    other = _torch_params(_args(8, (1, 4, 4, 3))[1])
    calls = K.prepare_weights.calls
    got = K.kernel_weights(other[0::2], other[1::2], torch.bfloat16)
    assert K.prepare_weights.calls == calls + 1
    assert torch.equal(got[0], K.prepare_weights(other[0::2], other[1::2], torch.bfloat16)[0])
    assert all(r() is not None for refs, _, _ in K._PREPARED.values() for r in refs)


def test_inference_tensor_weights_are_laid_out_anew_with_a_warning():
    _, ws = _args(9, (1, 4, 4, 3))
    with torch.inference_mode():
        params = [p.clone() for p in _torch_params(ws)]
    wts, bs = params[0::2], params[1::2]
    calls = K.prepare_weights.calls
    with pytest.warns(UserWarning, match="inference tensors"):
        first = K.kernel_weights(wts, bs, torch.bfloat16)
    with torch.inference_mode():
        wts[1].mul_(2)  # same data_ptr, no version to see it by
    with pytest.warns(UserWarning, match="inference tensors"):
        updated = K.kernel_weights(wts, bs, torch.bfloat16)
    assert K.prepare_weights.calls == calls + 2
    assert not torch.equal(updated[0], first[0])
    assert torch.equal(updated[0], K.prepare_weights(wts, bs, torch.bfloat16)[0])

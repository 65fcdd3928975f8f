"""driving_dirty_tpu_torch/ops/quant.py (the int8 trunk's numerics) and the
plain side of kernels/trunk_int8.py against the JAX package's
driving_dirty_tpu/ops/quant.py, on the CPU, on the same numpy inputs (conv
weights HWIO on the JAX side, OIHW in the port).

Tolerances: quantization, the per-channel weight scales, the int32
accumulator of the int8 conv and its f32 dequantization are exact (equal
arrays). Calibration scales within 1e-6 relative: both take the absmax of
an f32 conv chain whose sums run in another order. The int8 trunk with the
same static scales: c3 bit-equal in at least 99.9% of its elements, and
every element within one quantization step of c3 (max|c3| / 127) plus one
bf16 ulp: a layer output whose f32 value differs in its last bit (XLA may
contract acc * comb + b into an fma, ROADMAP §C) can round to the
neighbouring bf16 or int8 value, which moves the products that read it by
one step of their input. The dynamic path (f32) and the resident probe
(f32, against the shipped path) are held to the same bar.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from driving_dirty_tpu.ops import quant as JQ
from driving_dirty_tpu_torch.kernels import trunk_int8 as K8
from driving_dirty_tpu_torch.kernels.trunk import trunk_plain
from driving_dirty_tpu_torch.ops import quant as Q

SHAPES = [(3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,)]


def _params(seed):
    """Seeded trunk weights: (JAX params dict of HWIO weights, port OIHW tuple)."""
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(*s) * (0.15 if len(s) == 4 else 0.1)).astype(np.float32) for s in SHAPES]
    jp = {f"c{i + 1}": {"w": jnp.asarray(ws[2 * i]), "b": jnp.asarray(ws[2 * i + 1])} for i in range(3)}
    tp = tuple(torch.from_numpy(w.transpose(3, 2, 0, 1).copy() if w.ndim == 4 else w) for w in ws)
    return jp, tp


def _image(seed, shape=(2, 32, 48, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_quantize_rounds_ties_to_even_and_clips():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.49, 127.5, 300.0, -127.5, -1e9, 3.7, -3.7],
                 np.float32)
    got = Q.quantize(torch.from_numpy(v), 1.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(JQ.quantize(jnp.asarray(v), 1.0)))
    np.testing.assert_array_equal(got, [0, 2, 2, 0, -2, -2, 126, 127, 127, 127, -127, -127, 4, -4])
    assert got.dtype == np.int8
    # a scale that is not a power of two, on bf16 input (the kernel's path)
    x = _image(0, (4, 5, 3)) * 2 - 1
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = JQ.quantize(jnp.asarray(x, jnp.bfloat16), 113.37)
    np.testing.assert_array_equal(Q.quantize(xb, 113.37).numpy(), np.asarray(ref))


def test_absmax_scales_and_per_channel_weight_quantization():
    jp, tp = _params(1)
    x = _image(2) - 0.3
    s = Q.absmax_scale(torch.from_numpy(x))
    assert s.dtype == torch.float32 and s.dim() == 0
    assert s.item() == float(JQ.absmax_scale(jnp.asarray(x)))
    for i in range(3):
        wq, w_inv = Q.quantize_conv_weight(tp[2 * i])
        jwq, jw_inv = JQ.quantize_conv_weight(jp[f"c{i + 1}"]["w"])
        np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(w_inv.numpy(), np.asarray(jw_inv))
        # per output channel: each channel's largest |weight| maps to 127
        assert (wq.abs().amax(dim=(1, 2, 3)) == 127).all()
    z = torch.zeros(4)
    assert Q.absmax_scale(z).item() == np.float32(127.0) / np.float32(1e-8)


@pytest.mark.parametrize("ci,stride", [(3, 1), (32, 1), (32, 2)])
def test_conv_int8_accumulator_equals_jax(ci, stride):
    """int8 extremes everywhere, so sums reach |acc| near 288 * 127 * 127."""
    rng = np.random.RandomState(3)
    xq = rng.choice([-127, -126, -1, 0, 1, 126, 127], size=(2, 11, 13, ci)).astype(np.int8)
    xq[0] = 127
    wq = rng.choice([-127, 0, 127, 5], size=(3, 3, ci, 32)).astype(np.int8)
    wq[..., 0] = 127
    ref = lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq), (stride, stride), ((1, 1), (1, 1)),
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   preferred_element_type=jnp.int32)
    got = Q.conv_int32(torch.from_numpy(xq), torch.from_numpy(wq.transpose(3, 2, 0, 1).copy()), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.abs(np.asarray(ref)).max() >= 9 * ci * 127 * 127 - 2 * 127 * 127
    # dequantized: f32(1/s) * w_inv, then one f32 product
    w_inv = (np.random.RandomState(4).rand(32) * 0.01 + 1e-3).astype(np.float32)
    s = 113.37
    got_f = Q.conv2d_int8(torch.from_numpy(xq), torch.from_numpy(wq.transpose(3, 2, 0, 1).copy()),
                          1.0 / s, torch.from_numpy(w_inv), stride=stride)
    ref_f = JQ.conv2d_int8(jnp.asarray(xq), jnp.asarray(wq), 1.0 / s, jnp.asarray(w_inv), stride=stride)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(ref_f))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrate_trunk_matches_jax(dtype):
    jp, tp = _params(5)
    x = _image(6)
    got = Q.calibrate_trunk(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    ref = JQ.calibrate_trunk(jp, jnp.asarray(x, getattr(jnp, dtype)))
    assert all(isinstance(s, float) for s in got)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[0] == ref[0]  # the input's absmax: no sum involved


def _hold_c3(got, ref):
    """>= 99.9% of elements bit-equal, the rest within one c3 quantization
    step plus one bf16 ulp (module docstring)."""
    assert got.shape == ref.shape
    same = (got == ref).mean()
    step = np.abs(ref).max() / 127 + 2.0 ** -7 * np.abs(ref).max()
    assert same >= 0.999, same
    assert np.abs(got - ref).max() <= step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_convs_int8_static_matches_jax(dtype):
    jp, tp = _params(7)
    x = _image(8)
    scales = JQ.calibrate_trunk(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = Q.encoder_convs_int8(tp, xt, scales)
    ref = JQ.encoder_convs_int8(jp, jnp.asarray(x, getattr(jnp, dtype)), scales=scales)
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 16, 24, 32)
    _hold_c3(_np(got), np.asarray(ref.astype(jnp.float32)))
    # the kernel's plain version is this function; on a CPU tensor the
    # wrapper is the plain version
    assert torch.equal(K8.trunk_int8_plain(xt, *tp, scales), got)
    assert torch.equal(K8.trunk_int8(xt, *tp, scales), got)
    # int8 stays within quantization error of the float trunk
    f = trunk_plain(torch.from_numpy(x), *tp).numpy()
    assert np.abs(_np(got) - f).max() / np.abs(f).max() < 0.05


def test_encoder_convs_int8_dynamic_matches_jax():
    jp, tp = _params(9)
    x = _image(10)
    got = Q.encoder_convs_int8(tp, torch.from_numpy(x))
    ref = JQ.encoder_convs_int8(jp, jnp.asarray(x))
    _hold_c3(got.numpy(), np.asarray(ref))
    # no model reaches the dynamic path; off the CPU it raises, never runs plain
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Q.encoder_convs_int8(tp, torch.empty((1, 4, 4, 3), device="meta"))


def test_resident_equals_shipped_at_f32_and_matches_jax():
    """As tests/test_quant.py:test_int8_resident_matches_shipped: the
    int8-resident probe equals the shipped static path at f32; at bf16 the
    shipped path rounds each layer to bf16 before requantizing and may
    differ."""
    jp, tp = _params(11)
    x = _image(12)
    scales = Q.calibrate_trunk(tp, torch.from_numpy(x))
    a = Q.encoder_convs_int8(tp, torch.from_numpy(x), scales)
    b = Q.encoder_convs_int8_resident(tp, torch.from_numpy(x), scales)
    assert torch.equal(a, b)
    ref = JQ.encoder_convs_int8_resident(jp, jnp.asarray(x), scales)
    _hold_c3(b.numpy(), np.asarray(ref))


def test_int8_fragments_follow_the_mma_layout():
    """Unpack the fragment buffer by the PTX layout of mma.m16n8k32 .s8 B
    (lane (g, tg): b0 holds k = 4tg..4tg+3 of column g, b1 k = 16 + 4tg..,
    low byte first) and recover B[k][c], k = (ky*3 + kx)*Cin + ci: column c
    computes output channel N_PERM[c], so that accumulator lane tg holds
    channels 8tg .. 8tg + 7."""
    rng = np.random.RandomState(13)
    assert sorted(K8.N_PERM) == list(range(32))
    for c in range(32):  # column 8j + 2t + e -> channel 8t + 2j + e
        assert K8.N_PERM[c] == 8 * ((c % 8) // 2) + 2 * (c // 8) + c % 2
    for ci in (3, 32):
        wq = torch.from_numpy(rng.randint(-127, 128, (32, ci, 3, 3)).astype(np.int8))
        frags = K8.int8_fragments(wq).numpy()
        b = wq.permute(2, 3, 1, 0).reshape(-1, 32).numpy()
        steps = -(-b.shape[0] // 32)
        assert frags.shape == (steps * 2 * 32 * 16,)
        got = np.zeros((steps * 32, 32), np.int8)
        u = frags.reshape(steps, 2, 32, 4, 4)  # [step][pair][lane][u32 word][byte]
        for s in range(steps):
            for pair in range(2):
                for lane in range(32):
                    g, tg = lane >> 2, lane & 3
                    for word in range(4):
                        tile, reg = word >> 1, word & 1
                        for e in range(4):
                            got[32 * s + 16 * reg + 4 * tg + e, 8 * (2 * pair + tile) + g] = u[s, pair, lane, word, e]
        np.testing.assert_array_equal(got[:b.shape[0]], b[:, K8.N_PERM])
        assert not got[b.shape[0]:].any()


def test_int8_weight_cache_and_epilogue():
    """prepare_int8_weights builds once per (weight tensors, scales); an
    in-place update or other scales build anew. Its epilogue constants are
    the plain version's combined scales and the f32 biases."""
    _, tp = _params(14)
    ws, bs = tp[0::2], tp[1::2]
    scales = (113.37, 21.5, 7.25)
    K8.prepare_int8_weights.calls = 0
    frags, epi, flags = K8.kernel_int8_weights(ws, bs, scales)
    assert K8.kernel_int8_weights(ws, bs, scales)[0] is frags
    assert flags == 0  # seeded weights: every layer's |acc| stays below 2^22
    assert K8.prepare_int8_weights.calls == 1
    assert frags.dtype == torch.int8 and frags.numel() == 19456
    assert epi.dtype == torch.float32 and epi.numel() == 192
    for i, (w, s) in enumerate(zip(ws, scales)):
        _, w_inv = Q.quantize_conv_weight(w)
        assert torch.equal(epi[32 * i:32 * (i + 1)], Q.combined_scale(1.0 / s, w_inv))
    assert torch.equal(epi[96:], torch.cat(bs))
    K8.kernel_int8_weights(ws, bs, (1.0, 2.0, 3.0))
    assert K8.prepare_int8_weights.calls == 2
    with torch.no_grad():
        ws[1][0, 0, 0, 0] += 1.0  # a new absmax for output channel 0
    frags2 = K8.kernel_int8_weights(ws, bs, scales)[0]
    assert K8.prepare_int8_weights.calls == 3 and not torch.equal(frags2, frags)

"""The arithmetic of B1-int8's epilogue (driving_dirty_tpu_torch/csrc/
trunk_int8.cu), proven on the CPU: the kernel cannot run here, so its
epilogue is written out step for step in numpy int32 / float32 bit
operations and held bit-equal to the plain version's composition
(ops/quant.py: the conv2d_int8 epilogue acc * comb, the bias, ReLU, the
rounding to bf16 and `quantize`).

Emulated, as the kernel computes them:
  * int32 -> f32: the sum starts at the bits of 1.5 * 2^23 (the first
    k-step's mma C operand), so it ends as those bits plus acc, read as a
    float, with 1.5 * 2^23 taken off by an f32 add: exact for |acc| <=
    2^22; a layer whose accumulators can reach 2^22 (`int_path_flags`)
    starts at 0 and takes __int2float_rn instead;
  * acc * comb + bias, two f32 roundings (no fma);
  * cvt.rn.relu.bf16x2.f32: ReLU and bf16 round-to-nearest-even, one value
    with bf16(0) beside it for q1 and q2 (its bits are then the bf16 value
    as an f32), a pair for c3;
  * the requantization rn(min(v * s, 127)) + 1.5 * 2^23 (ReLU outputs are
    >= 0, so the lower clamp cannot act), the int8 in the float's low
    byte, four packed by byte permutes;
  * q0 of the bf16 input with both clamps, the low byte the two's
    complement int8.
Equality is exact: int8 values bit for bit, bf16 outputs equal as values
(+0 and -0 compare equal, as on the card).

Also: the kernel's B layout unpacked by the PTX layout, and the stage
variants' plain versions against the JAX package's own pieces
(driving_dirty_tpu/ops/quant.py), run on the CPU.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.ops import quant as JQ
from driving_dirty_tpu_torch.kernels import trunk_int8 as K8
from driving_dirty_tpu_torch.ops import quant as Q

MAGIC = np.float32(12582912.0)
MAGIC_BITS = np.int32(0x4B400000)
C1_BOUND = 27 * 127 * 127          # c1's |acc| bound: always below 2^22
FULL_BOUND = 288 * 127 * 127       # c2's and c3's worst case, above 2^22


# ---------------------------------------------------------------- emulation


def magic_f32(acc):
    """f32(acc) by the magic number: the int32 sum started at its bits,
    read as a float, the magic taken off by an f32 subtract."""
    return (acc.astype(np.int32) + MAGIC_BITS).view(np.float32) - MAGIC


def affine(acc, comb, bias, cvt=False):
    f = acc.astype(np.float32) if cvt else magic_f32(acc)
    return (f * np.float32(comb)).astype(np.float32) + np.float32(bias)


def relu_bf16_bits(v):
    """cvt.rn.relu to bf16: the 16-bit pattern, round to nearest even on the
    bits, negatives to +0."""
    bits = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint32)
    return np.where(np.signbit(v), np.uint32(0), r)


def bf16_to_f32(h):
    return (h.astype(np.uint32) << 16).view(np.float32)


def requant_bits(v, s):
    """min(v * s, 127) + 1.5 * 2^23, as bits; the low byte is q."""
    t = np.minimum((v * np.float32(s)).astype(np.float32), np.float32(127))
    return (t + MAGIC).view(np.uint32)


def quant_bits(v, s):
    t = np.maximum(np.minimum((v * np.float32(s)).astype(np.float32), np.float32(127)), np.float32(-127))
    return (t + MAGIC).view(np.uint32)


def pack4(a, b, c, d):
    """__byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
    0x5410): the four low bytes, a lowest."""
    return (a & 0xFF) | ((b & 0xFF) << 8) | ((c & 0xFF) << 16) | ((d & 0xFF) << 24)


def kernel_requant(acc, comb, bias, s, cvt=False):
    """The kernel's c1/c2 epilogue on [n, 8] accumulator rows (one thread's
    channels) -> int8 [n, 8] from the two packed words."""
    v = affine(acc, comb, bias, cvt)
    h = relu_bf16_bits(v)
    q = requant_bits(bf16_to_f32(h), s)
    lo = pack4(*(q[:, i] for i in range(4)))
    hi = pack4(*(q[:, i] for i in range(4, 8)))
    return np.stack([lo, hi], 1).astype(np.uint32).view(np.int8).reshape(len(acc), 8)


def kernel_c3(acc, comb, bias, cvt=False):
    """The kernel's c3 epilogue -> bf16 values as f32."""
    return bf16_to_f32(relu_bf16_bits(affine(acc, comb, bias, cvt)))


def kernel_q0(x_bf16_bits, s):
    return (quant_bits(bf16_to_f32(x_bf16_bits), s) & 0xFF).astype(np.uint8).view(np.int8)


# ------------------------------------------------------------ plain version


def plain_requant(acc, comb, bias, s):
    """ops/quant.py's composition, as encoder_convs_int8 runs it at bf16."""
    v = torch.from_numpy(acc).float() * Q.combined_scale(1.0, torch.from_numpy(comb))
    y = torch.relu(v + torch.from_numpy(bias)).to(torch.bfloat16)
    return Q.quantize(y, s).numpy(), y.float().numpy()


# ------------------------------------------------------------------ inputs


def _rows(acc, rng):
    """[n] accumulators -> [n, 8] rows with seeded per-channel comb, bias."""
    acc = np.asarray(acc, np.int64)
    acc = np.resize(acc, (max(1, -(-acc.size // 8)), 8)).astype(np.int32)
    comb = (rng.rand(8) * 2e-4 + 1e-6).astype(np.float32)
    bias = (rng.randn(8) * 0.2).astype(np.float32)
    return acc, comb, bias


def _hold(acc, comb, bias, s, cvt=False):
    got = kernel_requant(acc, comb, bias, s, cvt)
    ref, y = plain_requant(acc, comb, bias, s)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(kernel_c3(acc, comb, bias, cvt), y)


EDGES = [0, 1, -1, 2 ** 22 - 1, -(2 ** 22 - 1), 2 ** 22, -(2 ** 22), C1_BOUND, -C1_BOUND, 12345, -98765]


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize("s", [1.0, 113.37, 0.25, 3.0e-3])
def test_epilogue_equals_plain_at_edge_accumulators(s):
    rng = np.random.RandomState(0)
    acc, comb, bias = _rows(EDGES * 8, rng)
    _hold(acc, comb, bias, s)
    _hold(acc, comb, bias, s, cvt=True)


def test_magic_conversion_is_exact_to_2_22_and_the_selector_guards_beyond():
    acc = np.concatenate([np.arange(-2 ** 22, -2 ** 22 + 4096), np.arange(-4096, 4096),
                          np.arange(2 ** 22 - 4096, 2 ** 22 + 1)]).astype(np.int32)
    np.testing.assert_array_equal(magic_f32(acc), acc.astype(np.float32))
    beyond = np.array([2 ** 22 + 1, FULL_BOUND, -(2 ** 22) - 3], np.int32)
    assert (magic_f32(beyond) != beyond.astype(np.float32)).all()  # why the selector exists


def test_bf16_ties_round_to_even():
    """comb = 2^-8, bias 0: acc / 256 lands on every bf16 tie between 1 and
    512 (odd acc above 256), and on exact values."""
    acc = np.arange(256, 131072, 1, dtype=np.int32)
    comb = np.full(8, 2.0 ** -8, np.float32)
    bias = np.zeros(8, np.float32)
    a = np.resize(acc, (acc.size // 8, 8))
    got = kernel_c3(a, comb, bias)
    v = a.astype(np.float32) / 256
    ties = (v.view(np.uint32) & 0xFFFF) == 0x8000
    assert ties.sum() > 1000
    _hold(a, comb, bias, 0.5)
    # ties went to the even neighbour
    assert ((got[ties].view(np.uint32) >> 16) & 1 == 0).all()


@pytest.mark.parametrize("s", [1.0, 0.5, 2.0])
def test_requantization_ties_and_the_clamp(s):
    """v * s at k + 0.5 for every k below 127 (ties to even), and v * s
    around 126.5, 127 and 127.5 and above, on bf16 values."""
    v = np.concatenate([np.arange(0, 127) + 0.5, [126.49, 126.5, 126.51, 126.99, 127.0, 127.01, 127.49,
                                                  127.5, 127.51, 128.0, 200.0, 1e30]]) / s
    v = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).float().numpy()
    got = requant_bits(v, s) & 0xFF
    ref = Q.quantize(torch.from_numpy(v).to(torch.bfloat16), s).numpy()
    np.testing.assert_array_equal(got.astype(np.uint8).view(np.int8), ref)
    # through the whole epilogue: acc = v / comb exactly (comb = 2^-4)
    v16 = v * 16
    acc = np.round(v16[np.abs(v16) < 2 ** 22]).astype(np.int64)
    comb = np.full(8, 2.0 ** -4, np.float32)
    _hold(*_rows(acc, np.random.RandomState(1))[:1], comb, np.zeros(8, np.float32), s)


def test_negative_pre_relu_values_give_zero():
    rng = np.random.RandomState(2)
    acc = -rng.randint(1, 2 ** 22, 4096).astype(np.int32)
    acc, comb, bias = _rows(acc, rng)
    bias = -np.abs(bias) - 1e-3
    got = kernel_requant(acc, comb, bias, 50.0)
    assert not got.any()
    _hold(acc, comb, bias, 50.0)
    # negatives to +0; a subnormal positive value keeps its bf16 subnormal,
    # as torch rounds it. (acc * comb + bias is never -0: a sum of two
    # roundings is -0 only if both terms are, and acc * comb >= +0 at 0.)
    v = np.array([-1e-40, 1e-40, -3.5], np.float32)
    want = torch.relu(torch.from_numpy(v)).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert relu_bf16_bits(v).tolist() == want.tolist() == [0, 1, 0]


def test_input_quantization_keeps_both_clamps():
    """q0 of bf16 inputs around +-127.5 / s and across the range, as
    ops/quant.py:quantize rounds them."""
    for s in (1.0, 113.37, 0.731):
        base = np.array([127.5, -127.5, 126.5, -126.5, 127.0, -127.0, 0.5, -0.5, 1.5, -1.5, 0.0, -0.0, 300.0,
                         -300.0, 1e9, -1e9], np.float32) / np.float32(s)
        sweep = np.random.RandomState(3).uniform(-2, 2, 20000).astype(np.float32) * (200 / s)
        x = torch.from_numpy(np.concatenate([base, np.nextafter(base, 0), sweep])).to(torch.bfloat16)
        bits = x.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(kernel_q0(bits, s), Q.quantize(x, s).numpy())


def test_seeded_sweep_of_millions_of_values():
    """About 2.6 million accumulator values over the realistic range, with
    seeded per-channel comb, bias and scales, on both int paths."""
    rng = np.random.RandomState(4)
    for layer_bound, cvt in ((C1_BOUND, False), (2 ** 22, False), (FULL_BOUND, True)):
        for s in (rng.uniform(0.5, 400), rng.uniform(0.5, 400)):
            acc = rng.randint(-layer_bound, layer_bound + 1, 8 * 54000).astype(np.int32)
            acc, _, bias = _rows(acc, rng)
            # |acc * comb * s| up to 40..250: ReLU zeros, every q and the clamp
            comb = (127 * rng.uniform(0.3, 2, 8) / (layer_bound * s)).astype(np.float32)
            _hold(acc, comb, bias, s, cvt)


def test_int_path_selector_takes_int2float_where_2_22_is_reachable():
    rng = np.random.RandomState(5)
    w1 = torch.from_numpy(rng.randn(32, 3, 3, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 32, 3, 3).astype(np.float32) * 0.1)
    flat = torch.sign(torch.from_numpy(rng.randn(32, 32, 3, 3).astype(np.float32))) * 0.1  # every |wq| 127
    wqs = [Q.quantize_conv_weight(v)[0] for v in (w1, w, w)]
    assert K8.int_path_flags(wqs) == 0
    assert 127 * int(wqs[1].abs().sum(dim=(1, 2, 3), dtype=torch.int64).max()) < 2 ** 22
    assert K8.int_path_flags([wqs[0], Q.quantize_conv_weight(flat)[0], wqs[2]]) == 2
    assert K8.int_path_flags([wqs[0], wqs[1], Q.quantize_conv_weight(flat)[0]]) == 4
    # c1's worst case, every |wq| 127, stays below 2^22
    assert K8.int_path_flags([Q.quantize_conv_weight(torch.sign(w1))[0], wqs[1], wqs[2]]) == 0
    bs = [torch.zeros(32)] * 3
    assert K8.prepare_int8_weights((w1, flat, flat), bs, (1.0, 2.0, 3.0))[2] == 6


def _jax_stage(x, params_np, scales, stages):
    """The JAX package's pieces, composed as encoder_convs_int8 composes
    them at bf16: quantize, conv2d_int8, bias, ReLU, bf16, requantize."""
    q = JQ.quantize(jnp.asarray(x, jnp.bfloat16), scales[0])
    for i in range(stages):
        w, b = params_np[2 * i], params_np[2 * i + 1]
        wq, w_inv = JQ.quantize_conv_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
        v = JQ.conv2d_int8(q, wq, 1.0 / scales[i], w_inv, stride=2 if i == 2 else 1)
        y = jnp.maximum(v + jnp.asarray(b), 0).astype(jnp.bfloat16)
        if i == 2:
            return np.asarray(y.astype(jnp.float32))
        q = JQ.quantize(y, scales[i + 1])
    q = np.asarray(q)[:, ::2, ::2]
    if stages == 0:
        q = q[..., [c % 3 for c in range(32)]]
    return q.astype(np.float32)


@pytest.mark.parametrize("variant", list(K8.INT8_VARIANT_STAGES))
def test_stage_variants_plain_match_the_jax_pieces(variant):
    rng = np.random.RandomState(6)
    shapes = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]
    params_np = [(rng.randn(*s) * (0.15 if len(s) == 4 else 0.1)).astype(np.float32) for s in shapes]
    x = rng.rand(2, 17, 35, 3).astype(np.float32)
    params = [torch.from_numpy(p) for p in params_np]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    scales = Q.calibrate_trunk(params, xb)
    got = K8.trunk_int8_variant(xb, *params, scales, variant=variant)
    assert got.shape == (2, 9, 18, 32) and got.dtype == torch.bfloat16
    ref = _jax_stage(x, params_np, scales, K8.INT8_VARIANT_STAGES[variant])
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if variant == "full":
        assert torch.equal(got, K8.trunk_int8_plain(xb, *params, scales))

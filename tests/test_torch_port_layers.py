"""driving_dirty_tpu_torch layers, stitching, threat score and precision
against the JAX package's functions, on the CPU.

Inputs come from numpy seeds and go through both. Tolerances: f32 results
that are a reassociated sum get rtol/atol 1e-5; pure data movement and
integer-valued results are bit-exact; bf16 results get 2^-7 relative to the
output scale (one bf16 rounding of results taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.core import layers as JL
from driving_dirty_tpu.metrics.threat import ts_road_map as jax_ts
from driving_dirty_tpu.ops import stitch as JS
from driving_dirty_tpu_torch.checkpoints.convert import from_jax
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.metrics.threat import ts_road_map
from driving_dirty_tpu_torch.models.precision import compute_dtype
from driving_dirty_tpu_torch.ops import stitch as S

KEY = jax.random.PRNGKey(0)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _load(module, params, state=None):
    """Load one layer's JAX params/state into `module` through from_jax."""
    sd = from_jax({"m": params}, None if state is None else {"m": state})
    module.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    return module


def _bf16_close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -7 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(dtype):
    jl = JL.Linear(12, 5)
    p = jl.init(KEY)
    x = np.random.RandomState(0).randn(3, 12).astype(np.float32)
    ref = jl.apply(p, jnp.asarray(x, dtype))
    lin = _load(L.Linear(12, 5, device="cpu"), p)
    got = lin(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **F32_TOL)
    else:
        _bf16_close(got.detach().float().numpy(), ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_jax(stride):
    jc = JL.Conv2d(3, 8, 3, stride, 1)
    p = jc.init(KEY)
    x = np.random.RandomState(1).randn(2, 9, 12, 3).astype(np.float32)
    ref = jc.apply(p, jnp.asarray(x))
    conv = _load(L.Conv2d(3, 8, 3, stride, 1, device="cpu"), p)
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


def test_batchnorm_eval_and_train_match_jax():
    rng = np.random.RandomState(2)
    jbn = JL.BatchNorm(6)
    p = {"scale": jnp.asarray(rng.rand(6) + 0.5, jnp.float32),
         "bias": jnp.asarray(rng.randn(6), jnp.float32)}
    s = {"mean": jnp.asarray(rng.randn(6), jnp.float32),
         "var": jnp.asarray(rng.rand(6) + 0.5, jnp.float32)}
    x = rng.randn(5, 6).astype(np.float32)
    bn = _load(L.BatchNorm(6, device="cpu"), p, s)

    ref, _ = jbn.apply(p, s, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               **F32_TOL)

    ref, new_s = jbn.apply(p, s, jnp.asarray(x), train=True)
    got = bn.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_s["mean"]), **F32_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_s["var"]), **F32_TOL)


def test_dropout_is_gated_on_train():
    x = torch.ones(2000)
    assert L.dropout(x, 0.2, train=False) is x
    assert L.dropout(x, 0.0, train=True) is x
    y = L.dropout(x, 0.2, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert 0.75 < kept.float().mean().item() < 0.85


@pytest.mark.parametrize("n", [16, 18])  # 18 leaves a tail the pool drops
def test_max_pool_flat_matches_jax(n):
    x = np.random.RandomState(3).randn(3, n).astype(np.float32)
    ref = JL.max_pool_flat(jnp.asarray(x), 4)
    got = L.max_pool_flat(torch.from_numpy(x), 4)
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
def test_stitch_uint8_matches_jax(dtype):
    x = np.random.RandomState(4).randint(0, 256, (2, 6, 5, 7, 3)).astype(np.uint8)
    jdt = None if dtype is None else getattr(jnp, dtype)
    ref = JS.wide_stitch(JS.normalize_images(jnp.asarray(x), jdt))
    # the port stitches the uint8 bytes first, then divides on the device
    got = S.normalize_images(S.wide_stitch(torch.from_numpy(x)),
                             None if dtype is None else getattr(torch, dtype))
    assert tuple(got.shape) == ref.shape == (2, 5, 42, 3)
    assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_stitch_float_matches_jax_and_unstitch_inverts():
    x = np.random.RandomState(5).rand(2, 6, 4, 5, 3).astype(np.float32)
    ref = JS.wide_stitch(JS.normalize_images(jnp.asarray(x)))
    pano = S.wide_stitch(S.normalize_images(torch.from_numpy(x)))
    assert np.array_equal(pano.numpy(), np.asarray(ref))
    back = S.unstitch(pano, view_width=5)
    assert np.array_equal(back.numpy(), x)
    assert np.array_equal(back.numpy(), np.asarray(JS.unstitch(ref, view_width=5)))


def test_ts_road_map_matches_jax():
    rng = np.random.RandomState(6)
    a = (rng.rand(2, 40, 40) > 0.5).astype(np.float32)
    b = rng.rand(2, 40, 40).astype(np.float32)
    for x, y in ((a[0], (b[0] > 0.5).astype(np.float32)), (a, b)):
        got = ts_road_map(torch.from_numpy(x), torch.from_numpy(y)).item()
        np.testing.assert_allclose(got, float(jax_ts(x, y)), rtol=1e-6)


def test_compute_dtype():
    assert compute_dtype(None) is torch.float32
    assert compute_dtype(32) is torch.float32
    assert compute_dtype(16) is torch.bfloat16
    with pytest.raises(NotImplementedError):
        compute_dtype(8)
    with pytest.raises(ValueError):
        compute_dtype(64)

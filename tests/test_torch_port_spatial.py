"""driving_dirty_tpu_torch's conv layers, the transposed-conv weight layout
of its converter, and the spatial BEV heads (nn/spatial.py) against the JAX
package on the CPU.

JAX initializes; checkpoints/convert.py carries the weights across; the
same numpy inputs go through both. Tolerances: a single conv or transposed
conv, an f32 sum reassociated over at most a few thousand terms, rtol/atol
1e-5; the heads (a chain of up to seven such layers, as
tests/test_torch_port_models.py bounds its chains) rtol 1e-3 / atol 1e-4.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.core import layers as JL
from driving_dirty_tpu.nn import spatial as JS
from driving_dirty_tpu_torch.checkpoints.convert import (
    from_jax,
    load_jax_weights,
    model_to_jax,
    to_jax,
    transposed_paths,
)
from driving_dirty_tpu_torch.core import layers as L
from driving_dirty_tpu_torch.nn import spatial as S

KEY = jax.random.PRNGKey(0)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
HEAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _run_layer(jlayer, port, x):
    p = jlayer.init(KEY)
    ref = np.asarray(jlayer.apply(p, jnp.asarray(x)))
    transposed = {"m"} if isinstance(port, L.ConvTranspose2d) else ()
    sd = from_jax({"m": p}, transposed=transposed)
    port.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("cfg", [
    dict(kernel_size=(1, 5), stride=(3, 2), padding=0),
    dict(kernel_size=(4, 1), stride=(3, 2), padding=(0, 1)),
    dict(kernel_size=3, stride=1, padding=0, dilation=3),
    dict(kernel_size=(3, 2), stride=2, padding=(1, 0), dilation=(2, 1)),
])
def test_conv2d_rectangular_strided_dilated_matches_jax(cfg):
    x = np.random.RandomState(1).randn(2, 13, 15, 3).astype(np.float32)
    got, ref = _run_layer(JL.Conv2d(3, 5, **cfg), L.Conv2d(3, 5, **cfg, device="cpu"), x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **LAYER_TOL)


def _convt_tuples():
    tuples = {(32, 32, 2, 2, 0, 0, 1)}  # ss_deconv
    for g in JS.GEOMETRIES.values():
        tuples.update(tuple(t) for t in g["boxes_up"] + g["rm_up"])
    return sorted(tuples)


@pytest.mark.parametrize("cin,cout,k,s,p,op,d", _convt_tuples())
def test_conv_transpose2d_matches_jax(cin, cout, k, s, p, op, d):
    x = np.random.RandomState(2).randn(1, 4, 5, cin).astype(np.float32)
    got, ref = _run_layer(JL.ConvTranspose2d(cin, cout, k, s, p, op, d),
                          L.ConvTranspose2d(cin, cout, k, s, p, op, d, device="cpu"), x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **LAYER_TOL)


def test_conv_transpose_weights_round_trip_by_owner_not_shape():
    """A 32->32 ConvTranspose2d weight has the same shape in either 4-d
    layout; the converter lays it out by the module that owns it, and
    to_jax gives back the JAX pytree bit for bit."""
    jl = JL.ConvTranspose2d(32, 32, 2, 2, 0)
    p = jax.tree.map(np.asarray, jl.init(KEY))
    x = np.random.RandomState(3).randn(1, 3, 4, 32).astype(np.float32)
    ref = np.asarray(jl.apply(p, jnp.asarray(x)))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = L.ConvTranspose2d(32, 32, 2, 2, 0, device="cpu")

    holder = Holder()
    assert transposed_paths(holder) == {"m"}
    load_jax_weights(holder, {"m": p})
    with torch.no_grad():
        np.testing.assert_allclose(holder.m(torch.from_numpy(x)).numpy(), ref, **LAYER_TOL)
    params, _ = model_to_jax(holder)
    assert np.array_equal(params["m"]["w"], p["w"]) and np.array_equal(params["m"]["b"], p["b"])

    # read as a conv weight, the same array loads without error and is wrong
    as_conv = from_jax({"m": p})
    holder.load_state_dict(as_conv)
    with torch.no_grad():
        assert not np.allclose(holder.m(torch.from_numpy(x)).numpy(), ref, **LAYER_TOL)
    with pytest.raises(KeyError):
        to_jax(holder.state_dict(), transposed={"not_there"})


def _heads(cls, seed):
    jm = getattr(JS, cls)(geometry="small")
    params, _ = jm.init(jax.random.PRNGKey(seed))
    port = getattr(S, cls)("small", device="cpu")
    load_jax_weights(port, params)
    return jm, params, port


def test_spatial_mapping_cnn_matches_jax():
    jm, params, port = _heads("SpatialMappingCNN", 1)
    x = np.random.RandomState(4).rand(2, 6, 64, 78, 3).astype(np.float32)
    ref, _ = jm.apply(params, {}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 32)
    np.testing.assert_allclose(got, np.asarray(ref), **HEAD_TOL)


@pytest.mark.parametrize("cls", ["BoxesMergingCNN", "RoadMapBoxesMergingCNN"])
def test_merging_cnns_match_jax(cls):
    jm, params, port = _heads(cls, 2)
    assert port.raster_size == jm.raster_size
    rng = np.random.RandomState(5)
    ssr = rng.rand(2, 32, 234, 32).astype(np.float32)
    spatial = rng.rand(2, 64, 64, 32).astype(np.float32)
    args = [ssr, spatial]
    if cls == "RoadMapBoxesMergingCNN":
        args.append((rng.rand(2, 152, 152, 1) > 0.5).astype(np.float32))
    ref, _ = jm.apply(params, {}, *map(jnp.asarray, args))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args)).numpy()
    size = jm.raster_size
    assert got.shape == ref.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, np.asarray(ref), **HEAD_TOL)


def test_geometries_are_the_jax_presets():
    assert S.GEOMETRIES == JS.GEOMETRIES

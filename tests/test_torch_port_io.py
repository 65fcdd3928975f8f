"""driving_dirty_tpu_torch checkpoints: the npz format both ways and the
weight layouts between JAX pytrees and state_dicts, on the CPU.

Every comparison here is bit-exact: nothing is computed, only stored,
loaded and transposed."""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import numpy as np
import pytest
import torch

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.models.roadmap import RoadMapBCEv2 as JaxRoadMapBCEv2
from driving_dirty_tpu_torch.checkpoints import io as port_io
from driving_dirty_tpu_torch.checkpoints.convert import from_jax, to_jax
from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2

TINY = dict(ae_hidden_dim=8, ae_latent_dim=6, ae_input_height=16, ae_input_width=24,
            pretrained_path=None, batch_size=2)


@pytest.fixture(scope="module")
def jax_tree():
    params, state = JaxRoadMapBCEv2(TINY).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y), path


def _extras():
    rng = np.random.RandomState(3)
    opt = [rng.randn(4).astype(np.float32), np.int32(7), rng.randn(2, 3).astype(np.float32)]
    extra = {"rng": np.array([1, 2], np.uint32), "cursor": np.int64(5)}
    meta = {"task": "roadmap_bce", "epoch": 3, "step": 12, "lr": 1e-3}
    return opt, extra, meta


def test_jax_written_checkpoint_loads_bit_exact(jax_tree, tmp_path):
    params, state = jax_tree
    opt, extra, meta = _extras()
    path = str(tmp_path / "jax.ckpt")
    jax_io.save(path, params=params, state=state, opt_state=opt, hparams=TINY, meta=meta,
                extra=extra)
    got = port_io.load(path)
    ref = jax_io.load(path)
    for key in ("params", "state", "opt_state", "extra"):
        assert_tree_equal(got[key], ref[key], key)
    assert_tree_equal(got["params"], params)
    assert got["hparams"] == TINY and got["meta"] == meta


def test_port_written_checkpoint_loads_bit_exact_in_jax(jax_tree, tmp_path):
    params, state = jax_tree
    opt, extra, meta = _extras()
    # leaves may be torch tensors on the port's side
    torch_params = jax.tree.map(torch.tensor, params)
    path = str(tmp_path / "port.ckpt")
    port_io.save(path, params=torch_params, state=state, opt_state=opt, hparams=TINY,
                 meta=meta, extra=extra)
    got = jax_io.load(path)
    assert_tree_equal(got["params"], params)
    assert_tree_equal(got["state"], state)
    assert_tree_equal(got["opt_state"], [np.asarray(o) for o in opt])
    assert_tree_equal(got["extra"], jax.tree.map(np.asarray, extra))
    assert got["hparams"] == TINY and got["meta"] == meta


def test_convert_roundtrip_and_layouts(jax_tree):
    params, state = jax_tree
    sd = from_jax(params, state)
    enc = params["encoder"]
    assert np.array_equal(sd["encoder.c2.weight"].numpy(), enc["c2"]["w"].transpose(3, 2, 0, 1))
    assert np.array_equal(sd["encoder.fc1.fc.weight"].numpy(), enc["fc1"]["fc"]["w"].T)
    assert np.array_equal(sd["encoder.fc1.bn.weight"].numpy(), enc["fc1"]["bn"]["scale"])
    assert np.array_equal(sd["encoder.fc2.bn.running_var"].numpy(),
                          state["encoder"]["fc2"]["bn"]["var"])
    assert np.array_equal(sd["fc1.weight"].numpy(), params["fc1"]["w"].T)
    p2, s2 = to_jax(sd)
    assert_tree_equal(p2, params)
    assert_tree_equal(s2, state)


def test_converted_weights_fill_the_port_model_exactly(jax_tree):
    params, state = jax_tree
    model = RoadMapBCEv2(TINY, device="cpu")
    sd = from_jax(params, state)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    p2, s2 = to_jax(model.state_dict())
    assert_tree_equal(p2, params)
    assert_tree_equal(s2, state)

"""Box-family training of the tasks whose encoder holds BatchNorm,
multitask and bb_mlp (models/multitask.py, models/bb_mlp.py), against the
JAX package on the CPU: loss and gradients with the encoder frozen and
training, and bb_mlp's forward and validation loss. Shapes, inputs and
tolerances are those of tests/test_torch_port_box_training.py, whose
helpers this file uses; bb_mlp's box corners within rtol 1e-4, atol 1e-5
(f32 through the 59904-wide fc1 and the two head layers).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_box_training import B, KEY, LOSS_RTOL, _batch, _pair, _torch, check_loss_and_gradients


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("name", ["multitask", "bb_mlp"])
def test_loss_and_gradients_match_jax_value_and_grad(name, frozen):
    check_loss_and_gradients(name, frozen)


def test_bb_mlp_forward_and_loss_match_jax():
    jtask, params, state, port = _pair("bb_mlp")
    batch = _batch("bb_mlp", seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref, _ = jtask.forward(params, state, jb["images"], train=False, rng=KEY)
    port.eval()
    with torch.no_grad():
        got = port(_torch(batch)["images"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 100, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    m_ref = jtask.val_metrics(params, state, jb, KEY)
    with torch.no_grad():
        m = port.val_metrics(_torch(batch))
    assert set(m) == set(m_ref) == {"val_loss"}
    np.testing.assert_allclose(m["val_loss"].item(), float(m_ref["val_loss"]), rtol=LOSS_RTOL)
    # padding rows count: the loss is the plain mean over the whole padded tensor
    want = np.mean((batch["boxes"] - got.numpy()) ** 2)
    np.testing.assert_allclose(m["val_loss"].item(), want, rtol=1e-6)
    assert not hasattr(port, "predict") and not hasattr(jtask, "predict")

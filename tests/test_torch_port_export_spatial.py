"""Export and serving of a spatial_rm checkpoint (export.py:export_spatial) against
the JAX package's on the CPU: the JAX package writes the checkpoint at
small width (hidden 8, latent 8; the artifact's full input size),
both packages export it (the JAX one for platforms=("cpu",)), and the
port's `Served` must give, for raw uint8 images and for the same images
/255 in float32, the JAX `Served`'s outputs and the port's own
`predict`'s.

Tolerances: occupancy probabilities within 1e-5 relative + 1e-6 absolute
of the JAX artifact's (f32 transposed convs summed in another order;
6e-8 measured), and equal to the port's `predict`.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import numpy as np
import pytest
import torch

from driving_dirty_tpu import export as jx
from driving_dirty_tpu.checkpoints import io as jax_ckpt
from driving_dirty_tpu.models.spatial_bb import BBSpatialRoadMap as JaxTask
from driving_dirty_tpu_torch import export as tx

HPARAMS = dict(pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, batch_size=1, precision=32)
TASK = "spatial_rm"


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_export_spatial")
    params, state = JaxTask(dict(HPARAMS)).init(jax.random.PRNGKey(0))
    ckpt = str(d / "task.ckpt")
    jax_ckpt.save(ckpt, params=params, state=state, hparams=dict(HPARAMS), meta={"task": TASK})
    port, ref = str(d / "torch.ddx"), str(d / "jax.ddx")
    meta = tx.export_spatial(ckpt, port, batch_size=1, device="cpu")
    jax_meta = jx.export_spatial(ckpt, ref, batch_size=1, platforms=("cpu",))
    for k in ("task", "batch_size", "precision", "output", "inputs", "param_names", "state_digest"):
        assert meta[k] == jax_meta[k], k
    f32 = _inputs(12, raw_uint8=False)
    direct = tx.load_task_ckpt(ckpt, device="cpu").predict(*(torch.from_numpy(a) for a in f32))
    return {"port": port, "jax": jx.load(ref)(*f32), "direct": direct}


def _inputs(seed, raw_uint8):
    """Camera bytes (uint8), or the same images divided by 255 in f32."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(1, 6, 256, 306, 3) * 255).astype(np.uint8)
    if not raw_uint8:
        images = images.astype(np.float32) / np.float32(255.0)
    return [images, (rng.rand(1, 800, 800) > 0.5).astype(np.float32)]


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_served_matches_jax_served_and_predict(arts, raw_uint8):
    got = tx.load(arts["port"])(*_inputs(12, raw_uint8))
    ref, direct = arts["jax"], arts["direct"]
    assert got.shape == (1, 800, 800) and 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert torch.equal(got, direct)

"""The port's roadmap inference slice end to end against the JAX package's,
on the CPU: one JAX-written RoadMapBCEv2 checkpoint (small AE, full
256x1836 panorama) and one tiny synthetic dataset go through the JAX
`cli.run_test.main` and the port's `cli.run_test.main --device cpu`.

Masks must agree on >99.9% of pixels (only logits within float error of 0
can flip) and avg_ts within 1e-3."""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import numpy as np

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.cli import run_test as jax_run_test
from driving_dirty_tpu.data.synthetic import generate
from driving_dirty_tpu.models.roadmap import RoadMapBCEv2 as JaxRoadMapBCEv2
from driving_dirty_tpu_torch.cli import run_test as port_run_test

HPARAMS = dict(ae_hidden_dim=8, ae_latent_dim=8, pretrained_path=None, batch_size=2)


def test_run_test_main_matches_jax(tmp_path):
    data = str(tmp_path / "data")
    generate(data, scenes=1, samples=2, labeled_scenes=1, seed=0)
    params, state = JaxRoadMapBCEv2(HPARAMS).init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path / "rm.ckpt")
    jax_io.save(ckpt, params=params, state=state, hparams=HPARAMS, meta={"task": "roadmap_bce"})

    args = ["--rm_ckpt_path", ckpt, "--link", data, "--batch_size", "2",
            "--samples_per_scene", "2", "--num_labeled_scenes", "1"]
    ref = jax_run_test.main(args + ["--out", str(tmp_path / "jax.npz")])
    got = port_run_test.main(args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])

    assert got["n_scenes"] == ref["n_scenes"] == 2
    masks_ref = np.load(tmp_path / "jax.npz")["masks"]
    masks = np.load(tmp_path / "port.npz")["masks"]
    assert masks.shape == masks_ref.shape == (2, 800, 800)
    assert (masks == masks_ref).mean() > 0.999
    assert 0.0 < got["avg_ts"] < 1.0
    np.testing.assert_allclose(got["avg_ts"], ref["avg_ts"], atol=1e-3)

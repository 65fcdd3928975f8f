"""Export and serving of the port (export.py, cli/export.py, cli/serve.py)
against the JAX package's on the CPU, for a roadmap checkpoint written by
the JAX package at small width (hidden 8, latent 8, the artifact's full
input size).

The checkpoint is exported by both packages (the JAX one for
platforms=("cpu",)); the port's `Served` must give the JAX `Served`'s masks
for float32 and for raw uint8 images, and its own `predict`'s. Also
covered: the artifact's contents and meta (the JAX fields and state
digest), precision 8 (refused without calibration images, then served),
`swap_params` (a second JAX checkpoint's weights give that checkpoint's
masks; a drifted state is refused unless forced; a wrong tree or shape is
refused), bad input shapes and counts, and a load on another device type
or of a JAX artifact. tests/test_torch_port_serve.py covers the CLIs and
the HTTP server.

Tolerances: masks equal exactly (logits within float error of 0 could
flip, and none does at these seeds: the f32 programs run the same
convolutions, matmuls and threshold).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu import export as jx
from driving_dirty_tpu.checkpoints import io as jax_ckpt
from driving_dirty_tpu.models.roadmap import RoadMapBCEv2 as JaxRoadMap
from driving_dirty_tpu_torch import export as tx
from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model

HPARAMS = dict(pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, batch_size=2, precision=32)
B = 2


def _jax_ckpt(path, seed):
    task = JaxRoadMap(dict(HPARAMS))
    params, state = task.init(jax.random.PRNGKey(seed))
    jax_ckpt.save(str(path), params=params, state=state, hparams=dict(HPARAMS), meta={"task": "roadmap_bce"})
    return str(path)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_export")
    ckpt = _jax_ckpt(d / "rm.ckpt", 0)
    port, ref = str(d / "rm_torch.ddx"), str(d / "rm_jax.ddx")
    meta = tx.export_roadmap(ckpt, port, batch_size=B, device="cpu")
    jx.export_roadmap(ckpt, ref, batch_size=B, platforms=("cpu",))
    return {"dir": d, "ckpt": ckpt, "port": port, "jax": ref, "meta": meta}


def _images(seed, n=B):
    return np.random.RandomState(seed).rand(n, 6, 256, 306, 3).astype(np.float32)


def test_artifact_contents_and_meta(arts):
    with zipfile.ZipFile(arts["port"]) as z:
        assert {"program.pt2", "params.npz", "meta.json"} <= set(z.namelist())
        meta = json.loads(z.read("meta.json"))
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            names = sorted(npz.files)
    with zipfile.ZipFile(arts["jax"]) as z:
        jax_meta = json.loads(z.read("meta.json"))
        with np.load(io.BytesIO(z.read("params.npz"))) as npz:
            jax_params = {n: npz[n] for n in npz.files}
    assert meta == arts["meta"]
    assert meta["format_version"] == tx.FORMAT_VERSION == jx.FORMAT_VERSION
    assert meta["framework"] == "torch" and meta["device"] == "cpu"
    assert meta["inputs"] == jax_meta["inputs"] == [
        {"name": "images", "shape": [B, 6, 256, 306, 3], "dtype": "float32", "uint8_scale": True}]
    for k in ("task", "batch_size", "precision", "output", "param_names", "state_digest"):
        assert meta[k] == jax_meta[k], k
    assert names == sorted(jax_params)
    with zipfile.ZipFile(arts["port"]) as z, np.load(io.BytesIO(z.read("params.npz"))) as npz:
        for n in names:  # the JAX names, layouts and values
            np.testing.assert_array_equal(npz[n], jax_params[n], err_msg=n)


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_served_matches_jax_served_and_predict(arts, raw_uint8):
    served, ref = tx.load(arts["port"]), jx.load(arts["jax"])
    images = _images(1)
    if raw_uint8:
        images = (images * 255).astype(np.uint8)
    out = served(images)
    assert out.shape == (B, 800, 800) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref(images)))
    f32 = images.astype(np.float32) / np.float32(255.0) if raw_uint8 else images
    direct = load_roadmap_model(arts["ckpt"], device="cpu").predict(torch.from_numpy(f32))
    assert torch.equal(out, direct)
    assert 0 < out.mean() < 1


def test_precision8_export_needs_calibration_and_serves(arts):
    out = str(arts["dir"] / "rm8.ddx")
    with pytest.raises(ValueError, match="calibration"):
        tx.export_roadmap(arts["ckpt"], out, batch_size=B, precision=8, device="cpu")
    calib = _images(8, n=1)
    meta = tx.export_roadmap(arts["ckpt"], out, batch_size=1, precision=8, device="cpu", calib_images=calib)
    assert meta["precision"] == 8
    with zipfile.ZipFile(out) as z:
        assert b"driving_dirty.trunk_int8" in z.read("program.pt2")
    masks = tx.load(out)(calib)
    model = load_roadmap_model(arts["ckpt"], precision=8, device="cpu")
    direct = model.predict(torch.from_numpy(calib))  # calibrates on the same batch
    assert torch.equal(masks, direct)
    assert set(torch.unique(masks).tolist()) <= {0.0, 1.0}


def test_swap_params(arts):
    """A second JAX checkpoint's weights swap in: the port serves that
    checkpoint's masks, as the JAX Served does after its own swap."""
    ckpt2 = _jax_ckpt(arts["dir"] / "rm2.ckpt", 11)
    blob = jax_ckpt.load(ckpt2)
    served, ref = tx.load(arts["port"]), jx.load(arts["jax"])
    images = _images(2)
    before = served(images)
    served.swap_params(blob["params"], state=blob["state"])
    ref.swap_params(jax.tree.map(jnp.asarray, blob["params"]), state=blob["state"])
    after = served(images)
    assert not torch.equal(before, after)
    np.testing.assert_array_equal(after.numpy(), np.asarray(ref(images)))
    assert torch.equal(after, load_roadmap_model(ckpt2, device="cpu").predict(torch.from_numpy(images)))


def test_swap_params_refuses_drifted_state_and_mismatches(arts):
    served = tx.load(arts["port"])
    blob = jax_ckpt.load(arts["ckpt"])
    served.swap_params(blob["params"], state=blob["state"])  # the baked state itself passes
    drifted = jax.tree.map(lambda x: np.asarray(x) + 1.0, blob["state"])
    with pytest.raises(ValueError, match="re-export"):
        served.swap_params(blob["params"], state=drifted)
    served.swap_params(blob["params"], state=drifted, force=True)
    params = jax.tree.map(np.asarray, blob["params"])
    with pytest.raises(ValueError, match="does not match"):
        served.swap_params({k: v for k, v in params.items() if k != "fc1"})
    params["fc1"] = dict(params["fc1"], b=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape mismatch for fc1/b"):
        served.swap_params(params)


def test_served_rejects_bad_inputs(arts):
    served = tx.load(arts["port"])
    with pytest.raises(ValueError, match="expected images"):
        served(np.zeros((1, 6, 256, 306, 3), np.float32))
    with pytest.raises(ValueError, match="expected 1 inputs"):
        served(_images(3), _images(3))


def test_load_refuses_other_device_types_and_jax_artifacts(arts):
    with pytest.raises(ValueError, match="traced for cpu"):
        tx.load(arts["port"], device="cuda")
    with pytest.raises(ValueError, match="unsupported .ddx"):
        tx.load(arts["jax"])

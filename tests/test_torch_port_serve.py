"""The port's serving surface on the CPU: cli/serve.py (`predict_all`,
the one-shot run with --swap_params, the HTTP server on port 0) and
cli/export.py, over a roadmap artifact exported from a checkpoint that the
JAX package wrote at small width (hidden 8, latent 8, the artifact's full
input size), and a load in a fresh process that imports no model module
and neither JAX nor the JAX package.

Tolerances: none: the one-shot, chunked and HTTP paths return the masks
that `Served` itself gives for the same scenes, bit for bit, and the fresh
process the same masks (the same program on the same inputs).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from driving_dirty_tpu.checkpoints import io as jax_ckpt
from driving_dirty_tpu.models.roadmap import RoadMapBCEv2 as JaxRoadMap
from driving_dirty_tpu_torch import export as tx
from driving_dirty_tpu_torch.cli import export as cli_export
from driving_dirty_tpu_torch.cli import serve

HPARAMS = dict(pretrained_path=None, ae_hidden_dim=8, ae_latent_dim=8, batch_size=2, precision=32)
B = 2
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_serve")
    task = JaxRoadMap(dict(HPARAMS))
    params, state = task.init(jax.random.PRNGKey(0))
    ckpt = str(d / "rm.ckpt")
    jax_ckpt.save(ckpt, params=params, state=state, hparams=dict(HPARAMS), meta={"task": "roadmap_bce"})
    port = str(d / "rm_torch.ddx")
    tx.export_roadmap(ckpt, port, batch_size=B, device="cpu")
    return {"dir": d, "ckpt": ckpt, "port": port}


def _images(seed, n=B):
    return np.random.RandomState(seed).rand(n, 6, 256, 306, 3).astype(np.float32)


def test_predict_all_chunks_and_rejects_an_empty_batch(arts):
    served = tx.load(arts["port"])
    with pytest.raises(ValueError, match="no scenes"):
        serve.predict_all(served, np.zeros((0, 6, 256, 306, 3), np.float32))
    images = _images(4, n=3)
    got = serve.predict_all(served, images)["masks"]
    assert got.shape == (3, 800, 800) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[:2], served(images[:2]).numpy().astype(np.uint8))


def test_serve_and_export_clis(arts, tmp_path, capsys):
    art = str(tmp_path / "cli.ddx")
    meta = cli_export.main(["--rm_ckpt_path", arts["ckpt"], "--out", art, "--batch_size", str(B),
                            "--device", "cpu"])
    assert "exported" in capsys.readouterr().out and meta["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli_export.main(["--rm_ckpt_path", arts["ckpt"], "--out", art, "--precision", "8", "--device", "cpu"])
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "masks.npz")
    images = (_images(5, n=3) * 255).astype(np.uint8)
    np.savez(inp, images=images)
    serve.main(["--artifact", art, "--npz", inp, "--out", out, "--swap_params", arts["ckpt"]])
    assert "3 scenes" in capsys.readouterr().out
    with np.load(out) as z:
        np.testing.assert_array_equal(z["masks"][:2], tx.load(art)(images[:2]).numpy().astype(np.uint8))


def test_http_predict_and_healthz(arts):
    served = tx.load(arts["port"])
    srv = serve.make_server(served, 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            meta = json.loads(r.read())
        assert meta["batch_size"] == B and meta["framework"] == "torch"
        images = _images(6, n=3)
        buf = io.BytesIO()
        np.savez(buf, images=images)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req) as r:
            assert float(r.headers["X-Scenes-Per-Sec"]) > 0
            with np.load(io.BytesIO(r.read())) as z:
                masks = z["masks"]
        np.testing.assert_array_equal(masks, serve.predict_all(served, images)["masks"])
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=b"junk", method="POST")
        with pytest.raises(urllib.error.HTTPError, match="400"):
            urllib.request.urlopen(bad)
    finally:
        srv.shutdown()
        srv.server_close()


def test_load_in_a_fresh_process_imports_no_model_module(arts, tmp_path):
    np.save(tmp_path / "x.npy", _images(7))
    code = (
        "import sys, numpy as np\n"
        "from driving_dirty_tpu_torch import export\n"
        f"served = export.load({arts['port']!r})\n"
        f"out = served(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "mods = sorted(m for m in sys.modules if m.startswith(('driving_dirty_tpu_torch.models', 'jax', "
        "'driving_dirty_tpu.')) or m in ('jax', 'driving_dirty_tpu'))\n"
        "print('MODS', mods)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "MODS []" in res.stdout, res.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), tx.load(arts["port"])(_images(7)).numpy())

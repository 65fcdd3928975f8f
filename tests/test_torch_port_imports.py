"""The port's import rule: no module of driving_dirty_tpu_torch imports JAX
or the JAX package (driving_dirty_tpu), not even a JAX-free module of it.

A fresh process imports every module of the port (pkgutil.walk_packages)
and then lists what of `jax`, `jaxlib` and `driving_dirty_tpu` is in
sys.modules: it must be nothing. No tolerance: the list must be empty.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CODE = """
import importlib, json, pkgutil, sys
import driving_dirty_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "driving_dirty_tpu"))
print(json.dumps({"imported": names, "banned": banned}))
"""


def test_no_port_module_imports_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO), DD_NO_TB="1", OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", CODE], capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "driving_dirty_tpu_torch.export" in out["imported"]
    assert "driving_dirty_tpu_torch.kernels.ops" in out["imported"]
    assert "driving_dirty_tpu_torch.cli.serve" in out["imported"]
    assert len(out["imported"]) > 50
    assert out["banned"] == []

"""driving_dirty_tpu_torch's CUDA kernels against their plain versions on the
card, and the scan that keeps JAX out of the port.

This file imports neither JAX nor the JAX package, so it also runs where
they are absent (the card's machine):

    python -m pytest tests/test_torch_port_gpu.py -q -m gpu --noconftest -p no:cacheprovider

The `gpu` tests decide inside the test whether a card exists and skip
without one. Tolerances as in chip_smoke.py, scaled by max|plain|: f32 2e-4
(f32 sums in another order; cuDNN with TF32 off), bf16 2^-6 (c1, c2 and c3
rounded to bf16 at the same points from sums in another order: 2 to 4 bf16
ulps at the largest output).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from driving_dirty_tpu_torch.kernels import trunk as K

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -6}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 17, 35, 3), (1, 64, 306, 3), (2, 256, 1836, 3)])
def test_trunk_kernel_matches_plain_on_gpu(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda().to(getattr(torch, dtype))
    wshapes = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]
    ws = [torch.from_numpy((rng.randn(*s) * 0.2).astype(np.float32)).cuda() for s in wshapes]
    launches = K.trunk.launches
    got = K.trunk(x, *ws)
    ref = K.trunk_plain(x, *ws)
    torch.cuda.synchronize()
    assert K.trunk.launches == launches + 1
    assert got.shape == ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item()


@pytest.mark.gpu
def test_trunk_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ws = [torch.zeros(s, device="cuda") for s in
          [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]]
    with pytest.raises(TypeError):
        K.trunk(torch.zeros(1, 8, 8, 3, device="cuda", dtype=torch.float16), *ws)
    with pytest.raises(ValueError):
        K.trunk(torch.zeros(1, 8, 8, 4, device="cuda"), *ws)
    with pytest.raises(ValueError):
        K.trunk(torch.zeros(1, 8, 16, 3, device="cuda")[:, :, ::2], *ws)
    with pytest.raises(NotImplementedError):
        K.trunk(torch.zeros(1, 8, 8, 3, device="cuda", requires_grad=True), *ws)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "driving_dirty_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "driving_dirty_tpu", "flax", "optax"), (path, name)

"""Precision 8 in driving_dirty_tpu_torch (models/precision.py:Int8TrunkMixin
and every task that mixes it in) against the JAX package, on the CPU.

The mixin's semantics: an uncalibrated eval call runs the bf16 trunk, so it
equals precision 16 exactly, and prints its message once per class;
calibration happens once and sticks; training never runs int8 (its loss
equals precision 16's, bit for bit, on the same dropout draws) and
gradients flow. Then `predict` at precision 8 of MultiTask and
BBSpatialRoadMap (small geometry) against the JAX task at precision 8, on
shared weights, each calibrating on the same batch: scales within 1e-6
relative (tests/test_torch_port_quant.py), and the outputs to the bars of
precision 16 in tests/test_torch_port_models.py and
test_torch_port_boxmodels.py, since past the int8 trunk (c3 bit-equal in
>= 99.9% of elements) both run bf16 layers whose sums go in another order:
roadmap masks in > 99% agreement, box probabilities within 2^-5.
RoadMapBCEv2 and FasterRCNNRoadMap: tests/test_torch_port_precision8_tasks.py;
the CLIs: tests/test_torch_port_precision8_cli.py.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.models import roadmap as JR
from driving_dirty_tpu_torch.checkpoints.convert import from_jax, load_jax_weights
from driving_dirty_tpu_torch.models import basic_ae as B
from driving_dirty_tpu_torch.models import roadmap as R
from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin
from driving_dirty_tpu_torch.nn import autoencoder as AE
from test_torch_port_boxmodels import SMALL, _jax, _jax_init, _torch
from test_torch_port_boxmodels import _batch as box_batch
from test_torch_port_boxmodels import PAIRS as BOX_PAIRS

KEY = jax.random.PRNGKey(0)
H, W = 16, 4  # per view: the panorama is 16 x 24
TINY = dict(ae_hidden_dim=8, ae_latent_dim=6, ae_input_height=H, ae_input_width=6 * W,
            pretrained_path=None, batch_size=2)
MESSAGE = "--precision 8 without calibrated scales"


def _images(seed, h=H, w=W):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (2, 6, h, w, 3)).astype(np.uint8))


def _roadmap(precision, seed=0):
    return R.RoadMapBCEv2(dict(TINY, precision=precision), device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def test_uncalibrated_eval_runs_bf16_and_warns_once_per_class(capsys):
    R.RoadMapBCEv2._warned_uncalibrated = False
    B.BasicAE._warned_uncalibrated = False
    m8, m16 = _roadmap(8), _roadmap(16)
    m16.load_state_dict(m8.state_dict())
    images = _images(0)
    with torch.no_grad():
        logits8 = [m8.eval()(images)[0] for _ in range(2)]
        logits16, _ = m16.eval()(images)
        _roadmap(8, seed=1).eval()(images)  # another instance of the class: no new message
    assert torch.equal(logits8[0], logits16) and torch.equal(logits8[1], logits16)
    assert m8._int8_scales is None
    out = capsys.readouterr().out
    assert out.count(MESSAGE) == 1 and "[roadmap_bce]" in out
    # another class prints its own message, once: BasicAE is never calibrated
    ae = B.BasicAE(dict(hidden_dim=8, latent_dim=6, input_height=16, input_width=1836,
                        output_height=16, output_width=306, precision=8), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(2):
            ae.loss(_images(1, 16, 306), train=False, view=2)
    out = capsys.readouterr().out
    assert out.count(MESSAGE) == 1 and "[basic_ae]" in out


def test_calibration_happens_once_and_sticks(monkeypatch):
    calls = []
    int8 = AE.trunk_int8

    def spy(x, *params):
        calls.append(params[-1])
        return int8(x, *params)

    monkeypatch.setattr(AE, "trunk_int8", spy)
    model = _roadmap(8)
    before = Int8TrunkMixin.calibrations
    first = model.predict(_images(2))
    scales = model._int8_scales
    assert Int8TrunkMixin.calibrations == before + 1 and len(scales) == 3
    model.predict(_images(3))
    model.calibrate_int8(_images(4))
    assert model._int8_scales == scales and Int8TrunkMixin.calibrations == before + 1
    assert calls == [scales, scales]
    assert torch.equal(model.predict(_images(2)), first)
    for p in (16, 32):  # below precision 8 nothing calibrates
        m = _roadmap(p)
        m.predict(_images(2))
        assert m._int8_scales is None and Int8TrunkMixin.calibrations == before + 1


def test_training_never_runs_int8_and_gradients_flow(monkeypatch):
    """The port's tests/test_quant.py:test_precision8_training_stays_float."""
    m8, m16 = _roadmap(8), _roadmap(16)
    m16.load_state_dict(m8.state_dict())
    m8.predict(_images(5))  # calibrated: eval calls would run int8

    def refuse(*a, **k):
        raise AssertionError("a training step reached the int8 trunk")

    monkeypatch.setattr(AE, "trunk_int8", refuse)
    batch = {"images": _images(6), "road": torch.from_numpy(
        (np.random.RandomState(7).rand(2, 800, 800) > 0.5).astype(np.float32))}
    loss8, _ = m8.loss(batch, train=True, generator=torch.Generator().manual_seed(3))
    loss16, _ = m16.loss(batch, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(loss8, loss16)
    loss8.backward()
    grads = [p.grad for n, p in m8.named_parameters() if n.startswith("encoder.c")]
    assert len(grads) == 6 and all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(g.abs().sum().item() for g in grads) > 0


@pytest.mark.parametrize("name", ["multitask", "spatial_rm"])
def test_box_family_predict_matches_jax(name):
    hparams = dict(SMALL, precision=8)
    jtask, params, state = _jax_init(name, hparams, spread=False)
    port = BOX_PAIRS[name][1](hparams, device="cpu")
    load_jax_weights(port, params, state)
    batch = box_batch(name, seed=10)
    jb, tb = _jax(batch), _torch(batch)
    if name == "multitask":
        ref = jtask.predict(params, state, jb["images"])
        got = port.predict(tb["images"])
        probs, probs_ref = got["box_occupancy"], ref["box_occupancy"]
        assert (got["road_mask"].numpy() == np.asarray(ref["road_mask"])).mean() > 0.99
    else:
        probs_ref = jtask.predict(params, state, jb["images"], jb["road"])
        probs = port.predict(tb["images"], tb["road"])
    np.testing.assert_allclose(port._int8_scales, jtask._int8_scales, rtol=1e-6)
    assert probs.dtype == torch.float32 and probs.shape == (2, port.raster_size, port.raster_size)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), rtol=0, atol=2.0 ** -5)

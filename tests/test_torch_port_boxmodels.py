"""The port's box-occupancy family (models/spatial_bb.py: spatial_bb and
spatial_rm; models/multitask.py) and its checkpoint entry
(export.load_task_ckpt) against the JAX package on the CPU, at the "small"
geometry (64x78 views, 148/152-px rasters) with a tiny autoencoder.

JAX initializes; checkpoints/convert.py carries the weights across; the
same numpy batch (uint8 views, seeded box scenes from data/boxes.py, a
road map) goes through both in eval mode. The last upsampling stage's
weights are scaled by 60 on both sides so that the probabilities spread
over (0, 1) instead of sitting near 0.5, and the rounded prediction that
val_ts_boxes scores is decided: the test asserts that no JAX probability
lies within 1e-5 of 0.5, 20x the largest difference seen between the two.
Tolerances: f32 rtol 1e-3 / atol 1e-4 (as tests/test_torch_port_models.py);
box targets exactly equal; precision 16 (unscaled weights) against the
JAX package's bf16 within 2^-5 absolute on probabilities and relative to
max|logits| on the roadmap logits, and losses within 2% (activations
rounded to bf16 at the same layers, from sums taken in another order).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.checkpoints import io as jax_io
from driving_dirty_tpu.data.dataset import scene_split as jax_scene_split
from driving_dirty_tpu.data.synthetic import generate
from driving_dirty_tpu.export import _load_task_ckpt as jax_load_task_ckpt
from driving_dirty_tpu.models import multitask as JMT
from driving_dirty_tpu.models import spatial_bb as JSB
from driving_dirty_tpu.models.basic_ae import BasicAE as JBasicAE
from driving_dirty_tpu_torch import export
from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.data.dataset import scene_split
from driving_dirty_tpu_torch.models import multitask as MT
from driving_dirty_tpu_torch.models import spatial_bb as SB

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-3, atol=1e-4)
ROUND_TOL = 1e-5  # 20x the largest probability difference seen between the two (5e-7)
SMALL = dict(ae_hidden_dim=8, ae_latent_dim=6, ae_input_height=64, ae_input_width=6 * 78,
             pretrained_path=None, batch_size=2, spatial_geometry="small")
PAIRS = {"spatial_bb": (JSB.BBSpatialModel, SB.BBSpatialModel),
         "spatial_rm": (JSB.BBSpatialRoadMap, SB.BBSpatialRoadMap),
         "multitask": (JMT.MultiTask, MT.MultiTask)}


def _jax_init(name, hparams, spread=True):
    jtask = PAIRS[name][0](hparams)
    params, state = jtask.init(KEY)
    rng = np.random.RandomState(2)
    # non-trivial BN running stats, and spread-out box probabilities
    state = jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape) + 0.5, jnp.float32), state)
    if spread:
        merge = params["box_merge"]
        last = f"up_conv_{sum(k.startswith('up_conv_') for k in merge)}"
        merge[last] = {"w": merge[last]["w"] * 60, "b": merge[last]["b"]}
    return jtask, params, state


def _pair(name, precision=32, spread=True):
    hparams = dict(SMALL, precision=precision)
    jtask, params, state = _jax_init(name, hparams, spread)
    port = PAIRS[name][1](hparams, device="cpu")
    load_jax_weights(port, params, state)
    return jtask, params, state, port


def _batch(name, seed=3):
    rng = np.random.RandomState(seed)
    road_size = 152 if name == "spatial_rm" else 800  # the small geometry's rm branch
    boxes, valid = box_scenes(seed, batch=2, max_bb=100)
    return {"images": rng.randint(0, 256, (2, 6, 64, 78, 3)).astype(np.uint8),
            "road": (rng.rand(2, road_size, road_size) > 0.5).astype(np.float32),
            "boxes": boxes, "box_valid": valid}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jax_outputs(name, jtask, params, state, jb):
    """-> (box probs, roadmap logits or None, predict output) of the JAX task."""
    if name == "multitask":
        rm, probs, _ = jtask.forward(params, state, jb["images"], train=False, rng=KEY)
        return probs, rm, jtask.predict(params, state, jb["images"])
    road = jb["road"] if jtask.uses_roadmap else None
    probs, _ = jtask.forward(params, state, jb["images"], road, train=False, rng=KEY)
    return probs, None, jtask.predict(params, state, jb["images"], road)


def _port_outputs(name, port, tb):
    with torch.no_grad():
        port.eval()
        if name == "multitask":
            rm, probs = port(tb["images"])
            return probs, rm, port.predict(tb["images"])
        road = tb["road"] if port.uses_roadmap else None
        return port(tb["images"], road), None, port.predict(tb["images"], road)


@pytest.mark.parametrize("name", list(PAIRS))
def test_forward_predict_loss_and_val_metrics_match_jax(name):
    jtask, params, state, port = _pair(name)
    batch = _batch(name)
    jb, tb = _jax(batch), _torch(batch)

    probs_ref, rm_ref, pred_ref = _jax_outputs(name, jtask, params, state, jb)
    probs, rm, pred = _port_outputs(name, port, tb)
    size = port.raster_size
    assert probs.dtype == torch.float32 and tuple(probs.shape) == (2, size, size)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), **TOL)
    assert np.abs(np.asarray(probs_ref) - 0.5).min() > ROUND_TOL  # rounding is decided
    if name == "multitask":
        np.testing.assert_allclose(rm.numpy(), np.asarray(rm_ref), **TOL)
        assert set(pred) == set(pred_ref) == {"road_mask", "box_occupancy"}
        sure = np.abs(np.asarray(rm_ref)) > TOL["atol"]
        assert np.array_equal(pred["road_mask"].numpy()[sure], np.asarray(pred_ref["road_mask"])[sure])
        np.testing.assert_allclose(pred["box_occupancy"].numpy(), np.asarray(pred_ref["box_occupancy"]),
                                   **TOL)
    else:
        np.testing.assert_allclose(pred.numpy(), np.asarray(pred_ref), **TOL)

    targets = port._box_targets(tb) if name == "multitask" else port._targets(tb)
    targets_ref = jtask._box_targets(jb) if name == "multitask" else jtask._targets(jb)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(targets_ref))
    assert targets.sum() > 0

    m_ref = jtask.val_metrics(params, state, jb, KEY)
    m = port.val_metrics(tb)
    assert set(m) == set(m_ref)
    for k in m_ref:
        np.testing.assert_allclose(m[k].item(), float(m_ref[k]), **TOL, err_msg=k)
    assert 0.0 < m["val_ts_boxes"].item() < 1.0

    loss, extra = port.loss(tb, train=False)
    loss_ref, (_, extra_ref) = jtask.loss(params, state, jb, KEY, train=False)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)
    assert set(extra) == set(extra_ref)
    for k in extra_ref:
        np.testing.assert_allclose(extra[k].item(), float(extra_ref[k]), **TOL, err_msg=k)


def test_precision16_matches_jax_bf16():
    # multitask runs every bf16 layer of the family (encoder, roadmap head,
    # spatial box head). Unscaled weights: probabilities that bf16 rounds to
    # 1.0 would meet the BCE clamp at 1 - 1e-7 and make the loss hinge on
    # single roundings.
    name = "multitask"
    jtask, params, state, port = _pair(name, precision=16, spread=False)
    batch = _batch(name, seed=4)
    jb, tb = _jax(batch), _torch(batch)
    probs_ref, rm_ref, _ = _jax_outputs(name, jtask, params, state, jb)
    probs, rm, _ = _port_outputs(name, port, tb)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), rtol=0, atol=2.0 ** -5)
    ref = np.asarray(rm_ref)
    np.testing.assert_allclose(rm.numpy(), ref, rtol=0, atol=2.0 ** -5 * np.abs(ref).max())
    m_ref = jtask.val_metrics(params, state, jb, KEY)
    m = port.val_metrics(tb)
    for k in m_ref:
        if "loss" in k:
            np.testing.assert_allclose(m[k].item(), float(m_ref[k]), rtol=0.02, err_msg=k)


def test_c3_only_backbone_holds_no_dense_weights():
    port = SB.BBSpatialModel(SMALL, device="cpu")
    assert {k.split(".")[1] for k in port.state_dict() if k.startswith("encoder.")} == {"c1", "c2", "c3"}
    with pytest.raises(ValueError):
        port.encoder(torch.zeros(1, 64, 468, 3))
    jparams, _ = JSB.BBSpatialModel(SMALL).init(KEY)
    assert set(jparams["encoder"]) == {"c1", "c2", "c3"}


@pytest.mark.parametrize("name", ["spatial_bb", "multitask"])
def test_pretrained_encoder_loads_into_both_backbones(name, tmp_path):
    """A JAX BasicAE checkpoint as `pretrained_path`: the c3-only backbone
    takes its trunk, the full backbone its whole encoder, bit for bit."""
    ae_h = dict(hidden_dim=8, latent_dim=6, input_height=64, input_width=6 * 78, batch_size=2)
    params, state = JBasicAE(ae_h).init(KEY)
    path = str(tmp_path / "ae.ckpt")
    jax_io.save(path, params=params, state=state, hparams=ae_h, meta={"task": "basic_ae"})
    port = PAIRS[name][1](dict(SMALL, pretrained_path=path), device="cpu")
    enc = port.encoder.state_dict()
    assert np.array_equal(enc["c2.weight"].numpy(),
                          np.asarray(params["encoder"]["c2"]["w"]).transpose(3, 2, 0, 1))
    if name == "multitask":
        assert np.array_equal(enc["fc1.bn.running_var"].numpy(),
                              np.asarray(state["encoder"]["fc1"]["bn"]["var"]))
    else:
        assert {k.split(".")[0] for k in enc} == {"c1", "c2", "c3"}


def test_load_task_ckpt_end_to_end_matches_jax(tmp_path):
    """A JAX-written multitask checkpoint and one npz batch: the port loads
    it with load_task_ckpt(device="cpu") and agrees with the JAX task; the
    port's own writer gives a checkpoint that the JAX package restores to
    the same outputs."""
    hparams = dict(SMALL)
    jtask, params, state = _jax_init("multitask", hparams)
    ckpt = tmp_path / "multitask.ckpt"
    jax_io.save(str(ckpt), params=params, state=state, hparams=hparams, meta={"task": "multitask"})
    np.savez(tmp_path / "batch.npz", **_batch("multitask", seed=6))
    with np.load(tmp_path / "batch.npz") as z:
        batch = {k: z[k] for k in z.files}
    jb, tb = _jax(batch), _torch(batch)

    port = export.load_task_ckpt(str(ckpt), device="cpu")
    assert isinstance(port, MT.MultiTask) and not port.training
    assert not any(p.requires_grad for p in port.parameters())
    pred = port.predict(tb["images"])
    pred_ref = jtask.predict(params, state, jb["images"])
    np.testing.assert_allclose(pred["box_occupancy"].numpy(), np.asarray(pred_ref["box_occupancy"]),
                               **TOL)
    assert (pred["road_mask"].numpy() == np.asarray(pred_ref["road_mask"])).mean() > 0.999
    m, m_ref = port.val_metrics(tb), jtask.val_metrics(params, state, jb, KEY)
    for k in m_ref:
        np.testing.assert_allclose(m[k].item(), float(m_ref[k]), **TOL, err_msg=k)

    written = tmp_path / "port.ckpt"
    export.save_task_ckpt(str(written), port)
    jtask2, params2, state2 = jax_load_task_ckpt(str(written), None, {"multitask": JMT.MultiTask})
    again = jtask2.predict(params2, state2, jb["images"])
    np.testing.assert_array_equal(np.asarray(again["box_occupancy"]),
                                  np.asarray(pred_ref["box_occupancy"]))

    with pytest.raises(ValueError, match="not one of"):
        export.load_task_ckpt(str(ckpt), classes={"spatial_bb": SB.BBSpatialModel}, device="cpu")
    p8 = export.load_task_ckpt(str(ckpt), precision=8, device="cpu")
    assert isinstance(p8, MT.MultiTask) and p8.int8_trunk and p8._int8_scales is None
    pred8 = p8.predict(tb["images"])  # calibrates on this batch, then int8
    assert p8._int8_scales is not None and pred8["road_mask"].shape == pred["road_mask"].shape
    assert (pred8["road_mask"] == pred["road_mask"]).float().mean() > 0.99
    assert torch.isfinite(pred8["box_occupancy"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export.load_task_ckpt(str(ckpt))


def test_labeled_loaders_match_jax(tmp_path):
    """scene_split and the LabeledDataMixin loaders: the same scenes, and
    the same first val batch, as the JAX package's."""
    for seed in (0, 20200505):
        for got, ref in zip(scene_split(np.arange(106, 134), seed=seed),
                            jax_scene_split(np.arange(106, 134), seed=seed)):
            np.testing.assert_array_equal(got, ref)
    data = str(tmp_path / "data")
    generate(data, scenes=1, samples=2, labeled_scenes=5, seed=0)
    hparams = dict(SMALL, link=data, samples_per_scene=2, num_labeled_scenes=5, num_workers=2)
    port = SB.BBSpatialModel(hparams, device="cpu")
    jtask = JSB.BBSpatialModel(hparams)
    (ptr, pva), (jtr, jva) = port._labeled_datasets(), jtask._labeled_datasets()
    np.testing.assert_array_equal(ptr.scene_index, jtr.scene_index)
    np.testing.assert_array_equal(pva.scene_index, jva.scene_index)
    (pb, pmask), = list(port.val_loader())[:1]
    (jb, jmask), = list(jtask.val_loader())[:1]
    np.testing.assert_array_equal(pmask, jmask)
    for k in ("images", "boxes", "box_valid", "road"):
        np.testing.assert_array_equal(pb[k], np.asarray(jb[k]), err_msg=k)
    assert len(port.train_loader()) == len(jtask.train_loader())
    # cache_dir: the decode-once sample cache, in the JAX package's layout
    cached = dict(hparams, cache_dir=str(tmp_path / "cache"))
    for a, b in zip(SB.BBSpatialModel(cached, device="cpu")._labeled_datasets(),
                    JSB.BBSpatialModel(cached)._labeled_datasets()):
        assert type(a).__name__ == type(b).__name__ == "SampleCache" and a.dir == b.dir
        for k, v in b.dataset[0].items():
            np.testing.assert_array_equal(a[0][k], v, err_msg=k)

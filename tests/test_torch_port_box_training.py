"""Box-family training in driving_dirty_tpu_torch against the JAX package,
on the CPU: spatial_bb, spatial_rm, multitask and bb_mlp (models/
spatial_bb.py, models/multitask.py, models/bb_mlp.py).

Small shapes: the "small" spatial geometry (64 x 78 views, 148/152-px
rasters), AE hidden 16, latent 8, batch 4, max_bb 100 seeded box scenes
(data/boxes.py). JAX initializes; checkpoints/convert.py carries the
weights across; the same numpy batch goes to both. Random draws never
match across frameworks, so dropout is off on both sides (drop_p = 0)
wherever values are compared. Tolerances:

- freeze masks, parameter layouts and box targets: exact;
- one f32 loss (train or eval mode): rtol 1e-4 (XLA and ATen sum the
  convolutions and the 59904-wide fc1 in other orders, a few 1e-6
  relative);
- gradients against jax.value_and_grad(task.loss), per parameter, relative
  L2 error: GRAD_TOL 1e-3 where no BatchNorm lies on the way, which covers
  the c3-only spatial tasks whole (measured within 6.4e-6) and multitask's
  box head; BN_GRAD_TOL 2.9e-2 for what a training-mode BatchNorm's output
  reaches in multitask and bb_mlp: the encoder once it trains, and the
  latent heads (rm_head, fc1, fc2) in either mode. At batch 4 BatchNorm's
  batch statistics, and in the backward g - mean(g) - xhat mean(g xhat),
  lose digits that XLA and ATen lose differently
  (tests/test_torch_port_training.py measured up to 2.9e-2 at batch 4 for
  BasicAE; here the worst is rm_head's bias at 6.1e-4). The biases ahead
  of a training-mode BatchNorm (encoder fc1.fc.b, fc2.fc.b) have a true
  gradient of 0: both sides' values must lie within 1e-6 of the global
  gradient norm. A frozen parameter has no gradient in the port and a zero
  one in JAX (the JAX trainer's stop_gradient). The multitask and bb_mlp
  cases are in tests/test_torch_port_box_latent.py.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.models import bb_mlp as JBB
from driving_dirty_tpu.models import multitask as JMT
from driving_dirty_tpu.models import spatial_bb as JSB
from driving_dirty_tpu_torch.checkpoints.convert import host_array, load_jax_weights, param_layouts
from driving_dirty_tpu_torch.data.boxes import box_scenes
from driving_dirty_tpu_torch.models import bb_mlp as BB
from driving_dirty_tpu_torch.models import multitask as MT
from driving_dirty_tpu_torch.models import spatial_bb as SB
from driving_dirty_tpu_torch.nn.autoencoder import DenseBlock
from driving_dirty_tpu_torch.train.trainer import Trainer

KEY = jax.random.PRNGKey(0)
B = 4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
BN_GRAD_TOL = 2.9e-2
NOISE = ("encoder/fc1/fc/b", "encoder/fc2/fc/b")  # ahead of a training-mode BatchNorm
BN_TASKS = ("multitask", "bb_mlp")  # their encoder holds the DenseBlocks' BatchNorm
BN_DOWNSTREAM = ("encoder/", "rm_head/", "fc1/", "fc2/")  # what the latent's gradients reach
SMALL = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78,
             pretrained_path=None, batch_size=B, spatial_geometry="small")
PAIRS = {"spatial_bb": (JSB.BBSpatialModel, SB.BBSpatialModel),
         "spatial_rm": (JSB.BBSpatialRoadMap, SB.BBSpatialRoadMap),
         "multitask": (JMT.MultiTask, MT.MultiTask),
         "bb_mlp": (JBB.Boxes, BB.Boxes)}


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, DenseBlock):
            m.drop_p = 0.0
    return module


def _pair(name, **h):
    """(JAX task with dropout off, params, state, port model with the same
    weights and dropout off)."""
    hparams = dict(SMALL, **h)
    jtask = PAIRS[name][0](hparams)
    jtask.ae.encoder = dataclasses.replace(jtask.ae.encoder, drop_p=0.0)
    params, state = jtask.init(KEY)
    port = _no_dropout(PAIRS[name][1](hparams, device="cpu"))
    load_jax_weights(port, params, state)
    return jtask, params, state, port


def _batch(name, seed=3):
    rng = np.random.RandomState(seed)
    road = 152 if name == "spatial_rm" else 800  # the small geometry's road-map branch
    boxes, valid = box_scenes(seed, batch=B, max_bb=100)
    return {"images": rng.randint(0, 256, (B, 6, 64, 78, 3)).astype(np.uint8),
            "road": (rng.rand(B, road, road) > 0.5).astype(np.float32),
            "boxes": boxes, "box_valid": valid}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jax_path(path):
    return "/".join(getattr(k, "key", str(k)) for k in path)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    n = np.linalg.norm(ref)
    return np.linalg.norm(got - ref) / n if n else float(np.abs(got).max())


@pytest.mark.parametrize("name", list(PAIRS))
def test_freeze_mask_matches_jax_with_the_or_20_quirk(name):
    for h, unfreeze in (({}, 20), ({"unfreeze_epoch_no": 0}, 20), ({"unfreeze_epoch_no": 5}, 5)):
        jtask = PAIRS[name][0](dict(SMALL, **h))
        port = PAIRS[name][1](dict(SMALL, **h), device="cpu")
        assert port.unfreeze_epoch_no == jtask.unfreeze_epoch_no == unfreeze
        params, _ = jtask.init(KEY)
        for epoch in (0, 4, 5, 19, 20):
            ref, got = jtask.freeze_mask(params, epoch), port.freeze_mask(epoch)
            assert (got is None) == (ref is None) == (epoch >= unfreeze), (h, epoch)
            if got is None:
                continue
            flat = dict((_jax_path(p), m) for p, m in jax.tree_util.tree_flatten_with_path(ref)[0])
            layouts = param_layouts(port)
            assert len(flat) == len(layouts) == len(got)
            for (pname, _), (jpath, trainable) in zip(layouts, flat.items()):
                assert got[pname] == trainable == (not jpath.startswith("encoder/")), (pname, jpath)


@pytest.mark.parametrize("name", list(PAIRS))
def test_param_layouts_follow_the_jax_leaf_order(name):
    """The optimizer leaves of a checkpoint follow jax.tree.leaves of the
    params: param_layouts must name the same leaves in the same order, and
    its permutations must give the JAX shapes."""
    jtask, params, _, port = _pair(name)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    named = dict(port.named_parameters())
    layouts = param_layouts(port)
    assert len(layouts) == len(leaves)
    for (pname, perm), (path, leaf) in zip(layouts, leaves):
        jpath = _jax_path(path)
        assert pname.split(".")[:-1] == jpath.split("/")[:-1], (pname, jpath)
        np.testing.assert_array_equal(host_array(named[pname], perm), np.asarray(leaf), err_msg=jpath)


def check_loss_and_gradients(name, frozen):
    """One training-mode loss and its gradients, the port's against
    jax.value_and_grad of the JAX task's loss as the JAX trainer takes it
    (frozen leaves under stop_gradient), at epoch 0 (frozen) or 1.
    -> {JAX path: relative L2 error of its gradient}."""
    jtask, params, state, port = _pair(name, unfreeze_epoch_no=1)
    batch = _batch(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    epoch = 0 if frozen else 1
    mask = jtask.freeze_mask(params, epoch)

    def loss_fn(p):
        if mask is not None:
            p = jax.tree.map(lambda leaf, m: leaf if m else jax.lax.stop_gradient(leaf), p, mask)
        loss, (_, metrics) = jtask.loss(p, state, jb, KEY, train=True)
        return loss, metrics

    (ref, ref_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert (port.apply_freeze_mask(epoch) is None) == (mask is None)
    loss, metrics = port.loss(_torch(batch), train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=LOSS_RTOL)
    assert set(metrics) == set(ref_metrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]), rtol=LOSS_RTOL, err_msg=k)

    named = dict(port.named_parameters())
    jleaves = jax.tree_util.tree_flatten_with_path(grads)[0]
    norm = np.sqrt(sum(float(jnp.sum(g ** 2)) for _, g in jleaves))
    errs = {}
    for (pname, perm), (path, jg) in zip(param_layouts(port), jleaves):
        jpath, p = _jax_path(path), named[pname]
        if not p.requires_grad:
            assert frozen and jpath.startswith("encoder/") and p.grad is None, jpath
            assert not np.asarray(jg).any(), jpath
            continue
        got = host_array(p.grad, perm)
        if jpath in NOISE:
            assert max(np.abs(got).max(), np.abs(np.asarray(jg)).max()) <= 1e-6 * norm, jpath
            continue
        errs[jpath] = _rel_l2(got, jg)
        tol = BN_GRAD_TOL if name in BN_TASKS and jpath.startswith(BN_DOWNSTREAM) else GRAD_TOL
        assert errs[jpath] <= tol, (jpath, errs[jpath])
    trained = {n for n, p in named.items() if p.requires_grad}
    assert all(n.startswith("encoder.") for n in set(named) - trained)
    assert frozen == (len(trained) < len(named))
    return errs


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("name", ["spatial_bb", "spatial_rm"])
def test_loss_and_gradients_match_jax_value_and_grad(name, frozen):
    check_loss_and_gradients(name, frozen)


def test_multitask_dropout_draws_from_the_step_generator():
    """The encoder's dropout follows the generator handed to `loss` and
    nothing else: torch's global seed does not move the loss, the
    generator's seed does."""
    model = MT.MultiTask(SMALL, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = _torch(_batch("multitask"))

    def loss(global_seed, gen_seed):
        torch.manual_seed(global_seed)
        with torch.no_grad():
            return model.loss(batch, train=True, generator=torch.Generator().manual_seed(gen_seed))[0].item()

    assert loss(1, 7) == loss(2, 7)
    assert loss(1, 7) != loss(1, 8)


@pytest.mark.parametrize("name", ["spatial_bb", "bb_mlp"])
def test_trainer_fit_trains_a_box_task(name, tmp_path, monkeypatch):
    """Trainer.fit takes a box task through training steps, validation, image
    logging and its checkpoint (`loss` and `val_metrics` take the step
    generator); the encoder stays bit-identical while frozen."""
    monkeypatch.setenv("DD_NO_TB", "1")
    monkeypatch.setenv("DD_NO_COST_ANALYSIS", "1")
    model = PAIRS[name][1](dict(SMALL, output_img_freq=1), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    data = [(_batch(name, seed=s), np.ones(B, bool)) for s in (1, 2)]
    model.train_loader = lambda: data
    model.val_loader = lambda: data[:1]
    encoder = {k: v.clone() for k, v in model.encoder.state_dict().items() if "running" not in k}
    logged = []
    log_images = model.log_images

    def spy(batch, step_name, generator=None):
        out = log_images(batch, step_name, generator=generator)
        logged.append({k: tuple(v.shape) for k, v in out.items()})
        return out

    model.log_images = spy
    fit = Trainer(max_epochs=1, default_root_dir=str(tmp_path), log_every_n_steps=1,
                  enable_progress_bar=False, device="cpu").fit(model)
    assert np.isfinite(fit.best_val_loss) and fit.last_ckpt_path
    after = model.encoder.state_dict()
    assert all(torch.equal(after[k], v) for k, v in encoder.items())
    if name == "bb_mlp":  # no image logging, as in the JAX package
        assert logged == [{}, {}]
        return
    size = model.raster_size
    assert logged == [{"train_input_images": (64, 6 * 78, 3), "train_target_bbs": (size, size, 1),
                       "train_pred_bbs": (size, size, 1)}] * 2

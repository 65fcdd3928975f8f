"""Main-path training in driving_dirty_tpu_torch against the JAX package, on
the CPU: the six-to-one task, the Decoder, UnlabeledDataset, BasicAE's
loss, gradients and Adam trajectory, and the weight converter on a whole
BasicAE. The roadmap fine-tune over a frozen encoder is in
tests/test_torch_port_finetune.py.

Small shapes: 32 x 306 views (a 32 x 1836 panorama; BasicAE masks 306-wide
view columns in both packages), hidden 16, latent 8.
JAX initializes; checkpoints/convert.py carries the weights across; the
same numpy inputs go to both. Random draws never match across frameworks,
so the masked view is computed from the JAX key and handed to the port
(`view=`), and dropout is off on both sides (drop_p = 0) wherever values
are compared. Tolerances:

- data movement (six_to_one_task, the dataset) is exact;
- one f32 forward, loss or BatchNorm state: rtol 1e-4 of the largest value
  (XLA and ATen sum the 58752-wide fc1 and the conv reductions in other
  orders, a few 1e-6 relative; a wrong layout or missing term is off by
  order 1);
- gradients at batch 16, per parameter: relative L2 error <= 1e-2, plus
  1e-6 of the global gradient norm for the biases ahead of a training-mode
  BatchNorm (their true gradient is 0; what comes out is ~1e-9 of noise).
  BatchNorm's backward in training mode forms g - mean(g) - xhat *
  mean(g * xhat), a difference of nearly equal terms at a small batch (at
  batch 2 it is (1 - xhat^2) = eps / (var + eps) of g), and XLA and ATen
  order it differently; the digits lost there reach every parameter
  upstream. Measured: at most 1.6e-3 at batch 16, 5.5e-3 at batch 8, 2.9e-2
  at batch 4. The gap shrinks with the batch, as that rounding does and a
  wrong gradient (off by order 1 at any batch) would not;
- Adam trajectories: losses rtol 5e-2 over 10 steps. The one-step
  difference is ~1e-6 relative, but Adam amplifies it early on: with
  v_hat ~ 0 the update is sign-like, lr / (sqrt(v) + eps) per weight, so a
  gradient that differs in the last bits can flip a whole +-lr step on
  weights whose gradient is float noise. tests/test_training_dynamics_
  parity.py measured up to 1.7% loss drift over 30 such steps and allows
  5%; a semantic fault (BN update, loss reduction, missing gradient) is
  off by 2x within a few steps;
- the frozen encoder: bit for bit unchanged.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from driving_dirty_tpu.data import dataset as jax_dataset
from driving_dirty_tpu.data.synthetic import generate
from driving_dirty_tpu.models.basic_ae import BasicAE as JBasicAE
from driving_dirty_tpu.models.pretrained import load_pretrained_ae as jax_load_pretrained_ae
from driving_dirty_tpu.nn.autoencoder import Decoder as JDecoder
from driving_dirty_tpu.ops.stitch import six_to_one_task as jax_six_to_one
from driving_dirty_tpu_torch.checkpoints.convert import (load_jax_weights, model_to_jax, to_jax,
                                                         transposed_paths)
from driving_dirty_tpu_torch.data.dataset import UnlabeledDataset
from driving_dirty_tpu_torch.export import save_task_ckpt
from driving_dirty_tpu_torch.models import roadmap as R
from driving_dirty_tpu_torch.models.basic_ae import BasicAE
from driving_dirty_tpu_torch.nn.autoencoder import Decoder, DenseBlock
from driving_dirty_tpu_torch.ops.stitch import six_to_one_task

KEY = jax.random.PRNGKey(0)
RTOL = 1e-4
LR = 1e-3
VIEW_H, VIEW_W = 32, 306
AE = dict(hidden_dim=16, latent_dim=8, input_height=VIEW_H, input_width=6 * VIEW_W,
          output_height=VIEW_H, output_width=VIEW_W, batch_size=2)


def _close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-30), what


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, DenseBlock):
            m.drop_p = 0.0
    return module


def _images(seed, b=2, h=VIEW_H, w=VIEW_W):
    return np.random.RandomState(seed).randint(0, 256, (b, 6, h, w, 3)).astype(np.uint8)


def _mask_index(rng, num_maskable=5):
    """The view JAX's BasicAE.forward masks for this step key."""
    return int(jax.random.randint(jax.random.split(rng, 3)[0], (), 0, num_maskable))


# --- six_to_one_task -------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_six_to_one_task_equals_jax(seed):
    x = np.random.RandomState(seed).rand(2, 6, 8, 5, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    ref_m, ref_y = jax_six_to_one(jnp.asarray(x), key, view_width=5)
    view = int(jax.random.randint(key, (), 0, 5))
    for v in (view, torch.tensor(view)):
        got_m, got_y = six_to_one_task(torch.from_numpy(x), v, view_width=5)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(ref_y))


def test_six_to_one_task_draws_from_the_generator_and_keeps_the_quirk():
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 6, 2, 4, 3).astype(np.float32))
    pano = x[:, [0, 1, 2, 5, 4, 3]].permute(0, 2, 1, 3, 4).reshape(1, 2, 24, 3)
    seen = {}
    for maskable in (5, 6):
        gen = torch.Generator().manual_seed(0)
        views = set()
        for _ in range(60):
            masked, y = six_to_one_task(x, generator=gen, view_width=4, num_maskable=maskable)
            v = int((masked == 0).all(-1).all(1)[0].nonzero()[0]) // 4
            assert torch.equal(y, pano[:, :, 4 * v:4 * v + 4])
            views.add(v)
        seen[maskable] = views
    assert seen[5] == {0, 1, 2, 3, 4} and seen[6] == set(range(6))
    a = six_to_one_task(x, generator=torch.Generator().manual_seed(3), view_width=4)
    b = six_to_one_task(x, generator=torch.Generator().manual_seed(3), view_width=4)
    assert all(torch.equal(s, t) for s, t in zip(a, b))


# --- Decoder -----------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_decoder_equals_jax(train):
    jdec = JDecoder(16, 8, 3, VIEW_H, VIEW_W, drop_p=0.0)
    params, state = jdec.init(KEY)
    rng = np.random.RandomState(1)
    state = jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape) + 0.5, jnp.float32), state)
    dec = Decoder(16, 8, 3, VIEW_H, VIEW_W, drop_p=0.0, device="cpu").train(train)
    load_jax_weights(dec, params, state)
    assert dec.deconv_dims == jdec.deconv_dims == (16, 153)
    assert Decoder(128, 64, device="meta").deconv_dims == (128, 153)
    z = rng.randn(3, 8).astype(np.float32)
    ref, new_state = jdec.apply(params, state, jnp.asarray(z), train=train, rng=KEY)
    with torch.no_grad():
        got = dec(torch.from_numpy(z))
    assert tuple(got.shape) == (3, VIEW_H, VIEW_W, 3)
    _close(got, ref)
    _, got_state = model_to_jax(dec)
    for (name, g), (_, r) in zip(_leaves(got_state), _leaves(new_state)):
        _close(g, r, what=name)


# --- the converter on a whole BasicAE --------------------------------------

def test_whole_basic_ae_round_trips_and_loads_as_a_pretrained_encoder(tmp_path):
    params, state = JBasicAE(AE).init(KEY)
    model = BasicAE(AE, device="cpu")
    assert transposed_paths(model) == {f"decoder.dc{i}" for i in range(1, 5)}
    load_jax_weights(model, params, state)
    back_p, back_s = model_to_jax(model)
    for tree, back in ((params, back_p), (state, back_s)):
        ref, got = dict(_leaves(tree)), dict(_leaves(back))
        assert set(ref) == set(got)
        for name in ref:
            np.testing.assert_array_equal(got[name], np.asarray(ref[name]), err_msg=name)
    # the port's checkpoint feeds both packages' pretrained-encoder path
    ckpt = tmp_path / "basic_ae.ckpt"
    save_task_ckpt(ckpt, model)
    _, jparams, _ = jax_load_pretrained_ae(dict(pretrained_path=str(ckpt)))
    for name, leaf in _leaves(params["encoder"]):
        np.testing.assert_array_equal(dict(_leaves(jparams["encoder"]))[name], np.asarray(leaf))
    rm = R.RoadMapBCEv2(dict(pretrained_path=str(ckpt), batch_size=2), device="cpu")
    assert torch.equal(rm.encoder.fc1.fc.weight, model.encoder.fc1.fc.weight)


# --- UnlabeledDataset ----------------------------------------------------------

@pytest.fixture(scope="module")
def unlabeled_root(tmp_path_factory):
    return str(generate(str(tmp_path_factory.mktemp("unlabeled")), scenes=2, samples=2,
                        labeled_scenes=0))


@pytest.mark.parametrize("first_dim", ["sample", "image"])
@pytest.mark.parametrize("raw", [True, False])
def test_unlabeled_dataset_equals_jax(unlabeled_root, first_dim, raw, monkeypatch):
    monkeypatch.setattr(jax_dataset, "_native", None)  # PIL on both sides
    scenes = np.array([1, 0])
    ref = jax_dataset.UnlabeledDataset(unlabeled_root, scenes, first_dim, samples_per_scene=2,
                                       raw_uint8=raw)
    got = UnlabeledDataset(unlabeled_root, scenes, first_dim, samples_per_scene=2, raw_uint8=raw)
    assert len(got) == len(ref) == (24 if first_dim == "image" else 4)
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        if first_dim == "image":
            assert a[1] == b[1]
            a, b = a[0], b[0]
        assert a.dtype == b.dtype == (np.uint8 if raw else np.float32)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        UnlabeledDataset(unlabeled_root, scenes, "pixel")


def test_basic_ae_datasets_split_scenes_as_jax(unlabeled_root, tmp_path):
    h = dict(AE, link=unlabeled_root, num_unlabeled_scenes=2, samples_per_scene=2, num_workers=1)
    ref = JBasicAE(h)._datasets()
    got = BasicAE(h, device="cpu")._datasets()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.scene_index, b.scene_index)
        assert len(a) == len(b) and a.raw_uint8 and a.first_dim == "sample"
    batch, mask = next(iter(BasicAE(h, device="cpu").train_loader()))
    assert batch.shape == (2, 6, 256, 306, 3) and batch.dtype == np.uint8 and mask.all()
    # cache_dir: the decode-once sample cache, in the JAX package's layout
    h = dict(h, cache_dir=str(tmp_path / "cache"))
    for a, b in zip(BasicAE(h, device="cpu")._datasets(), JBasicAE(h)._datasets()):
        assert type(a).__name__ == type(b).__name__ == "SampleCache" and a.dir == b.dir
        if len(b):  # two scenes: both in the train split
            np.testing.assert_array_equal(a[0], b.dataset[0])


# --- BasicAE loss, gradients, Adam steps ---------------------------------------

def _ae_pair(**hparams):
    jtask = JBasicAE(dict(AE, **hparams))
    jtask.encoder = dataclasses.replace(jtask.encoder, drop_p=0.0)
    jtask.decoder = dataclasses.replace(jtask.decoder, drop_p=0.0)
    params, state = jtask.init(KEY)
    model = _no_dropout(BasicAE(dict(AE, **hparams), device="cpu"))
    load_jax_weights(model, params, state)
    return jtask, params, state, model


def _close_grads(got, ref, rtol=1e-2, floor=1e-6):
    """Per leaf: ||got - ref|| <= rtol * ||ref|| + floor * (global norm)."""
    ref = {k: np.asarray(v) for k, v in _leaves(ref)}
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in ref.values()))
    for name, g in _leaves(got):
        err = np.linalg.norm((np.asarray(g) - ref[name]).ravel())
        assert err <= rtol * np.linalg.norm(ref[name].ravel()) + floor * total, name


def _grads_as_jax(model):
    grads = {n: p.grad for n, p in model.named_parameters()}
    sd = {k: grads.get(k, v) for k, v in model.state_dict().items()}
    return to_jax(sd, transposed=transposed_paths(model))


@pytest.mark.parametrize("mask_all_six", [False, True])
def test_basic_ae_loss_gradients_and_state_equal_jax(mask_all_six):
    jtask, params, state, model = _ae_pair(mask_all_six=mask_all_six)
    images = _images(0, b=16)
    rng = jax.random.PRNGKey(5 if mask_all_six else 1)

    def loss_fn(p):
        return jtask.loss(p, state, images, rng, train=True)

    (ref_loss, (ref_state, _)), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    view = _mask_index(rng, 6 if mask_all_six else 5)
    loss, metrics = model.loss({"images": torch.from_numpy(images)}, train=True, view=view)
    loss.backward()
    assert metrics == {} and loss.dtype == torch.float32
    _close(loss.item(), float(ref_loss))
    got_grads, got_state = _grads_as_jax(model)
    _close_grads(got_grads, ref_grads)
    ref_s = dict(_leaves(ref_state))
    for name, s in _leaves(got_state):
        _close(s, ref_s[name], what=name)


def test_basic_ae_adam_trajectory_tracks_jax():
    jtask, params, state, model = _ae_pair()
    batches = [_images(10 + i) for i in range(2)]
    tx = optax.adam(LR)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(p, s, o, images, rng):
        (loss, (s, _)), g = jax.value_and_grad(
            lambda q: jtask.loss(q, s, images, rng, train=True), has_aux=True)(p)
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), s, o, loss

    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    ref_losses, losses = [], []
    for step in range(10):
        images, rng = batches[step % 2], jax.random.fold_in(KEY, step)
        params, state, opt_state, ref = jax_step(params, state, opt_state, jnp.asarray(images), rng)
        ref_losses.append(float(ref))
        opt.zero_grad()
        loss, _ = model.loss({"images": torch.from_numpy(images)}, train=True,
                             view=_mask_index(rng))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-2)
    assert abs(ref_losses[-1] - ref_losses[0]) > 1e-3 * ref_losses[0]  # it trained


def test_basic_ae_log_images_equal_jax():
    jtask, params, state, model = _ae_pair()
    images, rng = _images(3), jax.random.PRNGKey(9)
    ref = jtask.log_images(params, state, {"images": jnp.asarray(images)}, rng, "val")
    got = model.log_images({"images": torch.from_numpy(images)}, "val", view=_mask_index(rng))
    assert set(got) == set(ref) == {"val_predicted_images", "val_target_images"}
    for k in got:
        assert tuple(got[k].shape) == (VIEW_H, VIEW_W, 3)
        _close(got[k], ref[k], what=k)
    assert not model.training


def test_basic_ae_dropout_draws_from_the_generator():
    model = BasicAE(AE, device="cpu")
    batch = {"images": torch.from_numpy(_images(4))}

    def loss(seed):
        return model.loss(batch, train=True, generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(loss(0), loss(0))
    assert not torch.equal(loss(0), loss(1))

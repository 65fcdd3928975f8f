"""The roadmap fine-tune of driving_dirty_tpu_torch over a frozen
pretrained encoder, against the JAX package on the CPU: `freeze_mask` by
epoch for RoadMap, RoadMapBCE and RoadMapBCEv2, and training steps of
RoadMapBCEv2 with the encoder frozen (the JAX trainer's frozen step:
stop_gradient on the encoder, optax.adam over every parameter; the port:
requires_grad off, torch.optim.Adam over every parameter).

Tiny config (16 x 4 views, AE hidden 8, latent 6), dropout off on both
sides (drop_p = 0), weights carried across by checkpoints/convert.py.
Tolerances: the frozen encoder's parameters bit for bit unchanged; the
losses of 3 steps rtol 1e-3 (one f32 step agrees to ~1e-6; the head's
Adam steps are sign-like at first, and a head weight whose gradient is
float noise can step +-lr the other way, which moves the next loss by far
less than 1e-3); BatchNorm running statistics rtol 1e-4 (they move in
training mode on both sides, frozen or not).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from driving_dirty_tpu.models import roadmap as JR
from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights, model_to_jax
from driving_dirty_tpu_torch.models import roadmap as R
from driving_dirty_tpu_torch.nn.autoencoder import DenseBlock

KEY = jax.random.PRNGKey(0)
LR = 1e-3
RM = dict(ae_hidden_dim=8, ae_latent_dim=6, ae_input_height=16, ae_input_width=24,
          pretrained_path=None, batch_size=2)


def _close(got, ref, rtol, what=""):
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


@pytest.mark.parametrize("name,default", [("RoadMap", 30), ("RoadMapBCE", 30), ("RoadMapBCEv2", 0)])
def test_freeze_mask_follows_the_unfreeze_epoch(name, default):
    for h in (RM, dict(RM, unfreeze_epoch_no=5)):
        jtask = getattr(JR, name)(h)
        model = getattr(R, name)(h, device="cpu")
        assert model.unfreeze_epoch_no == jtask.unfreeze_epoch_no == h.get("unfreeze_epoch_no", default)
        params, _ = jtask.init(KEY)
        for epoch in (0, 4, 5, 29, 30):
            ref, got = jtask.freeze_mask(params, epoch), model.freeze_mask(epoch)
            assert (got is None) == (ref is None)
            if got is not None:
                assert set(got) == {n for n, _ in model.named_parameters()}
                assert all(v == (not n.startswith("encoder.")) for n, v in got.items())


def test_frozen_encoder_roadmap_steps_equal_jax_and_leave_the_encoder_bit_identical():
    h = dict(RM, unfreeze_epoch_no=1)
    jtask = JR.RoadMapBCEv2(h)
    jtask.ae.encoder = dataclasses.replace(jtask.ae.encoder, drop_p=0.0)
    params, state = jtask.init(KEY)
    model = _no_dropout(R.RoadMapBCEv2(h, device="cpu"))
    load_jax_weights(model, params, state)
    mask = model.apply_freeze_mask(0)
    assert mask is not None and jtask.freeze_mask(params, 0) is not None
    assert not any(p.requires_grad for p in model.encoder.parameters())
    assert model.fc1.weight.requires_grad
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.RandomState(7)
    for step in range(3):
        batch = {"images": rng.randint(0, 256, (2, 6, 16, 4, 3)).astype(np.uint8),
                 "road": (rng.rand(2, 800, 800) > 0.5).astype(np.float32)}

        def loss_fn(p):  # the JAX trainer's frozen step: stop_gradient on the encoder
            p = {**p, "encoder": jax.lax.stop_gradient(p["encoder"])}
            return jtask.loss(p, state, batch, KEY, train=True)

        (ref, (state, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()}, train=True)
        loss.backward()
        opt.step()
        _close(loss.item(), float(ref), 1e-3, what=f"step {step}")
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("encoder.") and "running" not in k:
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["fc1.weight"], before["fc1.weight"])
    assert not torch.equal(after["encoder.fc1.bn.running_mean"], before["encoder.fc1.bn.running_mean"])
    _, got_state = model_to_jax(model)
    ref_s = dict(_leaves(state))
    for name, s in _leaves(got_state):
        _close(s, ref_s[name], 1e-4, what=name)

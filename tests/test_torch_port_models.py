"""driving_dirty_tpu_torch's Encoder and roadmap models against the JAX
package on shared weights, on the CPU.

JAX initializes; checkpoints/convert.py carries the weights across; the same
numpy inputs go through both in eval mode. Tolerances: f32 rtol 1e-3 /
atol 1e-4 (the bound tests/test_nn_vs_torch.py uses for these modules:
a 940k-term f32 dot at full size, here the same code at 64x96); masks
must agree wherever |logit| exceeds that tolerance; bf16 (precision 16)
logits within 2^-5 of their scale and masks in >99% agreement (the JAX
package's bar for a lower-precision trunk against the float path).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu.models import roadmap as JR
from driving_dirty_tpu.nn.autoencoder import Encoder as JaxEncoder
from driving_dirty_tpu_torch.checkpoints.convert import from_jax
from driving_dirty_tpu_torch.models import roadmap as R
from driving_dirty_tpu_torch.nn.autoencoder import Encoder

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-3, atol=1e-4)
H, W = 16, 4  # per view: the panorama is 16 x 24
TINY = dict(ae_hidden_dim=8, ae_latent_dim=6, ae_input_height=H, ae_input_width=6 * W,
            pretrained_path=None, batch_size=2)


def _bn_state(state, rng):
    """Non-trivial running stats, so eval-mode BN is exercised."""
    return jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape) + 0.5, jnp.float32), state)


@pytest.fixture(scope="module")
def encoder_pair():
    enc = JaxEncoder(8, 6, 3, 64, 96)
    params, state = enc.init(KEY)
    state = _bn_state(state, np.random.RandomState(0))
    port = Encoder(8, 6, 3, 64, 96, device="cpu").eval()
    port.load_state_dict(from_jax(params, state))
    return enc, params, state, port


def test_encoder_full_c3_only_and_with_c3(encoder_pair):
    enc, params, state, port = encoder_pair
    x = np.random.RandomState(1).rand(2, 64, 96, 3).astype(np.float32)
    z_ref, _ = enc.apply(params, state, jnp.asarray(x), train=False, rng=KEY)
    c3_ref, _ = enc.apply(params, state, jnp.asarray(x), train=False, rng=KEY, c3_only=True)
    with torch.no_grad():
        z = port(torch.from_numpy(x))
        c3 = port(torch.from_numpy(x), c3_only=True)
        z2, c3_2 = port(torch.from_numpy(x), with_c3=True)
    assert tuple(c3.shape) == c3_ref.shape == (2, 32, 48, 32)
    assert port.c3_shape() == enc.c3_shape() and port.conv_out_dim() == enc.conv_out_dim()
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TOL)
    np.testing.assert_allclose(c3.numpy(), np.asarray(c3_ref), **TOL)
    assert torch.equal(z2, z) and torch.equal(c3_2, c3)
    # int8=True without static scales: the dynamic-absmax int8 trunk (CPU
    # tensors only), as the JAX encoder's; c3 bit-equal in >= 99.9% of its
    # elements (tests/test_torch_port_quant.py states the bar)
    c3_ref8, _ = enc.apply(params, state, jnp.asarray(x), train=False, rng=KEY, c3_only=True, int8=True)
    with torch.no_grad():
        c3_8 = port(torch.from_numpy(x), c3_only=True, int8=True)
    assert (c3_8.numpy() == np.asarray(c3_ref8)).mean() >= 0.999
    np.testing.assert_allclose(c3_8.numpy(), np.asarray(c3_ref8), rtol=0,
                               atol=np.abs(np.asarray(c3_ref8)).max() / 127)


def test_encoder_reference_dims():
    enc = Encoder(128, 64, device="meta")
    assert enc.conv_out_dim() == 940032 and enc.c3_shape() == (128, 918)


def _batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (2, 6, H, W, 3)).astype(np.uint8)
    road = (rng.rand(2, 800, 800) > 0.5).astype(np.float32)
    return images, road


def _pair(name, precision=32):
    jtask = getattr(JR, name)(TINY)
    params, state = jtask.init(KEY)
    state = _bn_state(state, np.random.RandomState(2))
    port = getattr(R, name)(dict(TINY, precision=precision), device="cpu")
    port.load_state_dict(from_jax(params, state))
    return jtask, params, state, port


@pytest.mark.parametrize("name", ["RoadMap", "RoadMapBCE", "RoadMapBCEv2"])
def test_roadmap_logits_predict_and_val_metrics(name):
    jtask, params, state, port = _pair(name)
    images, road = _batch(3)
    logits_ref, probs_ref, _ = jtask.forward(params, state, jnp.asarray(images), train=False, rng=KEY)
    mask_ref = jtask.predict(params, state, jnp.asarray(images))
    m_ref = jtask.val_metrics(params, state, {"images": jnp.asarray(images), "road": road}, KEY)

    port.eval()
    with torch.no_grad():
        logits, probs = port(torch.from_numpy(images))
    mask = port.predict(torch.from_numpy(images))
    m = port.val_metrics({"images": torch.from_numpy(images), "road": torch.from_numpy(road)})

    assert logits.dtype == torch.float32 and tuple(mask.shape) == (2, 800, 800)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), **TOL)
    sure = np.abs(np.asarray(logits_ref)) > TOL["atol"]
    assert np.array_equal(mask.numpy()[sure], np.asarray(mask_ref)[sure])
    assert set(m) == set(m_ref)
    for k in m_ref:
        np.testing.assert_allclose(m[k].item(), float(m_ref[k]), **TOL, err_msg=k)

    loss, _ = port.loss({"images": torch.from_numpy(images), "road": torch.from_numpy(road)},
                        train=False)
    loss_ref, _ = jtask.loss(params, state, {"images": jnp.asarray(images), "road": road}, KEY,
                             train=False)
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)


def test_roadmap_precision16_matches_jax_bf16():
    jtask = JR.RoadMapBCEv2(dict(TINY, precision=16))
    params, state = jtask.init(KEY)
    state = _bn_state(state, np.random.RandomState(4))
    port = R.RoadMapBCEv2(dict(TINY, precision=16), device="cpu").eval()
    port.load_state_dict(from_jax(params, state))
    images, _ = _batch(5)
    logits_ref, _, _ = jtask.forward(params, state, jnp.asarray(images), train=False, rng=KEY)
    with torch.no_grad():
        logits, _ = port(torch.from_numpy(images))
    ref = np.asarray(logits_ref)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=2.0 ** -5 * np.abs(ref).max())
    mask = port.predict(torch.from_numpy(images)).numpy()
    assert (mask == (ref > 0)).mean() > 0.99


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.RoadMapBCEv2(TINY)
    m8 = R.RoadMapBCEv2(dict(TINY, precision=8), device="cpu")  # precision 8 is ported
    assert m8.int8_trunk and m8.compute_dtype is torch.bfloat16

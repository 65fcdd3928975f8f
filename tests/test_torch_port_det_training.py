"""Detection training (nn/detection.py: rpn_loss, sample_proposals,
roi_loss, forward_train; models/faster_rcnn.py: loss, step_variant,
freeze_mask, label_offset) against the JAX package on the CPU.

The small config of tests/test_faster_rcnn.py (128-px layout image, 64 x
76 views, 200 pre-NMS and 64 post-NMS proposals, 32 RoI samples, a tiny
autoencoder) with exact top-k on the JAX side (`exact_topk=True`: its
default lax.approx_max_k has no PyTorch twin). JAX initializes;
checkpoints/convert.py carries the weights across; one numpy batch goes
through both. The samplers' noise is the JAX package's own draw for the
step key (`jax_noise` recomputes it from the key as the JAX loss splits
it), handed to the port's loss.

Tolerances at precision 32: the four losses and the total 1e-5 relative,
the parameter gradients 1e-4 relative L2 per leaf (f32 convs, matmuls and
the RoIAlign backward summed in another order; measured <= 2.5e-6); the
sampled rois, targets and masks equal where take holds. At precision 16
the losses within 2^-7 relative and the gradients within 2^-3 relative L2
per leaf: both round activations, logits and gradients to bf16, at other
points (the port's objectness BCE runs in f32, the JAX package's partly in
bf16: measured 2.6e-4 on loss_objectness; bias gradients sum ~1e5 bf16
terms: measured up to 7.9e-2 on mapper_cnn's bias); the RoIAlign backward
itself (the plain version) rounds By, Bx, g and u to bf16 exactly as the
JAX package does (tests/test_torch_port_roialign_grad.py). The goldens
(rpn_loss, roi_loss of tests/goldens/detection_goldens.json) 1e-5
relative.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights, to_jax, transposed_paths
from driving_dirty_tpu_torch.nn import detection as TN

from test_torch_port_faster_rcnn import KEY, PAIRS, TINY, _batch, _jax, _torch

GOLDENS = json.loads((Path(__file__).parent / "goldens" / "detection_goldens.json").read_text())
STEP_KEY = jax.random.PRNGKey(7)
LOSS_RTOL = {32: 1e-5, 16: 2.0 ** -7}
GRAD_RTOL = {32: 1e-4, 16: 2.0 ** -3}
NAMES = ("loss_classifier", "loss_box_reg", "loss_objectness", "loss_rpn_box_reg")


def jax_noise(cfg, key, b, g):
    """The uniform draws of the JAX loss's two samplers for step key `key`
    (models/faster_rcnn.py:loss splits it into backbone and head keys, the
    head into RPN and RoI keys, each into one key an image) -> the port's
    noise dict."""
    _, k_det = jax.random.split(key)
    k_rpn, k_roi = jax.random.split(k_det)
    n = cfg.feat_size ** 2 * cfg.num_anchors_per_cell
    rpn = [np.asarray(jax.random.uniform(k, (n,))) for k in jax.random.split(k_rpn, b)]
    roi = [np.asarray(jax.random.uniform(k, (cfg.rpn_post_nms_top_n + g,))) for k in jax.random.split(k_roi, b)]
    return {"rpn": torch.from_numpy(np.stack(rpn)), "roi": torch.from_numpy(np.stack(roi))}


def _models(name, **extra):
    hparams = dict(TINY, **extra)
    jtask = PAIRS[name][0](hparams)
    params, state = jtask.init(KEY)
    port = PAIRS[name][1](hparams, device="cpu")
    load_jax_weights(port, params, state)
    return jtask, params, state, port


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def _check_step(name, batch, precision=32, **extra):
    """One training step's losses and gradients, JAX's value_and_grad
    against the port's autograd (every parameter trainable)."""
    jtask, params, state, port = _models(name, precision=precision, **extra)

    def loss_fn(p):
        loss, (_, metrics) = jtask.loss(p, state, _jax(batch), STEP_KEY, train=True)
        return loss, metrics

    (ref, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port.apply_freeze_mask(port.unfreeze_epoch_no)
    noise = jax_noise(port.cfg, STEP_KEY, batch["images"].shape[0], batch["boxes"].shape[1])
    loss, metrics = port.loss(_torch(batch), train=True, noise=noise)
    loss.backward()
    rtol = LOSS_RTOL[precision]
    assert set(metrics) == set(NAMES) == set(ref_m)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=rtol)
    for k in NAMES:
        np.testing.assert_allclose(metrics[k].item(), float(ref_m[k]), rtol=rtol, err_msg=k)
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in port.named_parameters()}
    got = dict(_leaves(to_jax(grads, transposed=transposed_paths(port))[0]))
    want = dict(_leaves(ref_g))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = np.linalg.norm(w)
        err = np.linalg.norm(got[k] - w) / scale if scale else np.abs(got[k]).max()
        assert err <= GRAD_RTOL[precision], (k, err)
    return port, metrics


@pytest.mark.parametrize("name", ["faster_rcnn", "faster_rcnn_rm"])
def test_loss_and_gradients_match_jax(name):
    """The four losses, their sum and every parameter's gradient (trunk,
    heads, and mapper_cnn for the rm variant) at precision 32."""
    _check_step(name, _batch())


def test_loss_and_gradients_match_jax_at_precision_16():
    _check_step("faster_rcnn_rm", _batch(), precision=16)


def test_label_offset_shifts_the_training_targets():
    """label_offset 1 grows the classifier by one class and shifts the GT
    labels: the losses still match, and the positives' class targets are
    the raw categories plus one."""
    batch = _batch(seed=3)
    port, _ = _check_step("faster_rcnn", batch, label_offset=1)
    assert port.cfg.num_classes == 10
    gtb, gtv, labels = port._targets(_torch(batch))
    np.testing.assert_array_equal(labels.numpy(), batch["categories"] + 1)


def test_no_gt_boxes():
    """No valid box in the batch: every anchor and proposal is negative,
    both regression losses are 0, and the step still matches."""
    batch = dict(_batch(seed=4), box_valid=np.zeros((2, 8), bool))
    _, metrics = _check_step("faster_rcnn_rm", batch)
    assert metrics["loss_box_reg"].item() == 0 and metrics["loss_rpn_box_reg"].item() == 0


def test_head_stages_match_jax():
    """rpn_loss, sample_proposals and roi_loss one by one, on the same
    features and noise: the sampled rois, class and box targets and masks
    where take holds, and the losses."""
    jtask, params, state, port = _models("faster_rcnn")
    batch = _batch(seed=5)
    feats = np.random.RandomState(5).rand(2, 64, 64, 32).astype(np.float32)
    f = torch.from_numpy(feats)
    gtb, gtv, gtl = (t for t in port._targets(_torch(batch)))
    jgt = jtask._targets(_jax(batch))
    noise = jax_noise(port.cfg, STEP_KEY, 2, 8)
    _, k_det = jax.random.split(STEP_KEY)
    k_rpn, k_roi = jax.random.split(k_det)
    jhead, hp_ = jtask.head, params["head"]
    with torch.no_grad():
        obj, dl = port.head.rpn_forward(f)
        got = port.head.rpn_loss(obj, dl, gtb, gtv, noise["rpn"])
        obj_r, dl_r = jax.jit(jhead.rpn_forward)(hp_, jnp.asarray(feats))
        ref = jax.jit(jhead.rpn_loss)(k_rpn, obj_r, dl_r, jgt[0], jgt[1])
        np.testing.assert_allclose([t.item() for t in got], [float(t) for t in ref], rtol=1e-5)
        rois, rv, _ = jax.jit(lambda o, d: jhead.proposals(o, d, train=True))(obj_r, dl_r)
        s = port.head.sample_proposals(torch.from_numpy(np.array(rois)), torch.from_numpy(np.array(rv)),
                                       gtb, gtv, gtl, noise["roi"])
        s_ref = {k: np.asarray(v) for k, v in jax.jit(jhead.sample_proposals)(k_roi, rois, rv, *jgt).items()}
        take = s_ref["take"]
        np.testing.assert_array_equal(s["take"].numpy(), take)
        np.testing.assert_array_equal(s["is_pos"].numpy(), s_ref["is_pos"])
        np.testing.assert_array_equal(s["cls_target"].numpy()[take], s_ref["cls_target"][take])
        np.testing.assert_allclose(s["rois"].numpy()[take], s_ref["rois"][take], rtol=0, atol=1e-4)
        np.testing.assert_allclose(s["reg_target"].numpy()[take], s_ref["reg_target"][take], rtol=1e-5, atol=1e-5)
        assert take.sum() > 0 and s_ref["is_pos"].sum() > 0
        got = port.head.roi_loss(f, {k: torch.from_numpy(np.array(v)) for k, v in s_ref.items()})
        ref = jax.jit(jhead.roi_loss)(hp_, jnp.asarray(feats), {k: jnp.asarray(v) for k, v in s_ref.items()})
        np.testing.assert_allclose([t.item() for t in got], [float(t) for t in ref], rtol=1e-5)


def test_step_variant_and_freeze_mask_match_jax():
    """step_variant gives the JAX package's keys ("exact_topk_warmup" for
    the first exact_topk_warmup_steps steps unless exact_topk); freeze_mask
    freezes the encoder before unfreeze_epoch_no (0 reads as 10) and trains
    the heads and mapper_cnn from step 0."""
    for extra in (dict(exact_topk=False), dict(exact_topk=True), dict(exact_topk=False, exact_topk_warmup_steps=3)):
        jtask = PAIRS["faster_rcnn"][0](dict(TINY, **extra))
        port = PAIRS["faster_rcnn"][1](dict(TINY, **extra), device="cpu")
        for step in (0, 2, 3, 499, 500, 10_000):
            assert port.step_variant(step) == jtask.step_variant(step), (extra, step)
    for unfreeze, first in ((None, 10), (0, 10), (3, 3)):
        h = dict(TINY) if unfreeze is None else dict(TINY, unfreeze_epoch_no=unfreeze)
        jtask = PAIRS["faster_rcnn_rm"][0](h)
        params, _ = jtask.init(KEY)
        port = PAIRS["faster_rcnn_rm"][1](h, device="cpu")
        assert port.unfreeze_epoch_no == jtask.unfreeze_epoch_no == first
        for epoch in (0, first - 1, first, first + 5):
            ref = jtask.freeze_mask(params, epoch)
            mask = port.apply_freeze_mask(epoch)
            if ref is None:
                assert mask is None and all(p.requires_grad for p in port.parameters())
                continue
            flags = dict(_leaves(jax.tree.map(lambda v: np.float32(v), ref)))
            for n, p in port.named_parameters():
                path = n.replace(".weight", ".w").replace(".bias", ".b").replace(".", "/")
                assert p.requires_grad == bool(flags[path]), (epoch, n)
            assert not port.encoder.c1.weight.requires_grad and port.mapper_cnn.weight.requires_grad
    assert port.learning_rate() == jtask.learning_rate() == 1e-3


def test_rpn_and_roi_loss_goldens():
    """The hand-derived loss values: RPN (the 4-anchor forced-tie case,
    sampler-independent, so any noise passes) and RoI (zeroed MLP, uniform
    posteriors, the class-3 regression slot)."""
    g = GOLDENS["rpn_loss"]
    c = g["config"]
    head = TN.FasterRCNNHead(TN.DetectionConfig(
        image_size=c["image_size"], feat_stride=c["feat_stride"], anchor_sizes=tuple(c["anchor_sizes"]),
        anchor_ratios=tuple(c["anchor_ratios"]), rpn_batch_per_image=c["rpn_batch_per_image"],
        exact_topk=c["exact_topk"]), device="cpu")
    obj = torch.tensor([g["objectness"]], dtype=torch.float32)
    dl = torch.tensor([g["deltas"]], dtype=torch.float32)
    gtb = torch.tensor([[g["gt_box"]]], dtype=torch.float32)
    for seed in (0, 1, 2):
        noise = torch.rand((1, 4), generator=torch.Generator().manual_seed(seed))
        ol, rl = head.rpn_loss(obj, dl, gtb, torch.ones((1, 1), dtype=torch.bool), noise)
        np.testing.assert_allclose(ol.item(), g["loss_objectness"], rtol=1e-5)
        np.testing.assert_allclose(rl.item(), g["loss_rpn_box_reg"], rtol=1e-5)

    g = GOLDENS["roi_loss"]
    head = TN.FasterRCNNHead(TN.DetectionConfig(image_size=16), device="cpu")
    with torch.no_grad():
        for p in head.parameters():
            p.zero_()
        head.bbox_pred.bias.copy_(torch.arange(head.cfg.num_classes * 4, dtype=torch.float32)
                                  * g["bbox_pred_bias_scale"])
    sampled = {"rois": torch.tensor([g["rois"]], dtype=torch.float32),
               "cls_target": torch.tensor([g["cls_target"]], dtype=torch.int32),
               "reg_target": torch.tensor([g["reg_target"]], dtype=torch.float32),
               "is_pos": torch.tensor([g["is_pos"]]), "take": torch.tensor([g["take"]])}
    cl, rl = head.roi_loss(torch.zeros((1, 8, 8, 32)), sampled)
    np.testing.assert_allclose(cl.item(), g["loss_classifier"], rtol=1e-5)
    np.testing.assert_allclose(rl.item(), g["loss_box_reg"], rtol=1e-5)


def test_noise_comes_from_the_generator():
    """Without `noise`, the samplers' draws come from the step's generator
    ("rpn" then "roi"), so the same generator state gives the same losses."""
    _, _, _, port = _models("faster_rcnn")
    batch = _torch(_batch())
    with torch.no_grad():
        a = port.loss(batch, train=True, generator=torch.Generator().manual_seed(11))[1]
        gen = torch.Generator().manual_seed(11)
        noise = port.head.draw_noise(2, 8, gen, "cpu")
        assert noise["rpn"].shape == (2, 64 * 64 * 15) and noise["roi"].shape == (2, 64 + 8)
        b = port.loss(batch, train=True, noise=noise)[1]
    assert {k: v.item() for k, v in a.items()} == {k: v.item() for k, v in b.items()}

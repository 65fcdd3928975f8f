"""driving_dirty_tpu_torch's CUDA kernels against their plain versions on the
card, and the scan that keeps JAX out of the port.

This file imports neither JAX nor the JAX package, so it also runs where
they are absent (the card's machine):

    python -m pytest tests/test_torch_port_gpu.py -q -m gpu --noconftest -p no:cacheprovider

The `gpu` tests decide inside the test whether a card exists and skip
without one. Trunk tolerances as in chip_smoke.py, for the trunk and each of
its stage-bisection variants, scaled by max|plain|:
f32 2e-4 (the kernel's split-TF32 products are within about 2^-21 of f32
products, and its f32 sums run in another order; cuDNN with TF32 off),
bf16 2^-6 (c1, c2 and c3 rounded to bf16 at the same points from sums in
another order: 2 to 4 bf16 ulps at the largest output). The box
rasterizer must equal its plain version exactly: 0 differing pixels, on
seeded box scenes, on the adversarial set of data/boxes.py and on items of
more boxes than one staging pass of the span kernel holds. The trunk under
autograd (its forward the kernel, its backward the plain trunk recomputed)
must give the gradients of autograd through the plain trunk within 1e-4 of
max|plain| for a fixed cotangent: both run the same backward on the same
inputs, and only cuDNN's choice of reduction order can differ between the
calls (sums of up to 3.7M terms, a few 1e-6 of the largest).
The int8 trunk kernel (B1-int8) must equal its plain version exactly: 0
differing elements, since its int32 sums are exact and its epilogue runs
the plain version's f32 operations one by one (no fma contraction).
RoIAlign within 4e-6 of max|plain| in either feature dtype and at either
width (16 B of channels a thread, or one channel a thread for features
whose channels or address do not allow 16-B loads): both read the same
taps with the same f32 weights (the sample coordinates are computed
without fma contraction on both sides), and each output is a convex
combination of 16 taps whose products and sums round in another order, at
most about 16 f32 ulps of the largest value. Its backward (B3-bwd) within
1e-5 (f32) / 2^-6 (bf16) of max|plain| (reasons beside ROI_BWD_TOL), bit
for bit the same on a second launch, at either load width, and under
autograd launched by RoIAlign's backward with no plain version reached.
A box-family training step (spatial_bb, multitask; small geometry, batch
4, everything trainable) through the kernels against the same step with
the plain trunk and rasterizer patched in, from one init and one dropout
generator state: the loss within 1e-4 relative; each parameter's gradient
within 1e-3 relative L2 (the kernel's c3 is within a few 1e-6 of the
plain trunk's, and both backward passes are the same ATen operations from
there), except what a training-mode BatchNorm at batch 4 reaches in
multitask (the encoder, through the latent path, and the roadmap head),
which gets the CPU parity tests' bar for that batch, 2.9e-2
(tests/test_torch_port_box_training.py; the card measured 6.8e-3 on c1's
weight): the batch statistics of 4 rows amplify c3's last-bit
differences; the biases ahead of that BatchNorm, whose true gradient is 0,
within 1e-6 of the global gradient norm; the targets equal.
A .ddx artifact exported on the card (export.py; small widths, batch 2)
and loaded back launches B1 once a request (B1-int8 instead at precision
8, and B3 once for faster_rcnn_rm) and never a plain version, and gives
`predict`'s outputs on the same float32 inputs: the same kernels and
operations run, so masks agree on > 99.99% of pixels and detections'
valid flags and labels are equal and their scores within 1e-5.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from driving_dirty_tpu_torch.data.boxes import adversarial_boxes, box_scenes, detection_rois
from driving_dirty_tpu_torch.kernels import raster as R
from driving_dirty_tpu_torch.kernels import roialign as RA
from driving_dirty_tpu_torch.kernels import trunk as K
from driving_dirty_tpu_torch.kernels import trunk_int8 as K8
from driving_dirty_tpu_torch.ops import quant as Q

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -6}
ROI_TOL = 4e-6
# B3-bwd against roialign_backward_plain, max |error| <= this * max|plain|:
# f32: both sum in f32, the kernel sample by sample in roi order, the plain
# version through the bin interpolation matrices; the sample-level sums lie
# within 6.4e-6 of the largest value from a float64 sum where 1001 rois
# crowd a 21 x 30 map, the plain version's within 2.2e-7 (measured on the
# CPU, the sample-level sums by autograd through roialign_plain): 1e-5. bf16: the
# plain version rounds By, Bx, g and u to bf16 as the JAX package does (its
# error from float64 measured up to 3.95e-3 of the largest value), the
# kernel rounds its f32 sum once (2^-9 of each value): 2^-6.
ROI_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
GRAD_TOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 17, 35, 3), (1, 64, 306, 3), (2, 256, 1836, 3),
    (40, 64, 96, 3),   # more 8 x 16 tiles (1280) than one wave of the persistent grid
    (3, 37, 101, 3),   # c3 19 x 51: H and W not multiples of the tile
])
def test_trunk_kernel_matches_plain_on_gpu(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x, ws = _trunk_inputs(shape, dtype)
    launches = K.trunk.launches
    got = K.trunk(x, *ws)
    ref = K.trunk_plain(x, *ws)
    torch.cuda.synchronize()
    assert K.trunk.launches == launches + 1
    assert got.shape == ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item()


def _trunk_inputs(shape, dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda().to(getattr(torch, dtype))
    wshapes = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]
    return x, [torch.from_numpy((rng.randn(*s) * 0.2).astype(np.float32)).cuda() for s in wshapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 17, 35, 3), (3, 37, 101, 3), (40, 64, 96, 3)])
def test_trunk_variants_match_plain_on_gpu(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x, ws = _trunk_inputs(shape, dtype)
    launches = K.trunk_variant.launches
    for variant in K.VARIANT_STAGES:
        got = K.trunk_variant(x, *ws, variant=variant)
        ref = K.trunk_variant_plain(x, *ws, variant=variant)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype] * ref.float().abs().max().item(), variant
    assert K.trunk_variant.launches == launches + len(K.VARIANT_STAGES)
    assert torch.equal(K.trunk_variant(x, *ws, variant="full"), K.trunk(x, *ws))


@pytest.mark.gpu
def test_trunk_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ws = [torch.zeros(s, device="cuda") for s in
          [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32, 32, 3, 3), (32,)]]
    for fn, kw in ((K.trunk, {}), (K.trunk_variant, {"variant": "v1"})):
        with pytest.raises(TypeError):
            fn(torch.zeros(1, 8, 8, 3, device="cuda", dtype=torch.float16), *ws, **kw)
        with pytest.raises(ValueError):
            fn(torch.zeros(1, 8, 8, 4, device="cuda"), *ws, **kw)
        with pytest.raises(ValueError):
            fn(torch.zeros(1, 8, 16, 3, device="cuda")[:, :, ::2], *ws, **kw)
    with pytest.raises(NotImplementedError):  # the probe takes no gradient; trunk does
        K.trunk_variant(torch.zeros(1, 8, 8, 3, device="cuda", requires_grad=True), *ws, variant="v1")
    assert K.trunk(torch.zeros(1, 8, 8, 3, device="cuda", requires_grad=True), *ws).requires_grad
    with pytest.raises(ValueError):
        K.trunk_variant(torch.zeros(1, 8, 8, 3, device="cuda"), *ws, variant="v5")


@pytest.mark.gpu
@pytest.mark.parametrize("size", [800, 157])
def test_raster_kernel_equals_plain_on_gpu(size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    boxes, valid = (torch.from_numpy(a).cuda() for a in box_scenes(0, batch=8, max_bb=100))
    launches = R.raster.launches
    got = R.raster(boxes, valid, size)
    ref = R.raster_plain(boxes, valid, size)
    torch.cuda.synchronize()
    assert R.raster.launches == launches + 1
    assert got.shape == ref.shape == (8, size, size)
    assert int((got != ref).sum()) == 0 and ref.sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 1836, 3), (3, 37, 101, 3)])
def test_trunk_function_gradients_match_plain_on_gpu(shape, dtype):
    """x and all six parameters, for a fixed cotangent; B1 launches once,
    in the forward only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x, ws = _trunk_inputs(shape, dtype)
    a = [t.clone().requires_grad_() for t in (x, *ws)]
    b = [t.clone().requires_grad_() for t in (x, *ws)]
    g = torch.randn((shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32),
                    generator=torch.Generator(device="cuda").manual_seed(1), device="cuda").to(x.dtype)
    launches = K.trunk.launches
    out = K.trunk(*a)
    assert "driving_dirty_trunk" in type(out.grad_fn).__name__  # the op's backward: trunk_vjp
    out.backward(g)
    K.trunk_plain(*b).backward(g)
    torch.cuda.synchronize()
    assert K.trunk.launches == launches + 1
    for s, t in zip(a, b):
        assert s.grad.shape == t.grad.shape and torch.isfinite(s.grad).all()
        err = (s.grad.float() - t.grad.float()).abs().max().item()
        assert err <= GRAD_TOL * t.grad.float().abs().max().item()


@pytest.mark.gpu
def test_adam_steps_lay_out_the_trunk_weights_once_per_step_on_gpu():
    """Each Adam step writes the weights in place: the next forward must
    lay them out anew (once) and launch B1 once; the backward launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch.models.basic_ae import BasicAE

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = BasicAE(dict(hidden_dim=8, latent_dim=4, input_height=16, output_height=16),
                    device="cuda", generator=gen)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    images = torch.randint(0, 256, (2, 6, 16, 306, 3), dtype=torch.uint8, device="cuda", generator=gen)
    for _ in range(3):
        launches, calls = K.trunk.launches, K.prepare_weights.calls
        opt.zero_grad()
        loss, _ = model.loss(images, train=True, generator=gen)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert K.trunk.launches == launches + 1 and K.prepare_weights.calls == calls + 1


@pytest.mark.gpu
def test_trainer_fit_launches_the_trunk_every_step_and_its_checkpoint_loads_on_cpu(tmp_path, monkeypatch):
    """Trainer.fit of a TINY BasicAE on the card: 3 steps and one validation
    batch launch B1 4 times (the backward launches none), and the
    checkpoint it writes loads into a CPU model with the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
    from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights
    from driving_dirty_tpu_torch.data.synthetic import generate
    from driving_dirty_tpu_torch.models.basic_ae import BasicAE
    from driving_dirty_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("DD_NO_TB", "1")
    generate(str(tmp_path / "data"), scenes=3, samples=4, labeled_scenes=0, seed=0)
    h = dict(link=str(tmp_path / "data"), hidden_dim=8, latent_dim=8, batch_size=2, samples_per_scene=4,
             num_unlabeled_scenes=3, output_img_freq=0)
    model = BasicAE(h, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    launches = K.trunk.launches
    r = Trainer(max_epochs=1, limit_train_batches=3, limit_val_batches=1, log_every_n_steps=1,
                default_root_dir=str(tmp_path / "logs"), enable_progress_bar=False).fit(model)
    torch.cuda.synchronize()
    assert K.trunk.launches == launches + 4
    assert np.isfinite(r.best_val_loss)
    blob = ckpt_io.load(r.last_ckpt_path)
    assert blob["meta"]["global_step"] == 3 and "torch_generator_cuda" in blob["extra"]
    cpu = load_jax_weights(BasicAE(blob["hparams"], device="cpu"), blob["params"], blob["state"])
    for k, v in model.state_dict().items():
        assert torch.equal(cpu.state_dict()[k], v.cpu()), k


@pytest.mark.gpu
@pytest.mark.parametrize("size", [800, 148, 157])
@pytest.mark.parametrize("boxes", ["adversarial", "many"])
def test_raster_kernel_equals_plain_on_hard_boxes_on_gpu(boxes, size):
    """The adversarial set, and 500 boxes an item (about 290 valid: more
    than one 256-record staging pass of the span kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if boxes == "adversarial":
        b, v = adversarial_boxes(0, batch=8, max_bb=100)
    else:
        sets = [adversarial_boxes(s, batch=2, max_bb=100) for s in range(5)]
        b, v = (np.concatenate([s[i] for s in sets], axis=1) for i in (0, 1))
    b, v = torch.from_numpy(b).cuda(), torch.from_numpy(v).cuda()
    launches = R.raster.launches
    got = R.raster(b, v, size)
    ref = R.raster_plain(b, v, size)
    torch.cuda.synchronize()
    assert R.raster.launches == launches + 1
    assert got.shape == ref.shape == (b.shape[0], size, size)
    assert int((got != ref).sum()) == 0 and 0 < ref.sum() < ref.numel()


@pytest.mark.gpu
def test_raster_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    boxes, valid = torch.zeros(2, 3, 2, 4, device="cuda"), torch.ones(2, 3, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        R.raster(boxes.double(), valid, 8)
    with pytest.raises(TypeError):
        R.raster(boxes, valid.float(), 8)
    with pytest.raises(ValueError):
        R.raster(boxes[:, :, :, :3], valid, 8)
    with pytest.raises(ValueError):
        R.raster(boxes, valid[:, :2], 8)
    with pytest.raises(ValueError):
        R.raster(boxes.transpose(0, 1), valid.t(), 8)
    with pytest.raises(ValueError):
        R.raster(boxes, valid, 0)
    with pytest.raises(ValueError):
        R.raster(torch.zeros(65536, 1, 2, 4, device="cuda"),
                 torch.zeros(65536, 1, dtype=torch.bool, device="cuda"), 8)


def _roialign_inputs(b, h, w, c, r, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feats = torch.rand((b, h, w, c), generator=gen, device="cuda").to(getattr(torch, dtype))
    rois = torch.from_numpy(detection_rois(seed, b, r, size=2 * max(h, w))).cuda()
    return feats, rois


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", [
    ((8, 400, 400, 32, 1000), dict(spatial_scale=0.5)),              # the detection path's shape
    ((2, 37, 53, 24, 1), dict(spatial_scale=0.5)),                   # odd H and W, C not 32, R = 1
    ((1, 21, 30, 32, 1001), dict(spatial_scale=0.5, aligned=True)),
    ((3, 16, 19, 3, 33), dict(output_size=5, sampling_ratio=3, spatial_scale=0.25)),
])
def test_roialign_kernel_matches_plain_on_gpu(shape, kw, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c, r = shape
    feats, rois = _roialign_inputs(b, h, w, c, r, dtype)
    launches = RA.roialign.launches
    got = RA.roialign(feats, rois, **kw)
    ref = RA.roialign_plain(feats, rois, **kw)
    torch.cuda.synchronize()
    assert RA.roialign.launches == launches + 1
    out = kw.get("output_size", 7)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (b, r, out, out, c)
    assert (got - ref).abs().max().item() <= ROI_TOL * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c,offset,width", [
    ("float32", 4, 0, 4),      # one 16-B group of f32 channels
    ("bfloat16", 8, 0, 8),     # one 16-B group of bf16 channels
    ("float32", 3, 0, 1),      # C not a multiple of the width
    ("bfloat16", 3, 0, 1),
    ("float32", 32, 1, 1),     # data pointer 4 B off 16-B alignment
    ("bfloat16", 32, 2, 1),
])
def test_roialign_each_width_matches_plain_on_gpu(dtype, c, offset, width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, r = 2, 37, 53, 67
    gen = torch.Generator(device="cuda").manual_seed(c + offset)
    n = b * h * w * c
    buf = torch.rand(n + offset, generator=gen, device="cuda").to(getattr(torch, dtype))
    feats = buf[offset:].view(b, h, w, c)
    assert feats.is_contiguous() and feats.data_ptr() % 16 == 4 * (offset > 0)
    rois = torch.from_numpy(detection_rois(1, b, r, size=2 * max(h, w))).cuda()
    assert RA.channels_per_thread(feats) == width
    launches = RA.roialign.launches
    got = RA.roialign(feats, rois, spatial_scale=0.5)
    ref = RA.roialign_plain(feats, rois, spatial_scale=0.5)
    torch.cuda.synchronize()
    assert RA.roialign.launches == launches + 1
    assert got.shape == ref.shape == (b, r, 7, 7, c)
    assert (got - ref).abs().max().item() <= ROI_TOL * ref.abs().max().item()


@pytest.mark.gpu
def test_roialign_on_cuda_never_reaches_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    feats, rois = _roialign_inputs(2, 40, 40, 32, 16, "float32")
    ref = RA.roialign_plain(feats, rois)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(RA, "roialign_plain", refuse)
    launches = RA.roialign.launches
    from driving_dirty_tpu_torch.ops.detection import batched_roi_align
    got = batched_roi_align(feats, rois)
    torch.cuda.synchronize()
    assert RA.roialign.launches == launches + 1
    assert (got - ref).abs().max().item() <= ROI_TOL * ref.abs().max().item()
    empty = RA.roialign(feats, rois[:, :0])
    assert empty.shape == (2, 0, 7, 7, 32) and RA.roialign.launches == launches + 1


@pytest.mark.gpu
def test_roialign_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    feats, rois = _roialign_inputs(2, 8, 8, 4, 3, "float32")
    with pytest.raises(TypeError):
        RA.roialign(feats.half(), rois)
    with pytest.raises(TypeError):
        RA.roialign(feats, rois.double())
    with pytest.raises(ValueError):
        RA.roialign(feats, rois[:1])
    with pytest.raises(ValueError):
        RA.roialign(feats.transpose(1, 2), rois)
    with pytest.raises(ValueError):
        RA.roialign(feats, rois.cpu())
    with pytest.raises(ValueError):
        RA.roialign(feats, rois, output_size=128, sampling_ratio=4)
    g = torch.zeros((2, 3, 7, 7, 4), device="cuda")
    with pytest.raises(TypeError):
        RA.roialign_backward(g.double(), rois, feats.shape, torch.float32)
    with pytest.raises(TypeError):
        RA.roialign_backward(g, rois, feats.shape, torch.float16)
    with pytest.raises(ValueError):
        RA.roialign_backward(g[:, :2], rois, feats.shape, torch.float32)
    with pytest.raises(ValueError):
        RA.roialign_backward(g, rois.cpu(), feats.shape, torch.float32)


def _roialign_grad(b, h, w, c, r, seed=0, offset=0):
    """A seeded float32 gradient of RoIAlign's output [b, r, 7, 7, c] on the
    card, its data `offset` floats past an allocation, and seeded rois."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = b * r * 49 * c
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:].view(b, r, 7, 7, c)
    rois = torch.from_numpy(detection_rois(seed, b, r, size=2 * max(h, w))).cuda()
    return g, rois


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", [
    ((8, 400, 400, 32, 512), dict(spatial_scale=0.5)),               # the detection training path's shape
    ((2, 37, 53, 24, 1), dict(spatial_scale=0.5)),                   # odd H and W, C not 32, R = 1
    ((1, 21, 30, 40, 1001), dict(spatial_scale=0.5, aligned=True)),  # C over one 32-channel pass
    ((3, 16, 19, 3, 33), dict(output_size=5, sampling_ratio=3, spatial_scale=0.25)),
])
def test_roialign_backward_matches_plain_on_gpu(shape, kw, dtype):
    """B3-bwd against roialign_backward_plain: f32 within 1e-5 of
    max|plain|, bf16 within 2^-6 (tolerances in ROI_BWD_TOL's comment)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c, r = shape
    out = kw.get("output_size", 7)
    g, rois = _roialign_grad(b, h, w, c, r)
    g = g[:, :, :out, :out].contiguous()
    dt = getattr(torch, dtype)
    launches = RA.roialign_backward.launches
    got = RA.roialign_backward(g, rois, (b, h, w, c), dt, **kw)
    again = RA.roialign_backward(g, rois, (b, h, w, c), dt, **kw)
    ref = RA.roialign_backward_plain(g, rois, (b, h, w, c), dt, **kw)
    torch.cuda.synchronize()
    assert RA.roialign_backward.launches == launches + 2
    assert got.dtype == dt and got.shape == ref.shape == (b, h, w, c)
    assert torch.equal(got, again)  # no atomics: the same bits on every launch
    assert (got.float() - ref.float()).abs().max().item() <= ROI_BWD_TOL[dtype] * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("c,offset,vec", [(32, 0, 4), (3, 0, 1), (32, 1, 1)])
def test_roialign_backward_each_load_width_on_gpu(c, offset, vec):
    """16-B loads of g where C % 4 == 0 and g starts on 16 B; otherwise one
    float at a time (C = 3; g 4 B off 16-B alignment)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, r = 2, 37, 53, 67
    g, rois = _roialign_grad(b, h, w, c, r, seed=c + offset, offset=offset)
    assert RA.grad_channels_per_load(g) == vec
    got = RA.roialign_backward(g, rois, (b, h, w, c), torch.float32, spatial_scale=0.5)
    ref = RA.roialign_backward_plain(g, rois, (b, h, w, c), torch.float32, spatial_scale=0.5)
    assert (got - ref).abs().max().item() <= ROI_BWD_TOL["float32"] * ref.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roialign_autograd_runs_both_kernels_on_gpu(monkeypatch, dtype):
    """Under autograd, roialign on a CUDA tensor launches B3 forward and
    B3-bwd once each and never reaches a plain version; the rois get no
    gradient, and the features' gradient is B3-bwd's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    feats, rois = _roialign_inputs(2, 40, 40, 32, 16, dtype)
    g, _ = _roialign_grad(2, 40, 40, 32, 16, seed=3)
    ref = RA.roialign_backward(g, rois, feats.shape, feats.dtype, spatial_scale=0.5)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(RA, "roialign_plain", refuse)
    monkeypatch.setattr(RA, "roialign_backward_plain", refuse)
    feats.requires_grad_()
    rois.requires_grad_()
    fwd, bwd = RA.roialign.launches, RA.roialign_backward.launches
    out = RA.roialign(feats, rois, spatial_scale=0.5)
    # the box head flattens the pooled bins channel-major before its MLP, so
    # the gradient reaches RoIAlign strided
    out.permute(0, 1, 4, 2, 3).reshape(2, 16, -1).backward(g.permute(0, 1, 4, 2, 3).reshape(2, 16, -1))
    torch.cuda.synchronize()
    assert (RA.roialign.launches, RA.roialign_backward.launches) == (fwd + 1, bwd + 1)
    assert rois.grad is None and feats.grad.dtype == feats.dtype
    assert torch.equal(feats.grad, ref)


def _int8_inputs(shape, seed=0):
    """bf16 input, f32 trunk weights on the card and static scales
    calibrated on the input itself."""
    x, ws = _trunk_inputs(shape, "bfloat16")
    return x, ws, Q.calibrate_trunk(ws, x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (1, 17, 35, 3),    # batch 1, odd H and W: partial tiles
    (3, 37, 101, 3),   # c3 19 x 51
    (40, 64, 96, 3),   # more tiles than one wave of the persistent grid
    (2, 256, 1836, 3),  # the panorama
])
def test_trunk_int8_kernel_equals_plain_on_gpu(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, ws, scales = _int8_inputs(shape)
    launches = K8.trunk_int8.launches
    with torch.no_grad():
        got = K8.trunk_int8(x, *ws, scales)
        ref = K8.trunk_int8_plain(x, *ws, scales)
    torch.cuda.synchronize()
    assert K8.trunk_int8.launches == launches + 1
    assert got.dtype == ref.dtype == torch.bfloat16
    assert got.shape == ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
    assert int((got != ref).sum()) == 0 and ref.abs().max() > 0


# The int8 stage variants and the int -> float paths: the two odd shapes and
# batch 8 of both main-path shapes
INT8_CHECK_SHAPES = [(2, 17, 35, 3), (3, 37, 101, 3), (8, 256, 1836, 3), (8, 800, 800, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(K8.INT8_VARIANT_STAGES))
@pytest.mark.parametrize("shape", INT8_CHECK_SHAPES)
def test_trunk_int8_variants_equal_plain_on_gpu(shape, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, ws, scales = _int8_inputs(shape)
    launches = K8.trunk_int8_variant.launches
    with torch.no_grad():
        got = K8.trunk_int8_variant(x, *ws, scales, variant=variant)
        ref = K8.trunk_int8_variant_plain(x, *ws, scales, variant=variant)
    torch.cuda.synchronize()
    assert K8.trunk_int8_variant.launches == launches + 1
    assert got.shape == ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 32)
    assert int((got != ref).sum()) == 0 and ref.abs().max() > 0
    if variant == "full":
        with torch.no_grad():
            assert torch.equal(got, K8.trunk_int8(x, *ws, scales))


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["c2 signs", "c3 signs", "all positive"])
@pytest.mark.parametrize("shape", INT8_CHECK_SHAPES)
def test_trunk_int8_int2float_path_equals_plain_on_gpu(shape, weights):
    """Weights whose 127 * sum |wq| reaches 2^22 take __int2float_rn
    (int_path_flags): c2's or c3's weights as +-0.1 (every |wq| 127), or a
    constant input under constant positive weights, where every interior q0,
    q1 and q2 is 127 and c2's and c3's sums reach 288 * 127 * 127 > 2^22:
    there the magic conversion would be wrong."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, ws = _trunk_inputs(shape, "bfloat16")
    if weights == "all positive":
        x = torch.ones_like(x)
        ws = [torch.full_like(w, 0.1 if w.dim() == 4 else 0.05) for w in ws]
        flags = 6
    else:
        layer = 1 if weights == "c2 signs" else 2
        ws[2 * layer] = torch.sign(ws[2 * layer]) * 0.1
        flags = 2 * layer
    scales = Q.calibrate_trunk(ws, x)
    with torch.no_grad():
        assert K8.kernel_int8_weights(ws[0::2], ws[1::2], scales)[2] == flags
        held = []
        for v in K8.INT8_VARIANT_STAGES:
            got = K8.trunk_int8_variant(x, *ws, scales, variant=v)
            ref = K8.trunk_int8_variant_plain(x, *ws, scales, variant=v)
            held.append(int((got != ref).sum()))
        got = K8.trunk_int8(x, *ws, scales)
        ref = K8.trunk_int8_plain(x, *ws, scales)
        held.append(int((got != ref).sum()))
        wq1, w1_inv = Q.quantize_conv_weight(ws[0])
        v1 = Q.conv2d_int8(Q.quantize(x, scales[0]), wq1, 1.0 / scales[0], w1_inv)
        q1 = Q.quantize(torch.relu(v1 + ws[1]).to(x.dtype), scales[1])
    torch.cuda.synchronize()
    assert held == [0] * 5 and ref.abs().max() > 0
    if weights == "all positive":
        acc2 = Q.conv_int32(q1, Q.quantize_conv_weight(ws[2])[0])
        assert int(acc2.abs().max()) > 2 ** 22


@pytest.mark.gpu
def test_trunk_int8_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, ws, scales = _int8_inputs((1, 8, 16, 3))
    with torch.no_grad():
        with pytest.raises(TypeError):
            K8.trunk_int8(x.float(), *ws, scales)
        with pytest.raises(ValueError):
            K8.trunk_int8(x[:, :, ::2], *ws, scales)
        with pytest.raises(ValueError):
            K8.trunk_int8(torch.cat([x, x[..., :1]], -1), *ws, scales)
        with pytest.raises(ValueError):
            K8.trunk_int8(x, *[w.cpu() for w in ws], scales)
        with pytest.raises(ValueError):
            K8.trunk_int8(x, *ws, (scales[0], 0.0, scales[2]))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            K8.trunk_int8(x, *ws, None)
    with pytest.raises(NotImplementedError):
        K8.trunk_int8(x.clone().requires_grad_(), *ws, scales)


@pytest.mark.gpu
def test_trunk_int8_weight_cache_rebuilds_after_an_in_place_update():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, ws, scales = _int8_inputs((2, 33, 70, 3))
    K8.prepare_int8_weights.calls = 0
    with torch.no_grad():
        first = K8.trunk_int8(x, *ws, scales)
        assert torch.equal(K8.trunk_int8(x, *ws, scales), first)
        assert K8.prepare_int8_weights.calls == 1
        ws[2][3] += 0.5  # c2 weight, output channel 3: a new absmax
        got = K8.trunk_int8(x, *ws, scales)
        ref = K8.trunk_int8_plain(x, *ws, scales)
    torch.cuda.synchronize()
    assert K8.prepare_int8_weights.calls == 2
    assert int((got != ref).sum()) == 0 and not torch.equal(got, first)


@pytest.mark.gpu
def test_precision8_roadmap_calibrates_once_and_runs_the_int8_kernel_only(monkeypatch):
    """predict at precision 8 on the card: one calibration, B1-int8 once a
    call, bf16 B1 never, and no plain version of a kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch.models.precision import Int8TrunkMixin
    from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2

    model = RoadMapBCEv2(dict(ae_hidden_dim=8, ae_latent_dim=6, ae_input_height=32, ae_input_width=6 * 48,
                              pretrained_path=None, batch_size=2, precision=8),
                         device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(K8, "trunk_int8_plain", refuse)
    monkeypatch.setattr(K, "trunk_plain", refuse)
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 6, 32, 48, 3), np.uint8)).cuda()
    calibrations, int8s, trunks = Int8TrunkMixin.calibrations, K8.trunk_int8.launches, K.trunk.launches
    masks = [model.predict(images) for _ in range(2)]
    torch.cuda.synchronize()
    assert Int8TrunkMixin.calibrations == calibrations + 1
    assert K8.trunk_int8.launches == int8s + 2 and K.trunk.launches == trunks
    assert torch.equal(masks[0], masks[1]) and masks[0].shape == (2, 800, 800)


BOX_SMALL = dict(ae_hidden_dim=16, ae_latent_dim=8, ae_input_height=64, ae_input_width=6 * 78,
                 pretrained_path=None, batch_size=4, spatial_geometry="small", unfreeze_epoch_no=1)
BOX_NOISE = ("encoder.fc1.fc.bias", "encoder.fc2.fc.bias")  # ahead of a training-mode BatchNorm
BOX_GRAD_TOL = 1e-3
BOX_BN_GRAD_TOL = 2.9e-2  # what multitask's BatchNorm at batch 4 reaches: the encoder and rm_head


def _box_task(name):
    from driving_dirty_tpu_torch.models.bb_mlp import Boxes
    from driving_dirty_tpu_torch.models.multitask import MultiTask
    from driving_dirty_tpu_torch.models.spatial_bb import BBSpatialModel, BBSpatialRoadMap

    cls = {"spatial_bb": BBSpatialModel, "spatial_rm": BBSpatialRoadMap, "multitask": MultiTask,
           "bb_mlp": Boxes}[name]
    return cls(BOX_SMALL, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))


def _box_batch(name, seed=0, b=4):
    rng = np.random.RandomState(seed)
    road = 152 if name == "spatial_rm" else 800  # the small geometry's road-map branch
    boxes, valid = box_scenes(seed, batch=b, max_bb=100)
    batch = {"images": rng.randint(0, 256, (b, 6, 64, 78, 3)).astype(np.uint8), "boxes": boxes,
             "box_valid": valid, "road": (rng.rand(b, road, road) > 0.5).astype(np.float32)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _launches():
    torch.cuda.synchronize()
    return K.trunk.launches, R.raster.launches


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spatial_bb", "multitask"])
def test_box_training_step_matches_the_plain_kernels_on_gpu(name, monkeypatch):
    """One training step with the encoder trainable: B1 and B2 launch once
    each, the backward none; loss, gradients (c3's from the box head, and
    in multitask from both heads) and targets against the plain kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch.models import spatial_bb

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _box_task(name)
    assert model.apply_freeze_mask(1) is None
    batch = _box_batch(name)

    def step():
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, train=True, generator=torch.Generator(device="cuda").manual_seed(1))
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    before = _launches()
    loss, grads = step()
    assert _launches() == (before[0] + 1, before[1] + 1)
    targets = spatial_bb.box_targets(batch, model.raster_size)
    with monkeypatch.context() as m:
        m.setattr("driving_dirty_tpu_torch.nn.autoencoder.trunk", K.trunk_plain)
        m.setattr(spatial_bb, "raster", R.raster_plain)
        before = _launches()
        loss_plain, grads_plain = step()
        assert _launches() == before
    assert torch.equal(targets, R.raster_plain(batch["boxes"], batch["box_valid"], model.raster_size))
    assert abs(loss - loss_plain) <= 1e-4 * abs(loss_plain)
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_plain.values()])).item()
    for n, g in grads.items():
        ref = grads_plain[n]
        assert torch.isfinite(g).all(), n
        if n in BOX_NOISE:
            assert max(g.abs().max().item(), ref.abs().max().item()) <= 1e-6 * norm, n
            continue
        bn = name == "multitask" and n.startswith(("encoder.", "rm_head."))
        assert (g - ref).norm().item() <= (BOX_BN_GRAD_TOL if bn else BOX_GRAD_TOL) * ref.norm().item(), n
    assert grads["encoder.c1.weight"].abs().sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spatial_bb", "spatial_rm", "multitask", "bb_mlp"])
def test_box_tasks_launch_the_kernels_as_counted_on_gpu(name):
    """B1 once and B2 once (never for bb_mlp) a training step and a
    validation batch; log_images (the spatial tasks) once each, on one
    scene; the backward launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = _box_task(name)
    batch = _box_batch(name)
    rasters = 0 if name == "bb_mlp" else 1
    before = _launches()
    loss, _ = model.loss(batch, train=True, generator=torch.Generator(device="cuda").manual_seed(1))
    loss.backward()
    assert _launches() == (before[0] + 1, before[1] + rasters)
    before = _launches()
    metrics = model.val_metrics(batch)
    assert _launches() == (before[0] + 1, before[1] + rasters) and torch.isfinite(metrics["val_loss"])
    before = _launches()
    images = model.log_images(batch, "val")
    if name.startswith("spatial"):
        assert _launches() == (before[0] + 1, before[1] + 1)
        size = model.raster_size
        assert images["val_target_bbs"].shape == images["val_pred_bbs"].shape == (size, size, 1)
    else:
        assert _launches() == before and images == {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["spatial_bb", "multitask"])
def test_frozen_encoder_stays_bit_identical_on_gpu(name):
    """Adam steps with the encoder frozen (train/optim.py:Adam, the
    trainer's): its parameters bit-identical, its kernel weights laid out
    once in all, the heads moving; after the unfreeze the first forward
    reuses that layout, and each later one follows an update."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch.train.optim import Adam

    model = _box_task(name)
    assert model.apply_freeze_mask(0) is not None
    batch = _box_batch(name)
    opt = Adam(model.named_parameters(), 1e-3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def steps(n):
        calls = K.prepare_weights.calls
        for _ in range(n):
            loss, _ = model.loss(batch, train=True, generator=gen)
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        return K.prepare_weights.calls - calls

    assert steps(3) == 1
    after = dict(model.named_parameters())
    for n, v in before.items():
        assert torch.equal(after[n], v) == n.startswith("encoder."), n
    model.apply_freeze_mask(1)
    assert steps(3) == 2
    assert not torch.equal(after["encoder.c1.weight"], before["encoder.c1.weight"])


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


def _artifact(tmp_path, model, exporter, **kw):
    from driving_dirty_tpu_torch import export as ddx

    ckpt = tmp_path / f"{model.name}.ckpt"
    ddx.save_task_ckpt(ckpt, model)
    art = tmp_path / f"{model.name}.ddx"
    meta = exporter(str(ckpt), str(art), batch_size=2, device="cuda", **kw)
    assert meta["device"] == "cuda"
    return str(ckpt), ddx.load(str(art))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", [32, 8])
def test_roadmap_artifact_launches_the_trunk_and_matches_predict_on_gpu(tmp_path, monkeypatch, precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch import export as ddx
    from driving_dirty_tpu_torch.cli.run_test import load_roadmap_model
    from driving_dirty_tpu_torch.models.roadmap import RoadMapBCEv2

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((2, 6, 256, 306, 3), generator=gen, device="cuda")
    hp = dict(ae_hidden_dim=8, ae_latent_dim=8, pretrained_path=None, batch_size=2, precision=precision)
    kw = {"calib_images": x.cpu().numpy()} if precision == 8 else {}
    ckpt, served = _artifact(tmp_path, RoadMapBCEv2(hp, device="cuda", generator=gen), ddx.export_roadmap, **kw)
    direct = load_roadmap_model(ckpt, precision, device="cuda").predict(x)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(K, "trunk_plain", refuse)
    monkeypatch.setattr(K8, "trunk_int8_plain", refuse)
    before = (K.trunk.launches, K8.trunk_int8.launches)
    out = served(x)
    torch.cuda.synchronize()
    want = (1, 0) if precision == 32 else (0, 1)
    assert (K.trunk.launches - before[0], K8.trunk_int8.launches - before[1]) == want
    assert out.shape == (2, 800, 800)
    assert (out == direct).float().mean().item() > 0.9999


@pytest.mark.gpu
def test_detection_artifact_launches_trunk_and_roialign_and_matches_predict_on_gpu(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from driving_dirty_tpu_torch import export as ddx
    from driving_dirty_tpu_torch.models.faster_rcnn import FasterRCNNRoadMap

    gen = torch.Generator(device="cuda").manual_seed(1)
    hp = dict(pretrained_path=None, batch_size=2, rpn_pre_nms_top_n=256, rpn_post_nms_top_n=64)
    ckpt, served = _artifact(tmp_path, FasterRCNNRoadMap(hp, device="cuda", generator=gen), ddx.export_detection)
    x = torch.rand((2, 6, 256, 306, 3), generator=gen, device="cuda")
    road = (torch.rand((2, 800, 800), generator=gen, device="cuda") > 0.5).float()
    direct = ddx.load_task_ckpt(ckpt, device="cuda").predict(x, road)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(K, "trunk_plain", refuse)
    monkeypatch.setattr(RA, "roialign_plain", refuse)
    before = (K.trunk.launches, RA.roialign.launches)
    out = served(x, road)
    torch.cuda.synchronize()
    assert (K.trunk.launches - before[0], RA.roialign.launches - before[1]) == (1, 1)
    assert torch.equal(out["valid"], direct["valid"]) and out["valid"].any()
    assert torch.equal(out["labels"], direct["labels"])
    assert (out["scores"] - direct["scores"]).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_two_ranks_sharing_the_card_take_the_one_process_step_on_gpu(tmp_path, monkeypatch):
    """Two ranks on cuda:0 over gloo (parallel/launch.py) take one BasicAE
    step on the halves of a global batch of 4, dropout and the six-to-one
    mask drawn for the global batch: the all-reduced loss within 1e-4 of
    the one-process step's (the training phase's first-step bar in
    chip_smoke.py), and B1 launched once on each rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    from driving_dirty_tpu_torch.models.basic_ae import BasicAE
    from driving_dirty_tpu_torch.parallel import launch

    monkeypatch.setenv("DD_NO_TB", "1")
    monkeypatch.setenv("DD_NO_COST_ANALYSIS", "1")
    rng = np.random.RandomState(0)
    spec = dict(task=BasicAE, seed=0, device="cuda",
                hparams=dict(hidden_dim=8, latent_dim=4, input_height=16, output_height=16, batch_size=4),
                batches=[{"images": rng.randint(0, 256, (4, 6, 16, 306, 3)).astype(np.uint8)}],
                trainer=dict(max_epochs=1, limit_val_batches=0, log_every_n_steps=1, enable_checkpointing=False,
                             enable_progress_bar=False))
    losses = {}
    for name, ranks in (("one", 1), ("two", 2)):
        s = dict(spec, trainer=dict(spec["trainer"], default_root_dir=str(tmp_path / name)))
        out = [launch.fit_worker(s)] if ranks == 1 else launch.spawn(launch.fit_worker, 2, (s,), device="cuda:0")
        assert [o["launches"]["trunk"] for o in out] == [1] * ranks
        path = next((tmp_path / name).glob("basic_ae/version_*/tb/metrics.jsonl"))
        losses[name] = next(json.loads(x)["train_loss"] for x in path.read_text().splitlines() if "train_loss" in x)
    assert abs(losses["two"] - losses["one"]) <= 1e-4 * abs(losses["one"]), losses

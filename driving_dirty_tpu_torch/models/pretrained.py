"""A pretrained BasicAE encoder from a checkpoint
(driving_dirty_tpu/models/pretrained.py:24-85, encoder part).

The checkpoint's embedded hparams rebuild the encoder; its weights come
along. With no `pretrained_path` the encoder is initialized from the
caller's generator, with the caller-supplied dims. `c3_only` builds the
conv trunk alone, for backbones that tap the c3 feature map.
`encoder_freeze_mask` is the staged fine-tune every downstream task shares.
"""
from __future__ import annotations

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import load_jax_weights
from driving_dirty_tpu_torch.models.basic_ae import AEConfig
from driving_dirty_tpu_torch.train.task import hp


def load_pretrained_ae(hparams):
    """-> (AEConfig: the BasicAE dims, no weights; the encoder's JAX
    (params, state) pytrees or None). The weights are None when no
    checkpoint is given; init_backbone then initializes fresh."""
    path = hp(hparams, "pretrained_path", None)
    if path:
        blob = ckpt_io.load(path, opt_state=False)
        state = blob.get("state") or {}
        return AEConfig(blob["hparams"]), (blob["params"]["encoder"], state.get("encoder"))
    ae = AEConfig(
        dict(
            hidden_dim=hp(hparams, "ae_hidden_dim", 128),
            latent_dim=hp(hparams, "ae_latent_dim", 64),
            input_height=hp(hparams, "ae_input_height", 256),
            input_width=hp(hparams, "ae_input_width", 306 * 6),
            batch_size=hp(hparams, "batch_size", 16),
        )
    )
    return ae, None


_C3_KEYS = ("c1", "c2", "c3")


def init_backbone(ae, weights, *, c3_only: bool = False, device=None, generator=None):
    """-> the Encoder module, with the checkpoint's weights when given.

    c3_only=True keeps only the conv trunk (c1/c2/c3) and drops the dense
    latent path, as the JAX package's init_backbone(..., c3_only=True) drops
    its params: the spatial and detection backbones never evaluate it."""
    enc = ae.build_encoder(dense=not c3_only, device=device, generator=generator)
    if weights is not None:
        params, state = weights
        if c3_only:
            params, state = {k: v for k, v in params.items() if k in _C3_KEYS}, None
        load_jax_weights(enc, params, state, what="pretrained encoder")
    return enc


def encoder_freeze_mask(task, epoch: int):
    """None (everything trains) from `task.unfreeze_epoch_no` on; before it
    {parameter name: trainable}, False for the encoder's parameters."""
    if epoch >= task.unfreeze_epoch_no:
        return None
    return {name: not name.startswith("encoder.") for name, _ in task.named_parameters()}

"""A pretrained BasicAE encoder from a checkpoint
(driving_dirty_tpu/models/pretrained.py:24-85, encoder part).

The checkpoint's embedded hparams rebuild the encoder; its weights come
along. With no `pretrained_path` the encoder is initialized from the
caller's generator, with the caller-supplied dims.
"""
from __future__ import annotations

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io
from driving_dirty_tpu_torch.checkpoints.convert import from_jax
from driving_dirty_tpu_torch.models.basic_ae import BasicAE
from driving_dirty_tpu_torch.train.task import hp


def load_pretrained_ae(hparams):
    """-> (BasicAE, encoder state_dict or None). The state_dict is None when
    no checkpoint is given; init_backbone then initializes fresh."""
    path = hp(hparams, "pretrained_path", None)
    if path:
        blob = ckpt_io.load(path)
        state = blob.get("state") or {}
        sd = from_jax(blob["params"]["encoder"], state.get("encoder"))
        return BasicAE(blob["hparams"]), sd
    ae = BasicAE(
        dict(
            hidden_dim=hp(hparams, "ae_hidden_dim", 128),
            latent_dim=hp(hparams, "ae_latent_dim", 64),
            input_height=hp(hparams, "ae_input_height", 256),
            input_width=hp(hparams, "ae_input_width", 306 * 6),
            batch_size=hp(hparams, "batch_size", 16),
        )
    )
    return ae, None


def init_backbone(ae, state_dict, *, device=None, generator=None):
    """-> the Encoder module, with the checkpoint's weights when given."""
    enc = ae.build_encoder(device=device, generator=generator)
    if state_dict is not None:
        # a checkpoint without BN state keeps the fresh running stats, as the
        # JAX package does
        missing, unexpected = enc.load_state_dict(state_dict, strict=False)
        bad = [k for k in missing if not k.endswith(("running_mean", "running_var"))]
        if bad or unexpected:
            raise KeyError(f"encoder checkpoint mismatch: missing {bad}, unexpected {unexpected}")
    return enc

"""Reference PyTorch Lightning checkpoints (the reference's rm.ckpt) into
the JAX layout (driving_dirty_tpu/checkpoints/torch_import.py), for
checkpoints/convert.py:load_jax_weights and checkpoints/io.py.

The reference's state_dict keys follow its module tree (encoder.c1..c3,
DenseBlocks as fc1/fc2 with an inner fc1 + fc_bn, fc_z_out; decoder.fc1,
fc2, dc1..dc4; roadmap models: ae.encoder... and the fc1 head):

  Conv2d weight          OIHW -> HWIO           (transpose 2, 3, 1, 0)
  ConvTranspose2d weight [I, O, kh, kw] -> HWIO (transpose 2, 3, 0, 1)
  Linear weight          [out, in] -> [in, out]
  BatchNorm              weight/bias -> scale/bias (params),
                         running_mean/var -> state

Lightning 0.7.5 stores hparams as an argparse.Namespace; it is the one
class allowed besides tensors when the file is unpickled (torch.load with
weights_only=True).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from driving_dirty_tpu_torch.checkpoints import io as ckpt_io


def _load_state_dict(path):
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        sd = blob["state_dict"]
        hparams = blob.get("hparams") or blob.get("hyper_parameters") or {}
        if hasattr(hparams, "__dict__") and not isinstance(hparams, dict):
            hparams = dict(vars(hparams))
    else:
        sd, hparams = blob, {}
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()}, dict(hparams)


def _conv(sd, prefix):
    p = {"w": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0))}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _convT(sd, prefix):
    return {
        "w": np.transpose(sd[f"{prefix}.weight"], (2, 3, 0, 1)),
        "b": sd[f"{prefix}.bias"],
    }


def _linear(sd, prefix):
    return {"w": sd[f"{prefix}.weight"].T.copy(), "b": sd[f"{prefix}.bias"]}


def _dense_block(sd, prefix):
    params = {
        "fc": _linear(sd, f"{prefix}.fc1"),
        "bn": {"scale": sd[f"{prefix}.fc_bn.weight"], "bias": sd[f"{prefix}.fc_bn.bias"]},
    }
    state = {
        "bn": {
            "mean": sd[f"{prefix}.fc_bn.running_mean"],
            "var": sd[f"{prefix}.fc_bn.running_var"],
        }
    }
    return params, state


def import_encoder(sd, prefix="encoder"):
    """-> (params, state) for nn.autoencoder.Encoder."""
    p_fc1, s_fc1 = _dense_block(sd, f"{prefix}.fc1")
    p_fc2, s_fc2 = _dense_block(sd, f"{prefix}.fc2")
    params = {
        "c1": _conv(sd, f"{prefix}.c1"),
        "c2": _conv(sd, f"{prefix}.c2"),
        "c3": _conv(sd, f"{prefix}.c3"),
        "fc1": p_fc1,
        "fc2": p_fc2,
        "fc_z_out": _linear(sd, f"{prefix}.fc_z_out"),
    }
    return params, {"fc1": s_fc1, "fc2": s_fc2}


def import_decoder(sd, prefix="decoder"):
    p_fc1, s_fc1 = _dense_block(sd, f"{prefix}.fc1")
    p_fc2, s_fc2 = _dense_block(sd, f"{prefix}.fc2")
    params = {"fc1": p_fc1, "fc2": p_fc2}
    for i in (1, 2, 3, 4):
        params[f"dc{i}"] = _convT(sd, f"{prefix}.dc{i}")
    return params, {"fc1": s_fc1, "fc2": s_fc2}


def import_basic_ae(path):
    """Lightning BasicAE ckpt -> (params, state, hparams) in framework layout."""
    sd, hparams = _load_state_dict(path)
    pe, se = import_encoder(sd, "encoder")
    pd, sdd = import_decoder(sd, "decoder")
    return {"encoder": pe, "decoder": pd}, {"encoder": se, "decoder": sdd}, hparams


def import_roadmap(path):
    """Lightning roadmap ckpt (RoadMap/RoadMapBCE*, with `ae.encoder` backbone
    and `fc1` head — roadmap_bce_v2.py:43,50) -> (params, state, hparams)."""
    sd, hparams = _load_state_dict(path)
    pe, se = import_encoder(sd, "ae.encoder")
    params = {"encoder": pe, "fc1": _linear(sd, "fc1")}
    return params, {"encoder": se}, hparams


def convert_roadmap_ckpt(torch_path, out_path, extra_hparams=None):
    """rm.ckpt -> a framework .ckpt that cli/run_test.py (either package) loads."""
    params, state, hparams = import_roadmap(torch_path)
    hp = {"pretrained_path": None}
    hp.update({k: v for k, v in hparams.items() if isinstance(v, (int, float, str, bool))})
    # run_test rebuilds via RoadMapBCEv2 + embedded AE dims
    latent = params["fc1"]["w"].shape[0]
    hidden = params["encoder"]["fc_z_out"]["w"].shape[0]
    hp.setdefault("ae_latent_dim", int(latent))
    hp.setdefault("ae_hidden_dim", int(hidden))
    hp.update(extra_hparams or {})
    ckpt_io.save(out_path, params=params, state=state, hparams=hp,
                 meta={"source": str(torch_path), "format": "torch-lightning"})
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert a reference PyTorch Lightning ckpt")
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--kind", choices=["roadmap", "basic_ae"], default="roadmap")
    a = ap.parse_args(argv)
    if a.kind == "roadmap":
        convert_roadmap_ckpt(a.torch_ckpt, a.out)
    else:
        params, state, hparams = import_basic_ae(a.torch_ckpt)
        hp = {k: v for k, v in hparams.items() if isinstance(v, (int, float, str, bool))}
        ckpt_io.save(a.out, params=params, state=state, hparams=hp,
                     meta={"source": a.torch_ckpt, "format": "torch-lightning"})
    print(f"converted {a.torch_ckpt} -> {a.out}")


if __name__ == "__main__":
    main()

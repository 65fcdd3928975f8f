"""Weights between the JAX package's pytrees and this package's state_dicts.

The JAX package stores (params, state) pytrees of arrays (checkpoints/io.py);
this package's modules carry the same weights in PyTorch layouts, under the
same paths joined by dots:

  Conv2d     params {"w": HWIO, "b"}  <-> "<path>.weight" OIHW, "<path>.bias"
             (transpose 3, 2, 0, 1). The trunk kernel re-lays OIHW as HWIO
             itself, per call (kernels/trunk.py).
  Linear     params {"w": [in, out], "b"} <-> "<path>.weight" [out, in], ".bias"
  BatchNorm  params {"scale", "bias"} <-> "<path>.weight", "<path>.bias";
             state {"mean", "var"} <-> "<path>.running_mean", ".running_var"

This is the inverse of the JAX package's import of the reference's torch
checkpoints, restricted to the layer kinds this package has so far
(ConvTranspose2d comes with the Decoder).
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a):
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _params(tree, prefix, out):
    keys = set(tree)
    if keys in ({"w", "b"}, {"w"}) and not isinstance(tree["w"], dict):
        w = np.asarray(tree["w"])
        if w.ndim == 4:
            out[f"{prefix}weight"] = _tensor(w.transpose(3, 2, 0, 1))
        elif w.ndim == 2:
            out[f"{prefix}weight"] = _tensor(w.T)
        else:
            raise ValueError(f"{prefix}w: no layout for a {w.ndim}-d weight")
        if "b" in tree:
            out[f"{prefix}bias"] = _tensor(tree["b"])
    elif keys == {"scale", "bias"}:
        out[f"{prefix}weight"] = _tensor(tree["scale"])
        out[f"{prefix}bias"] = _tensor(tree["bias"])
    else:
        for k, v in tree.items():
            if not isinstance(v, dict):
                raise ValueError(f"{prefix}{k}: leaf outside a conv, linear or batch-norm node")
            _params(v, f"{prefix}{k}.", out)


def _state(tree, prefix, out):
    if set(tree) == {"mean", "var"}:
        out[f"{prefix}running_mean"] = _tensor(tree["mean"])
        out[f"{prefix}running_var"] = _tensor(tree["var"])
        return
    for k, v in tree.items():
        if not isinstance(v, dict):
            raise ValueError(f"{prefix}{k}: state leaf outside a batch-norm node")
        _state(v, f"{prefix}{k}.", out)


def from_jax(params, state=None) -> dict:
    """JAX (params, state) pytrees of arrays -> a state_dict of CPU tensors."""
    out: dict = {}
    _params(params, "", out)
    if state:
        _state(state, "", out)
    return out


def _put(tree, path, leaf):
    *parents, last = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = leaf


def to_jax(state_dict) -> tuple[dict, dict]:
    """A state_dict -> JAX (params, state) pytrees of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    params: dict = {}
    state: dict = {}
    for key, v in sd.items():
        prefix, _, name = key.rpartition(".")
        bn = f"{prefix}.running_mean" in sd
        if name == "running_mean":
            _put(state, f"{prefix}.mean", v)
        elif name == "running_var":
            _put(state, f"{prefix}.var", v)
        elif bn:
            _put(params, f"{prefix}.{'scale' if name == 'weight' else 'bias'}", v)
        elif name == "weight" and v.ndim == 4:
            _put(params, f"{prefix}.w", np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
        elif name == "weight" and v.ndim == 2:
            _put(params, f"{prefix}.w", np.ascontiguousarray(v.T))
        elif name == "bias":
            _put(params, f"{prefix}.b", v)
        else:
            raise ValueError(f"{key}: no JAX layout for this entry")
    return params, state

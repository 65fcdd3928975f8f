"""Weights between the JAX package's pytrees and this package's state_dicts.

The JAX package stores (params, state) pytrees of arrays (checkpoints/io.py);
this package's modules carry the same weights in PyTorch layouts, under the
same paths joined by dots:

  Conv2d           params {"w": HWIO, "b"} <-> "<path>.weight" OIHW, "<path>.bias"
                   (transpose 3, 2, 0, 1). The trunk kernel re-lays OIHW as
                   HWIO itself, per call (kernels/trunk.py).
  ConvTranspose2d  params {"w": HWIO [kh, kw, in, out], "b"} <-> "<path>.weight"
                   [in, out, kh, kw] (transpose 2, 3, 0, 1; no flip: the JAX
                   package flips the taps inside its apply, torch's
                   conv_transpose2d does the same internally).
  Linear           params {"w": [in, out], "b"} <-> "<path>.weight" [out, in], ".bias"
  BatchNorm        params {"scale", "bias"} <-> "<path>.weight", "<path>.bias";
                   state {"mean", "var"} <-> "<path>.running_mean", ".running_var"

A conv and a transposed conv weight are both 4-d, and a square one (the
32->32 `ss_deconv`) even has the same shape either way, so the layout is
never guessed from the array: the caller names the module paths that hold
a ConvTranspose2d (`transposed`, e.g. `transposed_paths(model)`), and every
other 4-d weight is a conv. `load_jax_weights` does this for a model.

This is the inverse of the JAX package's import of the reference's torch
checkpoints, restricted to the layer kinds this package has so far.
"""
from __future__ import annotations

import numpy as np
import torch

from driving_dirty_tpu_torch.core.layers import ConvTranspose2d

_CONV_TO_TORCH = (3, 2, 0, 1)   # HWIO -> OIHW
_CONV_TO_JAX = (2, 3, 1, 0)     # OIHW -> HWIO
_CONVT = (2, 3, 0, 1)           # HWIO <-> [in, out, kh, kw], either way


def _tensor(a):
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def transposed_paths(module) -> frozenset[str]:
    """Dotted paths of the ConvTranspose2d modules inside `module`."""
    return frozenset(name for name, m in module.named_modules() if isinstance(m, ConvTranspose2d))


def _params(tree, prefix, out, transposed, seen):
    keys = set(tree)
    if keys in ({"w", "b"}, {"w"}) and not isinstance(tree["w"], dict):
        w = np.asarray(tree["w"])
        path = prefix[:-1]
        if w.ndim == 4:
            perm = _CONVT if path in transposed else _CONV_TO_TORCH
            seen.add(path)
            out[f"{prefix}weight"] = _tensor(w.transpose(perm))
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
            _params(v, f"{prefix}{k}.", out, transposed, seen)


def _state(tree, prefix, out):
    if set(tree) == {"mean", "var"}:
        out[f"{prefix}running_mean"] = _tensor(tree["mean"])
        out[f"{prefix}running_var"] = _tensor(tree["var"])
        return
    for k, v in tree.items():
        if not isinstance(v, dict):
            raise ValueError(f"{prefix}{k}: state leaf outside a batch-norm node")
        _state(v, f"{prefix}{k}.", out)


def _check_transposed(transposed, seen):
    stray = set(transposed) - set(seen)
    if stray:
        raise KeyError(f"transposed-conv paths with no 4-d weight: {sorted(stray)}")


def from_jax(params, state=None, *, transposed=()) -> dict:
    """JAX (params, state) pytrees of arrays -> a state_dict of CPU tensors.
    `transposed`: the dotted paths whose 4-d weight is a ConvTranspose2d."""
    out: dict = {}
    seen: set = set()
    _params(params, "", out, frozenset(transposed), seen)
    _check_transposed(transposed, seen)
    if state:
        _state(state, "", out)
    return out


def _put(tree, path, leaf):
    *parents, last = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = leaf


def _jax_place(key, ndim, keys, transposed):
    """Where one state_dict entry goes in the JAX trees -> ("params" or
    "state", its dotted JAX path, the permutation from the torch layout to
    the JAX one or None). `keys`: the state_dict's keys (a BatchNorm is
    known by its running_mean)."""
    prefix, _, name = key.rpartition(".")
    if name == "running_mean":
        return "state", f"{prefix}.mean", None
    if name == "running_var":
        return "state", f"{prefix}.var", None
    if f"{prefix}.running_mean" in keys:
        return "params", f"{prefix}.{'scale' if name == 'weight' else 'bias'}", None
    if name == "weight" and ndim == 4:
        return "params", f"{prefix}.w", _CONVT if prefix in transposed else _CONV_TO_JAX
    if name == "weight" and ndim == 2:
        return "params", f"{prefix}.w", (1, 0)
    if name == "bias":
        return "params", f"{prefix}.b", None
    raise ValueError(f"{key}: no JAX layout for this entry")


def host_array(t, perm=None) -> np.ndarray:
    """A numpy copy of tensor `t` on the host, permuted by `perm`: a
    snapshot that later in-place writes to `t` do not reach. The permute
    runs on `t`'s device, where a card transposes far faster than numpy."""
    t = t.detach()
    if perm is None:
        return t.to("cpu", copy=True).numpy()
    return t.permute(perm).contiguous().cpu().numpy()  # contiguous() made the copy


def to_jax(state_dict, *, transposed=()) -> tuple[dict, dict]:
    """A state_dict -> JAX (params, state) pytrees of numpy arrays (host
    copies). `transposed`: the dotted paths whose 4-d weight is a
    ConvTranspose2d."""
    trees: dict = {"params": {}, "state": {}}
    seen: set = set()
    for key, v in state_dict.items():
        section, path, perm = _jax_place(key, v.ndim, state_dict, transposed)
        if v.ndim == 4:
            seen.add(key.rpartition(".")[0])
        _put(trees[section], path, host_array(v, perm))
    _check_transposed(transposed, seen)
    return trees["params"], trees["state"]


def param_places(model) -> list[tuple[str, str, tuple | None]]:
    """(the parameter's '/'-joined JAX name, its name in `model`, the
    permutation from its torch layout to the JAX one or None) for every
    parameter of `model`, sorted by JAX name (the argument order of the
    export programs, export.py)."""
    keys = model.state_dict(keep_vars=True)
    transposed = transposed_paths(model)
    placed = []
    for name, p in model.named_parameters():
        _, path, perm = _jax_place(name, p.ndim, keys, transposed)
        placed.append((path.replace(".", "/"), name, perm))
    return sorted(placed)


def param_layouts(model) -> list[tuple[str, tuple | None]]:
    """(parameter name, permutation from its torch layout to the JAX one or
    None) for every parameter of `model`, in the order jax.tree.leaves
    visits the JAX params tree (dict keys sorted at every level): the order
    of the per-parameter leaves of an optax state."""
    keys = model.state_dict(keep_vars=True)
    transposed = transposed_paths(model)
    placed = []
    for name, p in model.named_parameters():
        _, path, perm = _jax_place(name, p.ndim, keys, transposed)
        placed.append((tuple(path.split(".")), name, perm))
    return [(name, perm) for _, name, perm in sorted(placed)]


def model_to_jax(model) -> tuple[dict, dict]:
    """A module's weights -> JAX (params, state), transposed convs included."""
    return to_jax(model.state_dict(), transposed=transposed_paths(model))


def load_jax_weights(model, params, state=None, *, what="checkpoint"):
    """Fill `model` from JAX (params, state) pytrees, laying out each 4-d
    weight by the kind of module that owns it. A checkpoint without BN state
    keeps the fresh running stats, as the JAX package does; any other
    missing or unexpected entry raises KeyError naming `what`."""
    sd = from_jax(params, state, transposed=transposed_paths(model))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing if not k.endswith(("running_mean", "running_var"))]
    if bad or unexpected:
        raise KeyError(f"{what}: missing {bad}, unexpected {unexpected}")
    return model

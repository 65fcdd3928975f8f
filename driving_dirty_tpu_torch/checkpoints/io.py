"""Checkpoint save/load in the JAX package's npz format, without JAX.

Format (the same file either package writes and reads): one np.savez
archive holding every leaf of the {"params", "state", "opt_state", "extra"}
pytrees under a flattened "section/path/to/leaf" key, plus a "__meta__"
entry: the JSON of {"hparams", "meta"} stored as a uint8 array. Lists are
flattened with their indices as keys and come back as lists.

Leaves are numpy arrays; torch tensors are accepted on save and written as
their numpy values. Weights travel in the JAX layouts (HWIO convs, [in, out]
linears); checkpoints/convert.py maps them to and from a state_dict.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

_SEP = "/"
_META_KEY = "__meta__"


def _leaf(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif tree is None:
        pass
    else:
        out[prefix[: -len(_SEP)]] = _leaf(tree)
    return out


def _unflatten(flat):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node):
    """Convert dicts whose keys are 0..n-1 strings back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def _jsonable(obj):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


def save(path, *, params, state=None, opt_state=None, hparams=None, meta=None, extra=None):
    """Atomically write a checkpoint (tmp file + rename). `opt_state` is an
    ordered list of leaves; hparams a JSON-serializable dict or namespace."""
    payload = {"params": params}
    if state is not None:
        payload["state"] = state
    if opt_state is not None:
        payload["opt_state"] = list(opt_state)
    if extra is not None:
        payload["extra"] = extra
    flat = _flatten(payload)
    if hparams is not None and not isinstance(hparams, dict):
        hparams = dict(vars(hparams))
    meta_blob = json.dumps({"hparams": _jsonable(hparams), "meta": _jsonable(meta or {})})
    flat[_META_KEY] = np.frombuffer(meta_blob.encode(), dtype=np.uint8)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load(path):
    """-> dict with 'params', optional 'state'/'opt_state'/'extra', 'hparams', 'meta'."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode()) if _META_KEY in z.files else {}
    tree = _unflatten(flat)
    return {
        "params": tree.get("params", {}),
        "state": tree.get("state"),
        "opt_state": tree.get("opt_state"),
        "extra": tree.get("extra"),
        "hparams": meta.get("hparams"),
        "meta": meta.get("meta", {}),
    }

"""Checkpoint save/load in the JAX package's npz format, without JAX.

Format (the same file either package writes and reads): one np.savez
archive holding every leaf of the {"params", "state", "opt_state", "extra"}
pytrees under a flattened "section/path/to/leaf" key, plus a "__meta__"
entry: the JSON of {"hparams", "meta"} stored as a uint8 array. Lists are
flattened with their indices as keys and come back as lists.

Leaves are numpy arrays; torch tensors are accepted on save and written as
their numpy values. Weights travel in the JAX layouts (HWIO convs, [in, out]
linears); checkpoints/convert.py maps them to and from a state_dict.

"opt_state" is the ordered leaf list of the JAX trainer's optax state
(`opt_state_leaves`, `restore_opt_state`), so a checkpoint of either
trainer resumes in the other. `AsyncWriter` writes checkpoints on a
background thread.
"""
from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import zipfile

import numpy as np
import torch

from driving_dirty_tpu_torch.checkpoints.convert import host_array

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


def is_checkpoint(path) -> bool:
    """Whether `path` is a checkpoint in this format (an npz with the
    metadata entry), as opposed to, say, a torch.save file."""
    try:
        with zipfile.ZipFile(path) as z:
            return f"{_META_KEY}.npy" in z.namelist()
    except zipfile.BadZipFile:
        return False


def load(path, *, opt_state: bool = True):
    """-> dict with 'params', optional 'state'/'opt_state'/'extra', 'hparams',
    'meta'. opt_state=False leaves the optimizer leaves unread (None): what
    a caller that only needs the weights wants, as the Adam moments are
    twice their size."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files
                if k != _META_KEY and (opt_state or not k.startswith(f"opt_state{_SEP}"))}
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


class AsyncWriter:
    """Background checkpoint writer (driving_dirty_tpu/checkpoints/io.py:
    137-232): one worker thread runs `save`, so the file write overlaps the
    next training steps.

    The trainer's tensors change in place at the next step, so `save` takes
    host snapshots: numpy arrays, or tensors it copies to the host before
    returning. Saves to one path are written in order, and pending saves to
    the same path coalesce (the newest wins). `on_written` runs only after
    the file is on disk. A worker error is raised by the next `save`,
    `wait` or `close`: a failed checkpoint is never silent.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._pending: dict = {}  # path -> kwargs of the newest save enqueued
        self._lock = threading.Lock()
        self._exc = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            path = self._q.get()
            try:
                if path is None:
                    return
                with self._lock:
                    kwargs = self._pending.pop(path, None)
                if kwargs is None:
                    continue  # coalesced into a newer save of this path
                on_written = kwargs.pop("on_written", None)
                save(path, **kwargs)
                if on_written is not None:
                    on_written()
            except BaseException as e:  # noqa: BLE001 — raised by the next call
                self._exc = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def save(self, path, *, on_written=None, **kwargs):
        self._check()
        for k in ("params", "state", "opt_state", "extra"):
            if kwargs.get(k) is not None:
                kwargs[k] = _host_tree(kwargs[k])
        if on_written is not None:
            kwargs["on_written"] = on_written
        with self._lock:
            replacing = path in self._pending
            self._pending[path] = kwargs
        if not replacing:
            self._q.put(path)
        return path

    def wait(self):
        """Block until every enqueued checkpoint is on disk; raise its error."""
        self._q.join()
        self._check()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()


def _host_tree(tree):
    """A pytree with every tensor replaced by a host copy of it."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return host_array(tree) if isinstance(tree, torch.Tensor) else tree


# --- optimizer state as the JAX trainer's optax leaves ----------------------
#
# jax.tree.leaves of the JAX trainer's optimizer state
# (driving_dirty_tpu/train/trainer.py:217-237), for N parameter leaves:
#   inject_hyperparams(adam):  count, b1, b2, eps, eps_root, learning_rate,
#                              adam count, mu x N, nu x N          (6 + 2N + 1)
#   with clipping (inject_hyperparams(chain(clip_by_global_norm, adam))):
#                              count, learning_rate, adam count, mu x N, nu x N
#   under MultiSteps (accumulate_grad_batches > 1): mini_step, gradient_step,
#                              then the above, then acc_grads x N
# Per-parameter leaves follow the JAX params tree's flatten order and
# layouts (checkpoints/convert.py:param_layouts).


def param_leaves(layouts, tensors: dict) -> list:
    """Per-parameter tensors {name: tensor} -> host numpy copies in the JAX
    order and layouts of `layouts` (convert.param_layouts)."""
    return [host_array(tensors[name], perm) for name, perm in layouts]


def param_tensors(layouts, leaves) -> dict:
    """The inverse of `param_leaves`: -> {name: CPU tensor}."""
    out = {}
    for (name, perm), a in zip(layouts, leaves):
        a = np.asarray(a)
        if perm is not None:
            a = a.transpose(np.argsort(perm))
        out[name] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return out


def opt_state_leaves(opt, layouts) -> list:
    """The port's optimizer (train/optim.py:Adam) -> the leaf list the JAX
    trainer writes for the same configuration."""
    hyper = [np.float32(opt.lr)]
    if not opt.clip:
        hyper = [np.float32(v) for v in (opt.b1, opt.b2, opt.eps, opt.eps_root)] + hyper
    count = np.int32(opt.count)
    leaves = [count, *hyper, count, *param_leaves(layouts, opt.mu), *param_leaves(layouts, opt.nu)]
    if opt.every_k > 1:
        leaves = [np.int32(opt.mini_step), np.int32(opt.gradient_step), *leaves,
                  *param_leaves(layouts, opt.acc)]
    return leaves


def restore_opt_state(opt, layouts, leaves, shard=None) -> None:
    """Load a JAX-trainer leaf list (or one `opt_state_leaves` wrote) into
    `opt`. A leaf count that does not fit the optimizer's configuration
    raises, as the JAX trainer's restore does. `shard` ({name: whole
    tensor} -> this rank's blocks) cuts the moments for an optimizer over a
    'model'-sharded model."""
    shard = shard or (lambda tensors: tensors)
    n = len(layouts)
    n_hyper = 1 if opt.clip else 5
    expect = 2 + n_hyper + 2 * n + (2 + n if opt.every_k > 1 else 0)
    if len(leaves) != expect:
        raise ValueError(f"checkpointed opt_state has {len(leaves)} leaves; optimizer "
                         f"expects {expect} — optimizer config changed since save")
    leaves = list(leaves)
    if opt.every_k > 1:
        opt.mini_step, opt.gradient_step = int(leaves[0]), int(leaves[1])
        opt.load_moments(acc=shard(param_tensors(layouts, leaves[-n:])))
        leaves = leaves[2:-n]
    hyper = [float(v) for v in leaves[1:1 + n_hyper]]
    if not opt.clip:
        opt.b1, opt.b2, opt.eps, opt.eps_root = hyper[:4]
    opt.lr = hyper[-1]
    opt.count = int(leaves[1 + n_hyper])
    mu = leaves[2 + n_hyper:2 + n_hyper + n]
    nu = leaves[2 + n_hyper + n:]
    opt.load_moments(mu=shard(param_tensors(layouts, mu)), nu=shard(param_tensors(layouts, nu)))

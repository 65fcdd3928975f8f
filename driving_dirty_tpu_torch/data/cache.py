"""Decode-once sample cache (driving_dirty_tpu/data/cache.py): memmap-backed
items, in the JAX package's format, so either package reads a cache the
other wrote.

`SampleCache` wraps a map-style dataset whose items are fixed-shape numpy
pytrees (arrays, tuples or dicts: what `UnlabeledDataset` and
`LabeledDataset` give). The first access of an index decodes through the
wrapped dataset and writes the item into per-key `.npy` memmaps; every
later access, in this epoch, a later one or another process, is a memmap
row read: no JPEG decode, no CSV filter, no rasterization.

  * shared and persistent: the directory is keyed by `dataset_fingerprint`
    (class name and construction fields), so tasks reading the same split
    share one cache across runs;
  * incremental: a `valid.u8` bitmap marks the rows present, so a partial
    cache is valid and an interrupted `warm` resumes;
  * safe under the Loader's decode threads (disjoint-row writes; a racing
    duplicate decode of one index writes the same bytes), and across
    processes (creation is serialized by an flock);
  * exact: items round-trip bit for bit, except keys in `store_uint8`
    ({0,1}-valued float maps such as `road`), stored as uint8 and restored
    to their dtype, still exact because their values are integral.
"""
from __future__ import annotations

import fcntl
import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_META = "meta.json"
_VALID = "valid.u8"


def dataset_fingerprint(dataset) -> str:
    """Stable identity hash for a dataset instance (class + public fields).

    Two dataset objects with the same class and construction parameters map to
    the same cache directory; anything that changes item content (scene list,
    max_boxes, raw_uint8, extra_info, ...) changes the fingerprint.
    """
    parts = [type(dataset).__name__, str(len(dataset))]
    fields = getattr(dataset, "__dataclass_fields__", None)
    if fields:
        for name in sorted(fields):
            v = getattr(dataset, name)
            if isinstance(v, np.ndarray):
                v = v.tolist()
            parts.append(f"{name}={v!r}")
    else:  # non-dataclass: fall back to the public __dict__
        for name in sorted(vars(dataset)):
            if not name.startswith("_"):
                parts.append(f"{name}={getattr(dataset, name)!r}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def _flatten(item):
    """item -> (kind, {key: np.ndarray})."""
    if isinstance(item, dict):
        return "dict", {k: np.asarray(v) for k, v in item.items()}
    if isinstance(item, tuple):
        return "tuple", {f"t{i}": np.asarray(v) for i, v in enumerate(item)}
    return "array", {"arr": np.asarray(item)}


class SampleCache:
    """Map-style dataset wrapper: decode once, memmap thereafter."""

    def __init__(self, dataset, cache_dir: str, store_uint8: tuple = ("road", "lane")):
        self.dataset = dataset
        self.dir = os.path.join(cache_dir, dataset_fingerprint(dataset))
        self.store_uint8 = tuple(store_uint8)
        self._lock = threading.Lock()
        self._mm: dict[str, np.memmap] | None = None
        self._valid = None
        self._meta = None
        self.hits = 0
        self.misses = 0
        os.makedirs(self.dir, exist_ok=True)
        meta_path = os.path.join(self.dir, _META)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta["len"] != len(dataset):
                raise ValueError(
                    f"cache at {self.dir} was built for a dataset of length "
                    f"{meta['len']}, got {len(dataset)}"
                )
            self._open(meta, mode="r+")

    # -- storage ----------------------------------------------------------
    def _open(self, meta, mode):
        mm = {}
        for k in meta["keys"]:
            mm[k] = np.lib.format.open_memmap(
                os.path.join(self.dir, f"{k}.npy"),
                mode=mode,
                dtype=np.dtype(meta["store_dtype"][k]),
                shape=(meta["len"], *meta["shape"][k]),
            )
        valid_path = os.path.join(self.dir, _VALID)
        valid = np.memmap(valid_path, dtype=np.uint8, mode=mode, shape=(meta["len"],))
        # publication order matters for racing reader threads: _mm last, since
        # the miss path keys on it ("_mm is None" -> init) and the hit path
        # only fires after a writer sets valid[i]=1 (which needs _mm).
        self._meta = meta
        self._valid = valid
        self._mm = mm

    def _init_from(self, item):
        with self._lock:
            if self._mm is not None:
                return
            # Cross-process guard: concurrent runs (parallel trials) share one
            # cache dir, and two processes cold-starting against an
            # empty cache would otherwise BOTH run open_memmap(mode="w+") —
            # truncating files the other already mapped and is writing (rows
            # silently zeroed, or SIGBUS on a write landing between truncate
            # and re-extension). An exclusive flock serializes creation, and
            # the meta re-check under the lock attaches (r+) to a cache a
            # sibling just created instead of clobbering it.
            meta_path = os.path.join(self.dir, _META)
            with open(os.path.join(self.dir, ".init.lock"), "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    if os.path.exists(meta_path):
                        with open(meta_path) as f:
                            meta = json.load(f)
                        self._open(meta, mode="r+")
                        return
                    kind, flat = _flatten(item)
                    meta = {
                        "version": 1,
                        "len": len(self.dataset),
                        "kind": kind,
                        "keys": list(flat),
                        "shape": {k: list(v.shape) for k, v in flat.items()},
                        "dtype": {k: v.dtype.str for k, v in flat.items()},
                        "store_dtype": {
                            k: ("|u1" if k in self.store_uint8 and v.dtype.kind == "f" else v.dtype.str)
                            for k, v in flat.items()
                        },
                    }
                    self._open(meta, mode="w+")
                    # meta written last (still under the lock): a crash
                    # mid-create leaves no meta -> rebuilt; a sibling never
                    # sees meta before the files are fully sized
                    with open(meta_path, "w") as f:
                        json.dump(meta, f)
                finally:
                    fcntl.flock(lf, fcntl.LOCK_UN)

    def _write(self, index, item):
        _, flat = _flatten(item)
        for k, v in flat.items():
            self._mm[k][index] = v.astype(self._mm[k].dtype, copy=False)
        self._valid[index] = 1

    def _read(self, index):
        meta = self._meta
        flat = {
            k: np.asarray(self._mm[k][index]).astype(np.dtype(meta["dtype"][k]), copy=False)
            for k in meta["keys"]
        }
        if meta["kind"] == "dict":
            return flat
        if meta["kind"] == "tuple":
            return tuple(flat[f"t{i}"] for i in range(len(flat)))
        return flat["arr"]

    # -- dataset protocol ---------------------------------------------------
    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        index = int(index)
        if self._valid is not None and self._valid[index]:
            self.hits += 1
            return self._read(index)
        self.misses += 1
        item = self.dataset[index]
        if self._mm is None:
            self._init_from(item)
        self._write(index, item)
        return item

    # -- utilities ----------------------------------------------------------
    @property
    def fraction_cached(self) -> float:
        if self._valid is None:
            return 0.0
        return float(np.mean(self._valid))

    def warm(self, num_workers: int = 8):
        """Prefill every missing row with a thread pool; returns #decoded."""
        missing = (
            range(len(self)) if self._valid is None
            else [i for i in range(len(self)) if not self._valid[i]]
        )
        missing = list(missing)
        if missing:
            with ThreadPoolExecutor(max(1, num_workers)) as pool:
                for _ in pool.map(self.__getitem__, missing):
                    pass
        return len(missing)

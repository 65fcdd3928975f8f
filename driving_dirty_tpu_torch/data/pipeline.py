"""Host decode pool and device prefetch (driving_dirty_tpu/data/pipeline.py).

  * `Loader`: a thread pool decodes items concurrently (PIL releases the
    GIL in its decode loop) into fixed-shape NHWC numpy batches; the final
    partial batch is padded and masked, so every batch has the same shapes.
    Under a mesh, `shard` makes a data-parallel rank decode only its rows
    of each global batch (training), or only its whole batches
    (validation); the index order stays a function of (seed, epoch).
  * `device_prefetch`: keeps batches in flight on the device. On CUDA a
    staging thread copies each batch into pinned host memory, so the
    consumer's thread only queues `non_blocking=True` copies, which overlap
    the work queued before them.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class _ProducerError:
    def __init__(self, exc):
        self.exc = exc


def _stack(items):
    """Stack a list of dataset items (arrays, tuples, or dicts) into a batch."""
    first = items[0]
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return tuple(np.stack([it[i] for it in items]) for i in range(len(first)))
    return np.stack(items)


class Loader:
    """Minimal map-style-dataset batch loader with threaded decode.

    Yields (batch, mask) where mask is a [batch_size] bool validity vector
    (False rows are pad copies in the final partial batch). With
    drop_last=True, partial batches are dropped instead.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        seed: int = 0,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self._epoch = 0
        self._external_epoch = None
        self._skip_batches = 0
        self._shard = None

    def shard(self, rank: int, size: int, whole_batches: bool = False):
        """Data-parallel rank `rank` of `size`: yield its rows of every
        global batch (the batch size must divide by `size`; the padded tail
        is padded before the split), or with `whole_batches` the global
        batches rank, rank + size, ... whole. Ranks of one 'model' group
        pass the same rank and so take the same rows."""
        if size > 1 and not whole_batches and self.batch_size % size:
            raise ValueError(f"a global batch of {self.batch_size} does not divide over "
                             f"{size} data-parallel ranks")
        self._shard = (int(rank), int(size), bool(whole_batches)) if size > 1 else None

    def set_epoch(self, epoch: int, base_seed: int | None = None, skip_batches: int = 0):
        """Pin the shuffle order to (base_seed, epoch) for exact resume;
        `skip_batches` fast-forwards past batches a resumed run consumed."""
        self._external_epoch = int(epoch)
        if base_seed is not None:
            self.seed = int(base_seed)
        self._skip_batches = int(skip_batches)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            epoch = self._external_epoch if self._external_epoch is not None else self._epoch
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def __iter__(self):
        idx = self._index_order()
        if self._external_epoch is None:
            self._epoch += 1
        bs = self.batch_size
        n_full = len(idx) // bs
        batches = [idx[i * bs : (i + 1) * bs] for i in range(n_full)]
        rem = idx[n_full * bs :]
        if len(rem) and not self.drop_last:
            batches.append(rem)
        if self._skip_batches:
            batches = batches[self._skip_batches :]
            self._skip_batches = 0
        rows = slice(None)
        if self._shard is not None:
            rank, size, whole = self._shard
            if whole:
                batches = batches[rank::size]
            else:
                k = bs // size
                rows = slice(rank * k, (rank + 1) * k)

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def produce():
            # A producer exception is forwarded to the consumer and re-raised
            # there: a silently dead producer would deadlock out_q.get().
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        # pad the final batch with its last item, mask the copies
                        mask = np.arange(bs) < len(b)
                        idx = np.concatenate([b, np.repeat(b[-1:], bs - len(b))])[rows]
                        k = max(1, int(mask[rows].sum()))  # valid rows come first
                        items = list(pool.map(self.dataset.__getitem__, idx[:k]))
                        items += [items[-1]] * (len(idx) - k)
                        out_q.put((_stack(items), mask[rows]))
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                out_q.put(_ProducerError(e))
                return
            out_q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # drain so a blocked producer can observe `stop` and exit
            while not out_q.empty():
                out_q.get_nowait()


def tree_map(fn, tree):
    """fn over the leaves of a pytree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _pinned(a):
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory()


def _staged(iterator, size: int):
    """Items of `iterator` with their arrays in pinned host memory, made on
    a staging thread at most `size` items ahead of the consumer."""
    out_q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def stage():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                put(tree_map(_pinned, item))
            put(None)
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            put(_ProducerError(e))
        finally:
            if hasattr(iterator, "close"):
                iterator.close()

    t = threading.Thread(target=stage, daemon=True)
    t.start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        t.join()


def device_prefetch(iterator, device, size: int = 2):
    """Keep `size` batches in flight on `device` ahead of the consumer.
    Items are pytrees of numpy arrays; they come out as tensors."""
    device = torch.device(device)
    if device.type == "cuda":
        items = (tree_map(lambda t: t.to(device, non_blocking=True), item)
                 for item in _staged(iterator, size))
    else:
        items = (tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device), item)
                 for item in iterator)
    buf = []
    for item in items:
        buf.append(item)
        if len(buf) > size:
            yield buf.pop(0)
    yield from buf

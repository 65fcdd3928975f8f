"""Host decode pool and device prefetch (driving_dirty_tpu/data/pipeline.py).

  * `Loader`: a thread pool decodes items concurrently (PIL releases the
    GIL in its decode loop) into fixed-shape NHWC numpy batches; the final
    partial batch is padded and masked, so every batch has the same shapes.
  * `device_prefetch`: keeps batches in flight on the device: each array is
    copied from pinned host memory with `non_blocking=True`, so the copy
    overlaps the work queued before it.
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
                        items = list(pool.map(self.dataset.__getitem__, b))
                        mask = np.ones(bs, bool)
                        if len(items) < bs:  # pad final batch, mask the copies
                            mask[len(items) :] = False
                            items = items + [items[-1]] * (bs - len(items))
                        out_q.put((_stack(items), mask))
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


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(iterator, device, size: int = 2):
    """Keep `size` batches in flight on `device` ahead of the consumer.
    Items are pytrees of numpy arrays; they come out as tensors."""
    device = torch.device(device)
    buf = []
    for item in iterator:
        buf.append(_to_device(item, device))
        if len(buf) > size:
            yield buf.pop(0)
    yield from buf

# Ported from horovod_tpu/data/__init__.py:1-210: AsyncDataLoaderMixin
# (:26-94) is copied; shard_indices (:97-117) is the same recipe;
# ShardedBatchIterator (:120-182) is in its per-process mode always and
# yields torch tensors; prefetch_to_device (:185-210) copies on a side CUDA
# stream in place of jax.device_put.
"""Data-loading helpers: rank sharding and async prefetch.

Parity: reference ``horovod/data/data_loader_base.py``
(``AsyncDataLoaderMixin`` — SURVEY.md §2b P13) plus the shard-per-rank
pattern every Horovod example implements by hand
(``DistributedSampler(num_replicas=hvd.size(), rank=hvd.rank())``).

One process is one rank here, so ``ShardedBatchIterator`` yields this
rank's batches of ``batch_size`` rows (the JAX package's single-controller
global batches have no counterpart).  ``prefetch_to_device`` overlaps the
host-to-card copy with compute: each batch is pinned, copied on a side
CUDA stream, and handed to the consumer's stream behind an event.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..common import basics


# Copied from horovod_tpu/data/__init__.py:26-94.
class AsyncDataLoaderMixin:
    """Mix into a loader class to move ``__iter__`` production onto a
    background thread with a bounded prefetch queue.

    Reference-compatible surface: ``async_loader_queue_size`` (0 disables),
    ``close_async_loader()``.  Mix first:
    ``class MyLoader(AsyncDataLoaderMixin, BaseLoader)``.
    """

    def __init__(self, *args, async_loader_queue_size: int = 64, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        self._async_queue: Optional[queue.Queue] = None
        self._async_thread: Optional[threading.Thread] = None
        self._async_stop = threading.Event()
        super().__init__(*args, **kwargs)

    def _async_worker(self, q: queue.Queue, stop: threading.Event):
        # q/stop are THIS iteration's, passed by value: a producer that
        # outlives close_async_loader's join can only ever touch its own
        # (abandoned) queue, never a newer iteration's.
        try:
            for item in super().__iter__():
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as exc:  # noqa: BLE001 - surfaced to consumer
            q.put(_Raise(exc))
        finally:
            q.put(_SENTINEL)

    def __iter__(self):
        if self.async_loader_queue_size <= 0:
            yield from super().__iter__()
            return
        self.close_async_loader()
        self._async_stop = threading.Event()
        self._async_queue = queue.Queue(maxsize=self.async_loader_queue_size)
        self._async_thread = threading.Thread(
            target=self._async_worker,
            args=(self._async_queue, self._async_stop), daemon=True)
        self._async_thread.start()
        while True:
            item = self._async_queue.get()
            if item is _SENTINEL:
                break
            if isinstance(item, _Raise):
                raise item.exc
            yield item

    def close_async_loader(self):
        """Stop the background producer (reference API)."""
        if self._async_thread is None:
            return
        self._async_stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self._async_queue.get_nowait()
        except queue.Empty:
            pass
        self._async_thread.join(timeout=10)
        self._async_thread = None


class _Raise:
    def __init__(self, exc):
        self.exc = exc


_SENTINEL = object()


def _world():
    """(rank, size): this process's, or (0, 1) before ``init()``."""
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


def shard_indices(n: int, rank: Optional[int] = None,
                  size: Optional[int] = None, shuffle: bool = True,
                  seed: int = 0, drop_remainder: bool = True) -> np.ndarray:
    """This rank's sample indices — the ``DistributedSampler`` recipe.

    Every rank gets the SAME number of samples (equal per-rank lengths are
    what keeps per-batch collectives in lockstep): ``drop_remainder=True``
    truncates to ``n // size`` per rank; ``False`` pads by wrapping around,
    exactly like ``torch.utils.data.DistributedSampler``.
    """
    rank = basics.rank() if rank is None else rank
    size = basics.size() if size is None else size
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    if drop_remainder:
        per = n // size
        return idx[rank * per:(rank + 1) * per]
    total = -(-n // size) * size  # ceil
    idx = np.concatenate([idx, idx[:total - n]])
    return idx[rank:total:size]


class ShardedBatchIterator:
    """Iterate this rank's batches of ``batch_size`` rows of numpy arrays,
    as tuples of CPU tensors (``torch.from_numpy`` of the selected rows).

    The rows are this rank's :func:`shard_indices`, reshuffled by
    ``set_epoch``; before ``init()`` the whole array is one shard.
    ``drop_remainder=False`` keeps the tail as a short final batch.
    """

    def __init__(self, arrays, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = True):
        self.arrays = [np.asarray(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("ShardedBatchIterator: the arrays differ in "
                             "length")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rank, size = _world()
        idx = shard_indices(len(self.arrays[0]), rank, size,
                            shuffle=self.shuffle, seed=self.seed + self.epoch,
                            drop_remainder=self.drop_remainder)
        bs = self.batch_size
        stop = (len(idx) - len(idx) % bs) if self.drop_remainder else len(idx)
        for i in range(0, stop, bs):
            sel = idx[i:i + bs]
            yield tuple(torch.from_numpy(a[sel]) for a in self.arrays)

    def __len__(self):
        _, size = _world()
        n = len(self.arrays[0])
        shard = n // size if self.drop_remainder else -(-n // size)
        bs = self.batch_size
        return shard // bs if self.drop_remainder else -(-shard // bs)


def _map(fn, batch):
    """``fn`` over the array leaves of a batch of dicts, lists and tuples."""
    if isinstance(batch, dict):
        return type(batch)((k, _map(fn, v)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device=None) -> Iterator:
    """Overlap the host-to-card copy with compute: keep ``size`` batches
    in flight on ``device`` (``hvd.device()`` by default).

    A batch is a tensor, a numpy array, or dicts, lists and tuples of them.
    On a CUDA device each host leaf is pinned (``pin_memory()``, on the
    calling thread) and copied with ``non_blocking=True`` on one side
    ``torch.cuda.Stream``, which then records an event; when the batch is
    yielded, the consumer's current stream waits on that event, and each of
    its tensors is marked used there (``record_stream``), so that the
    caching allocator does not hand the buffer to another tensor while the
    consumer's kernels read it.  On the CPU the batches are yielded as
    they are (numpy leaves as tensors over the same memory).  A CUDA device
    without a card raises, as ``init()`` does.
    """
    dev = basics.device() if device is None else torch.device(device)
    if dev.type != "cuda":
        return _lookahead(iterator, size, lambda b: _map(_tensor, b))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "prefetch_to_device: no CUDA device is available for "
            f"{dev}; pass device='cpu' to keep the batches on the host")
    return _prefetch_cuda(iterator, size, dev)


def _lookahead(iterator: Iterable, size: int, put) -> Iterator:
    """Yield ``put(batch)`` for each batch, ``size`` of them started ahead
    of the one yielded (``:198-210`` of the origin)."""
    buf = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out


def _prefetch_cuda(iterator: Iterable, size: int,
                   dev: torch.device) -> Iterator:
    side = torch.cuda.Stream(dev)

    def put(batch):
        def copy(x):
            t = _tensor(x)
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)

        with torch.cuda.stream(side):
            out = _map(copy, batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    for out, done in _lookahead(iterator, size, put):
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        _map(lambda t: t.record_stream(current), out)
        yield out

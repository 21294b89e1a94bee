"""Sharded and prefetching data loaders.

The port's copy of ``horovod_tpu/data/loader.py`` (reference:
horovod/data/data_loader_base.py): ``BaseDataLoader`` is the iterator
contract, ``AsyncDataLoaderMixin`` moves batch production onto a
background thread with a bounded queue, and ``ShardedBatchLoader`` and
``StoreShardReader`` yield the reference's index sequences for the same
seed, epoch, rank and replica count (numpy code, as there).
``prefetch_to_device`` is the card's own pipeline: pinned host memory,
``non_blocking`` copies on a CUDA stream of their own, and the step's
stream waiting on each batch's copies.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch

from ..common.device import resolve_device


class BaseDataLoader:
    """Iterator contract (reference: data_loader_base.py BaseDataLoader)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self._iterate()


class AsyncDataLoaderMixin:
    """Prefetch batches on a background thread
    (reference: data_loader_base.py:48-130 AsyncDataLoaderMixin).

    Mix in BEFORE the loader class::

        class AsyncLoader(AsyncDataLoaderMixin, MyLoader): ...
    """

    def __init__(self, *args, async_loader_queue_size: int = 4,
                 **kwargs) -> None:
        self.async_loader_queue_size = async_loader_queue_size
        super().__init__(*args, **kwargs)

    def _iterate(self) -> Iterator[Any]:
        if self.async_loader_queue_size <= 0:
            yield from super()._iterate()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.async_loader_queue_size)
        done = object()
        stop = threading.Event()
        err: list[BaseException] = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for item in super(AsyncDataLoaderMixin, self)._iterate():
                    if not _put(item):
                        return     # consumer abandoned the iterator
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                err.append(e)
            finally:
                _put(done)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="hvd-data-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
        finally:
            # Early exit (break in the consumer loop): unblock and retire
            # the producer instead of leaking one thread per epoch.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)
        if err:
            raise err[0]


def _replica_indices(n: int, rank: int, num_replicas: int,
                     shuffle: bool, rng) -> np.ndarray:
    """This rank's row indices, PADDED so every rank gets exactly
    ceil(n/num_replicas) rows (indices wrap — the torch
    DistributedSampler contract).  Equal per-rank row counts are what
    keep per-rank step counts aligned: a rank with one extra batch would
    block forever in its collective."""
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    per = -(-n // num_replicas)
    total = per * num_replicas
    if total > n:
        idx = np.concatenate([idx, idx[:total - n]])
    return idx[rank::num_replicas]


def _batch_count(rows: int, batch_size: int, drop_last: bool) -> int:
    if drop_last:
        return rows // batch_size
    return -(-rows // batch_size)


def _iter_batches(idx: np.ndarray, batch_size: int,
                  drop_last: bool) -> Iterator[np.ndarray]:
    stop = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for start in range(0, stop, batch_size):
        yield idx[start:start + batch_size]


class ShardedBatchLoader(BaseDataLoader):
    """Batches a numpy dataset dict, sharded by rank: each rank of a
    Trainer's world or of an eager world loads its own rows.

    ``data``: dict of equal-first-dim numpy arrays, e.g. {"image":…,
    "label":…}.  With ``rank``/``num_replicas`` each process sees its
    padded strided shard — the reference's DistributedSampler contract
    (wrapped indices keep per-rank step counts identical).
    """

    def __init__(self, data: dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 rank: int = 0, num_replicas: int = 1) -> None:
        self.data = data
        first = next(iter(data.values()))
        self.n = int(first.shape[0])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.rank = rank
        self.num_replicas = num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        per_rank = -(-self.n // self.num_replicas)   # padded: rank-uniform
        return _batch_count(per_rank, self.batch_size, self.drop_last)

    def _iterate(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = _replica_indices(self.n, self.rank, self.num_replicas,
                               self.shuffle, rng)
        for sel in _iter_batches(idx, self.batch_size, self.drop_last):
            yield {k: v[sel] for k, v in self.data.items()}


def _host_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


class _CardBatch:
    """One batch on its way to the card: its tensors (allocated on the
    copy stream), the event recorded after their copies, and the pinned
    host tensors they were copied from."""

    def __init__(self, batch: dict, device: torch.device,
                 stream: "torch.cuda.Stream") -> None:
        self.host = {k: _host_tensor(v).pin_memory()
                     for k, v in batch.items()}
        with torch.cuda.stream(stream):
            self.tensors = {k: t.to(device, non_blocking=True)
                            for k, t in self.host.items()}
            self.ready = torch.cuda.Event()
            self.ready.record(stream)

    def take(self, device: torch.device) -> dict:
        """The batch for the current stream: it waits on the copies, and
        each tensor is marked as used there, so its memory is not reused
        under the step."""
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(self.ready)
        for t in self.tensors.values():
            t.record_stream(consumer)
        return self.tensors


def prefetch_to_device(iterator: Iterable[dict], size: int = 2,
                       sharding: Any | None = None,
                       device: str | torch.device | None = None
                       ) -> Iterator[dict]:
    """Device-prefetch pipeline: keep ``size`` batches in flight on the
    card so the input pipeline overlaps the training step.

    Each batch (a dict of arrays) is copied into pinned host memory, then
    to the card with ``non_blocking`` copies on a CUDA stream of its own;
    the consumer's stream waits on the copies' event before it uses the
    batch.  ``device=None`` is the card, and raises without one;
    ``device="cpu"`` yields the batches as CPU tensors.  ``sharding``,
    the reference's global-batch layout over a mesh, has no counterpart:
    each rank takes its shard from ``ShardedBatchLoader(rank=,
    num_replicas=)``, so a value raises."""
    if sharding is not None:
        raise ValueError(
            "prefetch_to_device takes no sharding: each rank loads its own "
            "shard (ShardedBatchLoader(rank=, num_replicas=))")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _prefetch(iterator, size, dev)


def _prefetch(iterator: Iterable[dict], size: int,
              dev: torch.device) -> Iterator[dict]:
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    buf: collections.deque = collections.deque()
    it = iter(iterator)

    def _put(batch: dict) -> None:
        if stream is None:
            buf.append({k: _host_tensor(v) for k, v in batch.items()})
        else:
            buf.append(_CardBatch(batch, dev, stream))

    # Prime the pipeline.
    primed = 0
    for _ in range(size):
        try:
            _put(next(it))
            primed += 1
        except StopIteration:
            break

    while primed:
        out = buf.popleft()
        primed -= 1
        try:
            _put(next(it))
            primed += 1
        except StopIteration:
            pass
        yield out if stream is None else out.take(dev)


# ---------------------------------------------------------------------------
# Store-backed shard reader (the petastorm-reader slot)
# ---------------------------------------------------------------------------
def write_dataset_shards(store, base_path: str,
                         data: dict[str, np.ndarray],
                         num_shards: int = 8) -> list[str]:
    """Split a dataset dict into ``num_shards`` npz shards behind a Store
    (reference analogue: materializing the DataFrame to parquet row
    groups, spark/common/util.py); returns the shard keys in order."""
    n = int(next(iter(data.values())).shape[0])
    bounds = np.linspace(0, n, num_shards + 1).astype(int)
    keys = []
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        if lo == hi:
            continue
        key = store.join(base_path, f"shard_{s:05d}.npz")
        store.save_npz(key, **{k: v[lo:hi] for k, v in data.items()})
        keys.append(key)
    return keys


class StoreShardReader(BaseDataLoader):
    """Streams a dataset living as npz shards behind a :class:`Store`
    (filesystem or network blob) — the petastorm-backed loader's slot
    (reference: spark/data_loaders/pytorch_data_loaders.py over
    spark/common/store.py).

    One shard is resident at a time (the row-group memory contract:
    O(shard), not O(dataset)); shard ORDER shuffles per epoch, rows
    within each shard are padded-strided across ranks (the same wrapped
    DistributedSampler contract as ShardedBatchLoader — every rank gets
    identical step counts, the collective-lockstep requirement), and rows
    shuffle within the shard.  ``drop_last`` defaults True so a step
    never sees a ragged tail batch.  Compose with
    ``AsyncDataLoaderMixin`` for background prefetch."""

    def __init__(self, store, shard_keys: Sequence[str], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 rank: int = 0, num_replicas: int = 1,
                 drop_last: bool = True,
                 shard_rows: Sequence[int] | None = None) -> None:
        self.store = store
        self.shard_keys = list(shard_keys)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.num_replicas = num_replicas
        self.drop_last = drop_last
        self.epoch = 0
        self._shard_rows: list[int] | None = \
            list(shard_rows) if shard_rows is not None else None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rows(self) -> list[int]:
        if self._shard_rows is None:
            # One pass over the shards (loads each blob once; pass
            # shard_rows to the constructor to avoid it on remote stores).
            self._shard_rows = [
                int(next(iter(blob[k] for k in blob.files)).shape[0])
                for blob in (self.store.load_npz(key)
                             for key in self.shard_keys)]
        return self._shard_rows

    def __len__(self) -> int:
        return sum(
            _batch_count(-(-rows // self.num_replicas), self.batch_size,
                         self.drop_last)
            for rows in self._rows())

    def _iterate(self) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(self.shard_keys))
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        for si in order:
            blob = self.store.load_npz(self.shard_keys[si])
            arrays = {k: blob[k] for k in blob.files}
            n = int(next(iter(arrays.values())).shape[0])
            idx = _replica_indices(n, self.rank, self.num_replicas,
                                   self.shuffle, rng)
            for sel in _iter_batches(idx, self.batch_size,
                                     self.drop_last):
                yield {k: v[sel] for k, v in arrays.items()}

"""The port's data loaders (``horovod_tpu_torch/data/``) on the CPU.

``tests/test_data.py``'s cases on the port, and each loader's batches
against the JAX package's loader for the same seed, epoch, rank and
replica count, bitwise: ``ShardedBatchLoader``, ``StoreShardReader``
over a ``FilesystemStore`` and over a ``RemoteBlobStore`` on the port's
``RendezvousServer``, and both through ``AsyncDataLoaderMixin``.
``prefetch_to_device(device="cpu")`` yields the same batches as CPU
tensors; without a card, ``device=None`` raises.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu import spark as jspark
from horovod_tpu_torch import spark as tspark
from horovod_tpu_torch.data import (AsyncDataLoaderMixin, ShardedBatchLoader,
                                    StoreShardReader, prefetch_to_device,
                                    write_dataset_shards)


def _dataset(n=32):
    return {"image": np.arange(n * 4, dtype=np.float32).reshape(n, 4),
            "label": np.arange(n, dtype=np.int32)}


class AsyncLoader(AsyncDataLoaderMixin, ShardedBatchLoader):
    pass


class TestShardedBatchLoader:
    def test_batches_cover_dataset(self):
        loader = ShardedBatchLoader(_dataset(), batch_size=8, shuffle=False)
        batches = list(loader)
        assert len(batches) == len(loader) == 4
        seen = np.concatenate([b["label"] for b in batches])
        np.testing.assert_array_equal(np.sort(seen), np.arange(32))

    def test_rank_sharding_is_disjoint_and_complete(self):
        loaders = [ShardedBatchLoader(_dataset(), batch_size=4,
                                      shuffle=True, seed=7, rank=r,
                                      num_replicas=2) for r in range(2)]
        seen = [np.concatenate([b["label"] for b in ld]) for ld in loaders]
        assert set(seen[0]) & set(seen[1]) == set()
        assert set(seen[0]) | set(seen[1]) == set(range(32))

    def test_epoch_changes_shuffle(self):
        loader = ShardedBatchLoader(_dataset(), batch_size=32, seed=1)
        first = next(iter(loader))["label"].copy()
        loader.set_epoch(1)
        second = next(iter(loader))["label"]
        assert not np.array_equal(first, second)

    def test_drop_last(self):
        loader = ShardedBatchLoader(_dataset(30), batch_size=8,
                                    shuffle=False, drop_last=True)
        assert len(loader) == 3
        assert sum(1 for _ in loader) == 3

    def test_len_matches_iteration_with_uneven_shards(self):
        for n, replicas, bs, drop in [(33, 2, 16, False), (33, 2, 16, True),
                                      (30, 4, 4, False), (31, 3, 5, True)]:
            data = {"label": np.arange(n)}
            for rank in range(replicas):
                loader = ShardedBatchLoader(data, batch_size=bs,
                                            shuffle=False, drop_last=drop,
                                            rank=rank, num_replicas=replicas)
                assert len(loader) == sum(1 for _ in loader)


LOADER_CASES = [  # (n, batch, shuffle, seed, epoch, replicas, drop_last)
    (32, 4, True, 7, 0, 2, True), (33, 5, True, 3, 2, 3, False),
    (30, 4, False, 0, 1, 4, False), (64, 8, True, 11, 5, 1, True),
    (23, 3, True, 2, 3, 4, True)]


@pytest.mark.parametrize("case", LOADER_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_sharded_batches_are_the_references(case):
    n, bs, shuffle, seed, epoch, replicas, drop = case
    data = _dataset(n)
    for rank in range(replicas):
        kw = dict(batch_size=bs, shuffle=shuffle, seed=seed, rank=rank,
                  num_replicas=replicas, drop_last=drop)
        port = ShardedBatchLoader(data, **kw)
        ref = jdata.ShardedBatchLoader(data, **kw)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(port) == len(ref) == len(got) == len(want)
        for a, b in zip(got, want):
            for k in data:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        asynchronous = AsyncLoader(data, async_loader_queue_size=2, **kw)
        asynchronous.set_epoch(epoch)
        for a, b in zip(asynchronous, want):
            np.testing.assert_array_equal(a["label"], b["label"])


def test_async_same_batches_as_sync():
    sync = ShardedBatchLoader(_dataset(), batch_size=8, shuffle=False)
    async_ = AsyncLoader(_dataset(), batch_size=8, shuffle=False,
                         async_loader_queue_size=2)
    for a, b in zip(sync, async_):
        np.testing.assert_array_equal(a["label"], b["label"])


def test_producer_error_propagates(monkeypatch):
    orig = ShardedBatchLoader._iterate

    def failing(self):
        yield from orig(self)
        raise RuntimeError("boom")

    monkeypatch.setattr(ShardedBatchLoader, "_iterate", failing)
    loader = AsyncLoader(_dataset(4), batch_size=2, shuffle=False,
                         async_loader_queue_size=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(loader)


def test_prefetch_to_device_on_the_cpu():
    loader = ShardedBatchLoader(_dataset(), batch_size=8, seed=4)
    want = list(ShardedBatchLoader(_dataset(), batch_size=8, seed=4))
    for size in (1, 2, 8):
        got = list(prefetch_to_device(loader, size=size, device="cpu"))
        assert len(got) == 4
        for a, b in zip(got, want):
            for k in b:
                assert isinstance(a[k], torch.Tensor)
                assert a[k].device.type == "cpu"
                np.testing.assert_array_equal(a[k].numpy(), b[k])
    # The reference's global-batch layout has no counterpart.
    with pytest.raises(ValueError, match="no sharding"):
        prefetch_to_device(loader, sharding=object(), device="cpu")


def test_prefetch_to_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefetch_to_device(iter([]))


class TestStoreShardReader:
    def _data(self, n=40):
        return {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
                "y": np.arange(n, dtype=np.int32)}

    def _roundtrip(self, store, ref_store):
        data = self._data()
        base = store.get_train_data_path("run1")
        keys = write_dataset_shards(store, base, data, num_shards=4)
        assert len(keys) == 4
        ref_keys = jdata.write_dataset_shards(
            ref_store, ref_store.get_train_data_path("run2"), data,
            num_shards=4)
        seen = []
        for rank in range(2):
            kw = dict(batch_size=4, shuffle=True, seed=7, rank=rank,
                      num_replicas=2, drop_last=False)
            reader = StoreShardReader(store, keys, **kw)
            ref = jdata.StoreShardReader(ref_store, ref_keys, **kw)
            for epoch in (0, 1):
                reader.set_epoch(epoch)
                ref.set_epoch(epoch)
                got, want = list(reader), list(ref)
                assert len(reader) == len(ref) == len(got) == len(want)
                for a, b in zip(got, want):
                    for k in data:
                        np.testing.assert_array_equal(a[k], b[k])
                if epoch == 0:
                    seen.extend(y for b in got for y in b["y"].tolist())
        assert sorted(seen) == list(range(40))

    def test_filesystem_store(self, tmp_path):
        self._roundtrip(tspark.FilesystemStore(str(tmp_path / "s")),
                        jspark.FilesystemStore(str(tmp_path / "r")))

    def test_remote_kv_store(self):
        from horovod_tpu.runner.network import RendezvousServer as JServer
        from horovod_tpu_torch.runner.network import RendezvousServer
        server, ref_server = RendezvousServer(), JServer()
        port, ref_port = server.start(), ref_server.start()
        try:
            store = tspark.Store.create(f"kv://127.0.0.1:{port}/ds")
            assert isinstance(store, tspark.RemoteBlobStore)
            self._roundtrip(store, jspark.RemoteBlobStore(
                jspark.KVBlobClient("127.0.0.1", ref_port), "ds"))
        finally:
            server.stop()
            ref_server.stop()

    def test_lockstep_step_counts_with_uneven_shards(self, tmp_path):
        store = tspark.FilesystemStore(str(tmp_path / "s"))
        data = {"y": np.arange(23, dtype=np.int64)}   # 3 ragged shards
        keys = write_dataset_shards(
            store, store.get_train_data_path(store.new_run_id()), data,
            num_shards=3)
        counts, rows_seen = [], []
        for rank in range(4):
            reader = StoreShardReader(store, keys, batch_size=1,
                                      shuffle=True, seed=3, rank=rank,
                                      num_replicas=4, drop_last=False)
            batches = list(reader)
            counts.append(len(batches))
            assert len(batches) == len(reader)
            rows_seen.extend(b["y"][0] for b in batches)
        assert len(set(counts)) == 1, counts
        assert set(rows_seen) == set(range(23))

    def test_async_composition(self, tmp_path):
        class AsyncReader(AsyncDataLoaderMixin, StoreShardReader):
            pass

        store = tspark.FilesystemStore(str(tmp_path / "s"))
        keys = write_dataset_shards(
            store, store.get_train_data_path(store.new_run_id()),
            self._data(), num_shards=3)
        reader = AsyncReader(store, keys, batch_size=8, shuffle=False,
                             drop_last=False)
        rows = [y for b in reader for y in b["y"].tolist()]
        assert sorted(rows) == list(range(40))

    def test_store_refusals_and_objects(self, tmp_path):
        with pytest.raises(ValueError, match="hdfs"):
            tspark.Store.create("hdfs://x/y")
        with pytest.raises(ValueError, match="malformed"):
            tspark.Store.create("kv://nohost")
        store = tspark.Store.create(str(tmp_path / "fs"))
        path = store.join(store.get_checkpoint_path("r"), "obj.pkl")
        store.save_object(path, {"a": 1})
        assert store.exists(path) and store.load_object(path) == {"a": 1}
        store.cleanup_run("r")
        assert not store.exists(path)

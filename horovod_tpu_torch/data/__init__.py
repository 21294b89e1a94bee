"""Data loading: sharded, prefetching input pipelines.

The port's copy of ``horovod_tpu/data/`` (reference:
horovod/data/data_loader_base.py and
horovod/spark/data_loaders/pytorch_data_loaders.py), with
``prefetch_to_device`` copying through pinned memory on a CUDA stream.
"""
from .loader import (AsyncDataLoaderMixin, BaseDataLoader,
                     ShardedBatchLoader, StoreShardReader,
                     prefetch_to_device, write_dataset_shards)

__all__ = ["BaseDataLoader", "AsyncDataLoaderMixin", "ShardedBatchLoader",
           "StoreShardReader", "write_dataset_shards",
           "prefetch_to_device"]

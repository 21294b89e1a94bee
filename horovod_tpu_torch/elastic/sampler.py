"""Elastic-aware data sampler.

The port's copy of ``horovod_tpu/elastic/sampler.py``.

Upstream: horovod/torch/elastic/sampler.py — partitions a dataset across
ranks, records which indices were already processed this epoch, and after a
world-size change re-shards only the *remaining* indices so no sample is
dropped or repeated.  Framework-agnostic here (works with torch DataLoaders
via ``__iter__``/``__len__``, or any Python loop).
"""
from __future__ import annotations

import random
from typing import Iterator, Sized


class ElasticSampler:
    def __init__(self, dataset: Sized, shuffle: bool = True,
                 seed: int = 0) -> None:
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set[int] = set()
        self.num_replicas = 1
        self.rank = 0
        self.remaining_indices: list[int] = []
        self.reset()

    def set_epoch(self, epoch: int) -> None:
        """New epoch: forget processed indices and reshuffle."""
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark one batch of this rank's shard as processed."""
        start = self.rank + batch_idx * batch_size * self.num_replicas
        indices = self.indices[batch_idx * batch_size:
                               (batch_idx + 1) * batch_size]
        del start
        self.record_indices(indices)

    def record_indices(self, indices) -> None:
        self.processed_indices.update(int(i) for i in indices)

    def reset(self) -> None:
        """Re-shard the remaining (unprocessed) indices over the current
        world.  Called on construction and from State.on_reset."""
        try:
            from .. import core
            if core.is_initialized():
                self.num_replicas = core.size()
                self.rank = core.rank()
        except Exception:  # noqa: BLE001 - usable before init in tests
            pass

        remaining = [i for i in range(len(self.dataset))
                     if i not in self.processed_indices]
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(remaining)
        self.remaining_indices = remaining

        # Pad so every rank yields the same number of samples (collectives
        # stay aligned), then take this rank's strided shard.
        total = len(remaining)
        if total % self.num_replicas != 0 and total > 0:
            pad = self.num_replicas - total % self.num_replicas
            remaining = remaining + remaining[:pad]
        self.indices = remaining[self.rank::self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)

    # -- State integration -------------------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch,
                "processed_indices": sorted(self.processed_indices)}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.processed_indices = set(state["processed_indices"])
        self.reset()

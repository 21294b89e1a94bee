"""statesync/: state images, their stamps and the ring-shard re-layout.

The port's copy of ``horovod_tpu/statesync/``'s snapshot half
(:mod:`.snapshot`), which the checkpoints use.  The streaming protocol
(``stream.py``), the membership service (``service.py``), the autoscale
loop (``autoscale.py``) and the protocol specs (``specs.py``) are ROADMAP
queue A item 11.
"""
from __future__ import annotations

from .snapshot import (Snapshot, SnapshotStamp, concat_ring_shards,
                       flatten_state, load_state_into, reshard_ring_state,
                       shard_for_rank, state_digest, unflatten_state)

__all__ = [
    "Snapshot", "SnapshotStamp", "concat_ring_shards", "flatten_state",
    "load_state_into", "reshard_ring_state", "shard_for_rank",
    "state_digest", "unflatten_state",
]

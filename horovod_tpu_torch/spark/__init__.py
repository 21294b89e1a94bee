"""The artifact stores of ``horovod_tpu/spark/`` that the data loader
needs (:mod:`.store`).  Spark's ``run``, ``claim_slot`` and the
estimators are ROADMAP queue A item 12."""
from __future__ import annotations

from .store import FilesystemStore, KVBlobClient, RemoteBlobStore, Store

__all__ = ["Store", "FilesystemStore", "RemoteBlobStore", "KVBlobClient"]

"""The artifact store the data loader reads its shards through.

The port's copy of ``horovod_tpu/spark/store.py`` (reference:
horovod/spark/common/store.py:36-533): a ``Store`` abstracts where
training data, checkpoints and logs live.  Two families:

- :class:`FilesystemStore`: local or NFS directories;
- :class:`RemoteBlobStore`: artifacts behind a byte-blob client instead
  of a shared filesystem.  The bundled :class:`KVBlobClient` rides the
  port's rendezvous HTTP KV server (``runner/network.py``), so workers on
  hosts without a shared filesystem still exchange data.

Stores are picklable and mediate all IO through ``read_bytes`` and
``write_bytes``.  The rest of ``spark/`` (``run``, the estimators) is
ROADMAP queue A item 12.
"""
from __future__ import annotations

import io
import os
import pickle
import shutil
import uuid
from typing import Any


class Store:
    """Base interface (reference: store.py Store)."""

    # -- logical layout ---------------------------------------------------
    def new_run_id(self) -> str:
        return uuid.uuid4().hex[:12]

    def get_run_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_train_data_path(self, run_id: str) -> str:
        raise NotImplementedError

    # -- byte-level IO (workers use ONLY these + the path getters) --------
    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    # -- convenience ------------------------------------------------------
    def join(self, *parts: str) -> str:
        return "/".join(p.strip("/") if i else p.rstrip("/")
                        for i, p in enumerate(parts))

    def save_object(self, path: str, obj: Any) -> None:
        self.write_bytes(path, pickle.dumps(obj))

    def load_object(self, path: str) -> Any:
        return pickle.loads(self.read_bytes(path))

    def save_npz(self, path: str, **arrays) -> None:
        import numpy as np
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        self.write_bytes(path, buf.getvalue())

    def load_npz(self, path: str):
        import numpy as np
        return np.load(io.BytesIO(self.read_bytes(path)))

    def cleanup_run(self, run_id: str) -> None:
        pass

    @staticmethod
    def create(prefix_path: str) -> "Store":
        """Dispatch on URL scheme (reference: store.py Store.create):
        ``kv://host:port/prefix`` → :class:`RemoteBlobStore` over the
        rendezvous KV server; anything else → :class:`FilesystemStore`.
        ``hdfs://`` is refused, as in the reference (no HDFS client;
        mount the data and use a filesystem path)."""
        if prefix_path.startswith("kv://"):
            rest = prefix_path[len("kv://"):]
            hostport, _, prefix = rest.partition("/")
            host, _, port = hostport.partition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"malformed kv store URL {prefix_path!r}: expected "
                    "kv://host:port[/prefix]")
            return RemoteBlobStore(KVBlobClient(host, int(port)),
                                   prefix or "store")
        if prefix_path.startswith("hdfs://"):
            raise ValueError(
                "hdfs:// stores are not supported (no HDFS client); mount "
                "the data (NFS/GCS-FUSE) "
                "and use a filesystem path, or use kv://host:port for the "
                "network blob store")
        return FilesystemStore(prefix_path)


class FilesystemStore(Store):
    """Local/NFS directory store (reference: store.py FilesystemStore)."""

    def __init__(self, prefix_path: str) -> None:
        self.prefix_path = os.path.abspath(prefix_path)
        os.makedirs(self.prefix_path, exist_ok=True)

    def get_run_path(self, run_id: str) -> str:
        path = os.path.join(self.prefix_path, "runs", run_id)
        os.makedirs(path, exist_ok=True)
        return path

    def get_checkpoint_path(self, run_id: str) -> str:
        path = os.path.join(self.get_run_path(run_id), "checkpoints")
        os.makedirs(path, exist_ok=True)
        return path

    def get_train_data_path(self, run_id: str) -> str:
        path = os.path.join(self.get_run_path(run_id), "data")
        os.makedirs(path, exist_ok=True)
        return path

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def cleanup_run(self, run_id: str) -> None:
        shutil.rmtree(os.path.join(self.prefix_path, "runs", run_id),
                      ignore_errors=True)


class KVBlobClient:
    """Byte-blob client over the rendezvous HTTP KV server
    (runner/network.py) — the transport the launcher already runs, so a
    remote store needs no extra infrastructure.  Lazily (re)connects after
    pickling to worker processes."""

    def __init__(self, host: str, port: int) -> None:
        self.host, self.port = host, port
        self._client = None

    def __getstate__(self):
        return {"host": self.host, "port": self.port}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._client = None

    def _kv(self):
        if self._client is None:
            from ..runner.network import RendezvousClient
            self._client = RendezvousClient(self.host, self.port,
                                            timeout=60.0)
        return self._client

    def put(self, key: str, data: bytes) -> None:
        self._kv().put("blobstore", key, data)

    def get(self, key: str) -> bytes | None:
        return self._kv().get("blobstore", key)


class RemoteBlobStore(Store):
    """Network-backed store (the HDFSStore slot, reference:
    store.py:228-533): artifact "paths" are logical keys resolved through
    a blob client, so estimator workers need no shared filesystem."""

    def __init__(self, client, prefix: str = "store") -> None:
        self.client = client
        self.prefix = prefix.strip("/")

    def get_run_path(self, run_id: str) -> str:
        return f"{self.prefix}/runs/{run_id}"

    def get_checkpoint_path(self, run_id: str) -> str:
        return f"{self.prefix}/runs/{run_id}/checkpoints"

    def get_train_data_path(self, run_id: str) -> str:
        return f"{self.prefix}/runs/{run_id}/data"

    def read_bytes(self, path: str) -> bytes:
        data = self.client.get(path)
        if data is None:
            raise FileNotFoundError(f"remote store has no blob {path!r}")
        return data

    def write_bytes(self, path: str, data: bytes) -> None:
        self.client.put(path, data)

    def exists(self, path: str) -> bool:
        return self.client.get(path) is not None

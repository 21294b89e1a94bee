"""Prefill-to-decode KV-block streaming (disaggregated serving; the
port's copy of ``horovod_tpu/serving/kvstream.py``, whose frames are
bitwise the reference's).

Under ``HOROVOD_SERVE_PREFILL_RANKS`` the highest N ranks of the serving
world run prompt prefill ONLY: they compute a prompt's KV blocks into a
local scratch pool and stream the finished blocks to the decode
replica's ranks over a dedicated :class:`~..runner.network.PeerMesh` —
never over the collective planes, so the BatchPlan broadcast stays the
single schedule source and the fingerprint stream is identical on every
rank.  Decode ranks keep decoding their in-flight slots while the
transfer runs; a long prompt therefore never occupies a decode step
(the compute-into-communication overlap of arXiv:2305.06942, applied to
inference).

Wire format is the ``STATE_MAGIC`` mold from statesync: magic-prefixed
frames, JSON meta, **addressed CRC'd chunks** so a half-arrived
transfer is detectable and every chunk self-describes its offset::

    KVS_MAGIC | u8 kind | u32 meta_len | meta json | payload

    KVS_DATA  {rid, o, n, crc, total}   one chunk of the block image
    KVS_DONE  {rid, total, first, plen, cursor, shape, dtype}  trailer

The payload image is the prompt's K/V pool rows for every layer,
serialized by the replica: the port's paged layout, ``[2L, nblk, bt,
H, D]`` (each layer's key pool, then its value pool), in the cache's
dtype, carried as its bytes (``view(torch.uint8)``: numpy has no
bfloat16); ``shape``/``dtype`` in the trailer (the torch dtype's name)
let the decode rank reinterpret it without trusting the sender's
layout implicitly.

Every receive wait is bounded by a :class:`KVStreamGuard` poll slice
(the StreamGuard discipline from statesync/stream.py): ``close()`` sets
the stop flag and the drain threads exit within one slice — the wakeup
half of the mesh's teardown.
"""
from __future__ import annotations

import json
import struct
import threading
import zlib

from ..common import config
from ..common.logging import logger

__all__ = ["KVS_DATA", "KVS_DONE", "KVS_MAGIC", "KVStreamGuard",
           "KVStreamMesh", "PrefilledImage", "pack_kv_frame",
           "unpack_kv_frame", "kvstream_scope"]

KVS_MAGIC = b"\xffHVDKVS\xff"
_KVS_HDR = struct.Struct(">BI")

KVS_DATA = 1     # prefill -> decode: one addressed, CRC'd chunk
KVS_DONE = 2     # prefill -> decode: transfer trailer (shape/dtype/...)


def pack_kv_frame(kind: int, meta: dict, payload=b"") -> bytes:
    meta_raw = json.dumps(meta, separators=(",", ":")).encode()
    head = KVS_MAGIC + _KVS_HDR.pack(kind, len(meta_raw)) + meta_raw
    if not payload:
        return head
    return head + bytes(payload)


def unpack_kv_frame(raw) -> tuple[int, dict, memoryview]:
    view = memoryview(raw)
    n_magic = len(KVS_MAGIC)
    if bytes(view[:n_magic]) != KVS_MAGIC:
        raise ValueError("kvstream channel received a non-KVS frame — "
                         "the prefill mesh carries only KVS_MAGIC "
                         "frames")
    kind, meta_len = _KVS_HDR.unpack_from(view, n_magic)
    meta_start = n_magic + _KVS_HDR.size
    meta = json.loads(bytes(view[meta_start:meta_start + meta_len]))
    return kind, meta, view[meta_start + meta_len:]


def kvstream_scope(epoch: str, gen: int) -> str:
    """The dedicated mesh scope of one serving generation's prefill
    streams (epoch-scoped like statesync's sync meshes, so a rebuilt
    world never collides with a dying one's sockets)."""
    return f"kvserve.{epoch}.{gen}"


class KVStreamStopped(ConnectionError):
    """The guard aborted a wait because the mesh is closing."""


class KVStreamGuard:
    """Deadline/stop policy for kvstream channel waits (duck-typed like
    statesync's StreamGuard): every wait polls in short slices and
    aborts as soon as ``stop`` is set — a drain thread parked on an
    idle channel wakes within one slice of ``close()``.  Sends are
    additionally silence-bounded: ``timeout`` seconds without a byte of
    progress raises instead of wedging the serve loop behind a dead
    decode peer (receives stay stop-only — a drain thread idling
    between transfers is the normal state, and a peer that dies
    mid-transfer closes the socket, which raises on its own)."""

    def __init__(self, stop: threading.Event,
                 poll_interval: float = 0.1,
                 timeout: float = 30.0) -> None:
        self._stop = stop
        self.poll_interval = poll_interval
        self.timeout = float(timeout)

    def check(self, peer: int, waited: float, phase: str) -> None:
        if self._stop.is_set():
            raise KVStreamStopped(
                f"kvstream mesh closing (peer {peer}, {phase})")
        if phase != "recv" and waited >= self.timeout:
            raise ConnectionError(
                f"kvstream peer {peer}: no progress for {waited:.1f}s "
                f"in {phase} — abandoning the transfer")

    def peer_connection_lost(self, peer: int, phase: str,
                             detail: str) -> ConnectionError:
        return ConnectionError(
            f"kvstream peer {peer} lost in {phase}: {detail}")


class PrefilledImage:
    """One fully received prefill transfer, ready for pool insertion."""

    __slots__ = ("rid", "data", "first", "plen", "cursor", "shape",
                 "dtype")

    def __init__(self, rid: int, data: bytearray, meta: dict) -> None:
        self.rid = rid
        self.data = data
        self.first = int(meta["first"])       # first generated token
        self.plen = int(meta["plen"])         # true prompt length
        self.cursor = int(meta["cursor"])     # decode resumes here
        self.shape = tuple(meta["shape"])
        self.dtype = str(meta["dtype"])


def _stream_bytes_counter(role: str):
    from ..telemetry import metrics

    return metrics().counter(
        "horovod_serve_prefill_stream_bytes_total",
        "KV-block payload bytes streamed from prefill ranks to decode "
        "replicas, by role",
        labels={"role": role})


class KVStreamMesh:
    """One rank's half of the prefill/decode streaming plane.

    Formed collectively (every serving rank constructs it with the same
    scope) so PeerMesh's pairwise bootstrap completes; decode ranks then
    run one named drain thread per prefill peer, prefill ranks just
    send.  The collective planes never see a byte of this traffic."""

    def __init__(self, kv, scope: str, rank: int, size: int,
                 prefill_ranks: list[int], *,
                 chunk_bytes: int | None = None,
                 timeout: float = 30.0) -> None:
        from ..runner.network import PeerMesh

        self.rank = rank
        self.prefill_ranks = list(prefill_ranks)
        self.chunk_bytes = chunk_bytes or \
            config.SERVE_KVSTREAM_CHUNK_BYTES.get()
        self._stop = threading.Event()
        self._guard = KVStreamGuard(self._stop)
        self.mesh = PeerMesh(rank, size, kv, scope=scope,
                             timeout=timeout, resilience=self._guard)
        self._lock = threading.Lock()
        self._partial: dict[int, tuple[bytearray, int]] = {}
        self._ready: dict[int, PrefilledImage] = {}
        self._threads: list[threading.Thread] = []
        self._sent = _stream_bytes_counter("sent")
        self._received = _stream_bytes_counter("received")
        if rank not in self.prefill_ranks:
            for peer in self.prefill_ranks:
                t = threading.Thread(
                    target=self._drain, args=(peer,), daemon=True,
                    name=f"hvd-serve-kvstream-{peer}")
                t.start()
                self._threads.append(t)

    # -- prefill side ------------------------------------------------------
    def send_image(self, rid: int, dests: list[int], image: bytes,
                   *, first: int, plen: int, cursor: int,
                   shape: tuple, dtype: str) -> None:
        """Stream one prompt's serialized KV-block image to every rank
        of the decode replica group: addressed CRC'd chunks, then the
        trailer that makes the transfer interpretable."""
        view = memoryview(image)
        total = view.nbytes
        trailer = pack_kv_frame(KVS_DONE, {
            "rid": rid, "total": total, "first": first, "plen": plen,
            "cursor": cursor, "shape": list(shape), "dtype": dtype})
        for dest in dests:
            for o in range(0, total, self.chunk_bytes):
                n = min(self.chunk_bytes, total - o)
                chunk = view[o:o + n]
                self.mesh.send(dest, pack_kv_frame(
                    KVS_DATA, {"rid": rid, "o": o, "n": n,
                               "crc": zlib.crc32(chunk),
                               "total": total}, chunk))
                self._sent.inc(n)
            self.mesh.send(dest, trailer)

    # -- decode side -------------------------------------------------------
    def _drain(self, peer: int) -> None:
        try:
            while not self._stop.is_set():
                kind, meta, payload = unpack_kv_frame(
                    self.mesh.recv(peer))
                self._ingest(kind, meta, payload)
        except KVStreamStopped:
            return
        except (ConnectionError, OSError, ValueError) as exc:
            if not self._stop.is_set():
                # A dead prefill rank mid-transfer: the replica's
                # pending-prefill fallback re-prefills locally, so this
                # is degradation, not failure.
                logger.warning("kvstream: drain from prefill rank %d "
                               "ended: %s", peer, exc)

    def _ingest(self, kind: int, meta: dict, payload) -> None:
        rid = int(meta["rid"])
        with self._lock:
            if kind == KVS_DATA:
                o, n = int(meta["o"]), int(meta["n"])
                if zlib.crc32(payload) != int(meta["crc"]):
                    # Corrupt chunk: drop the transfer — the decode
                    # side's fallback re-prefills locally rather than
                    # ever interpreting unverified bytes.
                    logger.warning("kvstream: chunk CRC mismatch for "
                                   "rid %d at offset %d; dropping the "
                                   "transfer", rid, o)
                    self._partial.pop(rid, None)
                    return
                buf, got = self._partial.get(
                    rid, (bytearray(int(meta["total"])), 0))
                buf[o:o + n] = payload
                self._partial[rid] = (buf, got + n)
                self._received.inc(n)
            elif kind == KVS_DONE:
                buf, got = self._partial.pop(rid, (bytearray(0), 0))
                if got != int(meta["total"]):
                    logger.warning("kvstream: transfer for rid %d ended "
                                   "with %d/%d bytes; dropping", rid,
                                   got, int(meta["total"]))
                    return
                self._ready[rid] = PrefilledImage(rid, buf, meta)

    def pop_ready(self, rid: int) -> PrefilledImage | None:
        """Non-blocking: the fully received transfer for ``rid``, or
        None while it is still in flight (the serve step never waits on
        a stream — pending slots simply skip decode)."""
        with self._lock:
            return self._ready.pop(rid, None)

    def ready_rids(self) -> list[int]:
        with self._lock:
            return list(self._ready)

    def discard(self, rid: int) -> None:
        """Drop any state for ``rid`` (locally admitted via a full
        prefix-cache hit, or resolved by the fallback prefill)."""
        with self._lock:
            self._partial.pop(rid, None)
            self._ready.pop(rid, None)

    # -- teardown ----------------------------------------------------------
    def close(self) -> None:
        """Stop the drain threads (guard flip = their wakeup), then
        close the mesh."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        self.mesh.close()
        with self._lock:
            self._partial.clear()
            self._ready.clear()

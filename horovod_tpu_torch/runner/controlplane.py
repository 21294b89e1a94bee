"""Coordinator-fault-tolerant control plane for the rendezvous KV.

The port's copy of ``horovod_tpu/runner/controlplane.py``.  Without it
the rendezvous KV (``network.RendezvousServer``) is a single in-memory
HTTP server whose death orphans heartbeats, membership watchers,
autoscale and every elastic rejoin path.  Three pieces close the gap:

- **Write-ahead log** (:class:`WalWriter` / :func:`replay`): every
  mutating KV verb (``put`` / ``claim`` / ``delete``) appends one
  epoch-stamped, CRC-framed record to an append-only log and is acked
  only after the group-commit fsync; a restarted or promoted server
  replays the log and loses nothing that was ever acked.  Claim records
  carry the *assigned* index, so replay never re-runs the counter and a
  retried claim stays idempotent by construction.  The record framing
  is the reference's byte for byte, so either package replays a log the
  other wrote.

- **Lease-based leader election, epoch-fenced, stored in the log
  itself** (:class:`ControlPlane`): the primary renews a ``lease``
  record every third of ``HOROVOD_RENDEZVOUS_LEASE_MS``; standbys tail
  the primary's log over HTTP (``/.ctl/wal``) and promote when the
  lease lapses by appending a ``leader`` record with ``epoch + 1``.
  The log is the arbiter: after appending, the candidate re-reads it
  and the FIRST ``leader`` record at the new epoch wins; a duelling
  candidate demotes itself.  A primary whose lease lapsed (SIGSTOP, GC
  pause, partition) re-verifies the log tail before accepting another
  write: a higher-epoch ``leader`` record fences it out (it demotes and
  answers 409 with the winner's endpoint), so a resumed stale primary
  can never ack a write the replayed state would drop.

- **Client failover** lives in ``network.RendezvousClient``: a
  multi-endpoint seed list, transparent retry of idempotent verbs, and
  409-redirect handling converge every client on the current leader.

``python -m horovod_tpu_torch.runner.controlplane`` runs one replica as
its own process (the shape the chaos ``coordkill:`` action kills) and
prints ``READY <port> <pid>`` once it serves.  The reference's model
check of the election (``runner/specs.py`` with hvdmc) waits for the
port's analysis passes.
"""
from __future__ import annotations

import os
import queue
import struct
import threading
import time
import zlib

from ..common import config
from ..common.logging import logger
from ..common.wire import Decoder, Encoder

__all__ = ["ControlPlane", "WalWriter", "apply_record", "fold_digest",
           "replay", "replay_state", "wal_path"]

_REC_HDR = struct.Struct(">I")       # payload length; trailer is crc32
_WAL_NAME = "rendezvous.wal"

# WAL record kinds (the rendezvous-failover spec's KV verb vocabulary).
KIND_PUT = "put"
KIND_CLAIM = "claim"
KIND_DELETE = "delete"
KIND_LEASE = "lease"
KIND_LEADER = "leader"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def wal_path(wal_dir: str) -> str:
    return os.path.join(wal_dir, _WAL_NAME)


def _encode_record(epoch: int, kind: str, scope: str, key: str,
                   value: bytes) -> bytes:
    enc = Encoder()
    enc.uvarint(epoch).string(kind).string(scope).string(key).blob(value)
    payload = enc.getvalue()
    return (_REC_HDR.pack(len(payload)) + payload
            + _REC_HDR.pack(zlib.crc32(payload)))


def _decode_payload(payload: bytes) -> tuple:
    dec = Decoder(payload)
    return (dec.uvarint(), dec.string(), dec.string(), dec.string(),
            dec.blob())


def replay(path: str, offset: int = 0):
    """Yield ``(epoch, kind, scope, key, value)`` records from `path`
    starting at byte `offset`.  A torn tail (partial record or CRC
    mismatch — the writer died mid-append) ends the stream: everything
    before it was fsync'd and acked, everything after was never acked."""
    try:
        with open(path, "rb") as f:
            if offset:
                f.seek(offset)
            while True:
                hdr = f.read(_REC_HDR.size)
                if len(hdr) < _REC_HDR.size:
                    return
                (n,) = _REC_HDR.unpack(hdr)
                payload = f.read(n)
                trailer = f.read(_REC_HDR.size)
                if len(payload) < n or len(trailer) < _REC_HDR.size:
                    return
                if _REC_HDR.unpack(trailer)[0] != zlib.crc32(payload):
                    return
                yield _decode_payload(payload)
    except FileNotFoundError:
        return


def fold_digest(digest: int, kind: str, scope: str, key: str,
                value: bytes) -> int:
    """FNV-1a fold of one applied record into a rolling 64-bit digest
    (the WAL-replay digest the failover battery checks)."""
    for chunk in (kind.encode(), scope.encode(), key.encode(), value):
        for b in chunk:
            digest = ((digest ^ b) * _FNV_PRIME) & _MASK64
        digest = ((digest ^ 0x1F) * _FNV_PRIME) & _MASK64
    return digest


def apply_record(state: dict, kind: str, scope: str, key: str,
                 value: bytes) -> None:
    """Apply one data record to a KV state dict (``kv`` / ``counters``
    / ``claims`` / ``digest`` keys — the same shape the live server
    mutates, so replayed and live state share one code path)."""
    if kind == KIND_PUT:
        state["kv"].setdefault(scope, {})[key] = value
    elif kind == KIND_DELETE:
        if key:
            state["kv"].get(scope, {}).pop(key, None)
        else:
            state["kv"].pop(scope, None)
    elif kind == KIND_CLAIM:
        # value = b"claimant|index": replay applies the index assigned
        # at commit time instead of re-running the counter (claim order
        # in the log therefore never matters).
        claimant, _, idx = value.decode().rpartition("|")
        n = int(idx)
        ckey = f"{scope}/{key}"
        state["counters"][ckey] = max(state["counters"].get(ckey, 0),
                                      n + 1)
        if claimant:
            state["claims"].setdefault(ckey, {})[claimant] = n
    else:
        return
    state["digest"] = fold_digest(state.get("digest", _FNV_OFFSET),
                                  kind, scope, key, value)


def replay_state(path: str) -> dict:
    """Replay a whole log into ``{kv, counters, claims, digest, epoch,
    lease_expiry, leader_id}``.  Epoch fencing happens HERE: a
    ``leader`` record advances the current epoch, and any data record
    stamped with an older epoch that appears after it is dropped — the
    write a fenced-out stale primary appended was never committed."""
    state = {"kv": {}, "counters": {}, "claims": {},
             "digest": _FNV_OFFSET, "epoch": 0, "lease_expiry": 0.0,
             "leader_id": -1}
    for epoch, kind, scope, key, value in replay(path):
        if kind == KIND_LEADER:
            if epoch > state["epoch"]:
                state["epoch"] = epoch
                state["leader_id"] = int(key or -1)
                state["lease_expiry"] = _lease_expiry_of(value)
            continue
        if epoch < state["epoch"]:
            continue                       # fenced: stale-primary record
        if kind == KIND_LEASE:
            state["lease_expiry"] = max(state["lease_expiry"],
                                        _lease_expiry_of(value))
            continue
        apply_record(state, kind, scope, key, value)
    return state


def _lease_expiry_of(value: bytes) -> float:
    try:
        return float(value.decode().rpartition("|")[2])
    except ValueError:
        return 0.0


class WalWriter:
    """Append-only log writer with a group-commit fsync lane.

    Appends enqueue ``(record bytes, committed event)`` on an internal
    queue drained by ONE daemon thread (``hvd-rdzv-wal-<id>``) that
    writes every queued record and issues a single fsync per batch —
    callers wait on their record's event, so an ack always means
    on-disk.  Records are written with ``O_APPEND`` in one ``os.write``
    each, so concurrent writers (a duelling election across processes)
    can interleave records but never tear one.
    """

    def __init__(self, path: str, writer_id: int = 0) -> None:
        self.path = path
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self._queue: queue.Queue = queue.Queue(maxsize=256)
        # Group-commit observability: records vs fsync batches is the
        # coalescing ratio the fleetsim fan-in test asserts on.
        from ..telemetry import metrics
        tm = metrics()
        self._m_batches = tm.counter(
            "horovod_rendezvous_wal_commit_batches_total",
            "WAL group-commit fsync batches flushed by this writer")
        self._m_records = tm.counter(
            "horovod_rendezvous_wal_records_total",
            "WAL records committed by this writer")
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hvd-rdzv-wal-{writer_id}")
        self._thread.start()

    def append_async(self, epoch: int, kind: str, scope: str, key: str,
                     value: bytes) -> threading.Event:
        """Enqueue one record; the returned event is set once the
        record (and its batch) is fsync'd.  Enqueue order is commit
        order — callers serialize enqueues under the KV lock so the
        log order matches the in-memory apply order."""
        done = threading.Event()
        self._queue.put((_encode_record(epoch, kind, scope, key, value),
                         done))
        return done

    def append(self, epoch: int, kind: str, scope: str, key: str,
               value: bytes, timeout: float = 10.0) -> bool:
        """Append + wait for the fsync (bounded)."""
        return self.append_async(epoch, kind, scope, key,
                                 value).wait(timeout)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            while True:               # group commit: drain what's queued
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch) -> None:
        for record, _done in batch:
            os.write(self._fd, record)
        os.fsync(self._fd)
        self._m_batches.inc()
        self._m_records.inc(len(batch))
        for _record, done in batch:
            done.set()

    def size(self) -> int:
        return os.fstat(self._fd).st_size

    def close(self) -> None:
        # Poison first, then join (the wedged-sender close contract):
        # the lane always reaches the sentinel because every append
        # before close() already has its bytes queued.
        self._queue.put(None)
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            logger.warning("controlplane: WAL writer thread for %s "
                           "survived poison; leaking it as daemon",
                           self.path)
        try:
            os.close(self._fd)
        except OSError:
            pass


class Replicator:
    """Standby half: tail the primary's log over HTTP and mirror it.

    One thread (``hvd-rdzv-tail-<id>``) long-polls ``/.ctl/wal`` on the
    current primary and applies fetched records to the owning server's
    KV state; every fetched byte also refreshes the lease-observation
    stamp the monitor thread judges lapse by.  The tail is warm-standby
    state only — promotion re-reads the durable log, so a standby that
    lagged the tail still loses nothing committed.
    """

    def __init__(self, plane: "ControlPlane") -> None:
        self._plane = plane
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"hvd-rdzv-tail-{plane.replica_id}")
        self._thread.start()

    def _run(self) -> None:
        plane = self._plane
        poll = max(0.05, plane.lease_s / 4.0)
        while not self._stop.wait(poll):
            if plane.role != "standby":
                continue
            try:
                got = plane._tail_once()
            except Exception:  # noqa: BLE001 - primary may be dying
                continue
            if got:
                plane.note_leader_activity()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)


class ControlPlane:
    """Role, epoch, lease and WAL state of one rendezvous replica.

    Attached to a ``network.RendezvousServer`` when
    ``HOROVOD_RENDEZVOUS_WAL_DIR`` (or the ``wal_dir=`` argument) is
    set.  The server's handler consults :meth:`check_write` before
    every mutating verb and :meth:`record` to commit it; reads are
    answered only by the primary too (409 + leader hint otherwise), so
    clients never observe a stale mirror.
    """

    def __init__(self, server, wal_dir: str, replica_id: int = 0,
                 endpoints=None, lease_ms: float | None = None,
                 standby: bool = False) -> None:
        self.server = server
        self.wal_dir = wal_dir
        self.replica_id = int(replica_id)
        # Ordered seed list ["host:port", ...]; index = replica id.
        self.endpoints = list(endpoints or [])
        lease_ms = config.RENDEZVOUS_LEASE_MS.get() \
            if lease_ms is None else float(lease_ms)
        self.lease_s = max(0.05, lease_ms / 1e3)
        self.role = "standby" if standby else "primary"
        self.epoch = 0
        self.failovers = 0
        self._lease_expiry = 0.0          # wall clock, primary only
        self._observed = time.monotonic()  # standby: last leader sign
        self._tail_offset = 0
        self._wal: WalWriter | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._replicator: Replicator | None = None
        self._lease_thread: threading.Thread | None = None
        os.makedirs(wal_dir, exist_ok=True)
        from ..telemetry import metrics
        tm = metrics()
        self._m_role = tm.gauge(
            "horovod_rendezvous_role",
            "1 while this replica is the rendezvous primary, 0 as "
            "standby", labels={"replica": str(self.replica_id)})
        self._m_failovers = tm.counter(
            "horovod_rendezvous_failovers_total",
            "Leader promotions this replica performed (lease lapse or "
            "primary death)")

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        state = replay_state(wal_path(self.wal_dir))
        if self.role == "primary":
            # Fresh primary: claim epoch 0 -> 1 (or succeed the log's
            # last leader) so every later record is fenced to our reign.
            self.epoch = state["epoch"] + 1
            self._append_leader()
            self._load(replay_state(wal_path(self.wal_dir)))
            self._renew_lease()
        else:
            self.epoch = state["epoch"]
            self._load(state)
            self.note_leader_activity()
            self._replicator = Replicator(self)
        self._m_role.set(1 if self.role == "primary" else 0)
        self._lease_thread = threading.Thread(
            target=self._lease_loop, daemon=True,
            name=f"hvd-rdzv-lease-{self.replica_id}")
        self._lease_thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._lease_thread is not None:
            self._lease_thread.join(timeout=10.0)
            self._lease_thread = None
        if self._replicator is not None:
            self._replicator.close()
            self._replicator = None
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- state loading ---------------------------------------------------
    def _load(self, state: dict) -> None:
        httpd = self.server._httpd
        with httpd.kv_lock:
            httpd.kv = state["kv"]
            httpd.counters = state["counters"]
            httpd.claims = state["claims"]
            httpd.kv_digest = state["digest"]
            httpd.kv_cond.notify_all()

    # -- WAL plumbing ----------------------------------------------------
    def _writer(self) -> WalWriter:
        if self._wal is None:
            self._wal = WalWriter(wal_path(self.wal_dir),
                                  self.replica_id)
        return self._wal

    def record(self, kind: str, scope: str, key: str,
               value: bytes) -> threading.Event:
        """Commit one data record at the current epoch.  Called with
        the server's KV lock HELD (enqueue only — the fsync wait
        happens on the returned event after the lock is released), so
        log order equals in-memory apply order."""
        return self._writer().append_async(self.epoch, kind, scope,
                                           key, value)

    def _append_leader(self) -> None:
        expiry = time.time() + self.lease_s
        self._writer().append(
            self.epoch, KIND_LEADER, "", str(self.replica_id),
            f"{self.replica_id}|{expiry}".encode())
        self._lease_expiry = expiry

    def _renew_lease(self) -> None:
        expiry = time.time() + self.lease_s
        if self._writer().append(
                self.epoch, KIND_LEASE, "", str(self.replica_id),
                f"{self.replica_id}|{expiry}".encode()):
            self._lease_expiry = expiry

    # -- primary write fence ---------------------------------------------
    def check_write(self) -> tuple[bool, str]:
        """May this replica accept a mutating (or any) KV request RIGHT
        NOW?  Returns ``(ok, leader_hint)``.  The lease check is the
        split-brain fence: a primary that overslept its lease (SIGSTOP,
        the ``coordpause:`` chaos shape) must re-read the log before
        touching state — a higher-epoch ``leader`` record means a
        standby was promoted during the pause, and accepting the write
        would ack bytes the replayed state drops."""
        if self.role == "primary":
            if time.time() <= self._lease_expiry:
                return True, ""
            return self._reverify_lease()
        return False, self.leader_hint()

    def _reverify_lease(self) -> tuple[bool, str]:
        with self._lock:
            if self.role != "primary":
                return False, self.leader_hint()
            state = replay_state(wal_path(self.wal_dir))
            if state["epoch"] > self.epoch:
                self._demote(state)
                return False, self.leader_hint()
            # Lease lapsed but nobody contested YET: self-succeed under
            # a fresh epoch.  A standby candidate may race us through
            # the same bytes — re-read and let the log arbitrate (first
            # leader record at the epoch wins), exactly like a
            # promotion duel.
            candidate_epoch = state["epoch"] + 1
            self.epoch = candidate_epoch
            self._append_leader()
            winner = self._election_winner(candidate_epoch)
            if winner != self.replica_id:
                self._demote(replay_state(wal_path(self.wal_dir)))
                return False, self.leader_hint()
            return True, ""

    def _demote(self, state: dict) -> None:
        logger.warning(
            "controlplane: replica %d fenced out by leader epoch %d "
            "(held epoch %d); demoting to standby",
            self.replica_id, state["epoch"], self.epoch)
        self.epoch = state["epoch"]
        self._load(state)
        self.role = "standby"
        self._m_role.set(0)
        self.note_leader_activity()
        if self._replicator is None:
            self._replicator = Replicator(self)

    # -- standby: lease watch + promotion --------------------------------
    def note_leader_activity(self) -> None:
        self._observed = time.monotonic()

    def _lapse_after(self) -> float:
        """Silence a standby tolerates before attempting promotion.
        Staggered by replica id so the lowest standby wins elections
        unopposed on the common path (duels resolve through the log)."""
        return self.lease_s * (2.0 + max(0, self.replica_id - 1))

    def _lease_loop(self) -> None:
        interval = max(0.02, self.lease_s / 3.0)
        while not self._stop.wait(interval):
            if self.role == "primary":
                if time.time() > self._lease_expiry:
                    # The loop overslept its own lease (SIGSTOP, GC
                    # pause): re-verify the log BEFORE renewing so a
                    # promotion that happened during the gap demotes us
                    # proactively — not only when the next request
                    # trips the write fence.
                    self._reverify_lease()
                    continue
                self._renew_lease()
            else:
                silence = time.monotonic() - self._observed
                if silence > self._lapse_after():
                    self._try_promote()

    def _try_promote(self) -> None:
        with self._lock:
            if self.role != "standby":
                return
            state = replay_state(wal_path(self.wal_dir))
            now = time.time()
            if state["lease_expiry"] > now or \
                    state["epoch"] > self.epoch:
                # Someone renewed or a peer already won a newer epoch:
                # adopt what the log says and keep standing by.
                self.epoch = state["epoch"]
                self.note_leader_activity()
                return
            candidate_epoch = state["epoch"] + 1
            self._writer().append(
                candidate_epoch, KIND_LEADER, "",
                str(self.replica_id),
                f"{self.replica_id}|{now + self.lease_s}".encode())
            winner = self._election_winner(candidate_epoch)
            if winner != self.replica_id:
                logger.warning(
                    "controlplane: replica %d lost election for epoch "
                    "%d to replica %d", self.replica_id,
                    candidate_epoch, winner)
                self.epoch = candidate_epoch
                self.note_leader_activity()
                return
            self.epoch = candidate_epoch
            self._load(replay_state(wal_path(self.wal_dir)))
            self.role = "primary"
            self.failovers += 1
            self._m_role.set(1)
            self._m_failovers.inc()
            self._renew_lease()
            logger.warning(
                "controlplane: replica %d promoted to rendezvous "
                "primary (epoch %d)", self.replica_id, self.epoch)

    def _election_winner(self, epoch: int) -> int:
        """The log is the arbiter: the FIRST leader record at `epoch`
        wins; everyone else demotes.  Reads the durable file, not the
        tail mirror — candidates race through the same bytes."""
        for rec_epoch, kind, _scope, key, _value in replay(
                wal_path(self.wal_dir)):
            if kind == KIND_LEADER and rec_epoch == epoch:
                return int(key or -1)
        return -1

    # -- tail fetch (standby) --------------------------------------------
    def leader_hint(self) -> str:
        """Best-known leader endpoint for the 409 redirect header."""
        state = replay_state(wal_path(self.wal_dir))
        leader = state["leader_id"]
        if 0 <= leader < len(self.endpoints):
            return self.endpoints[leader]
        return ""

    def _tail_once(self) -> bool:
        """Fetch new log bytes from the current leader's ``/.ctl/wal``
        endpoint and apply them to the mirror.  Returns True when any
        byte arrived (leader liveness evidence)."""
        from urllib import request as urlrequest
        hint = self.leader_hint()
        if not hint:
            return False
        url = f"http://{hint}/.ctl/wal?from={self._tail_offset}"
        with urlrequest.urlopen(url, timeout=self.lease_s) as resp:
            raw = resp.read()
            end = int(resp.headers.get("X-Hvd-Wal-End",
                                       self._tail_offset))
        if not raw:
            return True                    # reachable, nothing new
        self._apply_tail(raw)
        self._tail_offset = end
        return True

    def _apply_tail(self, raw: bytes) -> None:
        httpd = self.server._httpd
        pos = 0
        with httpd.kv_lock:
            state = {"kv": httpd.kv, "counters": httpd.counters,
                     "claims": httpd.claims,
                     "digest": getattr(httpd, "kv_digest",
                                       _FNV_OFFSET)}
            while pos + _REC_HDR.size <= len(raw):
                (n,) = _REC_HDR.unpack_from(raw, pos)
                end = pos + _REC_HDR.size + n + _REC_HDR.size
                if end > len(raw):
                    break
                payload = raw[pos + _REC_HDR.size:pos + _REC_HDR.size
                              + n]
                epoch, kind, scope, key, value = \
                    _decode_payload(payload)
                if kind == KIND_LEADER and epoch > self.epoch:
                    self.epoch = epoch
                elif kind not in (KIND_LEASE, KIND_LEADER) and \
                        epoch >= self.epoch:
                    apply_record(state, kind, scope, key, value)
                pos = end
            httpd.kv_digest = state["digest"]
            httpd.kv_cond.notify_all()

    # -- introspection (/.ctl handlers) ----------------------------------
    def describe(self) -> str:
        return f"{self.role}|{self.epoch}|{self.leader_hint()}"

    def wal_bytes_from(self, offset: int) -> tuple[bytes, int]:
        path = wal_path(self.wal_dir)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                raw = f.read()
                return raw, offset + len(raw)
        except FileNotFoundError:
            return b"", offset


def start_replica_set(n_standbys: int, wal_dir: str,
                      lease_ms: float | None = None,
                      host: str = "127.0.0.1"):
    """Convenience used by launchers and tests: one primary plus
    ``n_standbys`` standby replicas in this process, sharing `wal_dir`.
    Returns ``(servers, endpoints)`` — index 0 is the primary; the
    seed list goes into ``HOROVOD_GLOO_RENDEZVOUS_ADDR`` verbatim."""
    from .network import RendezvousServer, free_port

    ports = [free_port() for _ in range(n_standbys + 1)]
    endpoints = [f"{host}:{p}" for p in ports]
    servers = []
    for i, port in enumerate(ports):
        srv = RendezvousServer(port=port, wal_dir=wal_dir, replica_id=i,
                               endpoints=endpoints, lease_ms=lease_ms,
                               standby=(i > 0))
        srv.start()
        servers.append(srv)
    return servers, endpoints


def _main(argv=None) -> int:
    """Run ONE replica as its own process until SIGTERM — the unit the
    chaos ``coordkill:``/``coordpause:`` actions target."""
    import argparse
    import signal

    from .network import RendezvousServer

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.controlplane")
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--wal-dir", required=True)
    parser.add_argument("--replica-id", type=int, default=0)
    parser.add_argument("--endpoints", default="",
                        help="comma-separated host:port seed list")
    parser.add_argument("--lease-ms", type=float, default=None)
    parser.add_argument("--standby", action="store_true")
    args = parser.parse_args(argv)
    endpoints = [e for e in args.endpoints.split(",") if e]
    server = RendezvousServer(
        port=args.port, wal_dir=args.wal_dir,
        replica_id=args.replica_id, endpoints=endpoints,
        lease_ms=args.lease_ms, standby=args.standby)
    server.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    print(f"READY {server.port} {os.getpid()}", flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())

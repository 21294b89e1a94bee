"""Socket primitives for the DCN control/data planes.

The port's copy of ``horovod_tpu/runner/network.py``: the framing helpers,
the rendezvous KV (``RendezvousServer``, its HTTP handler,
``RendezvousClient``) and the peer sockets (``_PeerChannel``,
``PeerMesh``), with the metrics counters (per-peer wire bytes, the send
queue's depth, the KV verbs' latency), and under fault tolerance the
deadline-bounded socket waits and the chaos send hooks (resilience/).
Left out: the write-ahead-logged replica set
(``HOROVOD_RENDEZVOUS_WAL_DIR``) and NIC selection
(``HOROVOD_GLOO_IFACE``; ROADMAP queue A item 12).

Reference analogues: horovod/common/gloo/http_store.cc (KV client),
horovod/runner/http/http_server.py:35-241 (rendezvous KV server), and the
point-to-point plumbing under runner/common/service/.  Framing is a 4-byte
big-endian length prefix; payloads are opaque bytes (wire.py messages or raw
numpy buffers).

Bulk transfers ride persistent per-peer duplex channels (`_PeerChannel`):
one long-lived sender thread + bounded queue per neighbor drains
scatter-gather `sendmsg` frames, and receives land in a reusable per-peer
scratch pool via `recv_into` — no per-step thread spawn, no bytes copies
on either direction (the reference keeps Gloo's persistent pair
connections alive the same way).
"""
from __future__ import annotations

import os
import queue
import random
import selectors
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import error as urlerror
from urllib import parse as urlparse
from urllib import request as urlrequest

from ..common import config, wire
from ..common.logging import logger
from .controlplane import _FNV_OFFSET, apply_record

_LEN = struct.Struct(">I")

# Grace for a sender lane to drain after its queue is poisoned at close;
# past it the socket is shut down under the thread (unblocking a sendmsg
# wedged on a dead peer) and a structured warning names the peer.
_CLOSE_JOIN_GRACE = 10.0


# Depth of a channel's outbound queue.  Collective schedules keep at most
# one or two sends in flight per peer; the bound only exists so a runaway
# producer backpressures instead of buffering unbounded payload refs.
_SEND_QUEUE_DEPTH = 8


def _resilience_state():
    """The process ResilienceState, or None (zero-overhead off mode).
    Late import: resilience/ sits above the transport layer."""
    from ..resilience import active_state
    return active_state()


def _chaos_engine():
    from ..resilience import chaos
    return chaos.active()


def send_msg(sock: socket.socket, payload: bytes) -> None:
    if len(payload) < (1 << 16):
        # Small control messages: one syscall, concat is cheap.
        sock.sendall(_LEN.pack(len(payload)) + payload)
    else:
        # Bulk payloads: never materialize header+payload (a full copy of
        # a multi-MB gradient buffer per send).
        sock.sendall(_LEN.pack(len(payload)))
        sock.sendall(payload)


def send_msg_gather(sock: socket.socket, view: memoryview) -> None:
    """Frame + send in one scatter-gather syscall (`sendmsg`): the header
    never gets concatenated onto a multi-MB payload, and the payload is
    consumed straight from the caller's buffer (numpy slice, bytes, ...).
    Handles partial sends — sendmsg may stop at any byte boundary."""
    n = view.nbytes
    hdr = _LEN.pack(n)
    sent = sock.sendmsg([hdr, view])
    while sent < 4 + n:
        if sent < 4:
            sent += sock.send(memoryview(hdr)[sent:])
        else:
            sent += sock.send(view[sent - 4:])


def _as_byte_view(payload) -> memoryview:
    """A flat uint8 memoryview over bytes/bytearray/memoryview/ndarray
    without copying (C-contiguous buffers only — all our payloads are)."""
    view = payload if isinstance(payload, memoryview) else memoryview(payload)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    return view


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    # Single preallocated buffer + recv_into: no per-chunk allocations,
    # no final join copy (numpy consumes the bytearray zero-copy via
    # frombuffer).
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("socket closed mid-message")
        got += r
    return buf


def recv_msg(sock: socket.socket) -> bytearray:
    (length,) = _LEN.unpack(recv_exact(sock, 4))
    return recv_exact(sock, length)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Rendezvous KV store (HTTP, like the reference's RendezvousServer/HTTPStore)
# ---------------------------------------------------------------------------
def _kv_apply(httpd, kind: str, scope: str, key: str, value: bytes):
    """Apply one mutating KV verb under the KV lock and wake the
    long-polls.  Returns the claim index for a claim, else None."""
    with httpd.kv_lock:
        result = None
        if kind == "claim":
            claimant = value.decode()
            ckey = f"{scope}/{key}"
            assigned = httpd.claims.setdefault(ckey, {})
            if claimant and claimant in assigned:
                return assigned[claimant]    # idempotent re-present
            result = httpd.counters.get(ckey, 0)
            value = f"{claimant}|{result}".encode()
        state = {"kv": httpd.kv, "counters": httpd.counters,
                 "claims": httpd.claims, "digest": httpd.kv_digest}
        apply_record(state, kind, scope, key, value)
        httpd.kv_digest = state["digest"]
        httpd.kv_cond.notify_all()
    return result


def _kv_apply_many(httpd, records) -> None:
    """Apply a batch of put records under ONE KV-lock hold."""
    with httpd.kv_lock:
        state = {"kv": httpd.kv, "counters": httpd.counters,
                 "claims": httpd.claims, "digest": httpd.kv_digest}
        for scope, key, value in records:
            apply_record(state, "put", scope, key, value)
        httpd.kv_digest = state["digest"]
        httpd.kv_cond.notify_all()


def encode_batch(records) -> bytes:
    """Frame ``[(scope, key, value), ...]`` put records for the
    ``PUT /.batch/`` fan-in verb (wire.py varint framing)."""
    enc = wire.Encoder()
    records = list(records)
    enc.uvarint(len(records))
    for scope, key, value in records:
        enc.string(scope).string(key).blob(value)
    return enc.getvalue()


def decode_batch(raw: bytes) -> list[tuple[str, str, bytes]]:
    dec = wire.Decoder(bytes(raw))
    return [(dec.string(), dec.string(), dec.blob())
            for _ in range(dec.uvarint())]


def encode_scope(entries: dict) -> bytes:
    """Frame one scope's key->value dict for the empty-key GET (scope
    dump) response."""
    enc = wire.Encoder()
    enc.uvarint(len(entries))
    for key, value in entries.items():
        enc.string(key).blob(value)
    return enc.getvalue()


def decode_scope(raw: bytes) -> dict[str, bytes]:
    dec = wire.Decoder(bytes(raw))
    return {dec.string(): dec.blob() for _ in range(dec.uvarint())}


# Reserved scope name carrying batched put records (PUT body is a
# wire-framed record list, not a single value).
BATCH_SCOPE = ".batch"


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence default stderr logging
        pass

    def _split(self) -> tuple[str, str]:
        parts = urlparse.urlsplit(self.path).path.lstrip("/") \
            .split("/", 1)
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else ""
        return scope, key

    def _query(self) -> dict:
        return urlparse.parse_qs(urlparse.urlsplit(self.path).query)

    def _reply(self, code: int, body: bytes = b"",
               headers=()) -> None:
        self.send_response(code)
        for name, val in headers:
            self.send_header(name, val)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def do_PUT(self):
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if scope == BATCH_SCOPE:
            # Fan-in verb: one request carries many put records, applied
            # under a single lock hold.
            try:
                records = decode_batch(value)
            except (ValueError, IndexError):
                return self._reply(400)
            _kv_apply_many(self.server, records)
            return self._reply(200, str(len(records)).encode())
        _kv_apply(self.server, "put", scope, key, value)
        self._reply(200)

    def do_GET(self):
        scope, key = self._split()
        if scope == ".ctl":
            return self._ctl(key)
        if key == "":
            # Scope dump: one request returns every key in the scope
            # (fleetsim host groups refresh their heartbeat snapshot
            # with ONE read instead of size-many gets per window).
            with self.server.kv_lock:
                entries = dict(self.server.kv.get(scope, {}))
            return self._reply(200, encode_scope(entries))
        wait_q = self._query().get("wait", ["0"])[0]
        try:
            wait_s = max(0.0, min(float(wait_q) / 1e3, 60.0))
        except ValueError:
            wait_s = 0.0
        deadline = time.monotonic() + wait_s
        with self.server.kv_lock:
            value = self.server.kv.get(scope, {}).get(key)
            while value is None:
                # Server-side long-poll (?wait=<ms>): a steady-state
                # watcher costs one outstanding request instead of a
                # 100 req/s busy-poll.  Bounded by the client's wait
                # budget; wakeups ride every committed mutation.
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.server.kv_cond.wait(timeout=remaining)
                value = self.server.kv.get(scope, {}).get(key)
        if value is None:
            self._reply(404)
        else:
            self._reply(200, value)

    def _ctl(self, key: str) -> None:
        """Introspection endpoints under ``/.ctl/``: the role (always the
        primary: there is no replica set), the process id and the live
        KV digest."""
        if key == "pid":
            return self._reply(200, str(os.getpid()).encode())
        if key == "role":
            return self._reply(200, b"primary|0|")
        if key == "digest":
            with self.server.kv_lock:
                digest = self.server.kv_digest
            return self._reply(200, str(digest).encode())
        self._reply(404)

    def do_POST(self):
        """Atomic fetch-and-increment counter per (scope, key) — used for
        per-host slot claims (reference: the spark driver service's
        task-registration counter, spark/runner.py:47-426). A non-empty
        body names the logical claimant: re-presenting the same body
        returns the original index (idempotent under task retries)."""
        scope, key = self._split()
        length = int(self.headers.get("Content-Length", 0))
        claimant = self.rfile.read(length)
        n = _kv_apply(self.server, "claim", scope, key, claimant)
        self._reply(200, str(n).encode())

    def do_DELETE(self):
        scope, key = self._split()
        _kv_apply(self.server, "delete", scope, key, b"")
        self._reply(200)


class RendezvousServer:
    """Threaded HTTP KV store (reference: runner/http/http_server.py),
    in memory.  ``wal_dir`` (or ``HOROVOD_RENDEZVOUS_WAL_DIR``), the
    reference's write-ahead-logged replica set, raises."""

    def __init__(self, port: int = 0, wal_dir: str | None = None) -> None:
        self._httpd = ThreadingHTTPServer(("", port), _KVHandler)
        self._httpd.kv = {}
        self._httpd.counters = {}
        self._httpd.claims = {}
        self._httpd.kv_digest = _FNV_OFFSET
        self._httpd.kv_lock = threading.Lock()
        self._httpd.kv_cond = threading.Condition(self._httpd.kv_lock)
        if wal_dir or config.RENDEZVOUS_WAL_DIR.get():
            self._httpd.server_close()
            raise NotImplementedError(
                "a write-ahead-logged rendezvous replica set "
                "(HOROVOD_RENDEZVOUS_WAL_DIR) is ROADMAP queue A item 12")
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="hvd-rendezvous")
        self._thread.start()
        return self.port

    def put(self, scope: str, key: str, value: bytes) -> None:
        _kv_apply(self._httpd, "put", scope, key, value)

    def put_many(self, records) -> None:
        """Batched puts (``[(scope, key, value), ...]``) applied under
        one lock hold — the in-proc mirror of ``PUT /.batch/``."""
        _kv_apply_many(self._httpd, list(records))

    def get(self, scope: str, key: str) -> bytes | None:
        with self._httpd.kv_lock:
            return self._httpd.kv.get(scope, {}).get(key)

    def get_scope(self, scope: str) -> dict[str, bytes]:
        with self._httpd.kv_lock:
            return dict(self._httpd.kv.get(scope, {}))

    def kv_digest(self) -> int:
        """Rolling FNV digest of every applied mutation (matches the
        digest a WAL replay of the same history computes)."""
        with self._httpd.kv_lock:
            return self._httpd.kv_digest

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            # Reap the serve thread (hvdlife HVD701): shutdown() above
            # is its wakeup, so the join is prompt.
            self._thread.join(timeout=5.0)
            self._thread = None


# Long-poll chunk a single wait() request asks the server to hold for;
# short enough that endpoint failover is never stalled behind one
# outstanding request for long.
_LONG_POLL_CHUNK_S = 5.0
# Jittered exponential retry backoff between endpoint attempts.
_BACKOFF_FLOOR_S = 0.01
_BACKOFF_CAP_S = 0.25
# Per-attempt HTTP timeout: one stalled endpoint (SIGSTOP'd primary, a
# half-open socket) must never eat the whole retry deadline — the next
# seed gets its turn after this bound.
_ATTEMPT_TIMEOUT_S = 5.0


class RendezvousClient:
    """HTTP KV client with blocking get (reference: gloo/http_store.cc
    wait) and multi-endpoint failover: ``addr`` may be a single host
    (paired with ``port``) or a comma-separated ``host:port`` seed list
    (every replica of a fault-tolerant control plane).  Idempotent
    verbs — get/wait/delete/put/claim-with-``task_key`` — retry across
    endpoints with jittered exponential backoff inside one deadline,
    riding out a coordinator restart or failover window; a bare claim
    (no ``task_key``) still fails fast, since a retry could double-
    allocate its index."""

    def __init__(self, addr: str, port: int | None = None,
                 timeout: float = 30.0, endpoints=None) -> None:
        if endpoints is not None:
            self._endpoints = list(endpoints)
        else:
            self._endpoints = self.parse_endpoints(addr, port)
        self._active = 0
        self.timeout = timeout
        # Per-verb latency histograms, bound lazily to the live registry
        # (telemetry may be configured after the client is built).
        self._lat: dict[str, object] = {}
        self._lat_reg = None

    def _observe_latency(self, verb: str, start: float) -> None:
        """Record one verb's wall time (retries + failover included) on
        ``horovod_rendezvous_kv_latency_ms{verb}``."""
        from ..telemetry import metrics
        tm = metrics()
        if not tm.enabled:
            return
        if self._lat_reg is not tm:
            self._lat = {}
            self._lat_reg = tm
        hist = self._lat.get(verb)
        if hist is None:
            hist = tm.histogram(
                "horovod_rendezvous_kv_latency_ms",
                "Client-observed rendezvous KV verb latency, failover "
                "retries included", labels={"verb": verb})
            self._lat[verb] = hist
        hist.observe((time.monotonic() - start) * 1e3)

    @staticmethod
    def parse_endpoints(addr: str, port: int | None) -> list[str]:
        """``"h1:p1,h2:p2"`` (seed list) or ``("host", port)``."""
        eps = []
        for part in str(addr).split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part and port is None:
                raise ValueError(
                    f"rendezvous endpoint {part!r} has no port and no "
                    f"default port was given")
            eps.append(part if ":" in part else f"{part}:{port}")
        if not eps:
            raise ValueError("rendezvous client needs at least one "
                             "endpoint")
        return eps

    @property
    def endpoint(self) -> str:
        return self._endpoints[self._active]

    @property
    def _base(self) -> str:
        return f"http://{self.endpoint}"

    def _failover(self, failed: str, why, hint: str = "") -> None:
        """Move to the hinted leader (409 redirect) or the next seed;
        one structured warning names the endpoint per transition."""
        if hint:
            if hint not in self._endpoints:
                self._endpoints.append(hint)
            nxt = self._endpoints.index(hint)
        else:
            nxt = (self._active + 1) % len(self._endpoints)
        if nxt != self._active:
            logger.warning(
                "rendezvous: endpoint %s unavailable (%s); failing "
                "over to %s", failed, why, self._endpoints[nxt])
        self._active = nxt

    def _call(self, method: str, scope: str, key: str,
              data: bytes | None = None, query: str = "",
              idempotent: bool = True,
              deadline: float | None = None,
              attempt_timeout: float | None = None,
              verb: str | None = None) -> bytes | None:
        """One verb with bounded endpoint failover.  Returns the body,
        or None on 404.  Non-idempotent calls never retry a transport
        error (the request may have committed server-side); 409 leader
        redirects are always safe to follow — a refused request was
        never applied."""
        if deadline is None:
            deadline = time.monotonic() + self.timeout
        if attempt_timeout is None:
            attempt_timeout = min(self.timeout, _ATTEMPT_TIMEOUT_S)
        verb = verb or method.lower()
        start = time.monotonic()
        attempt = 0
        last_exc: Exception | None = None
        while True:
            endpoint = self.endpoint
            req = urlrequest.Request(
                f"http://{endpoint}/{scope}/{key}{query}",
                data=data, method=method)
            try:
                with urlrequest.urlopen(
                        req, timeout=attempt_timeout) as resp:
                    body = resp.read()
                self._observe_latency(verb, start)
                return body
            except urlerror.HTTPError as e:
                if e.code == 404:
                    self._observe_latency(verb, start)
                    return None
                if e.code not in (409, 503):
                    raise
                last_exc = e
                self._failover(endpoint, f"HTTP {e.code}",
                               e.headers.get("X-Hvd-Leader", ""))
            except (urlerror.URLError, ConnectionError, TimeoutError,
                    OSError) as e:
                if not idempotent:
                    raise
                last_exc = e
                reason = getattr(e, "reason", e)
                self._failover(endpoint, reason)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rendezvous {method} {scope}/{key} failed against "
                    f"every endpoint {self._endpoints} within the "
                    f"deadline") from last_exc
            delay = min(_BACKOFF_FLOOR_S * (2 ** attempt),
                        _BACKOFF_CAP_S)
            time.sleep(delay * random.uniform(0.5, 1.0))
            attempt += 1

    def put(self, scope: str, key: str, value: bytes) -> None:
        # A put is a blind last-write-wins set: retrying a possibly-
        # committed put re-applies the same value (idempotent).
        self._call("PUT", scope, key, data=value)

    def put_many(self, records) -> None:
        """Batched puts: ``[(scope, key, value), ...]`` in ONE request
        (``PUT /.batch/``), applied server-side under a single lock
        hold.
        Idempotent — every record is a last-write-wins put."""
        records = list(records)
        if not records:
            return
        self._call("PUT", BATCH_SCOPE, "", data=encode_batch(records),
                   verb="put_many")

    def get_scope(self, scope: str) -> dict[str, bytes]:
        """One request returning the scope's full key->value dict (the
        empty-key GET): what a fleetsim host group polls instead of
        size-many per-peer gets."""
        raw = self._call("GET", scope, "", verb="get_scope")
        return {} if raw is None else decode_scope(raw)

    def claim(self, scope: str, key: str, task_key: str = "") -> int:
        """Atomic fetch-and-increment of the (scope, key) counter.
        A non-empty ``task_key`` makes the claim idempotent: retries
        with the same key get the originally assigned index back (and
        may therefore safely ride endpoint failover)."""
        raw = self._call("POST", scope, key, data=task_key.encode(),
                         idempotent=bool(task_key))
        return int(raw)

    def get(self, scope: str, key: str) -> bytes | None:
        return self._call("GET", scope, key)

    def delete(self, scope: str, key: str = "") -> None:
        """Delete one key (or a whole scope when ``key`` is empty) —
        statesync consumes its join/ready/donation marks so a later
        epoch's watcher never replays a resolved event."""
        self._call("DELETE", scope, key)

    def probe(self) -> str | None:
        """The active endpoint's ``/.ctl/role`` descriptor, or None
        when no endpoint answers (control-plane health check)."""
        try:
            raw = self._call("GET", ".ctl", "role")
        except (TimeoutError, urlerror.URLError, OSError):
            return None
        return raw.decode() if raw is not None else None

    def find_primary(self) -> str | None:
        """Probe every seed DIRECTLY (each replica answers ``/.ctl``
        for itself) and return the endpoint currently acting as
        primary, retargeting the client at it.  None while no replica
        leads (mid-election)."""
        for i, endpoint in enumerate(list(self._endpoints)):
            try:
                with urlrequest.urlopen(
                        f"http://{endpoint}/.ctl/role",
                        timeout=2.0) as resp:
                    role = resp.read().decode()
            except OSError:
                continue
            if role.startswith("primary"):
                self._active = i
                return endpoint
        return None

    def wait(self, scope: str, key: str,
             timeout: float | None = None) -> bytes:
        """Block until the key exists.  Each request long-polls
        server-side (``?wait=<ms>``) so a steady-state watcher keeps
        ONE outstanding request instead of busy-polling at 100 req/s;
        between failed attempts the retry backs off with jitter
        (10 ms -> 250 ms cap)."""
        total = timeout or self.timeout
        deadline = time.monotonic() + total
        delay = _BACKOFF_FLOOR_S
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"Rendezvous key {scope}/{key} not available after "
                    f"{total}s")
            chunk_ms = int(min(remaining, _LONG_POLL_CHUNK_S) * 1e3)
            try:
                # The server legitimately holds the request for the
                # whole chunk: the per-attempt bound must exceed it.
                value = self._call("GET", scope, key,
                                   query=f"?wait={chunk_ms}",
                                   deadline=deadline,
                                   attempt_timeout=chunk_ms / 1e3 + 5.0,
                                   verb="wait")
            except TimeoutError:
                raise TimeoutError(
                    f"Rendezvous key {scope}/{key} not available after "
                    f"{total}s (endpoints {self._endpoints})") from None
            if value is not None:
                return value
            time.sleep(delay * random.uniform(0.5, 1.0))
            delay = min(delay * 2, _BACKOFF_CAP_S)


def advertised_hello() -> tuple[int, int]:
    """The wire proto version + feature bits this process offers at
    channel establishment: the build's native version.  (The reference's
    ``HOROVOD_PROTO_COMPAT`` pin for rolling upgrades comes with the
    launcher, ROADMAP queue A item 12.)"""
    return wire.PROTO_VERSION, wire.proto_features(wire.PROTO_VERSION)


# ---------------------------------------------------------------------------
# Persistent duplex channel to one peer
# ---------------------------------------------------------------------------
class _PeerChannel:
    """One long-lived socket to a peer with a persistent sender lane.

    Sends enqueue onto a bounded queue drained by ONE daemon thread that
    lives as long as the channel (spawned lazily on the first async send,
    so control-plane meshes that never bulk-send cost zero threads).
    Receives go through `recv_begin` (framing) + `recv_exact_into`
    (straight into the caller's buffer) or the reusable scratch pool —
    the zero-copy replacement for the old alloc-per-message recv.
    """

    __slots__ = ("sock", "peer", "_queue", "_sender", "_error",
                 "_scratch", "_hdr", "_on_sent", "_res")

    def __init__(self, sock: socket.socket, peer: int, on_sent,
                 resilience=None) -> None:
        self.sock = sock
        self.peer = peer
        self._queue: queue.Queue | None = None
        self._sender: threading.Thread | None = None
        self._error: BaseException | None = None
        self._scratch = bytearray(0)
        self._hdr = bytearray(4)
        self._on_sent = on_sent    # bytes counter callback (mesh-level)
        # Resilience (HOROVOD_FAULT_TOLERANCE): a non-None state installs
        # a short socket timeout so every blocking wait on this channel
        # becomes a deadline-bounded poll loop — between slices the state
        # raises RanksFailedError on peer death or per-op deadline expiry
        # instead of blocking forever.  None = the exact pre-resilience
        # syscall pattern (zero-overhead off mode).
        self._res = resilience
        if resilience is not None:
            self.sock.settimeout(resilience.poll_interval)

    def _dead(self, exc: BaseException) -> BaseException:
        """Latch a failure on the channel: later sends/recvs raise it
        immediately instead of re-waiting out a deadline on a stream
        that is already known broken (and possibly desynced)."""
        if self._error is None:
            self._error = exc
        return exc

    # -- sending ----------------------------------------------------------
    def send_async(self, payload) -> None:
        """Enqueue one framed message on the persistent sender lane.  The
        caller must not mutate `payload`'s buffer until the channel is
        flushed (collectives flush before returning results)."""
        if self._error is not None:
            raise self._error
        if self._sender is None:
            self._queue = queue.Queue(maxsize=_SEND_QUEUE_DEPTH)
            self._sender = threading.Thread(
                target=self._send_loop, daemon=True,
                name=f"hvd-send-{self.peer}")
            self._sender.start()
        self._queue.put(_as_byte_view(payload))

    def send_sync(self, payload) -> int:
        """Blocking framed send; routed through the sender lane when one
        exists so sync and async frames never interleave on the wire.
        Returns the bytes to account (0 when the lane already counted
        them through its completion callback)."""
        view = _as_byte_view(payload)
        if self._sender is not None:
            self.send_async(view)
            self.flush()
            return 0
        self._send_gather(view)
        return view.nbytes

    def _send_gather(self, view: memoryview) -> None:
        """Framed scatter-gather send, deadline-bounded when resilience
        is on: a sendmsg stalled on a wedged peer's zero-window socket
        polls in slices and raises RanksFailedError at the op deadline
        instead of blocking the lane forever (progress resets the clock —
        the deadline bounds silence, not transfer time)."""
        if self._res is None:
            send_msg_gather(self.sock, view)
            return
        n = view.nbytes
        hdr = _LEN.pack(n)
        sent = 0
        start = time.monotonic()
        while sent < 4 + n:
            try:
                if sent == 0:
                    sent += self.sock.sendmsg([hdr, view])
                elif sent < 4:
                    sent += self.sock.send(memoryview(hdr)[sent:])
                else:
                    sent += self.sock.send(view[sent - 4:])
            except TimeoutError:
                self._res.check(self.peer, time.monotonic() - start,
                                "send")
                continue
            except (ConnectionResetError, BrokenPipeError) as e:
                raise self._dead(self._res.peer_connection_lost(
                    self.peer, "send", str(e))) from e
            start = time.monotonic()

    def _send_loop(self) -> None:
        while True:
            view = self._queue.get()
            try:
                if view is None:
                    return
                self._send_gather(view)
                self._on_sent(view.nbytes)
            except BaseException as e:  # noqa: BLE001 - surfaced to caller
                if self._error is None:
                    self._error = e
                # Wake a peer blocked in recv on the dead channel.
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Block until every queued frame has been handed to the kernel
        (the pre-channel code's per-step join gave the same guarantee).
        Bounded indirectly: under fault tolerance every send the lane
        drains is itself deadline-bounded, so the join below terminates
        within one op deadline of a peer failure."""
        if self._queue is not None:
            self._queue.join()
        if self._error is not None:
            raise self._error

    # -- receiving --------------------------------------------------------
    def recv_exact_into(self, view: memoryview) -> None:
        got, n = 0, view.nbytes
        if self._res is None:   # zero-overhead off mode: original loop
            while got < n:
                r = self.sock.recv_into(view[got:], n - got)
                if r == 0:
                    raise ConnectionError("socket closed mid-message")
                got += r
            return
        start = time.monotonic()
        while got < n:
            try:
                r = self.sock.recv_into(view[got:], n - got)
            except TimeoutError:
                # check() raises RanksFailedError on peer death or op-
                # deadline expiry; otherwise keep polling.
                self._res.check(self.peer, time.monotonic() - start,
                                "recv")
                continue
            except (ConnectionResetError, BrokenPipeError) as e:
                raise self._dead(self._res.peer_connection_lost(
                    self.peer, "recv", str(e))) from e
            if r == 0:
                raise self._dead(self._res.peer_connection_lost(
                    self.peer, "recv", "socket closed mid-message"))
            got += r
            start = time.monotonic()   # progress: deadline bounds silence

    def recv_begin(self) -> int:
        """Read one frame header; the next `nbytes` on the wire are the
        payload, consumed by the caller via recv_exact_into/scratch."""
        if self._error is not None:
            raise self._error
        hv = memoryview(self._hdr)
        self.recv_exact_into(hv)
        return _LEN.unpack(self._hdr)[0]

    def scratch(self, nbytes: int) -> memoryview:
        """A reusable receive buffer of at least `nbytes` (grown
        geometrically, never shrunk): steady-state receives allocate
        nothing.  Contents are valid until the next scratch recv on this
        channel — consume before receiving again."""
        if len(self._scratch) < nbytes:
            self._scratch = bytearray(max(nbytes, 2 * len(self._scratch)))
        return memoryview(self._scratch)[:nbytes]

    def close(self) -> None:
        """Shutdown-leak fix (mirrors the Timeline writer fix): poison
        the queue FIRST, then join.  The old order (bounded join with no
        poison-first guarantee) could time out silently and leak the
        sender thread plus its bounded queue — every payload it
        referenced stayed pinned for the process lifetime.  A sender
        wedged in sendmsg on a dead peer is woken by shutting the socket
        down under it; if it STILL survives, a structured warning names
        the peer instead of hiding the leak."""
        if self._sender is not None:
            try:
                self.flush()
            except BaseException:  # noqa: BLE001 - already torn down
                pass
            self._queue.put(None)                      # poison first
            self._sender.join(timeout=_CLOSE_JOIN_GRACE)
            if self._sender.is_alive():
                # Unblock a send wedged on a dead/zero-window peer, then
                # give the lane one more chance to observe the poison.
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self._sender.join(timeout=1.0)
            if self._sender.is_alive():
                logger.warning(
                    "peer-channel close: sender thread for peer %d "
                    "survived poison + socket shutdown (queue depth %d); "
                    "leaking it as daemon", self.peer,
                    self._queue.qsize() if self._queue is not None else -1)
            self._sender = None
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Full-mesh point-to-point connections between ranks
# ---------------------------------------------------------------------------
class PeerMesh:
    """Connect every pair of ranks once; expose send/recv by peer rank.

    Bootstraps peer addresses through the rendezvous KV store, then lower
    rank listens / higher rank connects (the reference's gloo
    connectFullMesh does the same through its HTTPStore).
    """

    def __init__(self, rank: int, size: int, kv: RendezvousClient,
                 scope: str = "mesh", timeout: float = 30.0,
                 resilience=None) -> None:
        self.rank = rank
        self.size = size
        self.scope = scope
        # Resilience (HOROVOD_FAULT_TOLERANCE) + chaos (HOROVOD_CHAOS):
        # captured at formation.  Both None in the default off mode, so
        # the per-call cost is one attribute test; tests may inject a
        # private ResilienceState (the process default is rank-global).
        self._resilience = resilience if resilience is not None \
            else _resilience_state()
        self._chaos = _chaos_engine()
        self._socks: dict[int, socket.socket] = {}
        self._channels: dict[int, _PeerChannel] = {}
        self._lock = threading.Lock()
        # Payload byte counters (framing excluded): the observability the
        # compression subsystem's bandwidth claims are asserted against
        # (tests/test_compress.py) and PERFORMANCE.md numbers come from.
        self.bytes_sent = 0
        self.bytes_received = 0
        # Telemetry (HOROVOD_METRICS): per-peer wire counters + send-queue
        # depth, labelled by mesh scope so control/data/stream meshes stay
        # distinguishable.  Null registry when off — per-call cost is one
        # attribute test on _tm_on.
        from ..telemetry import metrics as _tm_metrics
        self._tm = _tm_metrics()
        self._tm_on = self._tm.enabled
        self._tm_sent: dict[int, object] = {}
        self._tm_recv: dict[int, object] = {}
        self._tm_qdepth = self._tm.histogram(
            "horovod_tcp_send_queue_depth",
            "Outbound frames queued on a peer's persistent sender lane "
            "at enqueue time", labels={"mesh": scope}) if self._tm_on \
            else None
        # Versioned wire handshake (HELLO{proto_version, feature_bits},
        # exchanged on every pair socket at formation): the mesh-wide
        # negotiated schema is the min proto / AND of feature bits over
        # every peer — identical on all ranks by construction, so one
        # encode per broadcast serves the whole world and optional
        # field groups (fp_*/tm_*/trace_*) are gated symmetrically.
        self.proto_version, self.features = advertised_hello()
        self.peer_protos: dict[int, int] = {}
        self.negotiated_proto = self.proto_version
        self.negotiated_features = self.features
        if size == 1:
            return

        listener = socket.socket()
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("", 0))
        listener.listen(size)
        port = listener.getsockname()[1]
        host = self._advertised_host()
        kv.put(scope, f"addr:{rank}", f"{host}:{port}".encode())

        expected_inbound = size - 1 - rank   # peers with higher rank dial in
        accepted: dict[int, socket.socket] = {}

        def _tune(sock: socket.socket) -> None:
            # Bulk data plane: large kernel buffers keep the ring's
            # concurrent 1-8 MB chunk exchanges streaming instead of
            # ping-ponging on default (~200 KB) windows.
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
                try:
                    sock.setsockopt(socket.SOL_SOCKET, opt, 4 << 20)
                except OSError:
                    pass

        hello = wire.pack_hello(self.proto_version, self.features)
        peer_hellos: dict[int, tuple[int, int]] = {}

        def _accept():
            for _ in range(expected_inbound):
                conn, _ = listener.accept()
                peer = int.from_bytes(recv_exact(conn, 4), "big")
                peer_hellos[peer] = wire.unpack_hello(
                    recv_exact(conn, wire.HELLO_LEN))
                conn.sendall(hello)
                _tune(conn)
                accepted[peer] = conn

        acceptor = threading.Thread(target=_accept, daemon=True,
                                    name="hvd-mesh-accept")
        acceptor.start()

        for peer in range(rank):   # dial every lower-ranked peer
            raw = kv.wait(scope, f"addr:{peer}", timeout).decode()
            peer_host, peer_port = raw.rsplit(":", 1)
            deadline = time.monotonic() + timeout
            while True:
                try:
                    sock = socket.create_connection(
                        (peer_host, int(peer_port)), timeout=timeout)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            _tune(sock)
            sock.sendall(self.rank.to_bytes(4, "big") + hello)
            peer_hellos[peer] = wire.unpack_hello(
                recv_exact(sock, wire.HELLO_LEN))
            self._socks[peer] = sock

        acceptor.join(timeout)
        if len(accepted) != expected_inbound:
            raise TimeoutError(
                f"rank {rank}: only {len(accepted)}/{expected_inbound} "
                f"inbound peers connected")
        self._socks.update(accepted)
        listener.close()
        self._negotiate_wire(peer_hellos)
        for peer, sock in self._socks.items():
            self._channels[peer] = _PeerChannel(sock, peer,
                                                self._count_sent,
                                                resilience=self._resilience)

    def _negotiate_wire(self, peer_hellos: dict) -> None:
        """Fold every peer's HELLO into the mesh-wide negotiated wire
        schema and export the per-peer proto gauge.  The fold is
        order-free (min / AND), so every rank lands on the identical
        (proto, features) pair without an extra exchange."""
        proto, feats = self.proto_version, self.features
        for peer_proto, peer_feats in peer_hellos.values():
            proto, feats = wire.negotiate(proto, feats, peer_proto,
                                          peer_feats)
        self.negotiated_proto = proto
        self.negotiated_features = feats
        self.peer_protos = {p: h[0] for p, h in peer_hellos.items()}
        if self._tm_on:
            for peer, (peer_proto, _pf) in sorted(peer_hellos.items()):
                self._tm.gauge(
                    "horovod_wire_proto_version",
                    "Wire protocol version the peer advertised at "
                    "channel establishment",
                    labels={"mesh": self.scope,
                            "peer": str(peer)}).set(peer_proto)

    @staticmethod
    def _advertised_host() -> str:
        """Address peers dial: HOROVOD_GLOO_IFACE pins the NIC when set
        (reference: gloo_context.cc reads the same variable to select the
        Gloo transport device); otherwise the hostname's address."""
        if os.environ.get("HOROVOD_GLOO_IFACE"):
            raise NotImplementedError(
                "HOROVOD_GLOO_IFACE (NIC selection through the launcher's "
                "driver service) is ROADMAP queue A item 12")
        return socket.gethostbyname(socket.gethostname())

    def _count_sent(self, nbytes: int) -> None:
        with self._lock:   # sender lanes run concurrently with the ring
            self.bytes_sent += nbytes

    def _count_received(self, nbytes: int) -> None:
        with self._lock:
            self.bytes_received += nbytes

    # -- per-peer telemetry counters (lazily created per peer) ----------
    def _tm_peer(self, table: dict, name: str, peer: int):
        c = table.get(peer)
        if c is None:
            c = self._tm.counter(
                name, "Payload bytes on the wire by peer rank "
                "(framing excluded)",
                labels={"mesh": self.scope, "peer": str(peer)})
            table[peer] = c
        return c

    def _tm_count_sent(self, peer: int, nbytes: int) -> None:
        self._tm_peer(self._tm_sent,
                      "horovod_tcp_bytes_sent_total", peer).inc(nbytes)

    def _tm_count_recv(self, peer: int, nbytes: int) -> None:
        self._tm_peer(self._tm_recv,
                      "horovod_tcp_bytes_received_total", peer).inc(nbytes)

    def send(self, peer: int, payload: bytes) -> None:
        if self._chaos is not None:
            act = self._chaos.on_send(self.scope, peer)
            if act == "drop":
                return
            if act == "dup":
                self._count_sent(self._channels[peer].send_sync(payload))
        self._count_sent(self._channels[peer].send_sync(payload))
        if self._tm_on:
            self._tm_count_sent(peer, len(payload))

    def send_async(self, peer: int, payload) -> None:
        """Enqueue a framed message on the peer's persistent sender lane
        (counted by the lane on completion).  Zero-copy: the payload
        buffer must stay unmutated until `flush()`."""
        ch = self._channels[peer]
        if self._chaos is not None:
            act = self._chaos.on_send(self.scope, peer)
            if act == "drop":
                return
            if act == "dup":
                ch.send_async(payload)
        ch.send_async(payload)
        if self._tm_on:
            # Depth AFTER the put: what's now waiting on the lane.
            if ch._queue is not None:
                self._tm_qdepth.observe(ch._queue.qsize())
            self._tm_count_sent(peer, _as_byte_view(payload).nbytes)

    def recv(self, peer: int) -> bytearray:
        """Receive one framed message, allocated fresh.  Routed through
        the peer channel so the wait is deadline-bounded under fault
        tolerance (the channel falls back to the original blocking loop
        when resilience is off)."""
        ch = self._channels.get(peer)
        if ch is None:   # size-1 mesh / pre-channel peer: legacy path
            data = recv_msg(self._socks[peer])
        else:
            n = ch.recv_begin()
            data = bytearray(n)
            if n:
                ch.recv_exact_into(memoryview(data))
        self._count_received(len(data))
        if self._tm_on:
            self._tm_count_recv(peer, len(data))
        return data

    # -- zero-copy receive surface (bulk data plane) --------------------
    def recv_begin(self, peer: int) -> int:
        """Read one frame header from `peer`; returns the payload length
        the caller must now consume via recv_raw_into/scratch."""
        n = self._channels[peer].recv_begin()
        self._count_received(n)
        if self._tm_on:
            self._tm_count_recv(peer, n)
        return n

    def recv_raw_into(self, peer: int, view: memoryview) -> None:
        """Receive exactly len(view) payload bytes straight into the
        caller's buffer (no staging copy)."""
        self._channels[peer].recv_exact_into(view)

    def scratch(self, peer: int, nbytes: int) -> memoryview:
        """The peer channel's reusable receive scratch (see
        _PeerChannel.scratch for the validity contract)."""
        return self._channels[peer].scratch(nbytes)

    def recv_in_arrival_order(self, peers):
        """Yield (peer, message) for one framed message from each of
        `peers`, draining whichever peer's bytes arrive first (selectors)
        instead of fixed rank order — one slow rank no longer serializes
        the drain behind the sockets after it."""
        remaining = set(peers)
        if not remaining:
            return
        res = self._resilience
        with selectors.DefaultSelector() as sel:
            for p in remaining:
                sel.register(self._socks[p], selectors.EVENT_READ, p)
            start = time.monotonic()
            while remaining:
                events = sel.select(None if res is None
                                    else res.poll_interval)
                if not events:
                    if res is not None:
                        # Deadline-bounded drain: a silent slice checks
                        # the liveness table and the op deadline,
                        # attributed to the still-missing peers.
                        res.check(min(remaining),
                                  time.monotonic() - start, "gather")
                    continue
                for key, _ in events:
                    peer = key.data
                    sel.unregister(key.fileobj)
                    remaining.discard(peer)
                    yield peer, self.recv(peer)
                start = time.monotonic()

    def flush(self, peer: int | None = None) -> None:
        """Wait until queued sends (to `peer`, or everyone) reached the
        kernel.  Collectives flush before returning so callers may mutate
        result buffers; direct-fd paths (native ring) flush first so raw
        writes never interleave with queued frames."""
        channels = [self._channels[peer]] if peer is not None \
            else self._channels.values()
        for ch in channels:
            ch.flush()

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()
        for sock in self._socks.values():   # size-1 meshes have no channels
            try:
                sock.close()
            except OSError:
                pass
        self._channels.clear()
        self._socks.clear()

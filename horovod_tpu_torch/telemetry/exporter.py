"""Metrics exposition: Prometheus scrape endpoint + shutdown JSON dump.

The port's own copy of ``horovod_tpu/telemetry/exporter.py``.

Both run OFF the hot path by construction: the HTTP server serves scrapes
from its own daemon thread pool (renders a snapshot under the registry's
metric locks only long enough to read each value), and the JSON dump
happens once, at shutdown, after the background loop has exited.

Port layout: each rank tries ``HOROVOD_METRICS_PORT + rank`` (launchers
ship one identical environment to every rank on a host); if that port is
taken it falls back to an ephemeral port and logs the actual one.  The
bound port is always available as ``MetricsExporter.port``.

Bind address: ``HOROVOD_METRICS_BIND``, default ``127.0.0.1`` — metrics
name tensors, hosts, and failure details, so serving them off-host must
be an explicit decision.  Set it to ``0.0.0.0`` (or empty) for a real
Prometheus scrape deployment.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..common import config
from ..common.logging import logger


class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # no stderr chatter per scrape
        pass

    def do_GET(self):
        if self.path not in ("/", "/metrics"):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = self.server.registry.render_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Server(ThreadingHTTPServer):
    """A ``ThreadingHTTPServer`` that keeps its request threads.  The
    stdlib's request threads are daemons that ``server_close`` never
    joins, so one may still be finishing its response after the client
    has read it; ``reap`` ends and joins them."""

    def __init__(self, *args, **kwargs) -> None:
        self._live: dict[threading.Thread, socket.socket] = {}
        self._live_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address) -> None:
        t = threading.Thread(target=self._serve_one,
                             args=(request, client_address), daemon=True,
                             name="hvd-metrics-request")
        with self._live_lock:
            self._live[t] = request
        t.start()

    def _serve_one(self, request, client_address) -> None:
        try:
            self.process_request_thread(request, client_address)
        finally:
            with self._live_lock:
                self._live.pop(threading.current_thread(), None)

    def reap(self, timeout: float) -> None:
        """Shut each live request's socket (a kept-alive connection
        would hold its thread in a read) and join the threads, all
        within ``timeout`` seconds."""
        with self._live_lock:
            live = list(self._live.items())
        for _, request in live:
            try:
                request.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        for t, _ in live:
            t.join(max(0.0, deadline - time.monotonic()))


class MetricsExporter:
    """Prometheus text-format endpoint for one rank's registry."""

    def __init__(self, registry, rank: int, base_port: int,
                 bind: str | None = None) -> None:
        self.registry = registry
        self.rank = rank
        if bind is None:
            bind = config.METRICS_BIND.get()
        self.bind = bind
        want = base_port + rank
        try:
            self._httpd = _Server((bind, want), _MetricsHandler)
        except OSError:
            # Port taken (another world on this host, or a low base):
            # fall back to an ephemeral port rather than failing init.
            self._httpd = _Server((bind, 0), _MetricsHandler)
            logger.info("telemetry: port %d busy; metrics for rank %d on "
                        "port %d instead", want, rank,
                        self._httpd.server_address[1])
        self._httpd.registry = registry
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="hvd-metrics")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        """shutdown() wakes the serve loop, server_close() releases the
        listening socket, and the joins reap the serve thread and the
        request threads: every ``core.init`` with the port knob set
        builds a new exporter, so without them its threads would leak a
        world."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._httpd.reap(timeout=5.0)


def resolve_dump_path(path: str, rank: int) -> str:
    """Per-rank dump path: ``{rank}`` substitutes; otherwise the rank is
    suffixed before the extension (``m.json`` -> ``m.r3.json``) so a
    launcher-wide identical HOROVOD_METRICS_FILE never self-clobbers."""
    if "{rank}" in path:
        return path.format(rank=rank)
    root, dot, ext = path.rpartition(".")
    if dot:
        return f"{root}.r{rank}.{ext}"
    return f"{path}.r{rank}"


def dump_json(registry, path: str, rank: int) -> str:
    """Write the registry snapshot as JSON; returns the resolved path."""
    resolved = resolve_dump_path(path, rank)
    snap = registry.snapshot()
    with open(resolved, "w") as f:
        json.dump(snap, f, indent=1)
    return resolved

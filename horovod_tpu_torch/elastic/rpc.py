"""Tiny authenticated pickle-RPC over TCP.

The port's copy of ``horovod_tpu/elastic/rpc.py``.

Upstream analogue: horovod/runner/common/service/{driver,task}_service.py +
common/util/{network,secret}.py — socket RPC between the launcher driver and
workers, HMAC-signed with a shared per-job secret so arbitrary processes on
the network cannot inject commands.
"""
from __future__ import annotations

import hmac
import hashlib
import os
import pickle
import socket
import threading

from ..common import wire
from ..common.logging import logger
from ..runner.network import advertised_hello, recv_exact, recv_msg, \
    send_msg

_DIGEST = hashlib.sha256
SECRET_ENV = "HOROVOD_SECRET_KEY"


def make_secret() -> str:
    return os.urandom(16).hex()


def _sign(secret: str, payload: bytes) -> bytes:
    return hmac.new(secret.encode(), payload, _DIGEST).digest()


def _pack(secret: str, obj) -> bytes:
    payload = pickle.dumps(obj)
    return _sign(secret, payload) + payload


def _unpack(secret: str, blob: bytes):
    mac, payload = blob[:_DIGEST().digest_size], blob[_DIGEST().digest_size:]
    if not hmac.compare_digest(mac, _sign(secret, payload)):
        raise PermissionError("RPC message failed HMAC verification")
    return pickle.loads(payload)


def _wake_and_close(listener: socket.socket) -> None:
    """Close a listening socket so that a thread blocked in its
    ``accept`` returns at once.  On Linux ``close`` alone does not wake
    ``accept``, and the join after it would wait out its timeout (the
    reference's 5 s at every elastic launcher's exit); ``shutdown``
    does."""
    try:
        listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        listener.close()
    except OSError:
        pass


class RpcServer:
    """Serves method calls on a handler object: any public method becomes an
    RPC endpoint.  One thread per connection; connections may issue many
    calls (workers keep one open)."""

    def __init__(self, handler, secret: str, port: int = 0) -> None:
        self._handler = handler
        self._secret = secret
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("", port))
        self._listener.listen(128)
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="hvd-rpc-accept")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="hvd-rpc-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            # Versioned handshake: the first bytes on every RPC
            # connection are a HELLO exchange, so a driver at framework
            # version N and a worker at N+1 agree on the min common
            # schema before any pickled call crosses (the rolling-
            # upgrade boundary lives exactly on this socket).
            try:
                peer_proto, peer_feats = wire.unpack_hello(
                    recv_exact(conn, wire.HELLO_LEN))
            except (ConnectionError, ValueError) as exc:
                logger.warning("rpc: connection rejected at HELLO: %s",
                               exc)
                return
            proto, feats = advertised_hello()
            conn.sendall(wire.pack_hello(proto, feats))
            while True:
                try:
                    method, args, kwargs = _unpack(self._secret,
                                                   recv_msg(conn))
                except (ConnectionError, EOFError):
                    return
                except PermissionError as exc:
                    logger.warning("rpc: %s", exc)
                    return
                try:
                    if method.startswith("_"):
                        raise AttributeError(method)
                    result = getattr(self._handler, method)(*args, **kwargs)
                    reply = (True, result)
                except Exception as exc:  # noqa: BLE001 - ship to caller
                    reply = (False, exc)
                send_msg(conn, _pack(self._secret, reply))
        finally:
            conn.close()

    def close(self) -> None:
        self._closed = True
        _wake_and_close(self._listener)
        # Reap the accept loop: the shutdown above is its wakeup (accept
        # raises OSError and the loop returns).  Per-connection threads
        # stay daemon by design.
        self._thread.join(timeout=5.0)


class RpcClient:
    """Blocking RPC client; one persistent connection, thread-safe."""

    def __init__(self, addr: str, port: int, secret: str,
                 timeout: float = 30.0) -> None:
        self._sock = socket.create_connection((addr, port), timeout=timeout)
        proto, feats = advertised_hello()
        self._sock.sendall(wire.pack_hello(proto, feats))
        self.peer_proto, peer_feats = wire.unpack_hello(
            recv_exact(self._sock, wire.HELLO_LEN))
        self.negotiated_proto, self.negotiated_features = wire.negotiate(
            proto, feats, self.peer_proto, peer_feats)
        # Calls may legitimately block far longer than the connect timeout:
        # get_assignment waits server-side for a rendezvous round (up to the
        # driver's elastic_timeout).  Block until the server answers or the
        # connection breaks — a short recv timeout here would crash healthy
        # workers and cascade into host blacklisting.
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._secret = secret
        self._lock = threading.Lock()

    def call(self, method: str, *args, **kwargs):
        with self._lock:
            send_msg(self._sock, _pack(self._secret, (method, args, kwargs)))
            ok, result = _unpack(self._secret, recv_msg(self._sock))
        if not ok:
            raise result
        return result

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

"""NIC discovery / reachability probing between the launcher ("driver")
and worker hosts.

The port's copy of ``horovod_tpu/runner/driver_service.py``.  Upstream
(horovod/runner/driver/driver_service.py + runner/task/task_service.py),
before launching, spawns a probe on every worker host that attempts to
connect back to each of the driver's interface addresses; the launcher
then advertises only addresses every host can actually reach (multi-NIC
clusters routinely have interfaces that exist but don't route, e.g.
docker0 or an IB fabric the head node isn't on).

Pieces:
- :func:`candidate_addresses` — the driver's IPv4 addresses (psutil),
  routable NICs first, loopback last;
- :class:`ProbeServer` — one listening socket; workers dial each
  candidate ``(addr, port)`` and get a banner back;
- :func:`probe` / ``python -m horovod_tpu_torch.runner.driver_service``
  — the worker-side client, printing the reachable subset as JSON;
- :func:`discover_common_interfaces` — runs the probe on every remote
  host through a caller-supplied exec function (ssh in production, a
  local shell in tests) and intersects the results.
"""
from __future__ import annotations

import json
import socket
import sys
import threading
from typing import Callable, Sequence

# The reference's banner, so either package's probe reads the other's.
_BANNER = b"hvd-tpu-probe\n"


def candidate_addresses(interface: str | None = None) -> list[str]:
    """This host's IPv4 addresses; ``interface`` restricts to one NIC.
    Routable addresses come first, loopback last (it is only reachable
    from local workers)."""
    import psutil

    addrs: list[str] = []
    loopback: list[str] = []
    for nic, entries in psutil.net_if_addrs().items():
        if interface is not None and nic != interface:
            continue
        for entry in entries:
            if entry.family != socket.AF_INET:
                continue
            (loopback if entry.address.startswith("127.")
             else addrs).append(entry.address)
    if interface is not None and not (addrs or loopback):
        raise ValueError(f"no IPv4 address on interface {interface!r}")
    return addrs + loopback


class ProbeServer:
    """Accepts probe connections on every interface and replies with a
    banner so clients can distinguish "something listens here" from an
    unrelated service."""

    def __init__(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-probe")
        self._thread.start()

    def _loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                conn.sendall(_BANNER)
            except OSError:
                pass
            finally:
                conn.close()

    def close(self) -> None:
        self._closed = True
        # shutdown wakes the blocked accept; close alone does not on
        # Linux, and the join would wait out its timeout.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


def probe(addresses: Sequence[str], port: int,
          timeout: float = 2.0) -> list[str]:
    """Worker side: which of ``addresses`` accept a connection on
    ``port`` and answer with the probe banner."""
    from .network import recv_exact

    reachable = []
    for addr in addresses:
        try:
            with socket.create_connection((addr, port),
                                          timeout=timeout) as s:
                s.settimeout(timeout)
                # recv_exact: a single recv may legally return a partial
                # banner (TCP segmentation on tunneled links).
                if recv_exact(s, len(_BANNER)) == _BANNER:
                    reachable.append(addr)
        except OSError:
            continue
    return reachable


def discover_common_interfaces(
        hostnames: Sequence[str],
        remote_exec: Callable[[str, list[str]], str],
        interface: str | None = None,
        timeout: float = 10.0) -> list[str]:
    """Driver side: start a probe server, run the probe client on every
    host through ``remote_exec(hostname, argv) -> stdout``, and return
    the addresses every host reached (driver NIC order preserved).

    ``remote_exec`` is ssh in production (see runner.hosts.ssh_argv);
    tests substitute a local shell."""
    addresses = candidate_addresses(interface)
    server = ProbeServer()
    try:
        common = list(addresses)
        argv = [sys.executable, "-m",
                "horovod_tpu_torch.runner.driver_service",
                str(server.port), ",".join(addresses), str(timeout)]
        for hostname in hostnames:
            out = remote_exec(hostname, argv)
            line = out.strip().splitlines()[-1] if out.strip() else "[]"
            reachable = set(json.loads(line))
            common = [a for a in common if a in reachable]
        if not common:
            raise RuntimeError(
                f"no common reachable interface: driver addresses "
                f"{addresses} are not all reachable from {hostnames}")
        return common
    finally:
        server.close()


def main() -> int:
    port = int(sys.argv[1])
    addresses = [a for a in sys.argv[2].split(",") if a]
    timeout = float(sys.argv[3]) if len(sys.argv) > 3 else 2.0
    print(json.dumps(probe(addresses, port, timeout=timeout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

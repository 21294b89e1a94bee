"""Host parsing and rank assignment.

The port's copy of ``horovod_tpu/runner/hosts.py`` (upstream
horovod/runner/common/util/hosts.py) — `parse_hosts` turns
"h1:2,h2:4" into host/slot records and `get_host_assignments` hands out
ranks round-robin host-major, producing for every slot its global rank,
local rank (within host) and cross rank (host index among hosts that hold
that local rank).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(host_string: str) -> "HostInfo":
        if ":" in host_string:
            name, slots = host_string.rsplit(":", 1)
            return HostInfo(name.strip(), int(slots))
        return HostInfo(host_string.strip(), 1)


@dataclasses.dataclass
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_env(self) -> dict[str, str]:
        """Env block consumed at init (reference: gloo_run.py:187-198)."""
        return {
            "HOROVOD_HOSTNAME": self.hostname,
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
        }


def parse_hosts(hosts_string: str) -> list[HostInfo]:
    """Parse "host1:2,host2:4" (reference: hosts.py parse_hosts)."""
    return [HostInfo.from_string(x) for x in hosts_string.split(",") if x]


def parse_host_files(filename: str) -> str:
    """Read a hostfile with "hostname slots=N" per line into the
    "h1:n1,h2:n2" form (reference: launch.py parse_host_files)."""
    hosts = []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            name = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p[len("slots="):])
            hosts.append(f"{name}:{slots}")
    return ",".join(hosts)


def get_host_assignments(hosts: list[HostInfo], min_np: int,
                         max_np: int | None = None) -> list[SlotInfo]:
    """Assign ranks host-major (reference: hosts.py:155
    get_host_assignments): fill each host's slots in order, stop at
    max_np; error if fewer than min_np slots exist."""
    max_np = max_np or min_np
    slots: list[tuple[str, int]] = []          # (hostname, local_rank)
    for h in hosts:
        for lr in range(h.slots):
            if len(slots) >= max_np:
                break
            slots.append((h.hostname, lr))
    if len(slots) < min_np:
        raise ValueError(
            f"requested {min_np} processes but only {len(slots)} slots "
            f"available on {','.join(h.hostname for h in hosts)}")

    size = len(slots)
    local_sizes: dict[str, int] = {}
    for hostname, _ in slots:
        local_sizes[hostname] = local_sizes.get(hostname, 0) + 1
    # cross world for local_rank L = hosts that have a slot with that L;
    # cross_rank = this host's position within that per-L host list.
    hosts_with_lr: dict[int, list[str]] = {}
    for hostname, lr in slots:
        hosts_with_lr.setdefault(lr, []).append(hostname)

    assignments = []
    for rank, (hostname, lr) in enumerate(slots):
        peers = hosts_with_lr[lr]
        assignments.append(SlotInfo(
            hostname=hostname, rank=rank, local_rank=lr,
            cross_rank=peers.index(hostname), size=size,
            local_size=local_sizes[hostname], cross_size=len(peers)))
    return assignments


def host_ids_env(assignments: list[SlotInfo]) -> str:
    """World-wide rank→host-index map ("0,0,1,1") for the slot layout.

    Per-slot env (``SlotInfo.to_env``) tells each rank only its OWN host;
    topology-aware collectives need the whole map to group ring orders by
    host when the layout is not the homogeneous host-major shape that
    local_size/cross_size auto-detection covers (elastic re-assignments,
    uneven slots-per-host).  The string is identical for every rank —
    launcher-uniform, so algo/ring-order decisions derived from it stay
    rank-symmetric.
    """
    by_rank = sorted(assignments, key=lambda s: s.rank)
    order: dict[str, int] = {}
    for slot in by_rank:
        order.setdefault(slot.hostname, len(order))
    return ",".join(str(order[s.hostname]) for s in by_rank)


def is_local_host(hostname: str) -> bool:
    """True for localhost and any 127/8 loopback alias.  Loopback aliases
    count as local everywhere (launcher AND programmatic run) so the
    multi-host-without-a-cluster trick (SURVEY §4: distinct loopback IPs
    act as distinct "hosts" with their own host hashes) behaves the same
    from every entry point."""
    import re
    return hostname in ("localhost", "127.0.0.1") or \
        bool(re.fullmatch(r"127(\.\d{1,3}){3}", hostname))


def ssh_argv(hostname: str, script: str) -> list[str]:
    """The shared remote-exec command shape (one place to keep ssh options
    in sync across the launcher and hvd.run)."""
    import shlex
    return ["ssh", "-o", "StrictHostKeyChecking=no", hostname,
            f"/bin/sh -c {shlex.quote(script)}"]

"""Topology discovery and neighbor-preferring ring construction.

The port's copy of ``horovod_tpu/common/topology.py``, with the explicit
rank-to-host map (``HOROVOD_HOST_IDS``) that the launcher and the elastic
driver set.

Reference: arXiv:1909.09756 (MLPerf on TPU-v3 pods) — the interconnect is
a 2-D torus of hosts×chips, and collective schedules that walk physical
neighbors (torus-ordered rings, hierarchical host×chip reduction) beat
layout-oblivious rings by keeping every hop on an adjacent link.

This module is the single source of truth for *what the layout is*; the
data planes (backend/tcp.py, backend/hierarchical.py) consume it as a
ring-order permutation, a torus shape, and a list of hierarchy levels.

Declaration: `HOROVOD_TOPOLOGY` =
  - ``flat``       — layout-oblivious; identity ring order (the pre-18
                     behavior, and the safe default for unknown fabrics);
  - ``host``       — two-level host×slot layout; ring orders keep
                     intra-host peers adjacent so cross-host links carry
                     only 1/local_size of the ring bytes;
  - ``torus:RxC``  — R×C grid, rank = row*C + col (row-major); ring
                     orders walk the grid boustrophedon (snake) so every
                     ring hop is a grid-neighbor link, and the two-phase
                     torus allreduce becomes eligible;
  - ``""`` (auto)  — ``host`` when the launcher env describes a
                     homogeneous two-level host-major layout (the same
                     eligibility test the hierarchical backend applies),
                     else ``flat``.

The knob is launcher-set and identical on every rank, so every consumer
below derives rank-symmetric decisions from it (the deadlock-freedom
invariant: algorithm choice additionally rides the negotiated
ResponseList, never a local heuristic).
"""
from __future__ import annotations

from dataclasses import dataclass

from . import config

# Allreduce algorithm vocabulary shared by the selection logic
# (backend/tcp.py), the autotuner sweep (parameter_manager.py) and the
# ResponseList.tuned_algo wire field: the svarint carries the index.
ALGO_NAMES = ("auto", "ring", "tree", "rhd", "torus")


def algo_index(name: str) -> int:
    """Wire index of an algorithm name (HVD_ALGO / tuned_algo)."""
    return ALGO_NAMES.index(name)


def algo_name(index: int) -> str:
    """Algorithm name for a tuned_algo wire index (bounds-checked: an
    out-of-range index from a newer peer degrades to 'auto')."""
    return ALGO_NAMES[index] if 0 <= index < len(ALGO_NAMES) else "auto"


@dataclass(frozen=True)
class Topology:
    """Immutable layout descriptor; all deriveds are pure functions."""

    size: int
    kind: str = "flat"            # flat | host | torus
    rows: int = 0                 # torus only
    cols: int = 0                 # torus only
    local_size: int = 1           # host only (slots per host)
    # Optional explicit rank->host map (elastic driver slots); when
    # present it overrides the homogeneous host-major assumption for the
    # host ring order.  A tuple so the dataclass stays hashable.
    hosts: tuple[int, ...] | None = None

    # -- validity ------------------------------------------------------
    def valid(self) -> bool:
        if self.kind == "torus":
            return self.rows >= 1 and self.cols >= 1 and \
                self.rows * self.cols == self.size
        if self.kind == "host":
            return self.local_size >= 1 and \
                self.size % max(self.local_size, 1) == 0
        return True

    # -- ring construction ---------------------------------------------
    def ring_order(self) -> list[int]:
        """Permutation of ranks in ring-walk order.

        torus: boustrophedon (snake) grid walk — row 0 left-to-right,
        row 1 right-to-left, ... — so consecutive ring positions are
        grid neighbors on every hop except (best-effort) the wrap link.
        host: ranks grouped by host (host-major), so each host's slots
        are adjacent on the ring and exactly ONE inbound + ONE outbound
        ring edge per host crosses the slow axis.  flat: identity."""
        if self.kind == "torus" and self.valid():
            order: list[int] = []
            for r in range(self.rows):
                cols = range(self.cols) if r % 2 == 0 \
                    else range(self.cols - 1, -1, -1)
                order.extend(r * self.cols + c for c in cols)
            return order
        if self.kind == "host":
            if self.hosts is not None and len(self.hosts) == self.size:
                # Explicit slot map (elastic driver): stable sort keeps
                # ranks ordered within each host.
                return sorted(range(self.size),
                              key=lambda r: (self.hosts[r], r))
            # Launcher's homogeneous host-major assignment
            # (rank == host * local_size + slot) is already host-grouped.
            return list(range(self.size))
        return list(range(self.size))

    # -- hierarchy -----------------------------------------------------
    def levels(self) -> list[int]:
        """Per-level group sizes, innermost (fastest links) first."""
        if self.kind == "host" and self.valid() and self.local_size > 1:
            return [self.local_size, self.size // self.local_size]
        if self.kind == "torus" and self.valid():
            return [self.cols, self.rows]
        return [self.size]

    def describe(self) -> str:
        """Stable human/payload label, e.g. 'torus:2x4', 'host:4x2'."""
        if self.kind == "torus":
            return f"torus:{self.rows}x{self.cols}"
        if self.kind == "host":
            return f"host:{self.size // max(self.local_size, 1)}" \
                   f"x{self.local_size}"
        return "flat"


def parse(spec: str, *, size: int, local_size: int = 1,
          cross_size: int = 1,
          hosts: tuple[int, ...] | None = None) -> Topology:
    """Build a Topology from a HOROVOD_TOPOLOGY spec string.

    Invalid specs degrade to flat with a warning rather than raising:
    the knob is launcher-uniform, so every rank degrades identically."""
    from .logging import logger
    spec = (spec or "").strip().lower()
    if spec.startswith("torus:"):
        shape = spec[len("torus:"):]
        try:
            r_s, c_s = shape.split("x", 1)
            rows, cols = int(r_s), int(c_s)
        except ValueError:
            rows = cols = 0
        topo = Topology(size=size, kind="torus", rows=rows, cols=cols)
        if topo.valid():
            return topo
        logger.warning("HOROVOD_TOPOLOGY=%s does not tile %d ranks; "
                       "using flat", spec, size)
        return Topology(size=size)
    if spec == "host":
        topo = Topology(size=size, kind="host", local_size=local_size,
                        hosts=hosts)
        if topo.valid() and local_size > 1:
            return topo
        logger.warning("HOROVOD_TOPOLOGY=host but the env describes no "
                       "multi-slot hosts (local_size=%d); using flat",
                       local_size)
        return Topology(size=size)
    if spec in ("", "auto"):
        # Auto-detect: the same homogeneous two-level eligibility test
        # the hierarchical backend applies (core.py layout verdict).
        if local_size > 1 and cross_size > 1 and \
                local_size * cross_size == size:
            return Topology(size=size, kind="host",
                            local_size=local_size, hosts=hosts)
        # Uneven multi-host layout with an explicit rank→host map
        # (HOROVOD_HOST_IDS): group the ring by host anyway.  local_size
        # is pinned to 1 — NOT the per-rank env value, which varies
        # across hosts here and would give ranks diverging Topologies —
        # so the level ladder stays [size] (hierarchy needs homogeneity)
        # while ring_order still clusters each host's slots.
        if hosts is not None and len(hosts) == size and \
                1 < len(set(hosts)) < size:
            return Topology(size=size, kind="host", hosts=hosts)
        return Topology(size=size)
    if spec != "flat":
        logger.warning("unknown HOROVOD_TOPOLOGY=%r; using flat", spec)
    return Topology(size=size)


def resolve(size: int, local_size: int = 1, cross_size: int = 1,
            hosts: tuple[int, ...] | None = None) -> Topology:
    """Topology for this world from the HOROVOD_TOPOLOGY knob."""
    return parse(config.TOPOLOGY.get(), size=size, local_size=local_size,
                 cross_size=cross_size, hosts=hosts)

"""Peer-to-peer state streaming over persistent duplex channels (the
port's copy of ``horovod_tpu/statesync/stream.py``).

One join event gets one dedicated ``PeerMesh`` (scope
``sssync.<epoch>.<join id>``): donors are the current world's ranks
0..N-1, the joiner is mesh rank N.  The data/ctrl meshes never carry a
state byte — a donor's main thread keeps training while its
:class:`DonorServer` thread serves the frozen snapshot.

Pull protocol (all frames are the ``tcp_transport`` state verb —
``STATE_MAGIC`` framed, never interleavable with control frames):

1. joiner → every donor: ``HELLO {join, round}``;
2. donor → joiner: ``META {epoch, step, digest, nbytes, donor}`` — the
   snapshot stamp.  The joiner REJECTS the round unless every donor's
   stamp is identical (a torn snapshot: donors cut at different steps);
3. joiner → donor: ``REQ {o, n}`` for this donor's byte range — ranges
   partition ``[0, nbytes)`` disjointly across donors, so each donor
   streams a disjoint shard of the image;
4. donor → joiner: ``DATA {o, n, crc}`` chunks
   (``HOROVOD_STATESYNC_CHUNK_BYTES`` each, CRC-checked on arrival,
   independently addressed so a transfer resumes at chunk granularity),
   then ``END {o, n}``;
5. when a donor dies mid-stream, its unfinished tail is re-requested
   from the surviving donors (any donor can serve any range — the
   snapshot is replicated state);
6. joiner → donors: ``BYE`` once the assembled image digest-verifies.

Every blocking wait on the sync mesh is bounded by a
:class:`StreamGuard` (the round deadline), never by the process
ResilienceState — the sync mesh's peer indices are not world ranks, so
feeding its failures into the liveness table would blame innocents.
"""
from __future__ import annotations

import queue
import threading
import time
import zlib

from ..common import config
from ..common.logging import logger
from ..common.tcp_transport import (STATE_BYE, STATE_DATA, STATE_END,
                                    STATE_HELLO, STATE_META, STATE_REQ,
                                    pack_state_frame, unpack_state_frame)
from .snapshot import Snapshot, SnapshotStamp, state_digest

__all__ = ["DonorLostError", "DonorServer", "JoinerPuller", "StreamGuard",
           "StreamError", "TornSnapshotError", "sync_scope"]


def sync_scope(epoch: str, join_id: int) -> str:
    """The dedicated mesh scope of one join event's streaming channels."""
    return f"sssync.{epoch}.{join_id}"


class StreamError(RuntimeError):
    """A streaming round failed (deadline, torn stamp, bad digest)."""


class TornSnapshotError(StreamError):
    """Donors disagree on the snapshot stamp, or the assembled image
    does not reproduce the stamped digest."""


class DonorLostError(StreamError):
    """The channel to one donor died mid-round; the caller reassigns
    the donor's unfinished range to the survivors."""

    def __init__(self, peer: int, detail: str) -> None:
        super().__init__(f"donor {peer} lost mid-stream: {detail}")
        self.peer = peer


class StreamGuard:
    """Deadline policy for sync-mesh channel waits (duck-typed stand-in
    for the ResilienceState a PeerMesh normally captures): every recv or
    wedged send polls in short slices and aborts at the round deadline;
    a closed socket converts to :class:`DonorLostError` immediately."""

    def __init__(self, timeout: float) -> None:
        self.timeout = float(timeout)
        self.poll_interval = min(0.25, max(0.05, self.timeout / 40.0))

    def check(self, peer: int, waited: float, phase: str) -> None:
        if waited >= self.timeout:
            raise DonorLostError(
                peer, f"no bytes for {waited:.1f}s (> "
                      f"HOROVOD_STATESYNC_TIMEOUT_SECONDS="
                      f"{self.timeout:g}s) in {phase}")

    def peer_connection_lost(self, peer: int, phase: str,
                             detail: str) -> "DonorLostError":
        return DonorLostError(peer, f"{detail} ({phase})")


def _record_reject(name: str, detail: str) -> None:
    """A rejected round is a protocol transition: it rides the flight
    ring (kind ``torn-reject``) so a post-mortem can replay it."""
    from ..telemetry import flight

    rec = flight.recorder()
    if rec.enabled:
        rec.record("torn-reject", name, detail=detail[:160])


def _statesync_bytes_counter(role: str):
    from ..telemetry import metrics

    return metrics().counter(
        "horovod_statesync_bytes_total",
        "State-snapshot payload bytes streamed between live peers, by "
        "role (donor = served, joiner = received and CRC-verified)",
        labels={"role": role})


class DonorServer(threading.Thread):
    """One incumbent's donor half for one join event.

    Runs as a daemon thread: forms the sync mesh (a collective act —
    every incumbent's donor thread plus the joiner), then answers the
    joiner's frames until BYE or the round deadline.  Snapshots arrive
    through :meth:`offer_snapshot` — round 0 is the bulk image taken
    when the join was first admitted, round 1 (optional) the final
    image taken at the grow boundary, streamed while the main thread is
    rebuilding channels anyway."""

    def __init__(self, kv, scope: str, donor_rank: int, num_donors: int,
                 *, chunk_bytes: int | None = None,
                 timeout: float | None = None) -> None:
        super().__init__(daemon=True,
                         name=f"hvd-statesync-donor-{donor_rank}")
        self.kv = kv
        self.scope = scope
        self.donor_rank = donor_rank
        self.num_donors = num_donors
        self.chunk_bytes = chunk_bytes or \
            config.STATESYNC_CHUNK_BYTES.get()
        self.timeout = timeout or config.STATESYNC_TIMEOUT_SECONDS.get()
        self._snapshots: queue.Queue = queue.Queue(maxsize=4)
        self.bytes_served = 0
        self.error: BaseException | None = None

    def offer_snapshot(self, round_idx: int, snap: Snapshot) -> None:
        self._snapshots.put((round_idx, snap), timeout=self.timeout)

    # -- thread body -----------------------------------------------------
    def run(self) -> None:
        try:
            self._serve()
        except StreamError as exc:
            # Joiner death / deadline: stand down quietly — the main
            # thread's world was never blocked on this transfer.
            logger.warning("statesync: donor %d round abandoned: %s",
                           self.donor_rank, exc)
            self.error = exc
        except Exception as exc:  # noqa: BLE001 - donor must never raise
            logger.warning("statesync: donor %d failed: %s",
                           self.donor_rank, exc)
            self.error = exc

    def _serve(self) -> None:
        from ..runner.network import PeerMesh

        guard = StreamGuard(self.timeout)
        counter = _statesync_bytes_counter("donor")
        mesh = PeerMesh(self.donor_rank, self.num_donors + 1, self.kv,
                        scope=self.scope, timeout=self.timeout,
                        resilience=guard)
        joiner = self.num_donors
        snap: Snapshot | None = None
        snap_round = -1
        try:
            while True:
                kind, meta, payload = unpack_state_frame(
                    mesh.recv(joiner))
                if kind == STATE_HELLO:
                    want = int(meta.get("round", 0))
                    while snap_round < want:
                        snap_round, snap = self._snapshots.get(
                            timeout=self.timeout)
                    mesh.send(joiner, pack_state_frame(
                        STATE_META,
                        {**snap.stamp.as_meta(), "round": snap_round,
                         "donor": self.donor_rank}))
                elif kind == STATE_REQ:
                    self._serve_range(mesh, joiner, snap,
                                      int(meta["o"]), int(meta["n"]),
                                      counter)
                elif kind == STATE_BYE:
                    return
                else:
                    raise StreamError(
                        f"unexpected state frame kind {kind} on the "
                        f"donor side")
        finally:
            mesh.close()

    def _serve_range(self, mesh, joiner: int, snap: Snapshot | None,
                     offset: int, length: int, counter) -> None:
        if snap is None:
            raise StreamError("REQ before any snapshot round opened")
        view = memoryview(snap.data)
        end = offset + length
        for o in range(offset, end, self.chunk_bytes):
            n = min(self.chunk_bytes, end - o)
            chunk = view[o:o + n]
            mesh.send(joiner, pack_state_frame(
                STATE_DATA, {"o": o, "n": n,
                             "crc": zlib.crc32(chunk)}, chunk))
            self.bytes_served += n
            counter.inc(n)
        mesh.send(joiner, pack_state_frame(STATE_END,
                                           {"o": offset, "n": length}))


class JoinerPuller:
    """The joining rank's pull half: assembles the donors' disjoint
    shards into one image and verifies it against the unanimous stamp
    before a single byte is interpreted."""

    def __init__(self, kv, scope: str, num_donors: int,
                 *, timeout: float | None = None) -> None:
        self.kv = kv
        self.scope = scope
        self.num_donors = num_donors
        self.timeout = timeout or config.STATESYNC_TIMEOUT_SECONDS.get()
        self._mesh = None
        self._dead: set[int] = set()
        # Per-round observability for the catch-up bound assertions:
        # donor -> (bytes pulled, wall seconds) of the last round.
        self.donor_stats: dict[int, tuple[int, float]] = {}

    def connect(self) -> None:
        from ..runner.network import PeerMesh

        guard = StreamGuard(self.timeout)
        self._mesh = PeerMesh(self.num_donors, self.num_donors + 1,
                              self.kv, scope=self.scope,
                              timeout=self.timeout, resilience=guard)

    # -- one round -------------------------------------------------------
    def pull_round(self, round_idx: int) -> tuple[bytearray,
                                                  SnapshotStamp]:
        """Pull one full snapshot round; returns the digest-verified
        image and its stamp.  Raises :class:`TornSnapshotError` when the
        donors' stamps disagree or the assembly fails verification, and
        :class:`StreamError` when too many donors die to finish."""
        mesh = self._mesh
        if mesh is None:
            raise StreamError("pull_round before connect")
        stamp = self._collect_metas(round_idx)
        image = bytearray(stamp.nbytes)
        donors = [d for d in range(self.num_donors)
                  if d not in self._dead]
        self.donor_stats = {}
        # Disjoint contiguous ranges, one per live donor.
        share = -(-stamp.nbytes // max(len(donors), 1))
        pending: list[tuple[int, int]] = []
        workers = []
        results: dict[int, tuple[int, int] | None] = {}
        for i, d in enumerate(donors):
            o = min(i * share, stamp.nbytes)
            n = min(share, stamp.nbytes - o)
            t = threading.Thread(
                target=self._pull_range, daemon=True,
                name=f"hvd-statesync-pull-{d}",
                args=(d, o, n, image, results))
            workers.append((d, t, o, n))
            t.start()
        for d, t, o, n in workers:
            t.join(timeout=self.timeout + 5.0)
            leftover = results.get(d)
            if t.is_alive() or leftover is None:
                # No progress record at all: re-pull the whole range
                # (chunk writes are idempotent, so overlap is safe).
                self._dead.add(d)
                leftover = (o, n)
            if leftover[1] > 0:
                pending.append(leftover)
        # Resume: reassign dead donors' unfinished tails to survivors
        # (chunk-granular — completed chunks are never re-pulled).
        while pending:
            alive = [d for d in range(self.num_donors)
                     if d not in self._dead]
            if not alive:
                raise StreamError(
                    "every donor died before the transfer finished")
            o, n = pending.pop()
            d = alive[0]
            results.pop(d, None)
            self._pull_range(d, o, n, image, results)
            leftover = results.get(d, (o, n))
            if leftover[1] > 0:
                pending.append(leftover)
        self.verify_round(image, stamp)
        return image, stamp

    def _collect_metas(self, round_idx: int) -> SnapshotStamp:
        mesh = self._mesh
        stamps: dict[int, SnapshotStamp] = {}
        for d in range(self.num_donors):
            if d in self._dead:
                continue
            try:
                mesh.send(d, pack_state_frame(
                    STATE_HELLO, {"round": round_idx}))
                kind, meta, _ = unpack_state_frame(mesh.recv(d))
            except (DonorLostError, ConnectionError, OSError) as exc:
                logger.warning("statesync: donor %d unreachable at "
                               "HELLO: %s", d, exc)
                self._dead.add(d)
                continue
            if kind != STATE_META:
                raise StreamError(
                    f"donor {d} answered HELLO with frame kind {kind}")
            stamps[d] = SnapshotStamp.from_meta(meta)
        if not stamps:
            raise StreamError("no live donors answered HELLO")
        stamp = next(iter(stamps.values()))
        for d, s in stamps.items():
            if s != stamp:
                _record_reject("torn-stamp",
                               f"donor {d}: {s} != {stamp}")
                raise TornSnapshotError(
                    f"torn snapshot: donor {d} stamped {s}, another "
                    f"donor stamped {stamp} — the donors cut at "
                    f"different steps; rejecting the round")
        return stamp

    def _pull_range(self, donor: int, offset: int, length: int,
                    image: bytearray, results: dict) -> None:
        """Pull [offset, offset+length) from one donor into the shared
        image (ranges are disjoint — no lock needed).  On donor death,
        records the unfinished tail in ``results`` for reassignment."""
        mesh = self._mesh
        counter = _statesync_bytes_counter("joiner")
        t0 = time.monotonic()
        next_offset = offset
        end = offset + length
        if length <= 0:
            results[donor] = (offset, 0)
            return
        try:
            mesh.send(donor, pack_state_frame(
                STATE_REQ, {"o": offset, "n": length}))
            view = memoryview(image)
            while True:
                kind, meta, payload = unpack_state_frame(
                    mesh.recv(donor))
                if kind == STATE_END:
                    break
                if kind != STATE_DATA:
                    raise StreamError(
                        f"donor {donor}: unexpected frame kind {kind} "
                        f"inside a range")
                o, n = int(meta["o"]), int(meta["n"])
                if zlib.crc32(payload) != int(meta["crc"]):
                    _record_reject("chunk-crc",
                                   f"donor {donor} offset {o}")
                    raise TornSnapshotError(
                        f"donor {donor}: chunk at offset {o} failed "
                        f"its CRC — rejecting the round")
                view[o:o + n] = payload
                counter.inc(n)
                if o == next_offset:
                    next_offset = o + n
            if next_offset != end:
                raise DonorLostError(
                    donor, f"range ended at {next_offset} of {end}")
            results[donor] = (end, 0)
        except TornSnapshotError:
            raise
        except (StreamError, ConnectionError, OSError) as exc:
            logger.warning("statesync: donor %d died mid-range "
                           "(resuming from %d): %s", donor,
                           next_offset, exc)
            self._dead.add(donor)
            results[donor] = (next_offset, end - next_offset)
        finally:
            self.donor_stats[donor] = (next_offset - offset,
                                       time.monotonic() - t0)

    @staticmethod
    def verify_round(image, stamp: SnapshotStamp) -> None:
        """The digest check gating every read of streamed state: the
        assembled image must reproduce the donors' unanimous stamp."""
        got = state_digest(image)
        if got != stamp.digest:
            _record_reject("digest",
                           f"{got:#x} != {stamp.digest:#x} (epoch "
                           f"{stamp.epoch}, step {stamp.step})")
            raise TornSnapshotError(
                f"assembled state digest {got:#x} != stamped "
                f"{stamp.digest:#x} (epoch {stamp.epoch}, step "
                f"{stamp.step}) — stale or corrupt transfer rejected")

    def close(self) -> None:
        mesh = self._mesh
        if mesh is None:
            return
        for d in range(self.num_donors):
            if d in self._dead:
                continue
            try:
                mesh.send(d, pack_state_frame(STATE_BYE, {}))
            except Exception:  # noqa: BLE001 - donor may be gone
                pass
        mesh.close()
        self._mesh = None

"""Chrome-trace timeline of collective negotiation and execution.

The port's copy of ``horovod_tpu/common/timeline.py``.

Reference: horovod/common/timeline.{cc,h}:37-80 — per-tensor phase machine
NEGOTIATING → <OP> → activities, written as Chrome trace events ("cat ph ts
pid name args") by an async writer thread fed through a queue so the hot
path never blocks on file IO.  Controlled by HOROVOD_TIMELINE
('DYNAMIC' starts stopped; start_timeline/stop_timeline flip it at runtime —
reference: operations.cc:740-769).
"""
from __future__ import annotations

import json
import queue
import threading
import time


def rank_path(path: str, rank: int) -> str:
    """Per-rank timeline path: rank 0 keeps the exact configured path
    (existing tooling reads it); other ranks get the metrics-dump
    convention ('{rank}' substitutes, else '.r<rank>' before the
    extension) so a launcher-wide identical HOROVOD_TIMELINE yields one
    stitchable file per rank instead of N ranks clobbering one file
    (telemetry/trace.py merges them)."""
    if "{rank}" in path:
        return path.format(rank=rank)
    if rank == 0:
        return path
    root, dot, ext = path.rpartition(".")
    if dot:
        return f"{root}.r{rank}.{ext}"
    return f"{path}.r{rank}"


class Timeline:
    def __init__(self, path: str = "", mark_cycles: bool = False,
                 rank: int = 0) -> None:
        self._path = path
        self._mark_cycles = mark_cycles
        self.rank = rank
        # Coordinator-clock sync estimate (tcp_transport round-trip
        # probes at init): recorded as trace METADATA — timestamps stay
        # in this rank's own monotonic base; the merge tool applies the
        # offset, never the recorder (a destructive shift would make the
        # raw file lie about what this rank observed).
        self._clock_offset_us: float | None = None
        self._clock_rtt_us: float = 0.0
        self._queue: queue.Queue = queue.Queue()
        self._active = False
        self._writer: threading.Thread | None = None
        self._file = None
        self._start = time.monotonic()
        # Open enqueue->callback async spans: tensor name -> flow id of
        # the latest 'b' event (ph "b"/"e", cat "op_queue" — async spans
        # live outside the per-lane B/E stacks, so a callback firing on
        # a stream worker cannot unbalance a lane).
        self._queue_ids: dict[str, int] = {}
        self._next_queue_id = 0
        self._tensor_tids: dict[str, int] = {}
        # Per-tensor negotiation state (the reference's per-tensor phase
        # machine, timeline.cc): a request resubmitted across cycles —
        # e.g. a local cache hit whose bit didn't survive the global AND
        # and was pushed back to the queue — must not open a second
        # NEGOTIATE span, and a joined rank's stand-in entry (which never
        # negotiated here) must not emit an unmatched end.
        self._negotiating: set[str] = set()
        # Per-tensor count of OPEN activity spans: an activity_end whose
        # matching start was suppressed (timeline off at the time, e.g. a
        # dynamic start_timeline() mid-collective) must not emit an
        # unmatched 'E' — the guard lives here so every call site (core
        # and all backends) inherits it.
        self._open_acts: dict[str, int] = {}
        self._lock = threading.Lock()
        if path and path != "DYNAMIC":
            self.start(path)
        elif path == "DYNAMIC":
            self._path = ""

    # -- lifecycle ------------------------------------------------------
    def start(self, path: str) -> None:
        with self._lock:
            if self._active:
                return
            # Fresh file: reset per-tensor state so lanes re-emit their
            # thread_name metadata and no phase state leaks from a
            # previous recording window.
            self._negotiating.clear()
            self._open_acts.clear()
            self._tensor_tids.clear()
            self._queue_ids.clear()
            # A DYNAMIC stop/start window begins at ts~0, not minutes
            # into the process: ts is defined relative to THIS recording
            # window's start (the clock-sync metadata below carries the
            # absolute monotonic base for cross-rank alignment).
            self._start = time.monotonic()
            self._path = rank_path(path, self.rank)
            self._file = open(self._path, "w")
            self._file.write("[\n")
            self._active = True
            self._writer = threading.Thread(target=self._write_loop,
                                            daemon=True,
                                            name="hvd-timeline")
            self._writer.start()
            self._emit_clock_metadata()

    def set_clock_sync(self, offset_us: float, rtt_us: float) -> None:
        """Record this rank's estimated clock offset against the
        coordinator (coordinator_monotonic - local_monotonic, µs) plus
        the probe round-trip as trace metadata."""
        self._clock_offset_us = float(offset_us)
        self._clock_rtt_us = float(rtt_us)
        with self._lock:
            if self._active:
                self._emit_clock_metadata()

    def _emit_clock_metadata(self) -> None:
        """Per-file stitching metadata (caller holds the lock): the rank
        (process_name renders it in viewers; the merge tool trusts the
        args), this window's monotonic base, and the clock-offset
        estimate when probed."""
        self._emit({"name": "process_name", "ph": "M", "pid": 0,
                    "args": {"name": f"rank {self.rank}"}})
        args: dict = {"rank": self.rank,
                      "start_us": (self._start * 1e6)}
        if self._clock_offset_us is not None:
            args["clock_offset_us"] = self._clock_offset_us
            args["clock_rtt_us"] = self._clock_rtt_us
        self._emit({"name": "horovod_clock_sync", "ph": "M", "pid": 0,
                    "args": args})

    def stop(self) -> None:
        with self._lock:
            if not self._active:
                return
            # The end marker goes through the queue so the writer thread
            # handles comma placement uniformly.
            self._queue.put({"name": "end", "ph": "i", "ts": self._ts(),
                             "pid": 0, "s": "g"})
            self._active = False
            self._negotiating.clear()
            self._open_acts.clear()
            self._queue_ids.clear()
            self._queue.put(None)
            writer, self._writer = self._writer, None
        if writer is not None:
            # Unbounded join AFTER poisoning the queue: the writer exits
            # as soon as it drains to the sentinel, and the file below is
            # only closed once it has — a bounded join could return with
            # the writer mid-drain and close the file under its write
            # (the pre-fix race; the writer's own closed-file guard in
            # _flush_pending is defense in depth, not the contract).
            writer.join()
        if self._file is not None:
            self._file.write("\n]\n")
            self._file.close()
            self._file = None

    @property
    def enabled(self) -> bool:
        return self._active

    # -- event emission -------------------------------------------------
    def _ts(self) -> int:
        return int((time.monotonic() - self._start) * 1e6)

    def _tid(self, tensor_name: str) -> int:
        tid = self._tensor_tids.get(tensor_name)
        if tid is None:
            tid = len(self._tensor_tids)
            self._tensor_tids[tensor_name] = tid
            self._emit({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": tensor_name}})
        return tid

    def _emit(self, event: dict) -> None:
        if self._active:
            self._queue.put(event)

    def negotiate_start(self, tensor_name: str, request_type) -> None:
        if not self._active or tensor_name in self._negotiating:
            return
        self._negotiating.add(tensor_name)
        name = getattr(request_type, "name", str(request_type))
        self._emit({"name": f"NEGOTIATE_{name}", "ph": "B",
                    "ts": self._ts(), "pid": 0,
                    "tid": self._tid(tensor_name)})

    def negotiate_end(self, tensor_name: str,
                      trace: str | None = None) -> None:
        if not self._active or tensor_name not in self._negotiating:
            return
        self._negotiating.discard(tensor_name)
        event = {"name": "", "ph": "E", "ts": self._ts(), "pid": 0,
                 "tid": self._tid(tensor_name)}
        if trace is not None:
            # The id is only known at pop (the coordinator assigned it
            # during THIS negotiation); Chrome merges E args into the
            # span, so the NEGOTIATE span still carries the trace.
            event["args"] = {"trace": trace}
        self._emit(event)

    def activity_start(self, tensor_name: str, activity: str,
                       stream: int = 0, trace: str | None = None) -> None:
        """Open an activity span; a nonzero multi-stream dispatch lane is
        recorded in the event args so traces show which channel set a
        fused response rode, and the collective's cross-rank trace id
        ("cycle.seq", telemetry/trace.py) rides the args so the merge
        tool can flow-link the same collective across ranks (stream-0
        untraced events stay byte-identical to the legacy format)."""
        if not self._active:
            return
        self._open_acts[tensor_name] = \
            self._open_acts.get(tensor_name, 0) + 1
        event = {"name": activity, "ph": "B", "ts": self._ts(),
                 "pid": 0, "tid": self._tid(tensor_name)}
        args = {}
        if stream:
            args["stream"] = stream
        if trace is not None:
            args["trace"] = trace
        if args:
            event["args"] = args
        self._emit(event)

    def activity_end(self, tensor_name: str) -> None:
        if not self._active:
            return
        count = self._open_acts.get(tensor_name, 0)
        if count <= 0:
            return   # matching start was suppressed: drop the end too
        self._open_acts[tensor_name] = count - 1
        self._emit({"name": "", "ph": "E", "ts": self._ts(), "pid": 0,
                    "tid": self._tid(tensor_name)})

    def activity_start_all(self, entries, activity: str,
                           stream: int = 0) -> None:
        """Open one ``activity`` span per entry of a (possibly fused)
        response — the reference's ActivityStartAll (timeline.cc), called
        from inside ops so pack/collective/unpack phases are separable in
        the trace.  Entries dispatched through core carry the response's
        trace id (``entry.trace``), so every backend sub-activity is
        cross-rank linkable without touching the planes."""
        if not self._active:
            return
        for e in entries:
            self.activity_start(e.tensor_name, activity, stream=stream,
                                trace=getattr(e, "trace", None))

    # -- enqueue -> callback async spans --------------------------------
    def queue_start(self, tensor_name: str) -> None:
        """Open the enqueue->callback span for one submitted tensor:
        Chrome async events ("ph":"b"/"e", cat "op_queue") on the
        tensor's lane — queue wait is the phase the per-lane B/E spans
        cannot show (the callback fires on a stream worker, outside any
        lane's stack discipline)."""
        if not self._active:
            return
        with self._lock:
            qid = self._next_queue_id
            self._next_queue_id += 1
            self._queue_ids[tensor_name] = qid
        self._emit({"name": "QUEUE", "cat": "op_queue", "ph": "b",
                    "id": qid, "ts": self._ts(), "pid": 0,
                    "tid": self._tid(tensor_name)})

    def queue_end(self, tensor_name: str,
                  trace: str | None = None) -> None:
        """Close the enqueue->callback span (entry callback).  The trace
        id — unknown at enqueue, assigned during negotiation — rides the
        end event's args."""
        if not self._active:
            return
        with self._lock:
            qid = self._queue_ids.pop(tensor_name, None)
        if qid is None:
            return   # opened while the timeline was off: drop the end
        event = {"name": "QUEUE", "cat": "op_queue", "ph": "e",
                 "id": qid, "ts": self._ts(), "pid": 0,
                 "tid": self._tid(tensor_name)}
        if trace is not None:
            event["args"] = {"trace": trace}
        self._emit(event)

    def activity_end_all(self, entries) -> None:
        if not self._active:
            return
        for e in entries:
            self.activity_end(e.tensor_name)

    def mark_cycle(self) -> None:
        if self._active and self._mark_cycles:
            self._emit({"name": "CYCLE", "ph": "i", "ts": self._ts(),
                        "pid": 0, "s": "g"})

    def counter(self, name: str, values: dict) -> None:
        """Chrome-trace counter track ("ph":"C"): queue depth, wire
        bytes, ... render as stacked area series alongside the spans
        (telemetry layer; docs/observability.md)."""
        if not self._active:
            return
        self._emit({"name": name, "ph": "C", "ts": self._ts(), "pid": 0,
                    "args": dict(values)})

    # -- writer thread --------------------------------------------------
    # Flush policy: the pre-batching writer flushed after EVERY event, so
    # heavy tracing perturbed the data plane it was measuring.  Events now
    # accumulate and hit the file when a batch fills, on CYCLE marks
    # (a consistent cut point for live tailing), or when the queue goes
    # momentarily idle — so a reader after stop() still sees everything
    # (stop() joins the drained writer before closing the file).
    _WRITE_BATCH = 64

    def _write_loop(self) -> None:
        first = True
        pending: list[str] = []
        while True:
            event = self._queue.get()
            if event is None:
                break
            line = json.dumps(event)
            pending.append(line if first else ",\n" + line)
            first = False
            if (len(pending) >= self._WRITE_BATCH
                    or event.get("name") == "CYCLE"
                    or self._queue.empty()):
                self._flush_pending(pending)
        self._flush_pending(pending)

    def _flush_pending(self, pending: list[str]) -> None:
        if not pending:
            return
        f = self._file
        if f is None:
            return
        try:
            f.write("".join(pending))
            f.flush()
        except ValueError:
            # File closed under us: only reachable if stop()'s join
            # contract is violated; drop rather than crash the writer.
            pass
        pending.clear()

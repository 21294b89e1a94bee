"""Cross-rank trace stitching and critical-path step attribution: the
port's own copy of ``horovod_tpu/telemetry/trace.py``.

CLI::

    python -m horovod_tpu_torch.telemetry.trace r0.json r1.json ... \
        [-o merged.json] [--critical-path] [--window N]

Input: the per-rank Chrome-trace files the Timeline writes when
``HOROVOD_TIMELINE`` is set (rank 0 keeps the configured path, rank *r*
writes ``path.r<r>.json`` — ``common/timeline.rank_path``).  Each file
carries a ``horovod_clock_sync`` metadata event with the rank, the
recording window's monotonic base, and the rank's clock offset against
the coordinator (round-trip probes at init,
``tcp_transport.estimate_clock_offset``).

Merge output (``-o``): one Chrome/Perfetto trace with

- ``pid`` = rank (plus ``process_name`` / ``process_sort_index``
  metadata), per-rank clock offsets **applied** so spans line up on the
  coordinator's clock;
- flow events (``"ph":"s"`` / ``"f"``) linking each collective's op
  spans across ranks by the coordinator-assigned trace id
  (``Response.trace_cycle`` / ``trace_seq`` riding span ``args.trace``)
  — click one allreduce, see it on every rank.

``--critical-path``: attributes each collective's wall time to phases —
queue wait (enqueue→dispatch), negotiate, wire legs (``TCP_``/``SHM_``/
``NCCL_``/hierarchical sub-spans), codec/staging (``MEMCPY_*``),
framework dispatch, and callback — and names the bottleneck rank and
its dominant phase per window of collectives: the rank whose op span
*starts last* on the aligned clock is the one the rest of the world
waited for (the same last-arrival semantics as the coordinator's
straggler gauges, ``telemetry/straggler.py`` — cross-check
``horovod_controller_straggler_rank`` against this report; the two
measure the same skew from opposite ends of the wire).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

# Response-type op spans (core._execute_response) — the per-collective
# anchor spans that get flow-linked across ranks.
OP_SPAN_NAMES = frozenset({
    "ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL", "REDUCESCATTER",
    "ADASUM", "BARRIER", "JOIN", "ERROR",
})
# Backend sub-activity prefixes = bytes actually moving on a data plane:
# the host planes', the device plane's (backend/nccl.py names its spans
# NCCL_ALLREDUCE, NCCL_ALLGATHER, ...), and the reference's XLA_ spans,
# so that its timelines read the same here.
WIRE_PREFIXES = ("TCP_", "SHM_", "NCCL_", "XLA_", "LOCAL_", "CROSS_",
                 "BASIC_")
# Staging/codec copies.
CODEC_PREFIXES = ("MEMCPY_",)

PHASES = ("queue_wait", "negotiate", "wire", "codec", "framework",
          "callback")

_RANK_SUFFIX_RE = re.compile(r"\.r(\d+)(?:\.[^.]+)?$")


@dataclass
class RankTrace:
    """One rank's loaded timeline plus its stitching metadata."""
    path: str
    rank: int
    events: list
    start_us: float = 0.0        # recording window's monotonic base
    clock_offset_us: float = 0.0  # coordinator clock - local clock
    clock_rtt_us: float = 0.0
    shift_us: float = 0.0        # merge-time additive ts shift


@dataclass
class _OpRecord:
    """Per-(trace id, rank) phase decomposition, µs (aligned clock)."""
    rank: int
    op_start: float = 0.0
    op_end: float = 0.0
    queue_start: float | None = None
    queue_end: float | None = None
    phases: dict = field(default_factory=lambda: dict.fromkeys(PHASES,
                                                               0.0))


def load_rank_file(path: str) -> RankTrace:
    events = json.loads(Path(path).read_text())
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome-trace event array "
                         f"(is this a metrics dump?)")
    rt = RankTrace(path=path, rank=-1, events=events)
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "horovod_clock_sync":
            args = e.get("args", {})
            # Last one wins: the init-time event may predate the clock
            # probe; set_clock_sync re-emits with the offset filled in.
            rt.rank = int(args.get("rank", rt.rank))
            rt.start_us = float(args.get("start_us", rt.start_us))
            rt.clock_offset_us = float(args.get("clock_offset_us",
                                                rt.clock_offset_us))
            rt.clock_rtt_us = float(args.get("clock_rtt_us",
                                             rt.clock_rtt_us))
    if rt.rank < 0:
        m = _RANK_SUFFIX_RE.search(path)
        rt.rank = int(m.group(1)) if m else 0
    return rt


def load(paths: list[str]) -> list[RankTrace]:
    traces = sorted((load_rank_file(p) for p in paths),
                    key=lambda t: t.rank)
    seen: dict[int, str] = {}
    for t in traces:
        if t.rank in seen:
            raise ValueError(f"duplicate rank {t.rank}: {seen[t.rank]} "
                             f"and {t.path}")
        seen[t.rank] = t.path
    # Align to the coordinator's clock: a rank's event at local ts
    # corresponds to coordinator-monotonic (ts + start_us + offset_us).
    # Subtract the global minimum so the merged trace starts near 0.
    bases = [t.start_us + t.clock_offset_us for t in traces]
    base0 = min(bases) if bases else 0.0
    for t, b in zip(traces, bases):
        t.shift_us = b - base0
    return traces


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------
def _op_span_starts(traces: list[RankTrace]) -> dict[str, list]:
    """trace id -> [(aligned ts, rank, tid)] of each rank's first op
    span for that collective."""
    out: dict[str, dict[int, tuple[float, int]]] = {}
    for t in traces:
        for e in t.events:
            if e.get("ph") != "B" or e.get("name") not in OP_SPAN_NAMES:
                continue
            trace_id = (e.get("args") or {}).get("trace")
            if trace_id is None:
                continue
            ts = e.get("ts", 0) + t.shift_us
            best = out.setdefault(trace_id, {}).get(t.rank)
            if best is None or ts < best[0]:
                out[trace_id][t.rank] = (ts, e.get("tid", 0))
    return {tid: sorted((ts, rank, lane)
                        for rank, (ts, lane) in ranks.items())
            for tid, ranks in out.items()}


def merge(traces: list[RankTrace]) -> list[dict]:
    """One flow-linked multi-process trace, offsets applied."""
    merged: list[dict] = []
    for t in traces:
        merged.append({"name": "process_name", "ph": "M", "pid": t.rank,
                       "args": {"name": f"rank {t.rank}"}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": t.rank, "args": {"sort_index": t.rank}})
        for e in t.events:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                continue   # replaced by the pid-correct one above
            e2 = dict(e)
            e2["pid"] = t.rank
            if "ts" in e2:
                e2["ts"] = int(e2["ts"] + t.shift_us)
            merged.append(e2)
    # Flow events: source = earliest op span; one "f" (bind point
    # "enclosing slice") on every other rank's span.
    for trace_id, spans in _op_span_starts(traces).items():
        if len(spans) < 2:
            continue
        ts0, rank0, lane0 = spans[0]
        merged.append({"name": "collective", "cat": "xrank", "ph": "s",
                       "id": trace_id, "ts": int(ts0) + 1, "pid": rank0,
                       "tid": lane0})
        for ts, rank, lane in spans[1:]:
            merged.append({"name": "collective", "cat": "xrank",
                           "ph": "f", "bp": "e", "id": trace_id,
                           "ts": int(ts) + 1, "pid": rank, "tid": lane})
    merged.sort(key=lambda e: e.get("ts", 0))
    return merged


# ---------------------------------------------------------------------------
# Critical path
# ---------------------------------------------------------------------------
def _classify(name: str) -> str | None:
    if name.startswith("NEGOTIATE_"):
        return "negotiate"
    if name.startswith(CODEC_PREFIXES):
        return "codec"
    if name.startswith(WIRE_PREFIXES):
        return "wire"
    if name in OP_SPAN_NAMES:
        return "op"
    return None


def _rank_records(t: RankTrace) -> dict[str, _OpRecord]:
    """trace id -> phase decomposition for one rank (aligned µs)."""
    records: dict[str, _OpRecord] = {}

    def rec(trace_id: str) -> _OpRecord:
        r = records.get(trace_id)
        if r is None:
            r = records[trace_id] = _OpRecord(rank=t.rank)
        return r

    # Per-lane stacks for B/E spans; the E event's args (where the
    # NEGOTIATE span's trace id rides) merge into the span's.
    stacks: dict[tuple, list[dict]] = {}
    spans: list[tuple[str, float, float, dict]] = []
    queue_open: dict = {}
    for e in t.events:
        ph = e.get("ph")
        if ph == "B":
            stacks.setdefault((e.get("pid"), e.get("tid")), []).append(e)
        elif ph == "E":
            stack = stacks.get((e.get("pid"), e.get("tid")))
            if stack:
                b = stack.pop()
                args = dict(b.get("args") or {})
                args.update(e.get("args") or {})
                spans.append((b.get("name", ""), b.get("ts", 0),
                              e.get("ts", 0), args))
        elif ph == "b" and e.get("cat") == "op_queue":
            queue_open[e.get("id")] = e
        elif ph == "e" and e.get("cat") == "op_queue":
            b = queue_open.pop(e.get("id"), None)
            if b is None:
                continue
            trace_id = (e.get("args") or {}).get("trace")
            if trace_id is None:
                continue
            r = rec(trace_id)
            # First queue begin / last queue end across a fused
            # response's entries bound the waiter-visible latency.
            qs = b.get("ts", 0) + t.shift_us
            qe = e.get("ts", 0) + t.shift_us
            if r.queue_start is None or qs < r.queue_start:
                r.queue_start = qs
            if r.queue_end is None or qe > r.queue_end:
                r.queue_end = qe

    for name, ts0, ts1, args in spans:
        trace_id = args.get("trace")
        if trace_id is None:
            continue
        kind = _classify(name)
        if kind is None:
            continue
        r = rec(trace_id)
        dur = max(ts1 - ts0, 0)
        if kind == "op":
            start = ts0 + t.shift_us
            end = ts1 + t.shift_us
            if r.op_start == 0.0 or start < r.op_start:
                r.op_start = start
            r.op_end = max(r.op_end, end)
        else:
            r.phases[kind] += dur

    for r in records.values():
        if r.op_end <= r.op_start:
            continue
        op_dur = r.op_end - r.op_start
        # Framework = op-span time not spent on a wire or staging copy.
        r.phases["framework"] = max(
            op_dur - r.phases["wire"] - r.phases["codec"], 0.0)
        if r.queue_start is not None:
            r.phases["queue_wait"] = max(
                r.op_start - r.queue_start - r.phases["negotiate"], 0.0)
        if r.queue_end is not None:
            r.phases["callback"] = max(r.queue_end - r.op_end, 0.0)
    return records


def _sort_key(trace_id: str) -> tuple[int, int]:
    try:
        cycle, seq = trace_id.split(".", 1)
        return int(cycle), int(seq)
    except ValueError:
        return (1 << 62, 0)


def collective_records(traces: list[RankTrace]
                       ) -> dict[str, dict[int, _OpRecord]]:
    """trace id -> rank -> phase record, for collectives that executed
    on at least one rank."""
    out: dict[str, dict[int, _OpRecord]] = {}
    for t in traces:
        for trace_id, r in _rank_records(t).items():
            if r.op_end > r.op_start:
                out.setdefault(trace_id, {})[t.rank] = r
    return out


def critical_path_report(traces: list[RankTrace], window: int = 32) -> str:
    """Per-window attribution: which rank was the critical path, and
    which of its phases dominated."""
    records = collective_records(traces)
    multi = sorted((tid for tid, ranks in records.items()
                    if len(ranks) >= 2), key=_sort_key)
    if not multi:
        return ("critical path: no cross-rank collectives found — were "
                "all ranks' timeline files passed, and did the run set "
                "HOROVOD_TIMELINE on every rank?")
    window = max(int(window), 1)
    lines = []
    overall_votes: dict[int, int] = {}
    overall_phases: dict[int, dict[str, float]] = {}
    for w0 in range(0, len(multi), window):
        chunk = multi[w0:w0 + window]
        votes: dict[int, int] = {}
        phase_sums: dict[int, dict[str, float]] = {}
        span_us = 0.0
        for tid in chunk:
            ranks = records[tid]
            # Last op-span START on the aligned clock = the rank the
            # rest of the world waited for (arrival-lag semantics, the
            # straggler gauges' counterpart).
            bottleneck = max(ranks, key=lambda r: ranks[r].op_start)
            votes[bottleneck] = votes.get(bottleneck, 0) + 1
            sums = phase_sums.setdefault(
                bottleneck, dict.fromkeys(PHASES, 0.0))
            for k, v in ranks[bottleneck].phases.items():
                sums[k] += v
            span_us += (max(r.op_end for r in ranks.values())
                        - min(r.op_start for r in ranks.values()))
        rank = max(votes, key=lambda r: votes[r])
        sums = phase_sums[rank]
        phase = max(sums, key=lambda k: sums[k])
        overall_votes[rank] = overall_votes.get(rank, 0) + votes[rank]
        tot = overall_phases.setdefault(rank, dict.fromkeys(PHASES, 0.0))
        for k, v in sums.items():
            tot[k] += v
        lines.append(
            f"window {w0 // window}: {len(chunk)} collectives, "
            f"{span_us / 1e3:.2f} ms total span; bottleneck rank {rank} "
            f"({votes[rank]}/{len(chunk)}), dominant phase {phase} "
            f"({sums[phase] / 1e3:.2f} ms)")
        lines.append("  phases on rank %d: %s" % (rank, "  ".join(
            f"{k}={sums[k] / 1e3:.2f}ms" for k in PHASES)))
    rank = max(overall_votes, key=lambda r: overall_votes[r])
    sums = overall_phases[rank]
    phase = max(sums, key=lambda k: sums[k])
    lines.append(f"critical path: rank {rank}, phase {phase} "
                 f"(cross-check horovod_controller_straggler_rank — "
                 f"docs/observability.md)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.trace",
        description="Merge per-rank HOROVOD_TIMELINE files into one "
                    "flow-linked Chrome/Perfetto trace (clock offsets "
                    "applied) and attribute the critical path "
                    "(docs/observability.md).")
    parser.add_argument("paths", nargs="+",
                        help="per-rank timeline files (rank 0's path + "
                             "the .r<rank> siblings)")
    parser.add_argument("-o", "--output",
                        help="write the merged trace JSON here")
    parser.add_argument("--critical-path", action="store_true",
                        help="print per-window bottleneck rank + phase "
                             "attribution")
    parser.add_argument("--window", type=int, default=32,
                        help="collectives per attribution window "
                             "(default 32)")
    args = parser.parse_args(argv)
    try:
        traces = load(args.paths)
    except (OSError, ValueError) as exc:
        sys.stderr.write(f"trace: {exc}\n")
        return 1
    for t in traces:
        sys.stderr.write(
            f"trace: rank {t.rank} <- {t.path} "
            f"(clock offset {t.clock_offset_us:+.0f} us, "
            f"rtt {t.clock_rtt_us:.0f} us, {len(t.events)} events)\n")
    if args.output:
        merged = merge(traces)
        Path(args.output).write_text(json.dumps(merged))
        sys.stderr.write(f"trace: wrote {len(merged)} events to "
                         f"{args.output}\n")
    if args.critical_path:
        sys.stdout.write(critical_path_report(traces,
                                              args.window) + "\n")
    elif not args.output:
        sys.stdout.write(json.dumps(merge(traces)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

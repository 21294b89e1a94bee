"""perfscope CLI: merge rank metric dumps into the PERF.json ledger (the
port's own copy of ``horovod_tpu/telemetry/perf.py``).

CLI::

    python -m horovod_tpu_torch.telemetry.perf DUMP.r*.json -o PERF.json \
        [--topology torus:2x4] [--size N] [--peak-mbps X] \
        [--timeline T.json T.json.r1 ...]

Inputs are ``HOROVOD_METRICS_FILE`` snapshots (one per rank; a
directory argument loads every ``*.json`` under it).  The ledger
(telemetry/perfmodel.py) carries:

- **busbw table**: bus bandwidth per (plane, op, codec, algo,
  size-bucket), merged across ranks, with roofline-relative efficiency
  (peak from ``--peak-mbps`` / HOROVOD_PERF_PEAK_MBPS, else
  self-calibrated to the best cell);
- **step ledger**: train MFU / serve throughput gauges when the dumps
  carry them;
- **lost time**: with ``--timeline``, the critical-path phases of
  telemetry/trace.py attribute straggler time into the ledger.

The merged ledger is what ``telemetry.perfcheck`` gates against
(docs/observability.md).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from ..common import config
from ..common.topology import parse as parse_topology
from . import perfmodel


def load_snapshots(paths: list[str]) -> tuple[list[dict], list[str]]:
    """Load metric-dump snapshots ({"rank", "metrics"} shape) from files
    and/or directories; unreadable or non-dump payloads are skipped and
    reported, never fatal (the console/sources.py posture)."""
    snapshots: list[dict] = []
    skipped: list[str] = []
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(os.path.join(p, name)
                         for name in sorted(os.listdir(p))
                         if name.endswith(".json"))
        else:
            files.append(p)
    for f in files:
        try:
            payload = json.loads(Path(f).read_text())
        except (OSError, ValueError):
            skipped.append(f)
            continue
        if isinstance(payload, dict) and "metrics" in payload:
            snapshots.append(payload)
        else:
            skipped.append(f)
    return snapshots, skipped


def _lost_time(timeline_paths: list[str]) -> dict | None:
    """Straggler-attributed lost time from per-rank timeline files: per
    collective, the span between the earliest and latest rank's op
    window is time the fast ranks spent waiting (the critical-path
    phases' cross-rank counterpart)."""
    from .trace import collective_records, critical_path_report, load
    try:
        traces = load(timeline_paths)
    except (OSError, ValueError) as exc:
        return {"error": f"cannot load timelines: {exc}"}
    records = collective_records(traces)
    lost_us = 0.0
    span_us = 0.0
    by_rank: dict[int, float] = {}
    multi = {tid: ranks for tid, ranks in records.items()
             if len(ranks) >= 2}
    for ranks in multi.values():
        start = min(r.op_start for r in ranks.values())
        end = max(r.op_end for r in ranks.values())
        span_us += end - start
        last = max(ranks, key=lambda r: ranks[r].op_start)
        wait = ranks[last].op_start - start
        lost_us += wait * (len(ranks) - 1)
        by_rank[last] = by_rank.get(last, 0.0) + wait
    if not multi:
        return None
    return {
        "collectives": len(multi),
        "span_ms": span_us / 1e3,
        "lost_rank_ms": lost_us / 1e3,
        "waited_on_ms": {str(r): v / 1e3
                         for r, v in sorted(by_rank.items())},
        "critical_path": critical_path_report(traces).splitlines()[-1],
    }


def build(paths: list[str], *, topology_spec: str = "",
          size: int = 0, peak_mbps: float = 0.0,
          min_samples: int = 0,
          timeline_paths: list[str] | None = None) -> tuple[dict, int]:
    """Assemble the full PERF.json payload; returns (payload, rc)."""
    snapshots, skipped = load_snapshots(paths)
    world = size or max((int(s.get("rank", 0)) for s in snapshots),
                        default=-1) + 1
    topo = parse_topology(topology_spec or config.TOPOLOGY.get(),
                          size=max(world, 1))
    ledger = perfmodel.build_ledger(
        snapshots, topo,
        peak_mbps=peak_mbps or float(config.PERF_PEAK_MBPS.get()),
        min_samples=min_samples or int(config.PERF_MIN_SAMPLES.get()))
    if skipped:
        ledger["skipped"] = skipped
    if timeline_paths:
        lost = _lost_time(timeline_paths)
        ledger["lost_time"] = lost if lost is not None else \
            {"note": "no cross-rank collectives in the timelines"}
    return ledger, 0 if snapshots else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.perf",
        description="Merge per-rank HOROVOD_METRICS_FILE dumps into the "
                    "roofline-attributed perf ledger, PERF.json "
                    "(docs/observability.md).")
    parser.add_argument("paths", nargs="+",
                        help="rank metric dumps and/or directories of "
                             "them")
    parser.add_argument("-o", "--output", default="",
                        help="write the ledger JSON here (default: "
                             "stdout)")
    parser.add_argument("--topology", default="",
                        help="fabric layout spec (HOROVOD_TOPOLOGY "
                             "syntax; default: the env knob)")
    parser.add_argument("--size", type=int, default=0,
                        help="world size (default: max dump rank + 1)")
    parser.add_argument("--peak-mbps", type=float, default=0.0,
                        help="roofline peak bus bandwidth (default: "
                             "HOROVOD_PERF_PEAK_MBPS, else "
                             "self-calibrated)")
    parser.add_argument("--min-samples", type=int, default=0,
                        help="samples a cell needs to enter the table "
                             "(default: HOROVOD_PERF_MIN_SAMPLES)")
    parser.add_argument("--timeline", nargs="*", default=[],
                        help="per-rank HOROVOD_TIMELINE files for "
                             "straggler lost-time attribution")
    parser.add_argument("--summary", action="store_true",
                        help="also print the compact human summary to "
                             "stderr")
    args = parser.parse_args(argv)

    ledger, rc = build(args.paths, topology_spec=args.topology,
                       size=args.size, peak_mbps=args.peak_mbps,
                       min_samples=args.min_samples,
                       timeline_paths=args.timeline)
    text = json.dumps(ledger, indent=1, sort_keys=True)
    if args.output:
        Path(args.output).write_text(text + "\n")
    else:
        sys.stdout.write(text + "\n")
    if args.summary:
        sys.stderr.write("\n".join(
            perfmodel.ledger_summary(ledger)) + "\n")
    if rc:
        sys.stderr.write("perf: no readable metric dumps among the "
                         "inputs\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())

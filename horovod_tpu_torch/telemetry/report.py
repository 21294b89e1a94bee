"""Offline summarizer for metrics dumps and timeline traces: the port's
own copy of ``horovod_tpu/telemetry/report.py``.

CLI::

    python -m horovod_tpu_torch.telemetry.report DUMP_OR_TIMELINE.json [...]

Accepts either artifact the runtime produces and answers "where did the
milliseconds go" as a per-activity table:

- a **metrics dump** (HOROVOD_METRICS_FILE JSON): counters/gauges as-is,
  histograms as count/mean/p50/p99/max rows;
- a **Chrome-trace timeline** (HOROVOD_TIMELINE JSON): per-activity
  total/mean/max span durations aggregated over every tensor lane, plus
  the final value of each counter track ("ph":"C").

Output goes to stdout as aligned plain text (one table per input file).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _fmt_table(rows: list[list[str]], header: list[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(header), sep] + [line(r) for r in rows])


def _label_str(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _collective_tables(payload: dict) -> list[str]:
    """The perfscope view of one dump: per-activity latency broken out
    by the algo label (one row per plane/op/codec/algo instead of one
    collapsed labels blob), and the busbw/efficiency rows the roofline
    ledger is built from (telemetry/perfmodel.py)."""
    lat_rows: list[list[str]] = []
    bus_rows: list[list[str]] = []
    eff = {}
    for m in payload.get("metrics", []):
        labels = m.get("labels", {})
        if m["name"] == "horovod_collective_efficiency":
            key = (labels.get("plane", ""), labels.get("algo", ""),
                   labels.get("size_bucket", ""))
            eff[key] = m.get("value", 0.0)
    for m in payload.get("metrics", []):
        if m.get("type") != "histogram":
            continue
        labels = m.get("labels", {})
        if m["name"] == "horovod_collective_latency_ms":
            lat_rows.append([
                labels.get("plane", ""), labels.get("op", ""),
                labels.get("codec", ""), labels.get("algo", ""),
                str(m["count"]), f"{m['p50']:.3f}", f"{m['p99']:.3f}"])
        elif m["name"] == "horovod_collective_busbw_mbps":
            key = (labels.get("plane", ""), labels.get("algo", ""),
                   labels.get("size_bucket", ""))
            bus_rows.append([
                labels.get("plane", ""), labels.get("op", ""),
                labels.get("algo", ""), labels.get("size_bucket", ""),
                str(m["count"]), f"{m['mean']:.1f}", f"{m['p50']:.1f}",
                f"{eff[key]:.2f}" if key in eff else "-"])
    parts = []
    if lat_rows:
        parts.append(_fmt_table(
            sorted(lat_rows),
            ["plane", "op", "codec", "algo", "count", "p50_ms",
             "p99_ms"]))
    if bus_rows:
        parts.append(_fmt_table(
            sorted(bus_rows),
            ["plane", "op", "algo", "size_bucket", "samples",
             "busbw_mbps", "p50_mbps", "efficiency"]))
    return parts


def summarize_dump(payload: dict) -> str:
    """Per-metric table for a HOROVOD_METRICS_FILE snapshot."""
    scalar_rows: list[list[str]] = []
    hist_rows: list[list[str]] = []
    for m in payload.get("metrics", []):
        name = m["name"]
        labels = _label_str(m.get("labels", {}))
        if m["type"] == "histogram":
            hist_rows.append([
                name, labels, str(m["count"]), f"{m['mean']:.3f}",
                f"{m['p50']:.3f}", f"{m['p99']:.3f}", f"{m['sum']:.1f}"])
        else:
            scalar_rows.append([name, labels, m["type"],
                                f"{m['value']:g}"])
    parts = [f"metrics dump (rank {payload.get('rank', '?')})"]
    if scalar_rows:
        parts.append(_fmt_table(scalar_rows,
                                ["metric", "labels", "type", "value"]))
    if hist_rows:
        parts.append(_fmt_table(
            hist_rows,
            ["histogram", "labels", "count", "mean", "p50", "p99", "sum"]))
    parts.extend(_collective_tables(payload))
    if not scalar_rows and not hist_rows:
        parts.append("(no metrics recorded — was HOROVOD_METRICS=on?)")
    return "\n\n".join(parts)


def summarize_timeline(events: list[dict]) -> str:
    """Per-activity duration table for a Chrome-trace timeline."""
    # Span matching: per (pid, tid) lane, a stack of open B events; an E
    # closes the innermost span (the format Timeline emits).
    stacks: dict[tuple, list[tuple[str, int]]] = {}
    totals: dict[str, list[float]] = {}
    counters: dict[str, dict] = {}
    for e in events:
        ph = e.get("ph")
        if ph == "C":
            counters[e.get("name", "")] = e.get("args", {})
            continue
        if ph not in ("B", "E"):
            continue
        key = (e.get("pid"), e.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(
                (e.get("name", ""), e.get("ts", 0)))
        else:
            stack = stacks.get(key)
            if stack:
                name, ts0 = stack.pop()
                totals.setdefault(name, []).append(
                    (e.get("ts", 0) - ts0) / 1e3)
    rows = []
    for name, spans in sorted(totals.items(),
                              key=lambda kv: -sum(kv[1])):
        rows.append([name, str(len(spans)), f"{sum(spans):.2f}",
                     f"{sum(spans) / len(spans):.3f}",
                     f"{max(spans):.3f}"])
    parts = []
    if rows:
        parts.append(_fmt_table(
            rows, ["activity", "spans", "total_ms", "mean_ms", "max_ms"]))
    else:
        parts.append("(no spans in trace)")
    if counters:
        crow = [[name, _label_str(args)]
                for name, args in sorted(counters.items())]
        parts.append(_fmt_table(crow, ["counter", "final value"]))
    return "\n\n".join(parts)


def summarize_file(path: str) -> str:
    payload = json.loads(Path(path).read_text())
    if isinstance(payload, list):
        body = summarize_timeline(payload)
        kind = "timeline"
    else:
        body = summarize_dump(payload)
        kind = "metrics"
    return f"== {path} ({kind}) ==\n{body}\n"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.report",
        description="Summarize a HOROVOD_METRICS_FILE dump or a "
                    "HOROVOD_TIMELINE trace into per-activity tables "
                    "(docs/observability.md).")
    parser.add_argument("paths", nargs="+",
                        help="metrics dump(s) and/or timeline file(s)")
    args = parser.parse_args(argv)
    rc = 0
    for path in args.paths:
        try:
            sys.stdout.write(summarize_file(path) + "\n")
        except (OSError, ValueError) as exc:
            sys.stderr.write(f"report: cannot summarize {path}: {exc}\n")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""perfscope regression gate: current ledger vs a committed baseline (the
port's own copy of ``horovod_tpu/telemetry/perfcheck.py``).

CLI::

    python -m horovod_tpu_torch.telemetry.perfcheck PERF.json \
        --baseline BASELINE.json [BENCH_r01.json ...] \
        [--tolerance-pct 10]

Compares the current perf ledger (``telemetry.perf`` output, or any
bench payload carrying a stamped ``perf`` ledger) against a baseline
window and exits 1 with a STRUCTURED finding — metric, delta, and the
first offending (plane, algo, size-bucket) — when bus bandwidth or MFU
dropped past the tolerance.  The comparison folds each algorithm into
its (plane, op, size-bucket) cell first, so a run that *switched* to a
slower algorithm (a forced ``HOROVOD_ALGO=tree`` at 4 MiB, a
chaos-delayed rank) is caught even though the per-algo cells have no
baseline counterpart; the finding names the dominant current algorithm
of the regressed cell.

Baselines are read permissively: a PERF.json ledger, a bench payload
with a stamped ledger, a list of either, or the repo's BENCH_r*.json /
BASELINE.json trajectory wrappers.  A baseline with no comparable perf
cells passes with a note (the gate cannot regress against nothing) —
the trajectory starts gating from the first ledger-stamped round.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..common import config

# Cells whose baseline busbw sits below this floor are noise (a probe
# that barely ran), not a reference worth gating against.
_MIN_GATE_MBPS = 1e-6


def _extract_ledgers(payload) -> list[dict]:
    """Every perf ledger reachable inside an arbitrary JSON payload:
    the ledger itself, a bench payload's ``perf`` stamp, the repo's
    {"n", "cmd", "rc", "tail"} round wrappers (no ledger inside — the
    tail truncates), or lists of any of these."""
    if isinstance(payload, list):
        return [led for item in payload for led in _extract_ledgers(item)]
    if not isinstance(payload, dict):
        return []
    if "busbw" in payload or "step" in payload:
        return [payload]
    if isinstance(payload.get("perf"), dict):
        return _extract_ledgers(payload["perf"])
    return []


def _fold_cells(ledger: dict) -> dict[tuple, dict]:
    """(plane, op, size_bucket) -> {busbw (sample-weighted), samples,
    dominant algo} — the algo-independent trend perfcheck trends."""
    cells: dict[tuple, dict] = {}
    for row in ledger.get("busbw", ()):
        key = (row.get("plane", ""), row.get("op", ""),
               row.get("size_bucket", ""))
        cell = cells.setdefault(
            key, {"weighted": 0.0, "samples": 0, "algos": {}})
        n = int(row.get("samples", 0))
        cell["weighted"] += float(row.get("busbw_mbps", 0.0)) * n
        cell["samples"] += n
        cell["algos"][row.get("algo", "")] = \
            cell["algos"].get(row.get("algo", ""), 0) + n
    out = {}
    for key, cell in cells.items():
        if not cell["samples"]:
            continue
        out[key] = {
            "busbw_mbps": cell["weighted"] / cell["samples"],
            "samples": cell["samples"],
            "algo": max(cell["algos"], key=lambda a: cell["algos"][a]),
        }
    return out


def compare(current: dict, baselines: list[dict],
            tolerance_pct: float) -> list[dict]:
    """Structured findings: every (plane, op, size-bucket) busbw cell
    and step-ledger metric that dropped past the tolerance versus the
    best baseline value (the window's high-water mark, so a lucky round
    does not ratchet the gate DOWN on the next merge)."""
    findings: list[dict] = []
    cur_cells = _fold_cells(current)
    base_cells: dict[tuple, dict] = {}
    for led in baselines:
        for key, cell in _fold_cells(led).items():
            best = base_cells.get(key)
            if best is None or cell["busbw_mbps"] > best["busbw_mbps"]:
                base_cells[key] = cell
    for key in sorted(base_cells):
        base = base_cells[key]
        cur = cur_cells.get(key)
        if cur is None or base["busbw_mbps"] <= _MIN_GATE_MBPS:
            continue
        delta_pct = (cur["busbw_mbps"] - base["busbw_mbps"]) \
            / base["busbw_mbps"] * 100.0
        if delta_pct < -tolerance_pct:
            plane, op, bucket = key
            findings.append({
                "metric": "busbw_mbps",
                "plane": plane, "op": op, "size_bucket": bucket,
                "algo": cur["algo"],
                "baseline_algo": base["algo"],
                "baseline": base["busbw_mbps"],
                "current": cur["busbw_mbps"],
                "delta_pct": delta_pct,
                "tolerance_pct": tolerance_pct,
            })
    base_step: dict[str, float] = {}
    for led in baselines:
        for k, v in led.get("step", {}).items():
            base_step[k] = max(base_step.get(k, v), v)
    for k in sorted(base_step):
        cur_v = current.get("step", {}).get(k)
        if cur_v is None or base_step[k] <= 0.0:
            continue
        delta_pct = (cur_v - base_step[k]) / base_step[k] * 100.0
        if delta_pct < -tolerance_pct:
            findings.append({
                "metric": k,
                "baseline": base_step[k], "current": cur_v,
                "delta_pct": delta_pct,
                "tolerance_pct": tolerance_pct,
            })
    return findings


def _load_json(path: str):
    return json.loads(Path(path).read_text())


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.perfcheck",
        description="Gate the current perf ledger against a committed "
                    "baseline window; exit 1 with a structured finding "
                    "on regression (docs/observability.md).")
    parser.add_argument("current",
                        help="current PERF.json (telemetry.perf output "
                             "or a ledger-stamped bench payload)")
    parser.add_argument("--baseline", nargs="+", required=True,
                        help="baseline files: PERF.json ledgers, "
                             "ledger-stamped BENCH_r*.json payloads, "
                             "and/or BASELINE.json")
    parser.add_argument("--tolerance-pct", type=float, default=0.0,
                        help="allowed drop before failing (default: "
                             "HOROVOD_PERF_TOLERANCE_PCT)")
    args = parser.parse_args(argv)
    tolerance = args.tolerance_pct \
        or float(config.PERF_TOLERANCE_PCT.get())

    try:
        current_ledgers = _extract_ledgers(_load_json(args.current))
    except (OSError, ValueError) as exc:
        sys.stderr.write(f"perfcheck: cannot read {args.current}: "
                         f"{exc}\n")
        return 2
    if not current_ledgers:
        sys.stderr.write(f"perfcheck: {args.current} carries no perf "
                         "ledger\n")
        return 2
    baselines: list[dict] = []
    unreadable: list[str] = []
    for path in args.baseline:
        try:
            baselines.extend(_extract_ledgers(_load_json(path)))
        except (OSError, ValueError):
            unreadable.append(path)
    report: dict = {"tolerance_pct": tolerance,
                    "baseline_ledgers": len(baselines)}
    if unreadable:
        report["unreadable"] = unreadable
    if not baselines:
        report["findings"] = []
        report["note"] = ("no comparable perf cells in the baseline "
                          "window — gating starts at the first "
                          "ledger-stamped round")
        sys.stdout.write(json.dumps(report, indent=1, sort_keys=True)
                         + "\n")
        return 0
    findings = compare(current_ledgers[0], baselines, tolerance)
    report["findings"] = findings
    sys.stdout.write(json.dumps(report, indent=1, sort_keys=True) + "\n")
    if findings:
        worst = min(findings, key=lambda f: f["delta_pct"])
        cell = "/".join(str(worst.get(k)) for k in
                        ("plane", "algo", "size_bucket")
                        if worst.get(k) is not None)
        sys.stderr.write(
            f"perfcheck: REGRESSION {worst['metric']}"
            f"{' at ' + cell if cell else ''}: "
            f"{worst['baseline']:.4g} -> {worst['current']:.4g} "
            f"({worst['delta_pct']:+.1f}% vs -{tolerance:g}% "
            f"tolerance); {len(findings)} finding(s)\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

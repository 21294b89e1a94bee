"""The port's cross-rank trace tools against the JAX package's, on the CPU.

``telemetry/trace.py``'s ``load``, ``merge``, ``collective_records``,
``critical_path_report`` and CLI on the synthetic rank files of
``tests/test_trace.py`` (and the committed merged-trace fixture through
``report``): the same events and the same text.  One difference is on
purpose: the port counts the device plane's ``NCCL_*`` spans
(``backend/nccl.py``) as wire time, where the reference, which has no
such plane, counts them as framework time; a synthetic world whose late
rank spends its op in ``NCCL_ALLREDUCE`` shows it.
"""
from __future__ import annotations

import dataclasses
import json
import os

import pytest

from horovod_tpu.telemetry import perf as jperf
from horovod_tpu.telemetry import trace as jtrace
from horovod_tpu_torch.telemetry import perf as tperf
from horovod_tpu_torch.telemetry import report as treport
from horovod_tpu_torch.telemetry import trace as ttrace
from test_trace import _write_rank_files

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "telemetry")

WORLDS = [dict(), dict(slow_rank=0), dict(ranks=2, collectives=1,
                                            slow_rank=1, delay_us=2000),
          dict(ranks=3, collectives=40, slow_rank=1, delay_us=300)]


def _records(mod, paths):
    return {tid: {r: dataclasses.asdict(rec) for r, rec in ranks.items()}
            for tid, ranks in mod.collective_records(mod.load(paths)).items()}


@pytest.mark.parametrize("world", range(len(WORLDS)))
def test_merge_and_critical_path_are_the_reference(tmp_path, world):
    paths = _write_rank_files(tmp_path, **WORLDS[world])
    tl, jl = ttrace.load(paths), jtrace.load(paths)
    assert [dataclasses.asdict(t) for t in tl] == \
        [dataclasses.asdict(t) for t in jl]
    assert ttrace.merge(tl) == jtrace.merge(jl)
    assert _records(ttrace, paths) == _records(jtrace, paths)
    for window in (1, 8, 32):
        assert ttrace.critical_path_report(tl, window) == \
            jtrace.critical_path_report(jl, window)
    assert ttrace.PHASES == jtrace.PHASES
    assert ttrace.OP_SPAN_NAMES == jtrace.OP_SPAN_NAMES


def test_load_edge_cases_are_the_reference(tmp_path):
    legacy = tmp_path / "legacy.r3.json"
    legacy.write_text(json.dumps([{"name": "ALLREDUCE", "ph": "B",
                                   "ts": 0, "pid": 0, "tid": 0}]))
    assert ttrace.load_rank_file(str(legacy)).rank == 3 == \
        jtrace.load_rank_file(str(legacy)).rank
    paths = _write_rank_files(tmp_path, ranks=1)
    for mod in (ttrace, jtrace):
        with pytest.raises(ValueError, match="duplicate rank 0"):
            mod.load([paths[0], paths[0]])
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps({"rank": 0, "metrics": []}))
    for mod in (ttrace, jtrace):
        with pytest.raises(ValueError, match="not a Chrome-trace"):
            mod.load_rank_file(str(dump))
    solo = tmp_path / "solo.json"
    solo.write_text(json.dumps([{"name": "horovod_clock_sync", "ph": "M",
                                 "pid": 0, "args": {"rank": 0,
                                                    "start_us": 0.0}}]))
    assert ttrace.critical_path_report(ttrace.load([str(solo)]), 4) == \
        jtrace.critical_path_report(jtrace.load([str(solo)]), 4)
    assert "no cross-rank collectives" in ttrace.critical_path_report(
        ttrace.load([str(solo)]))


@pytest.mark.parametrize("extra", [
    ["--critical-path", "--window", "8"], ["--critical-path"], [],
    ["-o", "{tmp}/merged.json"], ["-o", "{tmp}/m2.json", "--critical-path"]])
def test_trace_cli_is_the_reference(tmp_path, capsys, extra):
    paths = _write_rank_files(tmp_path)
    argv = paths + [a.format(tmp=tmp_path) for a in extra]
    assert ttrace.main(argv) == 0
    tout = capsys.readouterr()
    written = None
    if "-o" in extra:
        out = argv[argv.index("-o") + 1]
        with open(out) as f:
            written = json.load(f)
    assert jtrace.main(argv) == 0
    jout = capsys.readouterr()
    assert (tout.out, tout.err) == (jout.out, jout.err)
    if written is not None:
        with open(out) as f:
            assert written == json.load(f)
        assert any(e.get("ph") == "s" for e in written)
    assert ttrace.main([str(tmp_path / "absent.json")]) == 1
    tout = capsys.readouterr()
    assert jtrace.main([str(tmp_path / "absent.json")]) == 1
    assert tout.err.startswith("trace: ")
    capsys.readouterr()


def test_report_reads_the_merged_fixture_as_the_reference():
    from horovod_tpu.telemetry import report as jreport
    path = os.path.join(FIXTURES, "merged_trace.json")
    with open(path) as f:
        events = json.load(f)
    out = treport.summarize_timeline(events)
    assert out == jreport.summarize_timeline(events)
    row = next(line for line in out.splitlines()
               if line.startswith("ALLREDUCE"))
    assert row.split()[1] == "12", row


# ---------------------------------------------------------------------------
# The device plane's spans are wire time
# ---------------------------------------------------------------------------
def _nccl_world(tmp_path, ranks=2, collectives=3, late_rank=1,
                late_us=6000, wire="NCCL_ALLREDUCE"):
    """Rank files in the port's timeline format where ``late_rank``
    enqueues each collective ``late_us`` after the others and then spends
    its op span in one device-plane span, as ``NcclBackend`` records it."""
    paths = []
    for r in range(ranks):
        ev = [{"name": "horovod_clock_sync", "ph": "M", "pid": 0,
               "args": {"rank": r, "start_us": 5_000.0 + 10.0 * r,
                        "clock_offset_us": -10.0 * r,
                        "clock_rtt_us": 20.0}}]
        for k in range(collectives):
            trace = f"{k + 1}.0"
            late = late_us if r == late_rank else 0
            base = 20_000 * k + late
            op_e = 20_000 * k + late_us + 4000
            ev += [
                {"name": "QUEUE", "cat": "op_queue", "ph": "b", "id": k,
                 "ts": base + 10, "pid": 0, "tid": 0},
                {"name": "NEGOTIATE_ALLREDUCE", "ph": "B", "ts": base + 20,
                 "pid": 0, "tid": 0},
                {"name": "", "ph": "E", "ts": base + 120, "pid": 0,
                 "tid": 0, "args": {"trace": trace}},
                {"name": "ALLREDUCE", "ph": "B", "ts": base + 140,
                 "pid": 0, "tid": 0, "args": {"trace": trace}},
                {"name": wire, "ph": "B", "ts": base + 160, "pid": 0,
                 "tid": 0, "args": {"trace": trace}},
                {"name": "", "ph": "E", "ts": op_e - 20, "pid": 0,
                 "tid": 0},
                {"name": "", "ph": "E", "ts": op_e, "pid": 0, "tid": 0},
                {"name": "QUEUE", "cat": "op_queue", "ph": "e", "id": k,
                 "ts": op_e + 15, "pid": 0, "tid": 0,
                 "args": {"trace": trace}}]
        p = tmp_path / (f"d.r{r}.json" if r else "d.json")
        p.write_text(json.dumps(ev))
        paths.append(str(p))
    return paths


def test_nccl_spans_are_wire_time(tmp_path):
    paths = _nccl_world(tmp_path)
    report = ttrace.critical_path_report(ttrace.load(paths), 8)
    assert report.splitlines()[-1].startswith(
        "critical path: rank 1, phase wire")
    assert "bottleneck rank 1 (3/3)" in report
    rec = ttrace.collective_records(ttrace.load(paths))["1.0"][1]
    assert rec.phases["wire"] == 4000 - 160 - 20
    assert rec.phases["framework"] == 4000 - 140 - rec.phases["wire"]
    # The reference has no device plane: the same span is framework time.
    ref = jtrace.critical_path_report(jtrace.load(paths), 8)
    assert ref.splitlines()[-1].startswith(
        "critical path: rank 1, phase framework")
    # The other wire prefixes read the same in both.
    for wire in ("TCP_RING_ALLREDUCE", "XLA_ALLREDUCE", "SHM_ALLREDUCE"):
        sub = tmp_path / wire
        sub.mkdir()
        other = _nccl_world(sub, wire=wire)
        assert ttrace.critical_path_report(ttrace.load(other)) == \
            jtrace.critical_path_report(jtrace.load(other))
    # And the perf CLI's lost time names the same path.
    lost = tperf._lost_time(paths)
    assert lost["critical_path"].startswith(
        "critical path: rank 1, phase wire")
    assert lost["waited_on_ms"] == {"1": 3 * 6000 / 1e3}
    assert {k: v for k, v in lost.items() if k != "critical_path"} == \
        {k: v for k, v in jperf._lost_time(paths).items()
         if k != "critical_path"}

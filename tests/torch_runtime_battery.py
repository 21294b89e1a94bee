"""The eager core's runtime features both packages run, written once for
both: dispatch streams, the metrics registry and its dump, a collective
fingerprint divergence under ``strict`` and under ``cycle`` with the
flight recorder's dump, and the autotuner.

``tests/torch_reduce_worker.py <side> runtime ...`` runs the phases of
``PHASES`` through ``tests/torch_reduce_battery.py``'s ``run_suite``,
which registers them with ``BATTERIES`` and ``finish_phase`` and
formats ``{outdir}`` and ``{side}`` in a phase's environment, and
pickles every record.  Records whose value depends on timing (which
responses shared a cycle, what the autotuner measured) go under keys the
test reads on each side alone (``TIMED``); everything else must be equal
byte for byte between the packages.
"""
from __future__ import annotations

import importlib
import json
import os
import threading

import numpy as np

from torch_eager_battery import draw

_TCP = {"HOROVOD_SHM_OPERATIONS": "0"}
PHASES = {
    # Fusion off: every tensor is its own response, so a cycle of several
    # runs across the three streams.
    "streams": dict(_TCP, HOROVOD_NUM_STREAMS="3", HOROVOD_ALGO="ring",
                    HOROVOD_FUSION_THRESHOLD="0", HOROVOD_METRICS="1"),
    # Fusion off and the ring pinned, so every response's size bucket,
    # algorithm and wire bytes are the same in every run.
    "metrics": dict(_TCP, HOROVOD_METRICS="1", HOROVOD_ALGO="ring",
                    HOROVOD_FUSION_THRESHOLD="0",
                    HOROVOD_METRICS_FILE="{outdir}/metrics_{side}.json"),
    "fp_strict": dict(_TCP, HOROVOD_FINGERPRINT="strict",
                      HOROVOD_FLIGHT_FILE="{outdir}/flight_strict_{side}"
                                          ".json"),
    "fp_cycle": dict(_TCP, HOROVOD_FINGERPRINT="cycle",
                     HOROVOD_FLIGHT_FILE="{outdir}/flight_cycle_{side}"
                                         ".json"),
    "autotune": dict(_TCP, HOROVOD_AUTOTUNE="1", HOROVOD_NUM_STREAMS="2",
                     HOROVOD_AUTOTUNE_PIPELINE="1",
                     HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
                     HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="1",
                     HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="3",
                     HOROVOD_AUTOTUNE_LOG="{outdir}/autotune_{side}.csv"),
}
# Keys read on each side alone (their values depend on timing).
TIMED = ("stream_bytes", "metric_stream_labels", "tuned", "tuner",
         "autotune_log", "applied")
_TUNED_FIELDS = ("tuned_fusion_threshold", "tuned_cycle_time_ms",
                 "tuned_codec", "tuned_segment_bytes", "tuned_num_streams",
                 "tuned_fused", "tuned_algo", "tuned_tree_threshold")
# Metrics the reference has and the port does not: none since the port
# sets the roofline efficiency gauge too.
REF_ONLY_METRICS: tuple[str, ...] = ()
AUTOTUNE_OPS = 48
AUTOTUNE_N = 3001


def _snapshot(R):
    tm = importlib.import_module(R.hvd.__name__ + ".telemetry")
    return tm.metrics().snapshot()["metrics"]


def _labels(entry, epoch: str) -> tuple:
    return tuple(sorted((k, str(v).replace(epoch, "E"))
                        for k, v in entry["labels"].items()))


def battery_streams(R, st) -> None:
    """Three rounds of twelve async allreduces and a few gathers and
    broadcasts submitted at once: each cycle's responses spread over the
    streams; every output is the reference's.  After the first round no
    thread may start but a peer channel's lazy sender lane (the stream
    workers live for the whole world)."""
    hvd, rank = R.hvd, R.rank
    R.records[f"{R.phase}/dispatcher"] = (
        "streams", st.stream_dispatcher is not None, st.active_streams,
        len(st.op_managers), len(st.tcp_collectives))
    spawned: list[str] = []
    init = threading.Thread.__init__

    def counting_init(self, *args, **kwargs):
        spawned.append(kwargs.get("name") or "anon")
        init(self, *args, **kwargs)

    for rnd in range(3):
        if rnd == 1:
            threading.Thread.__init__ = counting_init
        handles = []
        for i in range(12):
            key = f"s{i}"
            dt = ("float32", "float64", "int32", "bfloat16")[i % 4]
            n = 7 + 513 * i
            handles.append((key, hvd.allreduce_async(
                R.t(draw(key, rank, n) * (1 if dt != "int32" else 100),
                    dt), op=hvd.Sum, name=key)))
        for i in range(3):
            key = f"g{i}"
            handles.append((key, hvd.allgather_async(
                R.t(draw(key, rank, (rank + 1 + i, 3)), "float32"),
                name=key)))
            key = f"b{i}"
            handles.append((key, hvd.broadcast_async(
                R.t(draw(key, rank, 40 + i), "float64"), root_rank=i % 2,
                name=key)))
        for key, h in handles:
            R.run(f"r{rnd}_{key}", hvd.synchronize, h)
    threading.Thread.__init__ = init
    R.records[f"{R.phase}/spawned"] = ("threads", [
        n for n in spawned if not n.startswith("hvd-send-")])
    R.records[f"{R.phase}/stream_bytes"] = (
        "bytes", [c.mesh.bytes_sent for c in st.tcp_collectives])
    R.records[f"{R.phase}/metric_stream_labels"] = ("labels", sorted(
        e["labels"]["stream"] for e in _snapshot(R)
        if e["name"] == "horovod_stream_busy_ms_total"))


def battery_metrics(R, st) -> None:
    """Every op twice (the second from the response cache), then the
    registry's metric names, label sets and byte counters."""
    hvd, rank, size = R.hvd, R.rank, R.size
    for rep in range(2):
        R.run(f"ar{rep}", hvd.allreduce,
              R.t(draw("mar", rank, 4096), "float32"), op=hvd.Sum,
              name="m_ar")
        R.run(f"ar16_{rep}", hvd.allreduce,
              R.t(draw("mar16", rank, 1000), "float32"), op=hvd.Average,
              name="m_ar16", compression="fp16")
        R.run(f"ag{rep}", hvd.allgather,
              R.t(draw("mag", rank, (rank + 2, 5)), "float32"),
              name="m_ag")
        R.run(f"bc{rep}", hvd.broadcast,
              R.t(draw("mbc", rank, 300), "float64"), root_rank=size - 1,
              name="m_bc")
        R.run(f"rs{rep}", hvd.reducescatter,
              R.t(draw("mrs", rank, (4 * size, 3)), "float32"), op=hvd.Sum,
              name="m_rs")
        R.run(f"a2a{rep}", hvd.alltoall,
              R.t(np.arange(2 * size) + 10 * rank, "int64"),
              splits=[2] * size, name="m_a2a")
    hvd.barrier()
    epoch = os.environ["HOROVOD_RENDEZVOUS_EPOCH"]
    snap = _snapshot(R)
    names = {}
    for e in snap:
        if e["name"] in REF_ONLY_METRICS:
            continue
        # The port's device-plane agreement (multihost.agree_on_cards)
        # waits on the KV store where the reference's world formation
        # only puts: the same metric, more verbs.
        names.setdefault(e["name"], set()).add(
            () if e["name"] == "horovod_rendezvous_kv_latency_ms"
            else _labels(e, epoch))
    R.records[f"{R.phase}/metric_names"] = (
        "names", sorted((n, sorted(ls)) for n, ls in names.items()))
    counted = ("horovod_collective_bytes_total",
               "horovod_tcp_bytes_sent_total",
               "horovod_tcp_bytes_received_total",
               "horovod_collective_algo_total", "horovod_basic_ops_total",
               "horovod_shm_ops_total", "horovod_world_size")
    # The control mesh's bytes depend on how many idle cycles ran.
    R.records[f"{R.phase}/byte_counters"] = ("counters", sorted(
        (e["name"], lab, e["value"]) for e in snap
        for lab in [_labels(e, epoch)]
        if e["name"] in counted and ("mesh", "ctrlE") not in lab))
    R.records[f"{R.phase}/histogram_counts"] = ("counts", sorted(
        (e["name"], _labels(e, epoch), e["count"]) for e in snap
        if e["name"] == "horovod_collective_latency_ms"))


def after_metrics(R, path: str) -> None:
    """After shutdown: the dump holds every metric name the registry
    had."""
    with open(path) as f:
        dump = json.load(f)
    R.records[f"{R.phase}/dump"] = (
        "dump", dump["rank"], sorted({e["name"] for e in dump["metrics"]}
                                     - set(REF_ONLY_METRICS)))


def _flight_tail(R, st) -> None:
    fl = st.flight
    path = fl.last_dump_path
    dumped = None
    if path is not None:
        with open(path) as f:
            dump = json.load(f)
        last = dump["events"][-1]
        dumped = (dump["rank"], dump["reason"], last["kind"],
                  last["detail"], len(dump["events"]) > 1)
    R.records[f"{R.phase}/flight"] = ("flight", fl.enabled, fl.dumps,
                                       dumped)


def battery_fp_strict(R, st) -> None:
    """Rank 1 submits a tensor of another shape under the same name: every
    rank gets the divergence error naming it, and the world goes on."""
    hvd, rank = R.hvd, R.rank
    for i in range(2):
        R.run(f"pre{i}", hvd.allreduce, R.t(draw(f"pre{i}", rank, 6),
                                            "float32"),
              op=hvd.Sum, name=f"pre{i}")
    n = 3 if rank == 1 else 4
    R.run("diverged", hvd.allreduce, R.t(draw("dv", rank, n), "float32"),
          op=hvd.Sum, name="fp")
    R.run("after", hvd.allreduce, R.t(draw("after", rank, 5), "float32"),
          op=hvd.Sum, name="after")
    _flight_tail(R, st)


def battery_fp_cycle(R, st) -> None:
    """Rank 1 submits another name where the others submit one: without
    the fingerprint the world would stall; with it every rank gets the
    structured error naming both."""
    hvd, rank = R.hvd, R.rank
    R.run("pre", hvd.allreduce, R.t(draw("cpre", rank, 6), "float32"),
          op=hvd.Sum, name="pre")
    R.run("diverged", hvd.allreduce, R.t(draw("cdv", rank, 4), "float32"),
          op=hvd.Sum, name="fp_b" if rank == 1 else "fp_a")
    R.run("after", hvd.allreduce, R.t(draw("cafter", rank, 5), "float32"),
          op=hvd.Sum, name="after")
    _flight_tail(R, st)


def battery_autotune(R, st) -> None:
    """Enough allreduces for the pipeline, fused and algorithm sweeps and
    three Bayesian samples to finish; then the values every rank
    applied."""
    hvd, rank = R.hvd, R.rank
    ctl = st.controller
    compute = ctl.compute_response_list
    applied = []

    def recording(*args, **kwargs):
        """Every ResponseList that carries tuned values, by the cycle
        (lockstep on every rank) that applies them."""
        rl = compute(*args, **kwargs)
        tuned = tuple(getattr(rl, f) for f in _TUNED_FIELDS)
        if any(v != -1 for v in tuned):
            applied.append((ctl._trace_cycle, tuned))
        return rl

    ctl.compute_response_list = recording
    for i in range(AUTOTUNE_OPS):
        R.run(f"at{i}", hvd.allreduce,
              R.t(draw(f"at{i % 8}", rank, AUTOTUNE_N), "float32"),
              op=hvd.Sum, name=f"at{i % 8}")
    hvd.barrier()
    hvd.barrier()
    R.records[f"{R.phase}/applied"] = ("applied", applied)
    R.records[f"{R.phase}/tuned"] = ("tuned", {
        "segment_bytes": [c.segment_bytes for c in st.tcp_collectives],
        "fused": [bool(c.fused) for c in st.tcp_collectives],
        "algo": [c.algo for c in st.tcp_collectives],
        "tree_threshold": [c.tree_threshold for c in st.tcp_collectives],
        "active_streams": st.active_streams,
        "fusion_threshold": ctl.tensor_fusion_threshold,
        "cycle_time_ms": st.cycle_time_ms})
    pm = st.parameter_manager
    R.records[f"{R.phase}/tuner"] = ("tuner", pm is not None, pm._active,
                                     pm._done)


BATTERIES = {"streams": battery_streams, "metrics": battery_metrics,
             "fp_strict": battery_fp_strict, "fp_cycle": battery_fp_cycle,
             "autotune": battery_autotune}


def finish_phase(R, phase: str, outdir: str, side: str) -> None:
    """What a phase reads after ``hvd.shutdown()``: the metrics dump and
    the autotuner's log (rank 0 writes it)."""
    if phase == "metrics":
        after_metrics(R, os.path.join(outdir,
                                      f"metrics_{side}.r{R.rank}.json"))
    elif phase == "autotune" and R.rank == 0:
        with open(os.path.join(outdir, f"autotune_{side}.csv")) as f:
            rows = f.read().splitlines()
        R.records[f"{phase}/autotune_log"] = (
            "log", rows[0], [r.split(",")[-1] for r in rows[1:]])

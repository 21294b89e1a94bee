"""telemetry/ — per-rank metrics, cross-rank straggler aggregation,
Prometheus/JSON exposition and the flight recorder: the port's own copy
of ``horovod_tpu/telemetry/__init__.py``.

- :func:`metrics` — the process registry.  A real
  :class:`~.registry.MetricsRegistry` under ``HOROVOD_METRICS=on``, the
  shared no-op :data:`~.registry.NULL_REGISTRY` otherwise.
- :func:`configure` — (re)build the registry from the environment; called
  by ``core.init``.
- :class:`~.exporter.MetricsExporter` / :func:`~.exporter.dump_json` —
  Prometheus scrape endpoint on ``HOROVOD_METRICS_PORT + rank`` and the
  shutdown JSON dump to ``HOROVOD_METRICS_FILE``.
- :class:`~.straggler.StragglerAggregator` — coordinator-side windowed
  negotiation-skew statistics naming the slowest rank.
- :mod:`.flight` — the always-on failure flight recorder
  (``HOROVOD_FLIGHT``).
- :mod:`.perfmodel` — perfscope: the roofline cost model, the FLOP counts
  and the card peak table behind the MFU gauges of ``Trainer`` and the
  serving replica, and the busbw/MFU ledger :func:`summary` stamps.
- the offline tools, each ``python -m horovod_tpu_torch.telemetry.<tool>``:
  ``report`` (tables of a metrics dump or a timeline), ``trace`` (the
  cross-rank merge of timelines and the critical path), ``perf`` (rank
  dumps merged into the PERF.json ledger) and ``perfcheck`` (the
  regression gate over ledgers); :mod:`.catalog` lists the metric names
  the package can register.

Serving builds its own :class:`MetricsRegistry` objects, whatever
``HOROVOD_METRICS`` says.
"""
from __future__ import annotations

from ..common import config
from . import flight
from .exporter import MetricsExporter, dump_json, resolve_dump_path
from .registry import (NULL_METRIC, NULL_REGISTRY, Counter, Gauge,
                       Histogram, MetricsRegistry, NullRegistry)
from .straggler import StragglerAggregator

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NullRegistry", "NULL_REGISTRY", "NULL_METRIC",
           "MetricsExporter", "StragglerAggregator", "configure",
           "dump_json", "enabled_in_env", "flight", "metrics",
           "resolve_dump_path", "summary"]

_registry: MetricsRegistry | NullRegistry | None = None


def enabled_in_env() -> bool:
    return bool(config.METRICS.get())


def configure(rank: int = 0):
    """(Re)build the process registry from the environment.  Called by
    ``core.init``; safe to call again — a fresh enabled registry starts
    empty."""
    global _registry
    _registry = MetricsRegistry(rank) if enabled_in_env() \
        else NULL_REGISTRY
    return _registry


def metrics():
    """The process metrics registry (never None; Null when off)."""
    global _registry
    if _registry is None:
        _registry = configure()
    return _registry


def summary() -> dict:
    """Compact end-of-run digest: total wire bytes, response-cache hit
    rate, per-stream busy time, and the perf ledger (``perf``) when there
    is one."""
    reg = metrics()
    if not reg.enabled:
        return {}
    sent = recv = 0.0
    hits = misses = 0.0
    streams: dict[str, float] = {}
    collective_bytes = 0.0
    shm_staged = 0.0
    for entry in reg.snapshot()["metrics"]:
        name = entry["name"]
        if entry["type"] not in ("counter", "gauge"):
            continue
        value = entry["value"]
        if name == "horovod_tcp_bytes_sent_total":
            sent += value
        elif name == "horovod_tcp_bytes_received_total":
            recv += value
        elif name == "horovod_controller_cache_hit_total":
            hits += value
        elif name == "horovod_controller_cache_miss_total":
            misses += value
        elif name == "horovod_collective_bytes_total":
            collective_bytes += value
        elif name == "horovod_shm_staged_bytes_total":
            shm_staged += value
        elif name == "horovod_stream_busy_ms_total":
            streams[entry["labels"].get("stream", "0")] = value
    out: dict = {
        "wire_bytes_sent": sent,
        "wire_bytes_received": recv,
        "shm_staged_bytes": shm_staged,
        "collective_bytes": collective_bytes,
        "cache_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
    }
    if streams:
        total = sum(streams.values())
        out["stream_busy_ms"] = streams
        out["stream_utilization"] = {
            s: (v / total if total else 0.0)
            for s, v in sorted(streams.items())}
    # The one-rank busbw/MFU ledger, whenever the registry holds busbw
    # or step evidence.
    from . import perfmodel
    ledger = perfmodel.build_ledger([reg.snapshot()])
    if ledger.get("busbw") or ledger.get("step"):
        out["perf"] = ledger
    return out

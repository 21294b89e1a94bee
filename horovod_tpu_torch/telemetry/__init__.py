"""Telemetry of the port: the metrics registry serving keeps its control
state in."""
from .registry import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

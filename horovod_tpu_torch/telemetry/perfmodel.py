"""Bus bandwidth of an executed collective: the port's own copy of the
size buckets and the busbw arithmetic of
``horovod_tpu/telemetry/perfmodel.py`` (``size_bucket``,
``busbw_factor``, ``busbw_mbps``), which ``core._observe_collective``
records under ``HOROVOD_METRICS``.

The rest of that module (the roofline cost model, the FLOP counts and the
per-device peak table behind the MFU ledger) is ROADMAP queue A item 12.
"""
from __future__ import annotations

# Size buckets: power-of-16 boundaries from 4 KiB keep the label set small
# while separating the latency-bound, crossover and bandwidth-bound
# regimes the algorithm selection distinguishes.
_BUCKET_BOUNDS = ((4 << 10, "4KiB"), (64 << 10, "64KiB"),
                  (1 << 20, "1MiB"), (16 << 20, "16MiB"),
                  (256 << 20, "256MiB"))
SIZE_BUCKETS = tuple(label for _, label in _BUCKET_BOUNDS) + ("huge",)


def size_bucket(nbytes: float) -> str:
    """Bucket label of a payload size (upper-bound buckets)."""
    for bound, label in _BUCKET_BOUNDS:
        if nbytes <= bound:
            return label
    return "huge"


def busbw_factor(op: str, n: int) -> float:
    """busbw = algbw x factor: the multiplier that makes measured
    bandwidth comparable across ops and world sizes (the nccl-tests
    convention)."""
    if n <= 1:
        return 1.0
    if op in ("allreduce", "adasum"):
        return 2.0 * (n - 1) / n
    if op in ("allgather", "reducescatter", "alltoall"):
        return float(n - 1) / n
    return 1.0     # broadcast / barrier-ish ops move S end to end


def busbw_mbps(op: str, nbytes: float, latency_ms: float, n: int) -> float:
    """Measured bus bandwidth in MB/s of one executed collective."""
    if latency_ms <= 0.0 or nbytes <= 0.0:
        return 0.0
    algbw = nbytes / (latency_ms / 1e3)          # bytes/s
    return algbw * busbw_factor(op, n) / 1e6

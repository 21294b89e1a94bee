"""Admission control: deadline feasibility + load shedding, keyed off
live telemetry (a copy of ``horovod_tpu/serving/admission.py``).

A request is admitted only when BOTH hold:

- **Deadline feasibility.**  Its estimated completion time — prefill
  plus ``max_new_tokens`` decode steps at the live per-step latency
  estimate, padded by the coordinator straggler-lag gauge — fits inside
  the remaining SLO budget.  An infeasible request is shed at admission
  and never executed: executing it would burn a decode slot to produce
  an answer nobody can use, which is how overload collapses goodput.
- **Load.**  The ingress queue-depth gauge stays under
  ``HOROVOD_SERVE_SHED_QUEUE_FRACTION`` of the queue bound.  Depth is a
  leading indicator: by the time latency SLOs blow, the queue has been
  growing for many steps.

The step-latency estimate is ``Histogram.quantile`` over
``horovod_serve_step_ms``, with an EWMA warm-start so the first requests
of a cold process are not admitted against a zero estimate.  The
straggler-lag gauge is read from the registry; nothing sets it in the
port yet (the coordinator's straggler telemetry is ROADMAP queue A item
12), so it reads 0.  All outcomes are counted:
``horovod_serve_requests_total{outcome=admitted|shed|expired|served|
lost|rejected_full}``.
"""
from __future__ import annotations

import time

from ..common import config
from ..telemetry.registry import MetricsRegistry


class AdmissionController:
    """Per-process admission policy (consulted on the front-end rank)."""

    def __init__(self, registry=None, *, queue_depth_limit: int | None = None,
                 shed_fraction: float | None = None,
                 step_ms_seed: float = 5.0) -> None:
        if registry is None:
            # Admission is CONTROL, not just observability: the step-time
            # histogram and outcome counters are always real.
            registry = MetricsRegistry(0)
        self._reg = registry
        self.queue_depth_limit = config.SERVE_QUEUE_DEPTH.get() \
            if queue_depth_limit is None else int(queue_depth_limit)
        self.shed_fraction = config.SERVE_SHED_QUEUE_FRACTION.get() \
            if shed_fraction is None else float(shed_fraction)
        # EWMA warm-start for the cold process; the histogram takes over
        # as soon as real steps land.
        self._ewma_step_ms = float(step_ms_seed)
        self._m_step = registry.histogram(
            "horovod_serve_step_ms",
            "Wall time of one serve step (plan exchange + prefill + "
            "decode + completion exchange)")
        self._m_latency = registry.histogram(
            "horovod_serve_request_latency_ms",
            "End-to-end request latency, ingress to final token")
        self._m_outcome = {
            outcome: registry.counter(
                "horovod_serve_requests_total",
                "Serving requests by outcome",
                labels={"outcome": outcome})
            for outcome in ("admitted", "shed", "expired", "served",
                            "lost")}

    # -- live estimates --------------------------------------------------
    def step_ms(self, q: float = 0.5) -> float:
        """Live per-step latency estimate: the shared histogram quantile
        path once data exists, the EWMA warm-start before that."""
        if self._m_step.count >= 8:
            return self._m_step.quantile(q)
        return self._ewma_step_ms

    def straggler_lag_ms(self) -> float:
        """Coordinator straggler-lag gauge; 0.0 until something sets
        it."""
        return self._reg.gauge(
            "horovod_controller_straggler_lag_ms",
            labels={"stat": "mean"}).value

    def observe_step_ms(self, ms: float) -> None:
        self._m_step.observe(ms)
        self._ewma_step_ms += 0.2 * (ms - self._ewma_step_ms)

    # -- the decision ----------------------------------------------------
    def estimate_completion_ms(self, req, steps_per_token: float = 1.0
                               ) -> float:
        """Estimated ms until req's final token if admitted now: one
        prefill step plus one decode step per generated token at the
        live p50 step time, padded by the straggler lag (a slow replica
        stretches every broadcast-consistent step)."""
        per_step = self.step_ms() + self.straggler_lag_ms()
        return (1.0 + req.max_new_tokens * steps_per_token) * per_step

    def admit(self, req, queue_depth: int,
              now: float | None = None) -> tuple[bool, str]:
        """(admit?, outcome) — outcome is the counted disposition when
        refused ('expired' | 'shed'); the caller records 'admitted'."""
        now = time.monotonic() if now is None else now
        if req.deadline <= now:
            self.count("expired")
            return False, "expired"
        if queue_depth > self.shed_fraction * self.queue_depth_limit:
            self.count("shed")
            return False, "shed"
        if now + self.estimate_completion_ms(req) / 1e3 > req.deadline:
            self.count("shed")
            return False, "shed"
        self.count("admitted")
        return True, "admitted"

    # -- accounting ------------------------------------------------------
    def count(self, outcome: str, n: int = 1) -> None:
        self._m_outcome[outcome].inc(n)

    def outcome_totals(self) -> dict:
        """Cumulative request counts by outcome — the fleet gauge
        publisher (fleet/wiring.py) computes per-interval shed rate
        from the deltas."""
        return {k: c.value for k, c in self._m_outcome.items()}

    def observe_latency_ms(self, ms: float) -> None:
        self._m_latency.observe(ms)

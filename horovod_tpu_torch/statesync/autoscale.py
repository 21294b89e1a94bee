"""Autoscale policy loop: drive the elastic driver's target world size
from live telemetry, with hysteresis (the port's copy of
``horovod_tpu/statesync/autoscale.py``; the same decisions for the same
observations).

The policy half (:class:`AutoscalePolicy`) is pure decision logic —
unit-testable with scripted observations.  The controller half
(:class:`AutoscaleController`) is a rank-0 daemon thread that samples a
gauge source every ``HOROVOD_AUTOSCALE_INTERVAL_S`` seconds and applies
decisions to the elastic driver (``ElasticDriver.set_target_np``).

Inputs:

- **queue depth** — the controller tensor-queue gauge or the serving
  ingress depth: a persistently deep queue means the world is
  under-provisioned for the offered load → scale UP;
- **shed rate** — the serving admission controller's load sheds per
  interval: sustained shedding is the capacity signal SLOs care about
  → scale UP;
- **straggler lag** — the coordinator's arrival-lag gauge: one rank
  persistently dragging the whole world while the queue is idle means
  the marginal rank costs more step time than its share of the work is
  worth → scale DOWN (past the straggler).

Hysteresis: a condition must hold ``HOROVOD_AUTOSCALE_HYSTERESIS_ROUNDS``
consecutive intervals to fire, and every decision starts an equal
cooldown — one burst never flaps the world size.  Every decision is
itself observable: a ``horovod_autoscale_decisions_total{direction}``
counter, a ``horovod_autoscale_target`` gauge, and a flight-recorder
event (kind ``autoscale``), so a post-mortem can replay why the world
resized.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

from ..common import config
from ..common.logging import logger

__all__ = ["AutoscaleController", "AutoscaleDecision", "AutoscalePolicy",
           "registry_source"]


@dataclasses.dataclass(frozen=True)
class AutoscaleDecision:
    direction: str                 # "up" | "down"
    target: int
    reason: str


class AutoscalePolicy:
    """Hysteresis-gated target-size decisions from gauge observations."""

    def __init__(self, min_np: int, max_np: int, *,
                 up_shed_rate: float | None = None,
                 up_queue_fraction: float | None = None,
                 down_lag_ms: float | None = None,
                 hysteresis_rounds: int | None = None,
                 queue_depth_limit: int | None = None) -> None:
        self.min_np = int(min_np)
        self.max_np = int(max_np)
        self.up_shed_rate = config.AUTOSCALE_UP_SHED_RATE.get() \
            if up_shed_rate is None else float(up_shed_rate)
        self.up_queue_fraction = config.AUTOSCALE_UP_QUEUE_FRACTION.get() \
            if up_queue_fraction is None else float(up_queue_fraction)
        self.down_lag_ms = config.AUTOSCALE_DOWN_LAG_MS.get() \
            if down_lag_ms is None else float(down_lag_ms)
        self.hysteresis_rounds = \
            config.AUTOSCALE_HYSTERESIS_ROUNDS.get() \
            if hysteresis_rounds is None else int(hysteresis_rounds)
        self.queue_depth_limit = config.SERVE_QUEUE_DEPTH.get() \
            if queue_depth_limit is None else int(queue_depth_limit)
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0

    def observe(self, current: int, *, queue_depth: float = 0.0,
                shed_rate: float = 0.0,
                straggler_lag_ms: float = 0.0) -> AutoscaleDecision | None:
        """Feed one interval's gauges; returns a decision when the
        hysteresis gate opens, else None."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        queue_frac = queue_depth / max(self.queue_depth_limit, 1)
        overload = (shed_rate > self.up_shed_rate
                    or queue_frac > self.up_queue_fraction)
        dragging = (straggler_lag_ms > self.down_lag_ms
                    and shed_rate == 0.0
                    and queue_frac < self.up_queue_fraction / 2.0)
        self._up_streak = self._up_streak + 1 if overload else 0
        self._down_streak = self._down_streak + 1 if dragging else 0
        if self._up_streak >= self.hysteresis_rounds \
                and current < self.max_np:
            self._reset_streaks()
            return AutoscaleDecision(
                "up", current + 1,
                f"shed_rate={shed_rate:.3f} queue_frac={queue_frac:.2f} "
                f"sustained {self.hysteresis_rounds} intervals")
        if self._down_streak >= self.hysteresis_rounds \
                and current > self.min_np:
            self._reset_streaks()
            return AutoscaleDecision(
                "down", current - 1,
                f"straggler_lag={straggler_lag_ms:.1f}ms with idle "
                f"queue, sustained {self.hysteresis_rounds} intervals")
        return None

    def _reset_streaks(self) -> None:
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = self.hysteresis_rounds


def registry_source(registry) -> Callable[[], dict]:
    """Build a gauge source over a telemetry registry: reads the
    queue-depth and straggler-lag gauges plus the serving outcome
    counters (shed rate computed as the per-interval delta)."""
    state = {"shed": 0.0, "offered": 0.0}

    def _value(name: str, labels: dict | None = None) -> float:
        try:
            if labels:
                return registry.counter(name, labels=labels).value
            return registry.gauge(name).value
        except Exception:  # noqa: BLE001 - absent metric reads as 0
            return 0.0

    def _sample() -> dict:
        shed = _value("horovod_serve_requests_total",
                      {"outcome": "shed"}) + \
            _value("horovod_serve_requests_total",
                   {"outcome": "expired"})
        served = _value("horovod_serve_requests_total",
                        {"outcome": "served"})
        offered = shed + served
        d_shed = shed - state["shed"]
        d_offered = offered - state["offered"]
        state["shed"], state["offered"] = shed, offered
        return {
            "queue_depth": max(
                _value("horovod_serve_queue_depth"),
                _value("horovod_controller_tensor_queue_depth")),
            "shed_rate": (d_shed / d_offered) if d_offered > 0 else 0.0,
            "straggler_lag_ms": _value(
                "horovod_controller_straggler_lag_ms"),
        }

    return _sample


def http_source(url: str, timeout: float = 2.0) -> Callable[[], dict]:
    """Build a gauge source over a rank's Prometheus exposition endpoint
    (`HOROVOD_METRICS_PORT`) — what the LAUNCHER-side controller uses:
    the gauges live in the rank processes, not the driver process.
    Unreachable scrapes read as all-zero (the policy simply observes an
    idle interval)."""
    state = {"shed": 0.0, "offered": 0.0}

    def _scrape() -> dict[str, float]:
        from urllib import request as urlrequest

        out: dict[str, float] = {}
        try:
            with urlrequest.urlopen(url, timeout=timeout) as resp:
                text = resp.read().decode(errors="replace")
        except Exception:  # noqa: BLE001 - endpoint down: idle sample
            return out
        for line in text.splitlines():
            if line.startswith("#") or " " not in line:
                continue
            name_part, _, value = line.rpartition(" ")
            try:
                out[name_part] = float(value)
            except ValueError:
                continue
        return out

    def _sample() -> dict:
        m = _scrape()

        def total(prefix: str, label: str) -> float:
            return sum(v for k, v in m.items()
                       if k.startswith(prefix) and label in k)

        shed = total("horovod_serve_requests_total",
                     'outcome="shed"') + \
            total("horovod_serve_requests_total", 'outcome="expired"')
        served = total("horovod_serve_requests_total",
                       'outcome="served"')
        offered = shed + served
        d_shed = shed - state["shed"]
        d_offered = offered - state["offered"]
        state["shed"], state["offered"] = shed, offered
        return {
            "queue_depth": max(
                m.get("horovod_serve_queue_depth", 0.0),
                m.get("horovod_controller_tensor_queue_depth", 0.0)),
            "shed_rate": (d_shed / d_offered) if d_offered > 0 else 0.0,
            "straggler_lag_ms": m.get(
                "horovod_controller_straggler_lag_ms", 0.0),
        }

    return _sample


class AutoscaleController(threading.Thread):
    """Rank-0 daemon: sample → decide → drive the elastic driver."""

    def __init__(self, driver, source: Callable[[], dict],
                 policy: AutoscalePolicy, *,
                 interval: float | None = None,
                 current_size: Callable[[], int] | None = None) -> None:
        super().__init__(daemon=True, name="hvd-autoscale")
        self.driver = driver
        self.source = source
        self.policy = policy
        self.interval = config.AUTOSCALE_INTERVAL_SECONDS.get() \
            if interval is None else float(interval)
        self._current_size = current_size or driver.world_size
        self._stop = threading.Event()
        self.decisions: list[AutoscaleDecision] = []
        from ..telemetry import flight, metrics

        self._flight = flight.recorder()
        tm = metrics()
        self._m_decisions = {
            d: tm.counter(
                "horovod_autoscale_decisions_total",
                "Autoscale policy decisions applied to the elastic "
                "driver's target world size", labels={"direction": d})
            for d in ("up", "down")}
        self._m_target = tm.gauge(
            "horovod_autoscale_target",
            "World size the autoscale policy currently asks the "
            "elastic driver for")

    def tick(self) -> AutoscaleDecision | None:
        """One sample→decide→apply round (called by the loop, and
        directly by tests)."""
        gauges = self.source()
        current = self._current_size()
        decision = self.policy.observe(
            current, queue_depth=float(gauges.get("queue_depth", 0.0)),
            shed_rate=float(gauges.get("shed_rate", 0.0)),
            straggler_lag_ms=float(gauges.get("straggler_lag_ms", 0.0)))
        if decision is None:
            return None
        self.decisions.append(decision)
        self.driver.set_target_np(decision.target)
        self._m_decisions[decision.direction].inc()
        self._m_target.set(decision.target)
        if self._flight.enabled:
            self._flight.record("autoscale", decision.direction,
                                detail=f"target={decision.target}: "
                                       f"{decision.reason}")
        logger.warning("autoscale: scale %s -> target %d (%s)",
                       decision.direction, decision.target,
                       decision.reason)
        return decision

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - controller must survive
                logger.debug("autoscale: tick failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        # Reap the loop: the event is its wakeup (the
        # run loop polls it every interval).  tick() can call into
        # code that stops the controller — never self-join.
        if self.is_alive() and \
                self is not threading.current_thread():
            self.join(timeout=self.interval + 5.0)

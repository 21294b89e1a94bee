"""Deterministic fault injection (the chaos harness).

The port's copy of ``horovod_tpu/resilience/chaos.py`` (``parse_spec``,
``ChaosAction``, ``ChaosEngine``, ``configure``): the same grammar, the
same counters and the same seeded ``prob`` matcher, so one spec fires at
the same collective or send in either package.  ``coordkill`` and
``coordpause`` parse, but an engine armed with one raises
``NotImplementedError``: they signal the rendezvous primary of the
replicated control plane, which is ROADMAP queue A item 12.

``HOROVOD_CHAOS`` holds a ``';'``-separated list of actions, each
``kind:key=val,key=val``.  Matching is deterministic — actions fire at a
global collective index or a per-peer send index, both of which are
identical run-to-run (and, for the op index, identical across ranks: it
counts responses of the coordinator-ordered ResponseList) — so every
failure path has a replayable pytest reproduction.  An optional
``seed=`` enables the one stochastic matcher (``prob=``) with its own
private, replayable ``random.Random`` stream.

Response-level actions (fired by the background loop before dispatch;
``op=`` is the global response index, ``name=`` a tensor-name prefix,
``rank=`` the injecting rank or ``*``):

- ``kill:rank=2,op=5[,exit=43]``       — ``os._exit`` at response 5;
- ``freeze:rank=1,op=3,ms=5000``       — sleep mid-collective;
- ``fail:op=4[,rank=*][,count=2]``     — convert the response to a
  structured ERROR before any byte moves (rank ``*`` makes the failure
  symmetric on every rank — the retriable case);
- ``preempt:rank=2,op=7``              — deliver SIGTERM (NOT SIGKILL)
  to self at the global collective index and keep running: under
  ``HOROVOD_PREEMPT_GRACE_S`` the statesync service's handler arms an
  orderly departure at the next step boundary (``statesync/service.py``);
  without it the flight recorder's chained SIGTERM handler dumps the
  ring and the default disposition ends the process.  Like every spec,
  ``rank=`` names the LAUNCH-TIME rank, and the engine with its counts
  survives the re-init of a retry or an elastic re-rendezvous
  (``configure``).
- ``coordkill:at=5[,rank=0]`` and ``coordpause:at=5,ms=800[,rank=0]``
  — SIGKILL, or SIGSTOP then SIGCONT, the rendezvous primary (the
  reference's control-plane failover shapes; not armed in the port).

Send-level actions (fired by ``PeerMesh`` at enqueue; ``send=`` is the
per-(mesh-scope, peer) send index, ``mesh=`` a scope prefix like
``data``):

- ``delay:rank=1,peer=2,send=0,ms=6000[,count=1]`` — sleep before the
  frame is handed to the sender lane (the caller thread stalls, exactly
  like a wedged producer);
- ``drop:rank=1,peer=2,send=3``        — swallow the frame;
- ``dup:rank=1,peer=2,send=3``         — enqueue the frame twice.

Every action consumes ``count`` firings (default: unlimited for
kill/freeze — they end the process or merely stall — and 1 for
fail/delay/drop/dup, so a retried op runs clean).
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time

from ..common import config
from ..common.logging import logger


__all__ = ["ChaosAction", "ChaosEngine", "ChaosInjectedError", "active",
           "configure", "parse_spec"]

_RESPONSE_KINDS = frozenset({"kill", "freeze", "fail", "preempt",
                             "coordkill", "coordpause"})
_SEND_KINDS = frozenset({"delay", "drop", "dup"})
_DEFAULT_COUNTS = {"fail": 1, "preempt": 1, "delay": 1, "drop": 1,
                   "dup": 1, "coordkill": 1, "coordpause": 1}


class ChaosInjectedError(RuntimeError):
    """A chaos ``fail`` action converted this collective into an error."""


class ChaosAction:
    __slots__ = ("kind", "rank", "op", "name", "peer", "send", "mesh",
                 "ms", "exit_code", "sig", "count", "prob", "_rng",
                 "fired")

    def __init__(self, kind: str, params: dict[str, str]) -> None:
        if kind not in _RESPONSE_KINDS | _SEND_KINDS:
            raise ValueError(f"unknown chaos action kind {kind!r}")
        self.kind = kind
        # coordkill/coordpause fire from ONE rank (default launch rank
        # 0): the victim is the shared coordinator process, and N ranks
        # each delivering the signal would consume N standby promotions.
        raw_rank = params.get("rank",
                              "0" if kind.startswith("coord") else "*")
        self.rank = None if raw_rank == "*" else int(raw_rank)
        if "at" in params:              # coord* spelling of the op index
            params = dict(params, op=params["at"])
        self.op = int(params["op"]) if "op" in params else None
        self.name = params.get("name")
        self.peer = int(params["peer"]) if "peer" in params else None
        self.send = int(params["send"]) if "send" in params else None
        self.mesh = params.get("mesh")
        self.ms = float(params.get("ms", 0.0))
        self.exit_code = int(params.get("exit", 43))
        # kill delivery: sig=9 sends a REAL signal (the acceptance
        # criterion's SIGKILL mid-allreduce); default is os._exit.
        self.sig = int(params["sig"]) if "sig" in params else None
        self.count = int(params.get(
            "count", _DEFAULT_COUNTS.get(kind, -1)))   # -1 = unlimited
        self.prob = float(params["prob"]) if "prob" in params else None
        self._rng = random.Random(int(params.get("seed", 0))) \
            if self.prob is not None else None
        self.fired = 0
        if kind in _SEND_KINDS and self.peer is None:
            raise ValueError(f"chaos {kind} action requires peer=")
        if kind in _RESPONSE_KINDS and self.op is None \
                and self.name is None:
            raise ValueError(f"chaos {kind} action requires op= or name=")

    # -- matching --------------------------------------------------------
    def _consume(self) -> bool:
        if self.count == 0:
            return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        if self.count > 0:
            self.count -= 1
        self.fired += 1
        return True

    def matches_response(self, rank: int, op_index: int,
                         tensor_names) -> bool:
        if self.kind not in _RESPONSE_KINDS or self.count == 0:
            return False
        if self.rank is not None and self.rank != rank:
            return False
        if self.op is not None and self.op != op_index:
            return False
        if self.name is not None and not any(
                n.startswith(self.name) for n in tensor_names):
            return False
        return self._consume()

    def matches_send(self, rank: int, scope: str, peer: int,
                     send_index: int) -> bool:
        if self.kind not in _SEND_KINDS or self.count == 0:
            return False
        if self.rank is not None and self.rank != rank:
            return False
        if self.peer != peer:
            return False
        if self.mesh is not None and not scope.startswith(self.mesh):
            return False
        if self.send is not None and self.send != send_index:
            return False
        return self._consume()


def parse_spec(spec: str) -> list[ChaosAction]:
    actions: list[ChaosAction] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"chaos action {part!r} lacks 'kind:' prefix")
        kind, rest = part.split(":", 1)
        params: dict[str, str] = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(f"chaos parameter {kv!r} lacks '='")
            k, v = kv.split("=", 1)
            params[k.strip()] = v.strip()
        actions.append(ChaosAction(kind.strip(), params))
    return actions


class ChaosEngine:
    """Process-wide injector.  Survives core shutdown/re-init on purpose:
    consumed ``count``s persist, so a retried collective after a world
    rebuild runs clean — the replayable half of the retry battery."""

    def __init__(self, spec: str, rank: int) -> None:
        self.spec = spec
        self.rank = rank
        self.actions = parse_spec(spec)
        coord = sorted({a.kind for a in self.actions
                        if a.kind.startswith("coord")})
        if coord:
            raise NotImplementedError(
                f"chaos {'/'.join(coord)} signals the rendezvous primary "
                f"of the replicated control plane, which is ROADMAP queue "
                f"A item 12")
        self._op_index = 0
        self._send_index: dict[tuple[str, int], int] = {}
        self._lock = threading.Lock()

    # -- response hook (background loop, pre-dispatch) -------------------
    def on_response(self, tensor_names) -> str | None:
        """Advance the global collective index; fire any matching
        response action.  Returns "fail" when the caller must convert
        this response into a structured ERROR."""
        idx = self._op_index
        self._op_index += 1
        verdict: str | None = None
        for act in self.actions:
            if not act.matches_response(self.rank, idx, tensor_names):
                continue
            if act.kind == "kill":
                self._fire_kill(act, idx)
            elif act.kind == "preempt":
                self._fire_preempt(act, idx)
            elif act.kind == "freeze":
                logger.warning("chaos: freezing rank %d at collective %d "
                               "for %.0f ms", self.rank, idx, act.ms)
                time.sleep(act.ms / 1e3)
            elif act.kind == "fail":
                logger.warning("chaos: failing collective %d (%s)",
                               idx, list(tensor_names))
                verdict = "fail"
        return verdict

    def _fire_kill(self, act: ChaosAction, idx: int) -> None:
        """Deliver a kill to THIS process (a seam: a virtual engine can
        override it to end one simulated rank instead)."""
        logger.warning("chaos: killing rank %d at collective %d "
                       "(%s)", self.rank, idx,
                       f"signal {act.sig}" if act.sig is not None
                       else f"exit {act.exit_code}")
        if act.sig is not None:
            os.kill(os.getpid(), act.sig)
            time.sleep(5.0)   # SIGKILL lands before this expires
        os._exit(act.exit_code)

    def _fire_preempt(self, act: ChaosAction, idx: int) -> None:
        """SIGTERM to self."""
        logger.warning("chaos: preempting rank %d at collective "
                       "%d (SIGTERM)", self.rank, idx)
        os.kill(os.getpid(), signal.SIGTERM)
        # NOT followed by an exit: the grace path owns the
        # departure; without a grace handler the default
        # disposition (or flight's chained handler) fires.

    # -- send hook (PeerMesh enqueue path) -------------------------------
    def on_send(self, scope: str, peer: int) -> str | None:
        """Advance the per-(scope, peer) send index; fire any matching
        send action.  Returns "drop"/"dup"/None; delays sleep inline
        (the caller thread stalls like a wedged producer)."""
        with self._lock:
            key = (scope, peer)
            idx = self._send_index.get(key, 0)
            self._send_index[key] = idx + 1
        verdict: str | None = None
        for act in self.actions:
            if not act.matches_send(self.rank, scope, peer, idx):
                continue
            if act.kind == "delay":
                logger.warning("chaos: delaying send %d to peer %d on "
                               "%s by %.0f ms", idx, peer, scope, act.ms)
                time.sleep(act.ms / 1e3)
            else:
                logger.warning("chaos: %s send %d to peer %d on %s",
                               act.kind, idx, peer, scope)
                verdict = act.kind
        return verdict


_engine: ChaosEngine | None = None
_lock = threading.Lock()


def active() -> ChaosEngine | None:
    return _engine


def configure(rank: int) -> ChaosEngine | None:
    """Install the engine from HOROVOD_CHAOS.  Reuses the existing engine
    when the spec is unchanged (consumed counts AND the global collective
    index must survive the shutdown+init cycle a retry or an elastic
    shrink performs — and a spec's ``rank=`` refers to the LAUNCH-TIME
    rank, so a survivor renumbered by a shrink keeps its original chaos
    identity instead of inheriting a dead rank's); clears it when the
    spec is."""
    global _engine
    spec = config.CHAOS.get().strip()
    with _lock:
        if not spec:
            _engine = None
        elif _engine is None or _engine.spec != spec:
            _engine = ChaosEngine(spec, rank)
        return _engine

"""Training-loop callbacks.

The port's copy of ``horovod_tpu/callbacks.py`` (reference:
horovod/keras/callbacks.py 22-151 and horovod/_keras/callbacks.py), for
``Trainer.fit`` and any hand-written loop: metric averaging across the
eager world's ranks (``hvd.allreduce``), learning-rate warmup and
schedules over ``torch.optim`` param groups, rank-0-gated best-model
checkpointing (``checkpoint.save_checkpoint``), and the elastic commit
and batch-state callbacks for the port's ``ObjectState`` and
``TorchState``.  On a Trainer whose sync runs the optimizer in the ring,
the LR callbacks given the Trainer's optimizer act on its shard
optimizer, the one the step uses.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch


class Callback:
    """Lifecycle hooks around the Trainer fit loop."""

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer

    def on_train_begin(self, logs: dict | None = None) -> None: ...

    def on_train_end(self, logs: dict | None = None) -> None: ...

    def on_epoch_begin(self, epoch: int,
                       logs: dict | None = None) -> None: ...

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None: ...

    def on_batch_begin(self, batch: int,
                       logs: dict | None = None) -> None: ...

    def on_batch_end(self, batch: int, logs: dict | None = None) -> None: ...


class MetricAverageCallback(Callback):
    """Average epoch metrics over all ranks (reference:
    _keras/callbacks.py:49-92 MetricAverageCallback).

    The Trainer already returns metrics averaged over its mesh; this
    callback matters for the eager API, where each process computes its
    own."""

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None:
        if not logs:
            return
        from . import eager as hvd
        if not hvd.is_initialized() or hvd.size() == 1:
            return
        keys = sorted(k for k, v in logs.items()
                      if isinstance(v, (int, float, np.floating)))
        if not keys:
            return
        vec = torch.tensor([float(logs[k]) for k in keys],
                           dtype=torch.float64)
        avg = hvd.allreduce(vec, average=True,
                            name=f"__metric_avg_e{epoch}__")
        for k, v in zip(keys, avg.tolist()):
            logs[k] = float(v)


class LearningRateScheduleCallback(Callback):
    """Multiply the base LR by ``multiplier(epoch)`` (reference:
    _keras/callbacks.py LearningRateScheduleCallback).  Works with a
    ``torch.optim`` optimizer (its ``param_groups``) or any object
    exposing ``lr`` / ``learning_rate``."""

    def __init__(self, optimizer, multiplier: Callable[[int], float] | float,
                 start_epoch: int = 0, end_epoch: int | None = None,
                 staircase: bool = True, steps_per_epoch: int | None = None
                 ) -> None:
        self.optimizer = optimizer
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0
        self._initial_lrs: list[float] | None = None
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def set_trainer(self, trainer) -> None:
        super().set_trainer(trainer)
        # The optimizer-in-ring step updates through the shard optimizer.
        ring = getattr(trainer, "_ring", None)
        if ring is not None and self.optimizer is trainer.optimizer:
            self.optimizer = ring
            self._initial_lrs = None

    def _lr_holders(self):
        opt = self.optimizer
        if hasattr(opt, "param_groups"):          # torch
            return opt.param_groups, "lr"
        for attr in ("learning_rate", "lr"):
            if hasattr(opt, attr):
                return [opt], attr
        raise AttributeError(
            "optimizer exposes neither param_groups nor lr/learning_rate")

    def _capture_initial(self):
        holders, attr = self._lr_holders()
        if self._initial_lrs is None:
            self._initial_lrs = [
                (h[attr] if isinstance(h, dict) else getattr(h, attr))
                for h in holders]

    def _adjust(self, epoch: float) -> None:
        if epoch < self.start_epoch or \
                (self.end_epoch is not None and epoch >= self.end_epoch):
            return
        self._capture_initial()
        holders, attr = self._lr_holders()
        mult = self.multiplier(epoch)
        for holder, initial in zip(holders, self._initial_lrs):
            value = initial * mult
            if isinstance(holder, dict):
                holder[attr] = value
            else:
                setattr(holder, attr, value)

    def on_epoch_begin(self, epoch: int, logs: dict | None = None) -> None:
        self.current_epoch = epoch
        # Smooth schedules without steps_per_epoch still adjust at epoch
        # granularity — a schedule must never silently no-op.
        if self.staircase or not self.steps_per_epoch:
            self._adjust(epoch)

    def on_batch_begin(self, batch: int, logs: dict | None = None) -> None:
        if not self.staircase and self.steps_per_epoch:
            self._adjust(self.current_epoch + batch / self.steps_per_epoch)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual LR warmup from ``lr / size`` to ``lr`` over
    ``warmup_epochs``, matching the reference convention that the
    configured optimizer LR is already scaled by the world size
    (reference: _keras/callbacks.py LearningRateWarmupCallback — the
    multiplier interpolates 1/size → 1; the "facebook 1-hour ImageNet"
    recipe)."""

    def __init__(self, optimizer, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: int | None = None, verbose: bool = False,
                 initial_lr: float | None = None, size: int | None = None
                 ) -> None:
        if size is None:
            from . import eager as hvd
            size = hvd.size() if hvd.is_initialized() else 1
        self.size = size
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch: float) -> float:
            if warmup_epochs <= 0:
                return 1.0
            # epoch/warmup interpolation 1/size → 1.
            frac = min(epoch / warmup_epochs, 1.0)
            return (1.0 + frac * (size - 1)) / size

        # No end_epoch: the multiplier clamps at 1.0, so past the warmup
        # window the configured LR is applied exactly (an exclusive window
        # would freeze just short of it at epoch granularity).
        super().__init__(optimizer, multiplier, start_epoch=0,
                         end_epoch=None, staircase=False,
                         steps_per_epoch=steps_per_epoch)

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None:
        if self.verbose and epoch == self.warmup_epochs - 1:
            print(f"Epoch {epoch}: finished gradual learning rate warmup "
                  f"(ramped 1/{self.size} -> 1x of the configured LR).")


class BestModelCheckpoint(Callback):
    """Save the model when the monitored metric improves; rank-0-gated
    (reference: keras/callbacks.py:151 BestModelCheckpoint).  A state
    with sharded parameters (``Trainer(param_rules=...)``) is saved on
    every rank, since its gather is a collective of the mesh;
    ``save_checkpoint`` still writes on rank 0 only."""

    def __init__(self, filepath: str, monitor: str = "loss",
                 mode: str = "min",
                 save_fn: Callable[[str, Any], None] | None = None) -> None:
        self.filepath = filepath
        self.monitor = monitor
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.save_fn = save_fn
        self._state = None

    def set_state(self, state: Any) -> None:
        self._state = state

    def _better(self, value: float) -> bool:
        return value < self.best if self.mode == "min" else value > self.best

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None:
        if not logs or self.monitor not in logs:
            return
        from .checkpoint import _not_rank0
        if _not_rank0() and getattr(self._state, "sharding", None) is None:
            return
        value = float(logs[self.monitor])
        if not self._better(value):
            return
        self.best = value
        path = self.filepath.format(epoch=epoch, **logs)
        if self.save_fn is not None:
            self.save_fn(path, self._state)
        else:
            from .checkpoint import save_checkpoint
            save_checkpoint(path, self._state)


class CommitStateCallback(Callback):
    """Commit elastic state every ``batches_per_commit`` batches
    (reference: _keras/elastic.py CommitStateCallback)."""

    def __init__(self, state, batches_per_commit: int = 1) -> None:
        self.state = state
        self.batches_per_commit = batches_per_commit

    def on_batch_end(self, batch: int, logs: dict | None = None) -> None:
        if (batch + 1) % self.batches_per_commit == 0:
            self.state.commit()


class UpdateBatchStateCallback(Callback):
    """Track batch progress in elastic state so a restored worker resumes
    mid-epoch (reference: _keras/elastic.py UpdateBatchStateCallback)."""

    def __init__(self, state) -> None:
        self.state = state

    def on_batch_end(self, batch: int, logs: dict | None = None) -> None:
        self.state.batch = batch

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None:
        self.state.epoch = epoch + 1
        self.state.batch = 0

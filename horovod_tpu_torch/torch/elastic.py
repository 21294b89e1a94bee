"""Elastic state for PyTorch models/optimizers.

The port's copy of ``horovod_tpu/torch/elastic.py`` (upstream
horovod/torch/elastic/state.py): ``TorchState`` composes per-object
handlers (module state_dict, optimizer state_dict, sampler, plain values)
over the generic commit/restore/sync machinery; sync broadcasts the
committed state from rank 0 (``broadcast_parameters``,
``broadcast_optimizer_state``, ``broadcast_object``).  The model and
optimizer handlers deepcopy ``state_dict()``, as the reference does, so a
commit of a model on the card keeps its copy on the card.

``run`` is ``hvd.elastic.run``, as in upstream ``horovod.torch.elastic``::

    import horovod_tpu_torch.torch as hvd
    import horovod_tpu_torch.torch.elastic

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()

    train(hvd.elastic.TorchState(model, optimizer, step=0))
"""
from __future__ import annotations

import copy
import io
from typing import Any

import torch

from ..elastic.run import run  # noqa: F401 (re-export)
from ..elastic.sampler import ElasticSampler  # noqa: F401 (re-export)
from ..elastic.state import ObjectState, State  # noqa: F401 (re-export)


class StateHandler:
    """Save/restore/sync one value of a known type."""

    def __init__(self, value: Any) -> None:
        self.value = value

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def set_value(self, value: Any) -> None:
        self.value = value
        self.save()


class ModelStateHandler(StateHandler):
    def __init__(self, model) -> None:
        super().__init__(model)
        self._saved_state = copy.deepcopy(self.value.state_dict())

    def save(self) -> None:
        self._saved_state = copy.deepcopy(self.value.state_dict())

    def restore(self) -> None:
        self.value.load_state_dict(self._saved_state)

    def sync(self) -> None:
        from .functions import broadcast_parameters
        broadcast_parameters(self.value.state_dict(), root_rank=0)
        self.save()


class OptimizerStateHandler(StateHandler):
    def __init__(self, optimizer) -> None:
        super().__init__(optimizer)
        self._saved_state = copy.deepcopy(self.value.state_dict())

    def save(self) -> None:
        self._saved_state = copy.deepcopy(self.value.state_dict())

    def restore(self) -> None:
        self.value.load_state_dict(self._saved_state)

    def sync(self) -> None:
        from .functions import broadcast_optimizer_state
        broadcast_optimizer_state(self.value, root_rank=0)
        self.save()


class SamplerStateHandler(StateHandler):
    def __init__(self, sampler: ElasticSampler) -> None:
        super().__init__(sampler)
        self._saved_state = self.value.state_dict()

    def save(self) -> None:
        self._saved_state = self.value.state_dict()

    def restore(self) -> None:
        self.value.load_state_dict(self._saved_state)

    def sync(self) -> None:
        from ..eager import allgather_object, broadcast_object
        # Merge processed indices across the old world so the re-shard skips
        # everything anyone already consumed, then share from rank 0.
        all_states = allgather_object(self.value.state_dict(),
                                      name="__elastic_sampler_state__")
        merged: set[int] = set()
        for st in all_states:
            merged.update(st["processed_indices"])
        synced = broadcast_object(
            {"epoch": max(st["epoch"] for st in all_states),
             "processed_indices": sorted(merged)},
            root_rank=0, name="__elastic_sampler_sync__")
        self.value.load_state_dict(synced)
        self.save()


def _get_handler(value: Any) -> StateHandler | None:
    if isinstance(value, torch.nn.Module):
        return ModelStateHandler(value)
    if isinstance(value, torch.optim.Optimizer):
        return OptimizerStateHandler(value)
    if isinstance(value, ElasticSampler):
        return SamplerStateHandler(value)
    return None


class TorchState(State):
    """Elastic state wrapping torch modules, optimizers, samplers, and
    plain picklable attributes (reference: torch/elastic/state.py)."""

    def __init__(self, model=None, optimizer=None, **kwargs: Any) -> None:
        kwargs = dict(kwargs)
        if model is not None:
            kwargs["model"] = model
        if optimizer is not None:
            kwargs["optimizer"] = optimizer

        self._handlers: dict[str, StateHandler] = {}
        self._plain: dict[str, Any] = {}
        for name, value in kwargs.items():
            handler = _get_handler(value)
            if handler is not None:
                self._handlers[name] = handler
            else:
                self._plain[name] = copy.deepcopy(value)
            object.__setattr__(self, name, value)
        super().__init__()

    def __setattr__(self, name: str, value: Any) -> None:
        # A plain value's committed copy changes only at save(), as in
        # upstream's ObjectState; the reference overwrites it here, so
        # its restore() keeps the value set after the last commit
        # (ROADMAP C).
        handler = getattr(self, "_handlers", {}).get(name)
        if handler is not None:
            handler.set_value(value)
        object.__setattr__(self, name, value)

    def save(self) -> None:
        for handler in self._handlers.values():
            handler.save()
        for name in self._plain:
            self._plain[name] = copy.deepcopy(getattr(self, name))

    def restore(self) -> None:
        for handler in self._handlers.values():
            handler.restore()
        for name, value in self._plain.items():
            object.__setattr__(self, name, copy.deepcopy(value))

    def sync(self) -> None:
        for handler in self._handlers.values():
            handler.sync()
        if self._plain:
            from ..eager import broadcast_object
            synced = broadcast_object(self._plain, root_rank=0,
                                      name="__elastic_torch_plain__")
            self._plain = synced
            for name, value in synced.items():
                object.__setattr__(self, name, copy.deepcopy(value))


def save_to_bytes(obj) -> bytes:
    """Serialize a torch object to bytes (checkpoint transport helper)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()

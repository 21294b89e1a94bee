"""Elastic training state: commit / restore / sync.

The port's copy of ``horovod_tpu/elastic/state.py``.  Upstream
(horovod/common/elastic.py) ``State`` checkpoints to host memory on
``commit()``, restores after a collective failure, and broadcast-syncs from
the new rank 0 after every re-rendezvous.  ``ObjectState`` handles plain
Python attributes; :class:`ArrayState` handles named trees (nested dicts,
lists and tuples) of torch tensors, the torch form of the reference's
pytrees of arrays.  ``torch/elastic.py``'s ``TorchState`` holds modules and
optimizers.
"""
from __future__ import annotations

import copy
from typing import Any, Callable

import torch

from ..common.exceptions import HostsUpdatedInterrupt
from .discovery import HostUpdateResult
from .worker import notification_manager


class State:
    """Base elastic state with commit/restore/sync hooks."""

    def __init__(self) -> None:
        self._reset_callbacks: list[Callable[[], None]] = []
        notification_manager.register_listener(self)

    def register_reset_callbacks(self, callbacks) -> None:
        """Callbacks run after every re-rendezvous (world size changed) —
        e.g. rescale the learning rate or repartition the dataset."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self.reset()
        for callback in self._reset_callbacks:
            callback()

    def on_hosts_updated(self, timestamp: int, update_res: int) -> None:
        # Notification thread context: nothing to do eagerly; the training
        # thread observes the pending update in check_host_updates().
        pass

    def commit(self) -> None:
        """Checkpoint to host memory and surface any pending host updates."""
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise :class:`HostsUpdatedInterrupt` when membership changed.

        All ranks must agree to interrupt at the same point, so the locally
        pending notification is sum-allreduced: if any rank heard from the
        driver, every rank interrupts together (upstream
        common/elastic.py:73-96).
        """
        from ..eager import allreduce  # late import: avoid cycle at init

        if not notification_manager.has_driver:
            return
        pending_ts, pending_res = notification_manager.pending_update()
        # Sum-allreduce [heard?, added?, removed?]: if ANY rank heard from
        # the driver, every rank interrupts at this same point.
        local = torch.tensor(
            [1 if pending_ts > 0 else 0,
             1 if pending_res & HostUpdateResult.ADDED else 0,
             1 if pending_res & HostUpdateResult.REMOVED else 0],
            dtype=torch.int64)
        agreed = allreduce(local, average=False,
                           name="__elastic_host_updates__").tolist()
        if int(agreed[0]) <= 0:
            return
        # Only acknowledge what THIS rank actually heard; ranks that had not
        # yet received the notification clear it at the next rendezvous
        # (the driver stamps assignments with its notification clock).
        notification_manager.acknowledge(pending_ts)
        # Upstream's rule (common/elastic.py: skip_sync when the update
        # only removed hosts): the survivors of a removal hold the same
        # state, but a worker that joins on an addition syncs from rank 0,
        # so everyone must sync with it.  The reference skips the sync on
        # a pure addition, which leaves the joiner alone in its broadcast
        # (ROADMAP C).
        skip_sync = int(agreed[2]) > 0 and int(agreed[1]) == 0
        raise HostsUpdatedInterrupt(skip_sync)

    # -- to be provided by subclasses --------------------------------------
    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """State holding plain picklable attributes
    (upstream common/elastic.py ObjectState)."""

    def __init__(self, **kwargs: Any) -> None:
        self._saved_state = kwargs
        for attr, value in kwargs.items():
            setattr(self, attr, value)
        super().__init__()

    def save(self) -> None:
        new_state = {}
        for attr in self._saved_state:
            new_state[attr] = copy.deepcopy(getattr(self, attr))
        self._saved_state = new_state

    def restore(self) -> None:
        for attr, value in self._saved_state.items():
            setattr(self, attr, copy.deepcopy(value))

    def sync(self) -> None:
        if self._saved_state:
            from ..eager import broadcast_object
            synced = broadcast_object(self._saved_state, root_rank=0,
                                      name="__elastic_object_state__")
            self._saved_state = synced
            self.restore()


def tree_flatten(tree: Any) -> tuple[list[torch.Tensor], Any]:
    """Leaves of a nested dict/list/tuple of tensors and its structure.
    Dict keys are visited sorted, as ``jax.tree_util`` visits them, so
    every rank flattens the same tree into the same leaf order whatever
    the order the dict was built in."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves: list[torch.Tensor] = []
        specs = []
        for k in keys:
            sub, spec = tree_flatten(tree[k])
            leaves += sub
            specs.append(spec)
        return leaves, ("dict", tuple(keys), tuple(specs))
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for item in tree:
            sub, spec = tree_flatten(item)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree).__name__, len(tree), tuple(specs))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"ArrayState leaves are torch tensors, not "
                        f"{type(tree).__name__}")
    return [tree], None


def tree_unflatten(spec: Any, leaves) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys_or_len, subs = s
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys_or_len, subs)}
        items = [build(sub) for sub in subs]
        return items if kind == "list" else tuple(items)
    return build(spec)


class ArrayState(State):
    """State over named trees of torch tensors (parameters, optimizer
    state, batch statistics) plus plain-object extras.

    ``save()`` copies every leaf to host memory, as the reference's does;
    ``restore()`` puts each leaf back on the device it came from;
    ``sync()`` broadcasts the metadata and then the committed leaves from
    rank 0 one at a time, so a joining worker adopts the survivors' state.
    """

    def __init__(self, trees: dict[str, Any] | None = None,
                 **objects: Any) -> None:
        self._trees: dict[str, Any] = dict(trees or {})
        self._objects = ObjectProxy(objects)
        self._saved_trees: dict[str, list[torch.Tensor]] = {}
        self._treedefs: dict[str, Any] = {}
        self._devices: dict[str, list[torch.device]] = {}
        for attr, value in objects.items():
            setattr(self, attr, value)
        self._object_names = list(objects)
        super().__init__()

    def tree(self, name: str) -> Any:
        return self._trees[name]

    def set_tree(self, name: str, value: Any) -> None:
        self._trees[name] = value

    def save(self) -> None:
        for name, value in self._trees.items():
            leaves, treedef = tree_flatten(value)
            self._saved_trees[name] = [
                leaf.detach().to("cpu", copy=True) for leaf in leaves]
            self._devices[name] = [leaf.device for leaf in leaves]
            self._treedefs[name] = treedef
        self._objects.data = {attr: copy.deepcopy(getattr(self, attr))
                              for attr in self._object_names}

    def restore(self) -> None:
        for name, host_leaves in self._saved_trees.items():
            devices = self._devices[name]
            self._trees[name] = tree_unflatten(
                self._treedefs[name],
                [leaf.to(device, copy=True)
                 for leaf, device in zip(host_leaves, devices)])
        for attr, value in self._objects.data.items():
            setattr(self, attr, copy.deepcopy(value))

    def sync(self) -> None:
        from ..eager import broadcast, broadcast_object
        if not self._saved_trees:
            self.save()
        # Structure (treedefs, shapes, plain objects) first, then the
        # leaves one at a time.
        meta = broadcast_object(
            {"objects": self._objects.data,
             "treedefs": self._treedefs,
             "shapes": {n: [(tuple(leaf.shape), str(leaf.dtype))
                            for leaf in leaves]
                        for n, leaves in self._saved_trees.items()}},
            root_rank=0, name="__elastic_array_meta__")
        self._objects.data = meta["objects"]
        for name, shape_dtypes in meta["shapes"].items():
            local = self._saved_trees.get(name, [])
            synced = []
            for i, (shape, dtype) in enumerate(shape_dtypes):
                if i < len(local) and tuple(local[i].shape) == shape \
                        and str(local[i].dtype) == dtype:
                    leaf = local[i]
                else:
                    leaf = torch.zeros(shape, dtype=_dtype(dtype))
                synced.append(broadcast(
                    leaf, root_rank=0, name=f"__elastic_leaf__.{name}.{i}"))
            self._saved_trees[name] = synced
            self._treedefs[name] = meta["treedefs"][name]
            known = self._devices.get(name, [])
            self._devices[name] = [
                known[i] if i < len(known) else torch.device("cpu")
                for i in range(len(synced))]
        self.restore()


def _dtype(name: str) -> torch.dtype:
    """``str(torch.float32)`` -> ``torch.float32``."""
    dtype = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


class ObjectProxy:
    """Mutable holder so saved plain objects survive deepcopy cycles."""

    def __init__(self, data: dict) -> None:
        self.data = data

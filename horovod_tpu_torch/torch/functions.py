"""Parameter and optimizer-state broadcast (the port's copy of
``horovod_tpu/torch/functions.py``; upstream horovod/torch/functions.py).

``broadcast_parameters`` pushes the root's model weights to every rank
before training; ``broadcast_optimizer_state`` does the same for the
optimizer's state (tensors broadcast one by one, on their own device;
the hyperparameters and scalars as one pickled object).
"""
from __future__ import annotations

import collections

import torch

from ..core import rank
from ..eager import broadcast_object
from .mpi_ops import broadcast_async_, synchronize


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast model parameters from root to all ranks. Accepts
    `model.state_dict()`, `model.named_parameters()`, or a list of
    (name, tensor) (reference: functions.py broadcast_parameters)."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif isinstance(params, collections.abc.Iterable):
        params = list(params)
        if params and not isinstance(params[0], tuple):
            raise ValueError("invalid params: expected (name, tensor) pairs")
    handles = []
    for name, p in params:
        if p is None or not isinstance(p, torch.Tensor):
            continue
        handles.append(broadcast_async_(p.data, root_rank,
                                        name=f"bcast_param.{name}"))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Broadcast rank 0's optimizer state
    (reference: functions.py broadcast_optimizer_state: scalars are
    wrapped as tensors; non-numeric state travels as pickled objects)."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()

    # The non-tensor payload (param_groups and scalar state) and the
    # root's list of tensor keys travel as one pickled object; the tensors
    # then broadcast in the root's key order, so every rank enqueues the
    # same sequence of collectives.
    meta = {
        "param_groups": state_dict["param_groups"],
        "scalars": {
            (sid, k): v
            for sid, s in state_dict["state"].items()
            for k, v in s.items() if not isinstance(v, torch.Tensor)},
        "tensor_keys": [
            (sid, k)
            for sid, s in sorted(state_dict["state"].items())
            for k, v in sorted(s.items()) if isinstance(v, torch.Tensor)],
    }
    meta = broadcast_object(meta, root_rank, name="opt_state.meta")

    if rank() != root_rank:
        # Materialise the state on ranks whose optimizers are still empty
        # by stepping with zero gradients (reference: functions.py:120-150),
        # only when the root has state.
        if meta["tensor_keys"] and not state_dict["state"]:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.requires_grad and p.grad is None:
                        p.grad = torch.zeros_like(p)
            optimizer.step()
            state_dict = optimizer.state_dict()
        state_dict["param_groups"] = meta["param_groups"]
        for (sid, k), v in meta["scalars"].items():
            state_dict["state"].setdefault(sid, {})[k] = v

    handles = []
    for sid, k in meta["tensor_keys"]:
        v = state_dict["state"].get(sid, {}).get(k)
        if not isinstance(v, torch.Tensor):
            raise ValueError(
                f"optimizer state [{sid}][{k}] is a tensor on the root "
                f"but {type(v).__name__} on rank {rank()}")
        handles.append(broadcast_async_(v, root_rank,
                                        name=f"opt_state.{sid}.{k}"))
    for h in handles:
        synchronize(h)
    optimizer.load_state_dict(state_dict)

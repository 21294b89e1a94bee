"""Collectives over the data axis: ``torch.distributed`` calls.

The counterpart of ``allreduce`` in ``horovod_tpu/parallel/collectives.py``
(sum and average).  The reduction runs in the tensor's own dtype, as the
reference's psum/pmean do, so a 16-bit wire reduces in 16 bits.  With no
initialised process group it is the identity; with one, it always goes
through the group's backend (NCCL on the card), a group of one rank
included.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def allreduce(x: torch.Tensor, op: str = "sum",
              group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Sum or average of ``x`` over the group's ranks (a new tensor)."""
    if op not in ("sum", "average", "mean"):
        raise NotImplementedError(
            f"allreduce op {op!r}: the port has sum/average so far "
            "(max/min/adasum are ROADMAP queue A item 7, rest of grad sync)")
    if not (dist.is_available() and dist.is_initialized()):
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    world = dist.get_world_size(group)
    if op != "sum" and world > 1:
        out = out / world
    return out

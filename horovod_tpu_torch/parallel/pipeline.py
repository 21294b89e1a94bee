"""Pipeline parallelism over the ``pp`` ranks: the GPipe tick loop.

The counterpart of ``horovod_tpu/parallel/pipeline.py``.  Every ``pp``
rank holds one stage's parameters; microbatches enter at stage 0,
activations hop to the next stage (``ppermute``) each tick, and after
``num_microbatches + num_stages - 1`` ticks every microbatch has crossed
every stage.  Stage 0 takes zeros once the microbatches are drained, as
the reference's feed does.  The last stage's outputs are then replicated
to every stage, so each rank returns the whole batch's result.

Differentiable.  Every rank runs the same ops at every tick (stage 0's
choice between the feed and the received activation is a ``where``), so
the backward's exchanges pair up.  The result is replicated: each rank
computes the same loss from it, and the backward hands the last stage
the mean of the ranks' gradients, once: each rank's cotangent is divided
by the stage count before the broadcast's backward sums it to the last
stage, as the reference's ``shard_map`` divides an unmapped output's
cotangent by the axis size before its psum sums it back.  Stage ``i``'s
gradients are then the serial ones.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .collectives import broadcast, ppermute, world_size


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   group: dist.ProcessGroup | None = None,
                   num_microbatches: int | None = None,
                   axis_size: int | None = None) -> torch.Tensor:
    """Run ``x`` through a pipeline of stages.

    - ``stage_fn(params, h) -> h``: one stage's computation; the same
      activation shape at every stage boundary.
    - ``stage_params``: THIS rank's stage parameters (stage = group rank).
    - ``x``: the batch [B, ...], the same on every rank; it is split into
      ``num_microbatches`` (default: the stage count) along dim 0.

    Returns stage_{n-1}(...stage_0(x)) for the whole batch on every rank.
    """
    n = axis_size if axis_size is not None else world_size(group)
    if n == 1:
        return stage_fn(stage_params, x)
    m = num_microbatches or n
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    micro = x.reshape(m, b // m, *x.shape[1:])
    first = torch.tensor(dist.get_rank(group) == 0, device=x.device)
    fwd_perm = [(i, (i + 1) % n) for i in range(n)]   # to the next stage
    ticks = m + n - 1

    buf = torch.zeros_like(micro[0])
    outputs = []
    for t in range(ticks):
        # Stage 0 ingests microbatch t (zeros once drained); the others
        # take what the previous stage sent.
        feed = micro[min(t, m - 1)] * float(t < m)
        h_out = stage_fn(stage_params, torch.where(first, feed, buf))
        if t >= n - 1:
            # The last stage's output for microbatch t - (n - 1).
            outputs.append(h_out)
        if t < ticks - 1:
            buf = ppermute(h_out, group, fwd_perm)
    out = broadcast(torch.stack(outputs), group, root=n - 1)
    if out.requires_grad:
        # Each rank's loss is the same, so the broadcast's backward would
        # hand the last stage n times the gradient: take the mean.
        out.register_hook(lambda g: g / n)
    return out.reshape(b, *out.shape[2:])

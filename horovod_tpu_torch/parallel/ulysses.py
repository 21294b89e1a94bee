"""Ulysses-style sequence parallelism: an all-to-all head/sequence
reshard.

The counterpart of ``horovod_tpu/parallel/ulysses.py``: sequence-sharded
activations ``[B, T/n, H, D]`` reshard to head-sharded ``[B, T, H/n, D]``
with a tiled all-to-all over the ``sp`` ranks, any full-sequence attention
runs locally on the head shard, and a second all-to-all reshards back.
The transformer passes its ``_bthd_attn_adapter``, which runs the CUDA
flash kernels on the card.  Differentiable: the backward of each
all-to-all is the swapped one.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import alltoall, world_size
from .ring_attention import local_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: dist.ProcessGroup | None = None,
                      causal: bool = False, sm_scale: float | None = None,
                      attn_fn: Callable | None = None,
                      axis_size: int | None = None) -> torch.Tensor:
    """q, k, v: local shards [B, T_local, H, D]; H must be a multiple of
    the axis size.  ``attn_fn(q, k, v, causal=..., sm_scale=...)`` runs
    full-sequence attention on the head shard (default
    ``local_attention``)."""
    n = axis_size if axis_size is not None else world_size(group)
    if attn_fn is None:
        attn_fn = local_attention
    if n == 1:
        return attn_fn(q, k, v, causal=causal, sm_scale=sm_scale)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"{h} heads not divisible by sp={n}")

    def seq_to_heads(x):
        # [B, T/n, H, D] -> [B, T, H/n, D]: split the heads over the
        # ranks, gather the sequence.
        return alltoall(x, group, split_axis=2, concat_axis=1)

    out = attn_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                  causal=causal, sm_scale=sm_scale)
    return alltoall(out, group, split_axis=1, concat_axis=2)

"""Fused gradient synchronization: tensor fusion, 16-bit wire, reduce.

The counterpart of ``horovod_tpu/parallel/grad_sync.py`` (sum/average
with the none/fp16/bf16 codecs, fused loss-scaling and global-norm
clipping).  Gradients are grouped by dtype, packed in the caller's leaf
order into flat buckets of at most ``fusion_threshold_bytes`` *wire* bytes
(``_bucketize``; each leaf flattened in its memory order, so that a
channels_last conv gradient keeps its layout and the optimizer's foreach
kernels see one layout), cast to the wire dtype, reduced with one
``torch.distributed.all_reduce`` per bucket (NCCL on the card, gloo on the
CPU), and cast back.  The reducer is the port's own, not DDP's: bucket
membership follows the reference's rule, so it depends on the leaf order,
and ``Trainer`` passes the gradients in the flax flatten order
(``convert.flax_leaf_order``).

As in the reference, the wire cast happens even when the data axis has
one rank: the gradients are rounded to the wire dtype and back.

Not ported yet (ROADMAP queue A, "rest of grad sync"): the int8/uint4
quantized codecs and error feedback, adasum, the hierarchical split and
optimizer-in-ring; each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from ..common import config as _config
from .collectives import allreduce

_WIRE_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16,
                "none": None, None: None}
_REST_OF_SYNC = "is ROADMAP queue A item 7 (rest of grad sync)"


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """The reference's knobs; the ones this slice does not cover are kept
    so that a config carries over, and are refused by ``check``."""
    axes: tuple[str, ...] = ("dp",)
    op: str = "average"                   # sum | average
    compression: str | None = None        # fp16 | bf16 | None
    compression_block_size: int = 256
    error_feedback: bool = False
    fusion_threshold_bytes: int = _config.FUSION_THRESHOLD.default
    hierarchical: bool = False
    # The loss was multiplied by this factor; gradients are unscaled by
    # 1/loss_scale after the reduce.
    loss_scale: float | None = None
    # Clip the global L2 norm of the reduced, unscaled gradients
    # (optax.clip_by_global_norm semantics).
    clip_global_norm: float | None = None
    optimizer_in_ring: bool = False

    def check(self) -> None:
        unported = [
            (self.op == "adasum", f"op='adasum' {_REST_OF_SYNC}"),
            (self.compression in ("int8", "uint4"),
             f"compression={self.compression!r} {_REST_OF_SYNC}"),
            (self.error_feedback, f"error_feedback {_REST_OF_SYNC}"),
            (self.hierarchical, f"hierarchical {_REST_OF_SYNC}"),
            (self.optimizer_in_ring, f"optimizer_in_ring {_REST_OF_SYNC}"),
        ]
        for unsupported, what in unported:
            if unsupported:
                raise NotImplementedError(what)
        if self.op not in ("sum", "average", "mean"):
            raise ValueError(f"unknown reduce op {self.op!r}")
        if self.compression not in _WIRE_DTYPES:
            raise ValueError(f"unknown compression {self.compression!r}")


def _bucketize(leaves: Sequence[torch.Tensor], threshold: int,
               itemsize: int | None = None) -> list[list[int]]:
    """Greedy bucketing in leaf order: a bucket closes when the next leaf
    would take it past ``threshold`` bytes.  ``itemsize`` overrides the
    leaf dtype width so that buckets are sized in wire bytes."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * (itemsize or leaf.element_size())
        if cur and cur_bytes + nbytes > threshold:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _memory_order(t: torch.Tensor) -> list[int]:
    """t's dims from the largest stride to the smallest: the permutation
    under which a dense tensor is contiguous ((0, 2, 3, 1) for a
    channels_last conv weight)."""
    return sorted(range(t.dim()), key=lambda d: -t.stride(d))


def _flatten(t: torch.Tensor) -> torch.Tensor:
    """t's elements in memory order (no copy for a dense tensor)."""
    return t.permute(_memory_order(t)).reshape(-1)


def _unflatten(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``flat`` (from ``_flatten``) as a tensor of ``like``'s shape and
    layout, so a channels_last gradient comes back channels_last."""
    order = _memory_order(like)
    inverse = sorted(range(len(order)), key=order.__getitem__)
    return flat.view([like.shape[d] for d in order]).permute(inverse)


def sync_gradients(grads: Mapping[str, torch.Tensor]
                   | Sequence[torch.Tensor],
                   config: GradSyncConfig = GradSyncConfig(),
                   group: dist.ProcessGroup | None = None):
    """Reduce gradients over the data axis (the ranks of ``group``).

    ``grads`` is a mapping name -> tensor or a sequence of tensors, in the
    order that buckets are filled; the result has the same structure and
    order.  The inputs are not modified; an output may share memory with
    its input where no cast or reduction was needed."""
    config.check()
    names = list(grads) if isinstance(grads, Mapping) else None
    leaves = [grads[n] for n in names] if names is not None else list(grads)
    out = _sync_impl(leaves, config, group)
    return dict(zip(names, out)) if names is not None else out


def _sync_impl(leaves: list[torch.Tensor], config: GradSyncConfig,
               group: dist.ProcessGroup | None) -> list[torch.Tensor]:
    if not leaves:
        return []
    wire = _WIRE_DTYPES[config.compression]
    out: list[torch.Tensor | None] = [None] * len(leaves)
    # (member leaf indices, reduced flat buffer, dtype, floating); the
    # slice-out waits for the global norm that clipping needs.
    reduced: list[tuple[list[int], torch.Tensor, torch.dtype, bool]] = []
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)

    for dtype, idxs in by_dtype.items():
        floating = dtype.is_floating_point
        cast = wire if (wire is not None and floating) else None
        itemsize = torch.empty((), dtype=cast).element_size() \
            if cast is not None else None
        group_leaves = [leaves[i] for i in idxs]
        for bucket in _bucketize(group_leaves, config.fusion_threshold_bytes,
                                 itemsize):
            members = [idxs[j] for j in bucket]
            parts = [_flatten(leaves[i]) for i in members]
            if cast is not None:
                parts = [p.to(cast) for p in parts]
            flat = torch.cat(parts) if len(parts) > 1 else parts[0]
            flat = allreduce(flat, config.op, group)
            reduced.append((members, flat, dtype, floating))

    factor = _scale_clip_factor(
        config, [flat for _, flat, _, floating in reduced if floating])
    for members, flat, dtype, floating in reduced:
        if factor is not None and floating:
            flat = (flat.float() * factor).to(dtype)
        else:
            flat = flat.to(dtype)
        offset = 0
        for i in members:
            n = leaves[i].numel()
            out[i] = _unflatten(flat[offset:offset + n], leaves[i])
            offset += n
    return out


def _scale_clip_factor(config: GradSyncConfig,
                       flats: list[torch.Tensor]) -> torch.Tensor | None:
    """Combined 1/loss_scale x global-norm-clip factor for the reduced
    buckets (None when neither knob is set):
    factor = inv * min(1, clip / (|g| * inv))."""
    if config.loss_scale is None and config.clip_global_norm is None:
        return None
    inv = 1.0 if config.loss_scale is None else 1.0 / config.loss_scale
    device = flats[0].device if flats else torch.device("cpu")
    inv_t = torch.tensor(inv, dtype=torch.float32, device=device)
    if config.clip_global_norm is None:
        return inv_t
    gsq = torch.zeros((), dtype=torch.float32, device=device)
    for flat in flats:
        f32 = flat.float()
        gsq = gsq + torch.dot(f32, f32)
    gnorm = torch.sqrt(gsq) * inv_t
    clip = torch.tensor(config.clip_global_norm, dtype=torch.float32,
                        device=device)
    return inv_t * torch.clamp(clip / torch.clamp(gnorm, min=1e-16),
                               max=1.0)

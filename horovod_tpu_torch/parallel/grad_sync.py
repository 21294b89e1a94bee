"""Fused gradient synchronization: tensor fusion, wire compression, reduce.

The counterpart of ``horovod_tpu/parallel/grad_sync.py``.  Gradients are
grouped by dtype and packed in the caller's leaf order into flat buckets
of at most ``fusion_threshold_bytes`` *wire* bytes (``_bucketize``), and
each bucket is reduced over the data axes with ``torch.distributed``
(NCCL on the card, gloo on the CPU).  The reducer is the port's own, not
DDP's: bucket membership follows the reference's rule, so it depends on
the leaf order, and ``Trainer`` passes the gradients in the flax flatten
order (``convert.flax_leaf_order``).

- **none / fp16 / bf16:** each leaf is flattened in its memory order (a
  channels_last conv gradient keeps its layout, and the optimizer's
  foreach kernels see one layout), cast to the wire dtype, reduced and
  cast back.  The cast is elementwise, so the order does not change the
  result.
- **int8 / uint4:** the block-quantized all-reduce of
  ``compress/ops.py``, with buckets sized at 1 wire byte an element.
  Blocks and rank chunks cut consecutive elements, so the result matches
  the reference only in flax's element order: where the caller gives
  ``layouts`` (``convert.flax_layouts``), each leaf is packed in flax's
  order and unpacked through the inverse.  Without, memory order.  With
  ``error_feedback``, ``sync_gradients_ef`` threads the quantization
  error through as fp32 residuals (EF-SGD), packed the same way.
- **adasum:** per leaf, with the 16-bit wire cast around the exchange.
- **hierarchical:** with one group per mesh axis (``mesh.axis_groups``)
  and two axes or more: reduce-scatter over the inner axes, all-reduce
  over the outer one, all-gather back.
- **optimizer-in-ring** (``sync_and_apply``): reduce-scatter the
  gradients, step an optimizer over this rank's flat fp32 shard of the
  parameters, all-gather the updated parameters.

``group`` is one process group (``None`` for the default one) or a
mapping from mesh axis to group; with a mapping, ``config.axes`` names
the axes reduced over, outermost first.  As in the reference, the wire
cast and the quantization happen even when the data axes have one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import torch

from ..common import config as _config
from ..compress import CompressionCodec, codec_from_name
from ..compress.ops import (check_block_size, dequantize_rows,
                            quantize_rows, quantized_allreduce)
from . import collectives
from .collectives import adasum_allreduce, allreduce

_WIRE_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16,
                "none": None, None: None}
_QUANTIZED = ("int8", "uint4")

# (to_flax, from_flax): a view of a torch-shaped tensor in flax's shape,
# and its inverse (``convert.flax_layouts``).
Layout = tuple[Callable[[torch.Tensor], torch.Tensor],
               Callable[[torch.Tensor], torch.Tensor]]


def _quantized_codec(compression) -> CompressionCodec | None:
    if compression in _QUANTIZED:
        return codec_from_name(compression)
    return None


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """The reference's knobs (``HOROVOD_FUSION_THRESHOLD`` et al.)."""
    axes: tuple[str, ...] = ("dp",)
    op: str = "average"                   # sum | average | adasum
    compression: str | None = None        # fp16 | bf16 | int8 | uint4 | None
    # Quantization block for int8/uint4 (elements; even for uint4).
    compression_block_size: int = 256
    # EF-SGD residuals for the quantized codecs, threaded through
    # sync_gradients_ef (see init_error_feedback).
    error_feedback: bool = False
    fusion_threshold_bytes: int = _config.FUSION_THRESHOLD.default
    # Two-stage reduction over a mapping of axis groups: reduce-scatter
    # over axes[1:], all-reduce over axes[0], all-gather over axes[1:].
    hierarchical: bool = False
    # The loss was multiplied by this factor; gradients are unscaled by
    # 1/loss_scale after the reduce.
    loss_scale: float | None = None
    # Clip the global L2 norm of the reduced, unscaled gradients
    # (optax.clip_by_global_norm semantics).
    clip_global_norm: float | None = None
    # Update the parameters inside the ring (sync_and_apply): optimizer
    # state 1/world per rank, updated parameters on the closing gather.
    optimizer_in_ring: bool = False

    def check(self) -> None:
        """The reference's refusals, as its ``ValueError``s."""
        if self.op not in ("sum", "average", "mean", "adasum"):
            raise ValueError(f"unknown reduce op {self.op!r}")
        if self.compression not in _WIRE_DTYPES \
                and self.compression not in _QUANTIZED:
            raise ValueError(f"unknown compression {self.compression!r}")
        codec = _quantized_codec(self.compression)
        if self.op == "adasum":
            if codec is not None:
                raise ValueError(
                    "adasum does not compose with quantized compression "
                    "(int8/uint4): the scale-adaptive dot products would "
                    "be computed on quantized blocks. Use none, fp16 or "
                    "bf16.")
            if self.loss_scale is not None \
                    or self.clip_global_norm is not None:
                raise ValueError(
                    "adasum does not compose with fused loss-scaling/"
                    "clipping: the scale-adaptive combine is not linear in "
                    "the gradients, so post-hoc unscaling would change the "
                    "update direction. Unscale/clip before sync instead.")
        if self.optimizer_in_ring:
            self._check_ring()
        if codec is not None:
            check_block_size(codec, self.compression_block_size)

    def _check_ring(self) -> None:
        if self.op not in ("sum", "average"):
            raise ValueError(
                f"optimizer-in-ring supports op=sum|average, not "
                f"{self.op!r} (adasum's per-tensor combine needs the leaf "
                f"boundaries the flat shard layout erases)")
        if self.error_feedback:
            raise ValueError(
                "optimizer-in-ring does not thread error-feedback state "
                "yet; use sync_gradients_ef + the optimizer, or drop "
                "error_feedback")


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


def _pack(leaves: Sequence[torch.Tensor],
          layouts: Sequence[Layout | None], out: torch.Tensor) -> None:
    """Copy the leaves one after another into the flat ``out`` (cast to
    its dtype): each in flax's element order where it has a layout, else
    in memory order.  One read and one write of every element."""
    offset = 0
    for leaf, layout in zip(leaves, layouts):
        n = leaf.numel()
        dst = out[offset:offset + n]
        if layout is None:
            dst.copy_(_flatten(leaf))
        else:
            src = layout[0](leaf)
            dst.view(src.shape).copy_(src)
        offset += n


def _unpack(flat: torch.Tensor, like: torch.Tensor,
            layout: Layout | None) -> torch.Tensor:
    """Inverse of ``_pack`` for one leaf: a tensor of ``like``'s shape and
    layout (a view of ``flat`` in memory order; a copy from flax order)."""
    if layout is None:
        return _unflatten(flat, like)
    view = layout[1](flat.view(layout[0](like).shape))
    return torch.empty_like(like, dtype=flat.dtype).copy_(view)


def _groups(config: GradSyncConfig, group) -> list:
    """The process groups reduced over, outermost axis first."""
    if isinstance(group, Mapping):
        return [group[a] for a in config.axes]
    return [group]


def _leaves_of(tree, layouts):
    """(names or None, leaves, layouts aligned with the leaves)."""
    names = list(tree) if isinstance(tree, Mapping) else None
    leaves = [tree[n] for n in names] if names is not None else list(tree)
    if layouts is None:
        aligned = [None] * len(leaves)
    elif isinstance(layouts, Mapping):
        aligned = [layouts[n] for n in names]
    else:
        aligned = list(layouts)
    return names, leaves, aligned


def _rebuild(names, leaves):
    return dict(zip(names, leaves)) if names is not None else leaves


def sync_gradients(grads: Mapping[str, torch.Tensor]
                   | Sequence[torch.Tensor],
                   config: GradSyncConfig = GradSyncConfig(),
                   group=None,
                   layouts: Mapping[str, Layout] | Sequence[Layout] | None
                   = None, norm_groups: Mapping[str, list] | None = None):
    """Reduce gradients over the data axes (the ranks of ``group``).

    ``grads`` is a mapping name -> tensor or a sequence of tensors, in the
    order that buckets are filled; the result has the same structure and
    order.  ``layouts`` (same structure; ``convert.flax_layouts``) puts
    the quantized buckets in flax's element order.  ``norm_groups`` maps
    the name of a gradient that is one rank's chunk of a sharded leaf to
    the process groups its chunks span: for ``clip_global_norm`` its
    squared norm is summed over them, so that the clip sees every chunk
    of every leaf once.  The inputs are not modified; an output may share
    memory with its input where no cast or reduction was needed."""
    config.check()
    names, leaves, aligned = _leaves_of(grads, layouts)
    chunked = None
    if norm_groups:
        chunked = [norm_groups.get(n) for n in names]
    out, _ = _sync_impl(leaves, config, group, aligned, None, chunked)
    return _rebuild(names, out)


def init_error_feedback(grads):
    """Zero EF residuals matching a gradient mapping or sequence (fp32:
    the residual holds error finer than the wire can carry)."""
    names, leaves, _ = _leaves_of(grads, None)
    return _rebuild(names, [torch.zeros_like(g, dtype=torch.float32)
                            for g in leaves])


def sync_gradients_ef(grads, residuals, config: GradSyncConfig, group=None,
                      layouts=None):
    """Error-feedback variant of :func:`sync_gradients`: the
    quantization error of this step's wire is returned as residuals, to
    be added to the next step's gradients (EF-SGD).  Returns
    ``(synced, new_residuals)``; initialise with
    :func:`init_error_feedback`.  For codecs that do not quantize, the
    residuals pass through untouched."""
    if _quantized_codec(config.compression) is None:
        return sync_gradients(grads, config, group, layouts), residuals
    config.check()
    names, leaves, aligned = _leaves_of(grads, layouts)
    res_names, res_leaves, _ = _leaves_of(residuals, None)
    if len(res_leaves) != len(leaves):
        raise ValueError(
            "error-feedback residuals do not match the gradients; "
            "initialise them with init_error_feedback()")
    out, new_res = _sync_impl(leaves, config, group, aligned, res_leaves)
    return _rebuild(names, out), _rebuild(res_names, new_res)


def _sync_impl(leaves: list[torch.Tensor], config: GradSyncConfig, group,
               layouts: list[Layout | None],
               residuals: list[torch.Tensor] | None, chunked=None):
    if not leaves:
        return [], residuals
    groups = _groups(config, group)
    codec = _quantized_codec(config.compression)
    wire = _WIRE_DTYPES[config.compression] if codec is None else None

    if config.op == "adasum":
        out = []
        for leaf in leaves:
            v = leaf.to(wire) if wire is not None \
                and leaf.is_floating_point() else leaf
            out.append(adasum_allreduce(v, groups).to(leaf.dtype))
        return out, residuals

    res_out = list(residuals) if residuals is not None else None
    out: list[torch.Tensor | None] = [None] * len(leaves)
    # (member leaf indices, reduced flat buffer, dtype, floating, packed
    # through the layouts); the slice-out waits for the global norm that
    # clipping needs.
    reduced: list[tuple[list[int], torch.Tensor, torch.dtype, bool,
                        bool]] = []
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)

    for dtype, idxs in by_dtype.items():
        floating = dtype.is_floating_point
        quantized = codec is not None and floating
        cast = wire if (wire is not None and floating) else None
        if quantized:
            itemsize: int | None = 1      # ~1 wire byte an element
        else:
            itemsize = torch.empty((), dtype=cast).element_size() \
                if cast is not None else None
        group_leaves = [leaves[i] for i in idxs]
        for bucket in _bucketize(group_leaves, config.fusion_threshold_bytes,
                                 itemsize):
            members = [idxs[j] for j in bucket]
            if quantized:
                flat = _quantized_bucket(leaves, layouts, members, config,
                                         groups, codec, res_out)
            else:
                parts = [_flatten(leaves[i]) for i in members]
                if cast is not None:
                    parts = [p.to(cast) for p in parts]
                flat = torch.cat(parts) if len(parts) > 1 else parts[0]
                if config.hierarchical and len(groups) >= 2:
                    flat = _hierarchical_allreduce(flat, groups, config.op)
                else:
                    flat = allreduce(flat, config.op, groups)
            reduced.append((members, flat, dtype, floating, quantized))

    if chunked is not None and config.clip_global_norm is not None:
        factor = _factor(config, _chunked_gsq(reduced, leaves, chunked),
                         leaves[0].device)
    else:
        factor = _scale_clip_factor(
            config, [flat for _, flat, _, floating, _ in reduced if floating])
    for members, flat, dtype, floating, packed in reduced:
        if factor is not None and floating:
            flat = (flat.float() * factor).to(dtype)
        else:
            flat = flat.to(dtype)
        offset = 0
        for i in members:
            n = leaves[i].numel()
            part = flat[offset:offset + n]
            out[i] = _unpack(part, leaves[i], layouts[i]) if packed \
                else _unflatten(part, leaves[i])
            offset += n
    return out, res_out


def _quantized_bucket(leaves, layouts, members, config, groups, codec,
                      res_out) -> torch.Tensor:
    """One quantized bucket: pack, quantized all-reduce (with the
    residuals when ``res_out`` is given, updated in place), and the
    reduced flat buffer in the packed order."""
    member_leaves = [leaves[i] for i in members]
    member_layouts = [layouts[i] for i in members]
    total = sum(leaf.numel() for leaf in member_leaves)
    flat = member_leaves[0].new_empty(total)
    _pack(member_leaves, member_layouts, flat)
    if res_out is None:
        return quantized_allreduce(flat, groups, config.op, codec,
                                   config.compression_block_size)
    rflat = flat.new_empty(total, dtype=torch.float32)
    _pack([res_out[i] for i in members], member_layouts, rflat)
    flat, new_res = quantized_allreduce(
        flat, groups, config.op, codec, config.compression_block_size,
        residual=rflat)
    offset = 0
    for i, leaf, layout in zip(members, member_leaves, member_layouts):
        n = leaf.numel()
        res_out[i] = _unpack(new_res[offset:offset + n], res_out[i], layout)
        offset += n
    return flat


def _scale_clip_factor(config: GradSyncConfig,
                       flats: list[torch.Tensor]) -> torch.Tensor | None:
    """Combined 1/loss_scale x global-norm-clip factor for the reduced
    buckets (None when neither knob is set):
    factor = inv * min(1, clip / (|g| * inv))."""
    if config.loss_scale is None and config.clip_global_norm is None:
        return None
    device = flats[0].device if flats else torch.device("cpu")
    gsq = None
    if config.clip_global_norm is not None:
        gsq = torch.zeros((), dtype=torch.float32, device=device)
        for flat in flats:
            f32 = flat.float()
            gsq = gsq + torch.dot(f32, f32)
    return _factor(config, gsq, device)


def _chunked_gsq(reduced, leaves: list[torch.Tensor],
                 chunked: list) -> torch.Tensor:
    """The squared global norm when some leaves are chunks of sharded ones
    (``chunked[i]``: the groups leaf i's chunks span, else None): the
    whole leaves' squares here, each chunked leaf's summed over its
    groups, one all-reduce a distinct set of groups."""
    gsq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    spans: dict[tuple, torch.Tensor] = {}
    for members, flat, _, floating, _ in reduced:
        if not floating:
            continue
        offset = 0
        for i in members:
            n = leaves[i].numel()
            part = flat[offset:offset + n].float()
            offset += n
            sq = torch.dot(part, part)
            if chunked[i] is None:
                gsq = gsq + sq
            else:
                key = tuple(chunked[i])
                spans[key] = spans[key] + sq if key in spans else sq
    for key, sq in spans.items():
        gsq = gsq + allreduce(sq, "sum", list(key))
    return gsq


def _factor(config: GradSyncConfig, gsq: torch.Tensor | None,
            device: torch.device) -> torch.Tensor:
    """inv * min(1, clip / (sqrt(gsq) * inv)), or inv without clipping."""
    inv = 1.0 if config.loss_scale is None else 1.0 / config.loss_scale
    inv_t = torch.tensor(inv, dtype=torch.float32, device=device)
    if config.clip_global_norm is None:
        return inv_t
    gnorm = torch.sqrt(gsq) * inv_t
    clip = torch.tensor(config.clip_global_norm, dtype=torch.float32,
                        device=device)
    return inv_t * torch.clamp(clip / torch.clamp(gnorm, min=1e-16),
                               max=1.0)


def _hierarchical_allreduce(flat: torch.Tensor, groups: list,
                            op: str) -> torch.Tensor:
    """reduce_scatter(inner axes) -> all-reduce(outer axis) ->
    all_gather(inner axes), padding the buffer to a multiple of the
    inner ranks (the reference's NCCLHierarchicalAllreduce split)."""
    cross, inner = groups[0], groups[1:]
    n = flat.shape[0]
    pad = (-n) % collectives.world_size(inner)
    shard = collectives.reduce_scatter(
        torch.nn.functional.pad(flat, (0, pad)), inner)
    shard = allreduce(shard, "sum", cross)
    full = collectives.allgather(shard, inner)[:n]
    if op in ("average", "mean"):
        full = full / collectives.world_size(groups)
    return full


# ---------------------------------------------------------------------------
# Optimizer-in-ring (ZeRO-style fused sync and update)
# ---------------------------------------------------------------------------
def ring_chunk_size(n_params: int, world_size: int,
                    config: GradSyncConfig) -> int:
    """Per-rank flat shard length of the optimizer-in-ring layout: the
    flat parameter buffer padded to world x chunk, the chunk
    block-aligned when a quantized codec rides the gradient leg."""
    chunk = -(-n_params // max(world_size, 1))
    if _quantized_codec(config.compression) is not None:
        bs = config.compression_block_size
        chunk = -(-chunk // bs) * bs
    return chunk


def init_ring_optimizer(optimizer: torch.optim.Optimizer,
                        params: Sequence[torch.Tensor], world_size: int,
                        config: GradSyncConfig) -> torch.optim.Optimizer:
    """The optimizer of one rank's shard (the reference's
    ``init_ring_optimizer_state``): a new optimizer of ``optimizer``'s
    class, with the hyperparameters of its one param group, over one flat
    fp32 ``Parameter`` of ``ring_chunk_size`` elements, so that its state
    is 1/world of the replicated one.  The update runs on the flat
    buffer, so only elementwise optimizers (SGD, Adam, AdamW and the
    like) give the per-leaf result."""
    if len(optimizer.param_groups) != 1:
        raise ValueError(
            f"optimizer-in-ring takes an optimizer with one param group "
            f"(its hyperparameters apply to the whole flat shard), not "
            f"{len(optimizer.param_groups)}")
    hyper = {k: v for k, v in optimizer.param_groups[0].items()
             if k != "params"}
    n = sum(p.numel() for p in params)
    shard = torch.nn.Parameter(torch.zeros(
        ring_chunk_size(n, world_size, config), dtype=torch.float32,
        device=params[0].device))
    return type(optimizer)([{"params": [shard], **hyper}])


def sync_and_apply(optimizer: torch.optim.Optimizer, grads, params, config:
                   GradSyncConfig, group=None, layouts=None) -> None:
    """Fused gradient sync and optimizer update (optimizer-in-ring), in
    place of ``sync_gradients`` and ``optimizer.step()``:

      1. pack the gradients into one fp32 buffer, padded to world x chunk
         (in flax's element order where ``layouts`` are given);
      2. reduce-scatter it over the data axes: quantized codecs send
         int8/uint4 rows through an all-to-all and sum them in fp32 at
         the owner, cast codecs reduce 16-bit words;
      3. step ``optimizer`` (from :func:`init_ring_optimizer`) on this
         rank's shard of the flat fp32 parameters;
      4. all-gather the updated shards (in the wire dtype of a cast
         codec: the parameters are rounded to it on every step, as in the
         reference) and write each parameter back in its own layout.

    ``grads`` and ``params`` are mappings or sequences of one structure;
    the parameters are updated in place.  Loss scaling and clipping apply
    on the reduced shard, with one scalar all-reduce for the norm."""
    config.check()
    config._check_ring()
    _, g_leaves, aligned = _leaves_of(grads, layouts)
    _, p_leaves, _ = _leaves_of(params, None)
    if len(g_leaves) != len(p_leaves):
        raise ValueError("gradients and parameters do not match")
    if not g_leaves:
        return
    groups = _groups(config, group)
    world = collectives.world_size(groups)
    n = sum(leaf.numel() for leaf in g_leaves)
    chunk = ring_chunk_size(n, world, config)
    shard = optimizer.param_groups[0]["params"][0]
    if shard.numel() != chunk:
        raise ValueError(f"the ring optimizer's shard holds {shard.numel()} "
                         f"elements, this world needs {chunk}")
    device = shard.device

    g32 = torch.zeros(chunk * world, dtype=torch.float32, device=device)
    _pack(g_leaves, aligned, g32)
    codec = _quantized_codec(config.compression)
    wire = _WIRE_DTYPES[config.compression] if codec is None else None
    if codec is not None:
        # The scatter-reduce half of quantized_allreduce: the reduced
        # shard feeds the update and is not requantized.
        bs = config.compression_block_size
        q, s, zp = quantize_rows(g32.view(world, chunk), codec, bs)
        q, s, zp = (collectives.alltoall(t, groups) for t in (q, s, zp))
        g_shard = dequantize_rows(q, s, zp, codec, bs).sum(dim=0)
    else:
        leg = g32 if wire is None else g32.to(wire)
        g_shard = collectives.reduce_scatter(leg, groups).float()
    if config.op == "average":
        g_shard = g_shard / world

    if config.loss_scale is not None or config.clip_global_norm is not None:
        gsq = None
        if config.clip_global_norm is not None:
            gsq = allreduce(torch.dot(g_shard, g_shard), "sum", groups)
        g_shard = g_shard * _factor(config, gsq, device)

    idx = collectives.axis_index(groups)
    p32 = torch.zeros(chunk * world, dtype=torch.float32, device=device)
    _pack(p_leaves, aligned, p32)
    with torch.no_grad():
        shard.copy_(p32[idx * chunk:(idx + 1) * chunk])
    del p32
    shard.grad = g_shard
    optimizer.step()
    shard.grad = None

    full = shard.detach() if wire is None else shard.detach().to(wire)
    full = collectives.allgather(full, groups)[:n]
    offset = 0
    with torch.no_grad():
        for p, layout in zip(p_leaves, aligned):
            k = p.numel()
            part = full[offset:offset + k]
            if layout is None:
                p.copy_(_unflatten(part, p))
            else:
                p.copy_(layout[1](part.view(layout[0](p).shape)))
            offset += k

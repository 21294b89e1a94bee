"""Collectives over the mesh axes: ``torch.distributed`` calls.

The counterpart of ``horovod_tpu/parallel/collectives.py``.  Where the
reference names mesh axes, the port names process groups: ``group`` is
one group (``None`` for the default one) or a sequence of groups, one
per mesh axis, outermost first (``mesh.axis_groups``).  Over a sequence
each collective is the reference's multi-axis one: a reduction runs
group after group, a scatter splits the outermost axis first and a
gather stacks the innermost first, so that shard ``i`` of a tiled result
belongs to the rank whose row-major index over the axes is ``i``.

``allgather``, ``alltoall``, ``broadcast`` and ``ppermute`` are
differentiable as JAX's are: the backward of each is the adjoint of its
forward over the whole group (a gather's is the summed scatter, a tiled
all-to-all's the swapped all-to-all, a broadcast's the sum handed to the
root, a permutation's the inverse permutation).  A backward that runs a
collective must run on every rank of the group in the same order, so the
autograd graphs around them must have the same shape on every rank.

A reduction runs in the tensor's own dtype, as the reference's
psum/pmean do, so a 16-bit wire reduces in 16 bits.  With no initialised
process group every collective is the identity (a world of one); with
one, it always goes through the group's backend (NCCL on the card), a
group of one rank included.

``adasum_allreduce`` is the reference's recursive distance-doubling: at
level ``l`` rank ``i`` exchanges its vector with rank ``i ^ 2^l``
(``batch_isend_irecv``) and both combine

    a' = a (1 - a.b / 2|a|^2) + b (1 - a.b / 2|b|^2)

with ``a`` the vector of the rank whose bit ``l`` is clear.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

# One process group (None: the default one) or one per mesh axis,
# outermost first.
Groups = dist.ProcessGroup | None | Sequence[dist.ProcessGroup | None]

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "average": dist.ReduceOp.SUM,
               "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_list(group: Groups) -> list:
    """``group`` as a list of groups, outermost axis first."""
    if isinstance(group, (list, tuple)):
        return list(group)
    return [group]


def world_size(group: Groups) -> int:
    """Ranks over all the groups' axes (1 with no process group)."""
    if not _initialized():
        return 1
    return math.prod(dist.get_world_size(g) for g in group_list(group))


def axis_index(group: Groups) -> int:
    """This rank's row-major index over the groups' axes."""
    if not _initialized():
        return 0
    idx = 0
    for g in group_list(group):
        idx = idx * dist.get_world_size(g) + dist.get_rank(g)
    return idx


def allreduce(x: torch.Tensor, op: str = "sum",
              group: Groups = None) -> torch.Tensor:
    """sum, average, max, min or adasum of ``x`` over the groups' ranks
    (a new tensor, except where there is nothing to reduce)."""
    if op == "adasum":
        return adasum_allreduce(x, group)
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    if not _initialized():
        return x
    out = x.clone()
    for g in group_list(group):
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=g)
    world = world_size(group)
    if op in ("average", "mean") and world > 1:
        out = out / world
    return out


def reduce_scatter(x: torch.Tensor, group: Groups = None) -> torch.Tensor:
    """Sum over the groups' ranks, then this rank's shard of dim 0
    (``x.shape[0]`` divisible by the world size)."""
    if not _initialized():
        return x
    for g in group_list(group):
        out = x.new_empty((x.shape[0] // dist.get_world_size(g),)
                          + x.shape[1:])
        dist.reduce_scatter_tensor(out, x.contiguous(),
                                   op=dist.ReduceOp.SUM, group=g)
        x = out
    return x


def _allgather(x: torch.Tensor, group: Groups) -> torch.Tensor:
    for g in reversed(group_list(group)):
        out = x.new_empty((x.shape[0] * dist.get_world_size(g),)
                          + x.shape[1:])
        dist.all_gather_into_tensor(out, x.contiguous(), group=g)
        x = out
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _allgather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group), None


def allgather(x: torch.Tensor, group: Groups = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order.
    Differentiable: the backward sums the gradients over the ranks and
    hands each rank its block."""
    if not _initialized():
        return x
    return _AllGather.apply(x, group)


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g.contiguous(), "sum", ctx.group), None


class _LeaveSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return allreduce(x.contiguous(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_split(x: torch.Tensor, group: Groups) -> torch.Tensor:
    """The input of a layer whose weight is split over ``group``'s ranks
    (tensor parallelism): the identity forward, the gradient summed over
    the group backward, as every rank's slice of the layer reads all of
    ``x``.  The identity over no group or one rank."""
    if world_size(group) == 1:
        return x
    return _EnterSplit.apply(x, group)


def leave_split(x: torch.Tensor, group: Groups) -> torch.Tensor:
    """The output of such a layer: this rank's partial sum summed over the
    group forward, the gradient passed through backward.  The identity
    over no group or one rank."""
    if world_size(group) == 1:
        return x
    return _LeaveSplit.apply(x, group)


class _AllToAll(torch.autograd.Function):
    """The reference's tiled ``lax.all_to_all`` over one group: split
    ``split_axis`` into one block per rank, send block ``p`` to rank
    ``p``, concatenate the received blocks along ``concat_axis`` in rank
    order."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        n = dist.get_world_size(group)
        send = torch.stack(x.chunk(n, split_axis)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return torch.cat(recv.unbind(0), concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return (_AllToAll.apply(g, group, concat_axis, split_axis), None,
                None, None)


def alltoall(x: torch.Tensor, group: Groups = None, split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank and exchange: block
    ``p`` of the result along ``concat_axis`` is rank ``p``'s block for
    this rank (the reference's tiled ``alltoall``, ``split_axis`` and
    ``concat_axis`` as there).  Over a sequence of groups it splits and
    concatenates dim 0 only: dim 0 is viewed as one axis per group, each
    exchanged over its group in turn.  Differentiable."""
    if not _initialized():
        return x
    groups = group_list(group)
    if len(groups) == 1:
        return _AllToAll.apply(x, groups[0], split_axis % x.dim(),
                               concat_axis % x.dim())
    if split_axis or concat_axis:
        raise ValueError("an all-to-all over several groups exchanges "
                         "blocks of dim 0 only")
    sizes = [dist.get_world_size(g) for g in groups]
    y = x.reshape(*sizes, x.shape[0] // math.prod(sizes), *x.shape[1:])
    for i, g in enumerate(groups):
        y = _AllToAll.apply(y, g, i, i)
    return y.reshape(x.shape)


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root):
        ctx.args = group, root
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=_global_rank(group, root), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        group, root = ctx.args
        total = g.contiguous().clone()
        dist.all_reduce(total, group=group)
        if dist.get_rank(group) != root:
            total = torch.zeros_like(total)
        return total, None, None


def broadcast(x: torch.Tensor, group: dist.ProcessGroup | None = None,
              root: int = 0) -> torch.Tensor:
    """Every rank takes ``root``'s ``x`` (the reference's masked psum).
    Differentiable: the root's gradient is the sum of every rank's, the
    others' zero."""
    if not _initialized():
        return x
    return _Broadcast.apply(x, group, root)


def _ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for d in dst:
        if d == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.isend, x, _global_rank(group, d),
                                  group))
    for s in src:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, s),
                                  group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.args = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        group, perm = ctx.args
        return (_PPermute.apply(g, group, tuple((d, s) for s, d in perm)),
                None, None)


def ppermute(x: torch.Tensor, group: dist.ProcessGroup | None,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Point-to-point exchange over ``group``: for every pair ``(i, j)``
    of ``perm`` (group ranks) rank ``i``'s ``x`` becomes rank ``j``'s
    result; a rank that receives nothing gets zeros.  Differentiable: the
    backward runs the inverse permutation."""
    if not _initialized():
        return x
    perm = tuple((int(s), int(d)) for s, d in perm)
    if len({s for s, _ in perm}) != len(perm) \
            or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute takes a permutation, got {perm}")
    return _PPermute.apply(x, group, perm)


def adasum_allreduce(x: torch.Tensor, group: Groups = None,
                     eps: float = 0.0) -> torch.Tensor:
    """Adasum over the groups' ranks, innermost axis first (the
    reference's hierarchical order).  Power-of-2 group sizes only."""
    if not _initialized():
        return x
    for g in reversed(group_list(group)):
        x = _adasum_one_group(x, g, eps)
    return x


def _adasum_one_group(x: torch.Tensor, group, eps: float) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if n & (n - 1):
        raise ValueError(f"Adasum requires power-of-2 axis size, got {n}")
    idx = dist.get_rank(group)
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype
    v = x.to(acc).contiguous()
    for level in range(int(math.log2(n))):
        distance = 1 << level
        peer = dist.get_global_rank(
            dist.group.WORLD if group is None else group, idx ^ distance)
        other = torch.empty_like(v)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, v, peer, group),
                dist.P2POp(dist.irecv, other, peer, group)]):
            req.wait()
        # Both partners compute with the same (a, b): a is the vector of
        # the rank whose level bit is clear.
        a, b = (v, other) if (idx & distance) == 0 else (other, v)
        aa, bb, ab = (a * a).sum(), (b * b).sum(), (a * b).sum()
        one = torch.ones_like(aa)
        acoef = torch.where(aa > eps, 1.0 - ab / (2.0 * aa + 1e-30), one)
        bcoef = torch.where(bb > eps, 1.0 - ab / (2.0 * bb + 1e-30), one)
        zero = (aa == 0.0) & (bb == 0.0)
        acoef = torch.where(zero, one, acoef)
        bcoef = torch.where(zero, one, bcoef)
        v = acoef.to(acc) * a + bcoef.to(acc) * b
    return v.to(x.dtype)

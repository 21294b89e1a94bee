"""The device mesh of the port: a data-parallel axis over a process group.

The counterpart of ``horovod_tpu/parallel/mesh.py``.  ``MeshSpec`` keeps
the same axes (``pp dp fsdp ep sp tp``, outermost first) and the same
``dp=-1`` rule; this slice builds meshes whose only axis larger than one
is ``dp``.  The ``dp`` axis is the ranks of a ``torch.distributed``
process group (the default group unless one is given); a world of one
needs no group at all.  Each rank drives one card.  ``axis_groups``
forms one subgroup per axis of a data mesh (``dp`` and ``fsdp``) for the
gradient sync's multi-axis reductions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..common.device import resolve_device

# outermost -> innermost
DEFAULT_AXES: tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Requested parallelism degrees; ``dp=-1`` means "all remaining
    ranks"."""
    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in DEFAULT_AXES}
        fixed = math.prod(v for v in sizes.values() if v > 0)
        if sizes["dp"] == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed} ({sizes})")
            sizes["dp"] = n_devices // fixed
            fixed *= sizes["dp"]
        if fixed != n_devices:
            raise ValueError(
                f"mesh axes {sizes} require {fixed} devices, have "
                f"{n_devices}")
        return sizes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axis sizes, the process group of the data axis (None for a
    world of one without a group), and this rank's device."""
    shape: dict[str, int]
    group: dist.ProcessGroup | None
    device: torch.device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def build_mesh(spec: MeshSpec | None = None,
               group: dist.ProcessGroup | None = None,
               device: str | torch.device | None = None,
               **axis_sizes: int) -> Mesh:
    """``build_mesh(dp=2)`` or ``build_mesh(MeshSpec())``.  The ranks are
    those of ``group`` (default: the initialised default group, else a
    world of one).  Runs on the card unless ``device="cpu"``."""
    if spec is None:
        spec = MeshSpec(**axis_sizes)
    elif axis_sizes:
        spec = dataclasses.replace(spec, **axis_sizes)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        world = 1
    sizes = spec.resolve(world)
    others = {a: n for a, n in sizes.items() if a != "dp" and n > 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others}: only 'dp' is ported so far (fsdp/tp/sp/"
            "ep/pp are ROADMAP queue A item 10)")
    return Mesh(shape=sizes, group=group, device=dev)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes gradients are reduced over: every data-parallel-like axis
    larger than 1."""
    return tuple(a for a in ("dp", "fsdp") if axis_size(mesh, a) > 1)


def axis_groups(shape: dict[str, int],
                group: dist.ProcessGroup | None = None
                ) -> dict[str, dist.ProcessGroup]:
    """One process group per axis of a mesh over ``group``'s ranks
    (default: the world), holding this rank and the ranks that differ
    from it in that axis' coordinate only.

    The mesh is row-major over ``shape``'s axes in ``DEFAULT_AXES``
    order: with ``{"dp": 2, "fsdp": 2}`` the rank of group rank ``r`` has
    ``dp`` index ``r // 2`` and ``fsdp`` index ``r % 2``, the index of
    its slice in the reference's stacked ``P(("dp", "fsdp"))`` input.
    Every rank of ``group`` must call this with the same shape: each
    ``dist.new_group`` is collective."""
    axes = [a for a in DEFAULT_AXES if a in shape]
    sizes = [shape[a] for a in axes]
    world = dist.get_world_size(group)
    if math.prod(sizes) != world:
        raise ValueError(f"mesh axes {shape} require {math.prod(sizes)} "
                         f"ranks, the group has {world}")
    ranks = [dist.get_global_rank(group, r) if group is not None else r
             for r in range(world)]
    me = dist.get_rank(group)
    grid = torch.arange(world).reshape(sizes)
    out = {}
    for i, axis in enumerate(axes):
        # Every line of the grid along this axis, in the same order on
        # every rank.
        lines = grid.movedim(i, -1).reshape(-1, sizes[i])
        for line in lines.tolist():
            g = dist.new_group([ranks[r] for r in line])
            if me in line:
                out[axis] = g
    return out

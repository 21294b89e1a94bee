"""The device mesh of the port: named axes over a process group.

The counterpart of ``horovod_tpu/parallel/mesh.py``.  ``MeshSpec`` keeps
the same axes (``pp dp fsdp ep sp tp``, outermost first) and the same
``dp=-1`` rule.  The mesh's ranks are those of a ``torch.distributed``
process group (the default group unless one is given); a world of one
needs no group at all.  Each rank drives one card.

Ranks lie row-major over ``DEFAULT_AXES``, as the reference's CPU meshes
lay out their devices (``np.asarray(devices).reshape(shape)``): with
``dp=2, sp=2`` rank ``r`` has ``dp`` coordinate ``r // 2`` and ``sp``
coordinate ``r % 2``.  ``Mesh.groups`` holds one process group for each
axis larger than one (``axis_groups``): the ranks that differ from this
one in that axis' coordinate only.  ``Mesh.coords`` is this rank's
coordinate on every axis.  ``tp`` is an axis like the others: its group
holds the ranks that split a tensor-parallel layer's heads or columns
(``parallel/sharding.py``, ``Trainer(param_rules=...)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

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
    """Named axis sizes, the process group of the whole mesh (None for
    the default group, or a world of one without a group), this rank's
    device, one group per axis larger than one and this rank's
    coordinate on each axis."""
    shape: dict[str, int]
    group: dist.ProcessGroup | None
    device: torch.device
    groups: dict[str, dist.ProcessGroup | None] = dataclasses.field(
        default_factory=dict)
    coords: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_group(self, axis: str) -> dist.ProcessGroup | None:
        """The process group of ``axis`` (an axis larger than one)."""
        if axis_size(self, axis) == 1:
            raise ValueError(f"mesh axis {axis!r} has one rank and no group")
        return self.groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords.get(axis, 0)


def build_mesh(spec: MeshSpec | None = None,
               group: dist.ProcessGroup | None = None,
               device: str | torch.device | None = None,
               **axis_sizes: int) -> Mesh:
    """``build_mesh(dp=2, sp=2)`` or ``build_mesh(MeshSpec())``.  The
    ranks are those of ``group`` (default: the initialised default group,
    else a world of one).  Runs on the card unless ``device="cpu"``.
    With two axes or more larger than one, every rank of ``group`` must
    call it alike: forming the axis groups is collective."""
    if spec is None:
        spec = MeshSpec(**axis_sizes)
    elif axis_sizes:
        spec = dataclasses.replace(spec, **axis_sizes)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed "
                         "is not initialised")
    else:
        world, rank = 1, 0
    sizes = spec.resolve(world)
    coords = {}
    for axis in reversed(DEFAULT_AXES):
        rank, coords[axis] = divmod(rank, sizes[axis])
    big = {a: n for a, n in sizes.items() if n > 1}
    if len(big) > 1:
        groups = axis_groups(big, group)
    else:
        # One axis spans the whole group (or none does).
        groups = {a: group for a in big}
    return Mesh(shape=sizes, group=group, device=dev, groups=groups,
                coords={a: coords[a] for a in DEFAULT_AXES})


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
    ``build_mesh`` forms its ``groups`` here.
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


class _View(threading.local):
    """The mesh and batch axes of the Trainer's pure-GSPMD step, the
    sequence axes bound there, and the mesh of its manual step, on this
    thread (None and () outside them)."""
    batch: tuple[Mesh, tuple[str, ...]] | None = None
    seq: tuple[str, ...] = ()
    manual: Mesh | None = None


_VIEW = _View()


@contextlib.contextmanager
def global_batch(mesh: Mesh, batch_axes: tuple[str, ...],
                 seq_axes: tuple[str, ...] = ()):
    """Inside, a model's rows are this rank's shard of a global batch laid
    over ``mesh``'s ``batch_axes`` (row-major, in that order), and a layer
    whose result depends on rows other than its own sees the global
    batch, as the reference's model does under its pure-GSPMD step (sync
    axes ``()``), where it is traced with global shapes.  Outside, a
    model's rows are all it sees, as inside the reference's manual
    region.

    ``seq_axes`` are bound as in a manual region: a model's tokens are
    this rank's chunk of the sequence over them, and a layer that
    computes over that axis itself (ring or Ulysses attention over its
    ``sp`` axis) takes the chunk as it is, as the reference's nested
    ``shard_map`` over ``P(batch_spec, sp_axis)`` does."""
    prev = _VIEW.batch, _VIEW.seq
    _VIEW.batch, _VIEW.seq = (mesh, tuple(batch_axes)), tuple(seq_axes)
    try:
        yield
    finally:
        _VIEW.batch, _VIEW.seq = prev


def current_global_batch() -> tuple[Mesh, tuple[str, ...]] | None:
    """The mesh and batch axes of the enclosing ``global_batch``, else
    None."""
    return _VIEW.batch


def current_sequence_axes() -> tuple[str, ...]:
    """The sequence axes the enclosing ``global_batch`` binds, else ()."""
    return _VIEW.seq if _VIEW.batch is not None else ()


def current_view() -> tuple | None:
    """The enclosing ``global_batch``'s arguments (to enter it again,
    ``global_batch(*view)``), else None."""
    if _VIEW.batch is None:
        return None
    return (*_VIEW.batch, _VIEW.seq)


@contextlib.contextmanager
def manual_region(mesh: Mesh):
    """Inside, ``mesh``'s axis names are bound as in the reference's
    manual region (its ``shard_map`` over every mesh axis): a layer
    given an ``axis_name`` (cross-replica BatchNorm) reduces over that
    axis' group.  The Trainer's manual step runs its forward here."""
    prev = _VIEW.manual
    _VIEW.manual = mesh
    try:
        yield
    finally:
        _VIEW.manual = prev


def current_manual_mesh() -> Mesh | None:
    """The mesh of the enclosing ``manual_region``, else None."""
    return _VIEW.manual

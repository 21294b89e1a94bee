"""Parameter sharding rules, and the cuts and gathers of sharded leaves.

The counterpart of ``horovod_tpu/parallel/sharding.py``.  ``ShardingRules``
maps a parameter's path to a spec by ordered regular expressions: the
patterns are searched, not anchored, the first match wins, a spec longer
than the leaf's ndim is skipped, and a leaf that no rule matches takes
the default (replicated).  A spec (``P``) has one entry a dim: None (a
replicated dim), a mesh axis name, or a tuple of axis names (a dim split
over several axes, the first outermost).  Dims past the spec's end are
replicated.

The paths and shapes are flax's wherever the model has a flax twin
(``convert.leaf_views``): ``layer_0/attn/wq/kernel`` of shape ``[dm, H,
D]``, not the port's ``layers.0.attn.wq.weight`` of ``[H*D, dm]``, so
that one rule table places the same elements on the same rank in both
packages.  ``P(None, "tp", None)`` on ``wq`` takes whole heads: rows of
the port's weight.  A chunk over ``D`` is strided in the port's layout,
and it is cut and gathered in the flax view all the same.  A model with
no flax twin matches its torch names with ``/`` for ``.`` and indexes
its torch shapes.

- ``shard_params(params, mesh, rules)``: this rank's chunk of every leaf
  of a tree of flax-shaped arrays (``jax.device_put`` with a
  ``NamedSharding`` in the reference); ``gather_params`` is its inverse,
  all-gathering the chunks over the mesh's axis groups.  A dim that the
  product of its axes' sizes does not divide is refused with a
  ``ValueError``, as ``jax.device_put`` refuses such a sharding.
- ``named_sharding``/``replicated``: a ``Placement``, the mesh and a spec.
- ``constrain``: the identity, as the reference's annotation is
  numerically; it checks the spec's axes against the mesh.
- ``plan_sharding``: every parameter of a model as a ``LeafShard`` (its
  flax path, shape and spec, and the views between the port's layout
  and flax's for a chunk of any shape), what ``Trainer(param_rules=...)``
  and ``checkpoint.py`` cut and gather with.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Mapping, Sequence

import torch

from ..analysis.hvdshard.specs import missing_axes, rule_coverage, spec_token
from . import collectives
from .mesh import DEFAULT_AXES


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return tuple(e)


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: ``P(None,
    "tp")``, ``P(("dp", "fsdp"))``; ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def as_spec(spec) -> P:
    """``spec`` as a ``P``: None is replicated, a string one axis over dim
    0, a sequence its entries."""
    if spec is None:
        return P()
    if isinstance(spec, str):
        return P(spec)
    return P(*spec)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mesh_axes(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is not None:
        return tuple(names)
    return tuple(_mesh_sizes(mesh))


def _mesh_sizes(mesh) -> dict[str, int]:
    """Axis sizes of a port ``Mesh`` or of a mapping of sizes."""
    return dict(mesh.shape if hasattr(mesh, "shape") else mesh)


def mesh_coords(mesh, rank: int | None = None) -> dict[str, int]:
    """Coordinates of ``rank`` (default: this rank of a ``Mesh``) on every
    axis, ranks row-major over ``DEFAULT_AXES`` as ``build_mesh`` lays
    them out."""
    sizes = _mesh_sizes(mesh)
    if rank is None:
        return dict(mesh.coords)
    coords = {}
    for axis in reversed([a for a in DEFAULT_AXES if a in sizes]):
        rank, coords[axis] = divmod(rank, sizes[axis])
    return coords


def _path_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of a nested mapping (a flax tree, or a flat mapping
    keyed by path), or of a model's flax view."""
    if isinstance(tree, torch.nn.Module):
        from ..convert import leaf_views
        return [(v.path, torch.empty(v.flax_shape, device="meta"))
                for v in leaf_views(tree).values()]
    if isinstance(tree, Mapping):
        out = []
        for key, value in tree.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            out += _path_leaves(value, path)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, value in enumerate(tree):
            out += _path_leaves(value, f"{prefix}/{i}" if prefix else str(i))
        return out
    return [(prefix, tree)]


def _map_tree(tree, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, Mapping):
        return {key: _map_tree(value, fn,
                               f"{prefix}/{key}" if prefix else str(key))
                for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(value, fn,
                                    f"{prefix}/{i}" if prefix else str(i))
                          for i, value in enumerate(tree))
    return fn(prefix, tree)


class ShardingRules:
    """Ordered ``(regex, spec)`` rules.

    >>> rules = ShardingRules([
    ...     (r"attn/w[qkv]/kernel", P(None, "tp", None)),
    ...     (r"attn/wo/kernel",     P("tp", None, None)),
    ... ])
    """

    def __init__(self, rules: Sequence[tuple[str, Any]] = (),
                 default=P()) -> None:
        self._patterns = [pat for pat, _ in rules]
        self._rules = [(re.compile(pat), as_spec(spec)) for pat, spec in rules]
        self._default = as_spec(default)

    def spec_for(self, path: str, leaf=None) -> P:
        for pat, spec in self._rules:
            if pat.search(path):
                if leaf is not None and len(spec) > getattr(leaf, "ndim", 99):
                    continue   # the rule does not fit this rank; look on
                return spec
        return self._default

    def tree_specs(self, tree: Any) -> Any:
        """The spec of every leaf of a nested mapping, in its structure."""
        return _map_tree(tree, self.spec_for)

    def validate(self, mesh, params: Any) -> list[str]:
        """The problems of this table against a mesh (a port ``Mesh``) and
        a parameter tree (a flax tree, or a model, read in its flax view):
        axes the mesh does not carry (HVD802), rules that match no path
        and paths that fall through to the replicated default beside a
        sharded sibling (HVD801), in the reference's words.  Empty when
        the table is coherent; the Trainer logs each one."""
        problems: list[str] = []
        mesh_axes = _mesh_axes(mesh)
        for (_, spec), pat in zip(self._rules, self._patterns):
            bad = missing_axes(spec_token(spec), mesh_axes)
            if bad:
                problems.append(
                    f"rule {pat!r} names mesh ax"
                    f"{'es' if len(bad) > 1 else 'is'} "
                    f"{', '.join(repr(a) for a in bad)} absent from the "
                    f"mesh {mesh_axes} (HVD802)")
        paths = [path for path, _ in _path_leaves(params)]
        table = [(pat, spec_token(spec))
                 for (_, spec), pat in zip(self._rules, self._patterns)]
        dead, uncovered = rule_coverage(table, paths)
        for pat in dead:
            problems.append(
                f"rule {pat!r} matches no parameter path in this tree "
                f"(HVD801 dead rule)")
        for path, sib in uncovered:
            problems.append(
                f"path '{path}' falls through to the replicated default "
                f"while sibling rule {sib!r} shards its neighbours "
                f"(HVD801 uncovered path)")
        return problems


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor lies: the mesh and the spec over its axes (the
    reference's ``NamedSharding``)."""
    mesh: Any
    spec: P


def _check_axes(mesh, spec: P) -> None:
    bad = missing_axes(spec_token(spec), _mesh_axes(mesh))
    if bad:
        raise ValueError(f"spec {spec} names mesh axes {bad} absent from "
                         f"the mesh {_mesh_axes(mesh)}")


def named_sharding(mesh, spec=P()) -> Placement:
    spec = as_spec(spec)
    _check_axes(mesh, spec)
    return Placement(mesh, spec)


def replicated(mesh) -> Placement:
    return Placement(mesh, P())


def constrain(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The reference annotates an intermediate's layout inside ``jit``,
    which changes no value; here it checks the spec against the mesh and
    the tensor's rank and returns ``x``."""
    spec = as_spec(spec)
    _check_axes(mesh, spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{x.dim()}-dim tensor has dims")
    return x


def _split(spec: P, shape: Sequence[int], sizes: Mapping[str, int]
           ) -> list[tuple[int, tuple[str, ...], int]]:
    """``(dim, axes, parts)`` for every dim the spec splits over axes of
    more than one rank in all."""
    out = []
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        parts = math.prod(sizes.get(a, 1) for a in axes)
        if parts == 1:
            continue
        if shape[dim] % parts:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} is not "
                             f"divisible by the {parts} ranks of {axes}")
        out.append((dim, axes, parts))
    return out


def _chunk_index(axes, sizes, coords) -> int:
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def chunk_slices(spec, shape: Sequence[int], sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple[slice, ...]:
    """The index of the chunk at ``coords`` on a mesh of ``sizes`` in an
    array of ``shape`` (in the spec's view)."""
    index = [slice(None)] * len(shape)
    for dim, axes, parts in _split(as_spec(spec), shape, sizes):
        n = shape[dim] // parts
        i = _chunk_index(axes, sizes, coords)
        index[dim] = slice(i * n, (i + 1) * n)
    return tuple(index)


def cut(x, spec, sizes: Mapping[str, int], coords: Mapping[str, int]):
    """The chunk of ``x`` (a tensor or a numpy array, in the spec's view)
    at ``coords`` on a mesh of ``sizes``."""
    index = chunk_slices(spec, x.shape, sizes, coords)
    return x[index] if index else x


def gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """Inverse of ``cut`` at this rank: the whole tensor from every rank's
    chunk, all-gathered dim by dim over the spec's axis groups.  Every
    rank of those groups must call it alike."""
    spec = as_spec(spec)
    sizes = _mesh_sizes(mesh)
    splits = []
    for dim, entry in enumerate(spec):
        axes = [a for a in entry_axes(entry) if sizes.get(a, 1) > 1]
        if axes:
            splits.append((dim, axes))
    for dim, axes in splits:
        groups = [mesh.groups[a] for a in axes]
        moved = x.movedim(dim, 0).contiguous()
        x = collectives.allgather(moved, groups).movedim(0, dim)
    return x


def shard_params(params: Any, mesh, rules: ShardingRules | None = None,
                 rank: int | None = None) -> Any:
    """This rank's (or ``rank``'s) chunk of every leaf of a parameter tree
    of flax-shaped arrays, by the rules (default: replicated, every leaf
    whole)."""
    rules = rules or ShardingRules()
    sizes, coords = _mesh_sizes(mesh), mesh_coords(mesh, rank)
    return _map_tree(params, lambda path, leaf: cut(
        leaf, rules.spec_for(path, leaf), sizes, coords))


def gather_params(chunks: Any, mesh, rules: ShardingRules | None = None
                  ) -> Any:
    """Inverse of ``shard_params`` over the mesh's process groups: the
    whole leaves from every rank's chunks (tensors).  The rules see each
    chunk's path and rank, which are the whole leaf's."""
    rules = rules or ShardingRules()
    return _map_tree(chunks, lambda path, leaf: gather(
        leaf, rules.spec_for(path, leaf), mesh))


@dataclasses.dataclass
class LeafShard:
    """One parameter of a model under a rule table: its torch name, its
    flax path and shape, its spec over the flax dims (padded with None to
    the flax ndim), the dims split over axes of more than one rank, and
    the views between the port's layout and flax's for a chunk of any
    shape (``to_flax(t, flax_shape)``, ``to_torch(k)``)."""
    name: str
    path: str
    flax_shape: tuple[int, ...]
    spec: P
    splits: list[tuple[int, tuple[str, ...], int]]
    to_flax: Callable
    to_torch: Callable

    @property
    def sharded(self) -> bool:
        return bool(self.splits)

    @property
    def axes(self) -> tuple[str, ...]:
        """The axes (of more than one rank) this leaf is split over."""
        return tuple(a for _, axes, _ in self.splits for a in axes)

    @property
    def chunk_flax_shape(self) -> tuple[int, ...]:
        shape = list(self.flax_shape)
        for dim, _, parts in self.splits:
            shape[dim] //= parts
        return tuple(shape)

    def cut(self, full: torch.Tensor, sizes: Mapping[str, int],
            coords: Mapping[str, int]) -> torch.Tensor:
        """The chunk at ``coords`` of the torch-shaped ``full``, in the
        port's layout (a new contiguous tensor)."""
        chunk = cut(self.to_flax(full, self.flax_shape), self.spec, sizes,
                    coords)
        return self.to_torch(chunk).contiguous()

    def gather(self, chunk: torch.Tensor, mesh) -> torch.Tensor:
        """The whole torch-shaped leaf from this rank's chunk and its
        peers' (collective over the leaf's axis groups)."""
        full = gather(self.to_flax(chunk, self.chunk_flax_shape), self.spec,
                      mesh)
        return self.to_torch(full).contiguous()


def plan_sharding(model: torch.nn.Module, mesh,
                  rules: ShardingRules) -> dict[str, LeafShard]:
    """Every parameter of ``model`` as a ``LeafShard`` under ``rules``
    over ``mesh``'s axis sizes (a dim that its axes do not divide
    raises ``ValueError``)."""
    from ..convert import leaf_views
    sizes = _mesh_sizes(mesh)
    plan = {}
    for name, view in leaf_views(model).items():
        shape = tuple(view.flax_shape)
        spec = rules.spec_for(view.path, torch.empty(shape, device="meta"))
        spec = P(*spec, *([None] * (len(shape) - len(spec))))
        try:
            splits = _split(spec, shape, sizes)
        except ValueError as exc:
            raise ValueError(f"{view.path}: {exc}") from None
        plan[name] = LeafShard(name, view.path, shape, spec, splits,
                               view.to_flax, view.to_torch)
    return plan


@dataclasses.dataclass
class ShardedParams:
    """The sharded parameters of a model held by a ``Trainer``: the mesh,
    each sharded leaf's ``LeafShard`` by torch name, and its whole torch
    shape.  The parameter tensors (and their optimizer state) hold this
    rank's chunks."""
    mesh: Any
    leaves: dict[str, LeafShard]
    shapes: dict[str, torch.Size]

    def gather(self, name: str, chunk: torch.Tensor) -> torch.Tensor:
        """The whole leaf (collective over its axis groups)."""
        with torch.no_grad():
            return self.leaves[name].gather(chunk, self.mesh)

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a whole leaf (or of a tensor of its
        shape: a gradient, an optimizer moment)."""
        return self.leaves[name].cut(full, self.mesh.shape, self.mesh.coords)

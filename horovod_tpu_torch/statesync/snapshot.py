"""State images: one flat byte image of the training state, stamped for
integrity, and the ring-shard (ZeRO) re-layout.

The counterpart of ``horovod_tpu/statesync/snapshot.py``.  The reference
flattens a pytree in ``jax.tree_util`` leaf order; the port's tree is an
ordered mapping of name to tensor (or numpy array, or number), taken in
its own order: the flax leaf order where the caller builds it from a
model (``training._leaf_order``).  Each leaf is laid out in its own
dtype, and, where ``layouts`` (``convert.flax_layouts``) name it, in
flax's shape and element order, so the same weights give the same bytes
and the same digest in both packages.

A leaf's bytes are read through ``tensor.view(torch.uint8)``: numpy has
no bfloat16, and a float cast would change the bytes.  The image is the
one host copy: a leaf on the card is copied straight into its slice of
the image, and restoring copies each slice straight into its target.

The digest is an FNV-1a 64-bit fold over the 4-byte big-endian CRC32s of
64 KiB blocks.  Every read of an image that came from elsewhere (a file,
a peer) must check the digest before it interprets a byte.

Ring-shard math: :func:`reshard_ring_state` re-cuts a full set of
per-rank optimizer-state shards of the optimizer-in-ring layout
(``parallel.grad_sync.init_ring_optimizer``) for another world size;
the ring checkpoints (``checkpoint.py``) use it.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_MASK = (1 << 64) - 1
_DIGEST_BLOCK = 64 * 1024

# name -> (to_flax, from_flax), as convert.flax_layouts gives them.
Layouts = Mapping[str, tuple[Callable, Callable]]


def fnv1a_fold(data: bytes, h: int = _FNV_OFFSET) -> int:
    """Plain FNV-1a 64 over ``data`` (stamp-sized inputs only)."""
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def state_digest(view) -> int:
    """FNV-1a 64-bit fold over per-64KiB-block CRC32s of ``view``."""
    mv = memoryview(view)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    h = _FNV_OFFSET
    for off in range(0, mv.nbytes, _DIGEST_BLOCK):
        crc = zlib.crc32(mv[off:off + _DIGEST_BLOCK])
        h = fnv1a_fold(crc.to_bytes(4, "big"), h)
    return h


@dataclasses.dataclass(frozen=True)
class SnapshotStamp:
    """The integrity stamp of an image, checked before any byte of it is
    interpreted."""
    epoch: str
    step: int
    digest: int
    nbytes: int

    def as_meta(self) -> dict:
        return {"epoch": self.epoch, "step": self.step,
                "digest": self.digest, "nbytes": self.nbytes}

    @classmethod
    def from_meta(cls, meta: dict) -> "SnapshotStamp":
        return cls(epoch=str(meta["epoch"]), step=int(meta["step"]),
                   digest=int(meta["digest"]), nbytes=int(meta["nbytes"]))


def _tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def _items(tree: Any) -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, Mapping):
        return [(str(k), _tensor(v)) for k, v in tree.items()]
    return [(str(i), _tensor(v)) for i, v in enumerate(tree)]


def _flax_view(t: torch.Tensor, name: str, layouts: Layouts | None
               ) -> torch.Tensor:
    """``t`` in flax's shape and element order, contiguous, on its own
    device."""
    if layouts is not None and name in layouts:
        t = layouts[name][0](t)
    return t.contiguous()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def state_nbytes(tree: Any) -> int:
    return sum(_nbytes(t) for _, t in _items(tree))


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def flatten_state(tree: Any, layouts: Layouts | None = None) -> bytearray:
    """One contiguous byte image of the tree's leaves, in its order, each
    in its own dtype and (where ``layouts`` name it) flax's element
    order.  The image is a copy: the caller's tensors are never
    aliased."""
    items = _items(tree)
    out = bytearray(sum(_nbytes(t) for _, t in items))
    if not out:
        return out
    image = torch.frombuffer(out, dtype=torch.uint8)
    offset = 0
    for name, t in items:
        n = _nbytes(t)
        if n:
            image[offset:offset + n].copy_(
                _as_bytes(_flax_view(t, name, layouts)))
        offset += n
    return out


def iter_leaves(buf, template: Any, layouts: Layouts | None = None
                ) -> Iterator[tuple[str, torch.Tensor, torch.Tensor]]:
    """For each leaf of ``template``: its name, the template tensor, and
    a CPU tensor in the template's shape and dtype whose elements are the
    leaf's slice of ``buf`` (a view of ``buf`` where the layout allows)."""
    items = _items(template)
    view = memoryview(buf)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    total = sum(_nbytes(t) for _, t in items)
    if view.nbytes != total:
        raise ValueError(
            f"state image is {view.nbytes} bytes but the template "
            f"flattens to {total}; the streamed state does not match "
            f"this rank's model")
    if view.readonly:
        # torch.frombuffer wants a writable buffer; a read-only image
        # (bytes) is copied once.
        view = memoryview(bytearray(view))
    image = torch.frombuffer(view, dtype=torch.uint8) if total else None
    offset = 0
    for name, ref in items:
        n = _nbytes(ref)
        meta = torch.empty(ref.shape, dtype=ref.dtype, device="meta")
        flax_shape = _flax_view(meta, name, layouts).shape
        if n:
            part = image[offset:offset + n]
            if offset % ref.element_size():
                part = part.clone()     # a misaligned leaf: copy it
            part = part.view(ref.dtype)
        else:
            part = torch.empty(0, dtype=ref.dtype)
        part = part.reshape(flax_shape)
        if layouts is not None and name in layouts:
            part = layouts[name][1](part)
        yield name, ref, part
        offset += n


def unflatten_state(buf, template: Any, layouts: Layouts | None = None
                    ) -> dict[str, torch.Tensor]:
    """The leaves of ``template`` rebuilt from a flat image (the inverse
    of :func:`flatten_state`), as new CPU tensors in the template's shapes
    and dtypes.  Every caller must have digest-checked ``buf`` first."""
    return {name: part.contiguous().clone()
            for name, _, part in iter_leaves(buf, template, layouts)}


def load_state_into(buf, targets: Mapping[str, torch.Tensor],
                    layouts: Layouts | None = None) -> None:
    """Copy each leaf of a flat image into its tensor of ``targets`` in
    place, on the target's device: the restore path, which holds no
    second host copy of the image.  ``buf`` must be digest-checked."""
    with torch.no_grad():
        for _, target, part in iter_leaves(buf, targets, layouts):
            target.copy_(part)


class Snapshot:
    """A frozen, stamped state image taken at one step boundary."""

    def __init__(self, tree: Any, epoch: str, step: int,
                 layouts: Layouts | None = None) -> None:
        self.data = flatten_state(tree, layouts)
        self.stamp = SnapshotStamp(epoch=epoch, step=int(step),
                                   digest=state_digest(self.data),
                                   nbytes=len(self.data))

    def __len__(self) -> int:
        return len(self.data)


# ---------------------------------------------------------------------------
# Ring-shard (ZeRO) re-layout
# ---------------------------------------------------------------------------
def ring_chunk(n_params: int, world: int, config=None) -> int:
    """Per-rank flat shard length for a world size: delegates to
    ``grad_sync.ring_chunk_size``, so checkpoints and the live
    optimizer-in-ring path never disagree on the layout."""
    from ..parallel.grad_sync import GradSyncConfig, ring_chunk_size

    return ring_chunk_size(n_params, world,
                           config if config is not None
                           else GradSyncConfig())


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def concat_ring_shards(shards: Sequence, n_params: int) -> np.ndarray:
    """The per-rank 1-D shards concatenated back into the unpadded flat
    buffer (the world x chunk padding tail dropped)."""
    full = np.concatenate([_numpy(s).reshape(-1) for s in shards])
    if full.size < n_params:
        raise ValueError(
            f"shards cover {full.size} elements < n_params={n_params}")
    return full[:n_params]


def shard_for_rank(full, n_params: int, world: int, rank: int,
                   config=None) -> np.ndarray:
    """Rank ``rank``'s shard of the flat buffer under the ``world``-way
    ring layout (zero-padded tail on the last shard, as the padded
    reduce-scatter of ``sync_and_apply``)."""
    full = _numpy(full).reshape(-1)
    chunk = ring_chunk(n_params, world, config)
    out = np.zeros(chunk, dtype=full.dtype)
    start = min(rank * chunk, n_params)
    stop = min(start + chunk, n_params)
    out[:stop - start] = full[start:stop]
    return out


def reshard_ring_state(shards: Sequence[Mapping[str, Any]], n_params: int,
                       new_world: int, new_rank: int, config=None
                       ) -> dict[str, np.ndarray]:
    """Re-cut a full set of per-rank optimizer-state shards (old world =
    ``len(shards)``, each an ordered mapping of leaf name to array) into
    ``new_rank``'s shard of a ``new_world``-way layout.

    Leaves whose first dimension is the old chunk length are ring-sharded
    state (Adam's moments, momentum): their pieces concatenate to the
    full flat buffer, which is re-padded and re-sliced.  Every other leaf
    (step counters) is replicated: taken from shard 0 and required equal
    on every shard."""
    old_world = len(shards)
    if old_world == 0:
        raise ValueError("need at least one shard to reshard")
    chunk_old = ring_chunk(n_params, old_world, config)
    names = list(shards[0])
    for s in shards[1:]:
        if list(s) != names:
            raise ValueError("shard pytrees disagree on structure")
    out = {}
    for i, name in enumerate(names):
        ref = _numpy(shards[0][name])
        if ref.ndim >= 1 and ref.shape[0] == chunk_old:
            full = concat_ring_shards([s[name] for s in shards], n_params)
            out[name] = shard_for_rank(full, n_params, new_world, new_rank,
                                       config)
        else:
            for s in shards[1:]:
                if not np.array_equal(_numpy(s[name]), ref):
                    raise ValueError(
                        "replicated optimizer-state leaf differs across "
                        "shards (index %d); the shard files are from "
                        "different steps" % i)
            out[name] = ref.copy()
    return out

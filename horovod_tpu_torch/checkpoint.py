"""Checkpoint save and restore.

The counterpart of ``horovod_tpu/checkpoint.py``.  The reference writes
orbax checkpoints; the port has no orbax, so it writes a format of its
own, one directory a checkpoint:

- ``state.bin``: the ``statesync.flatten_state`` image of the state, each
  leaf in its own dtype and memory order (row-major over the torch
  shape);
- ``manifest.json``: the format, the step, the image's byte count and
  ``state_digest``, every leaf's name, shape, dtype, offset and bytes, and
  the optimizer's class and hyperparameters.

A ``TrainState``'s leaves are ``params/<name>`` in the flax leaf order
(``training._leaf_order``), ``batch_stats/<name>`` (the model's buffers)
and ``opt/<param name>/<key>``, the optimizer's per-parameter state
(AdamW's ``step``, ``exp_avg``, ``exp_avg_sq``; SGD's
``momentum_buffer``).  A state whose optimizer steps parameters other
than the model's (the optimizer-in-ring shard optimizer) keeps its
optimizer state out: each rank writes its shard with
:func:`save_ring_checkpoint`.  Any other mapping of names to tensors,
arrays or numbers is saved as its leaves.

A ``TrainState`` whose Trainer has ``param_rules`` holds chunks of its
sharded parameters and of their optimizer state; its tree gathers them
(a collective: every rank saves, and rank 0 writes), so that its image
and digest are the unsharded state's and either package's tree reads
it.  Restoring into such a state cuts this rank's chunks out of the
whole leaves, for whatever mesh and rules the restoring Trainer has:
the reference's reshard of a trained state onto another mesh.
``train_state_tree(state, gather=True)`` gives the same gathered tree,
the image statesync streams, and ``load_train_state`` cuts a whole tree
into such a state by its own plan, as a restore does.

Restoring reads the manifest, checks the image's byte count and digest
before any byte of it is interpreted (the reference's HVD1007 rule),
and either returns the leaves as CPU tensors or, given a ``target``,
loads them into it in place, on its device.

Ring-sharded optimizer state: :func:`save_ring_checkpoint` writes one
stamped shard a rank (``ring-<r>-of-<w>.state`` and ``.json``, the
reference's names and stamp fields), and :func:`restore_ring_checkpoint`
reads every shard, checks each digest, the steps and the set, and re-cuts
the state for the current world (``statesync.reshard_ring_state``): a
4-rank checkpoint restores on 2 ranks, and the reverse.  A shard's image
holds the optimizer's state in the leaf order of the reference's optax
state, so the files of both packages are one format: Adam and AdamW
``count`` (int32; torch's ``step``, a float tensor), ``mu``
(``exp_avg``) and ``nu`` (``exp_avg_sq``); SGD with momentum ``trace``
(``momentum_buffer``); SGD without momentum no leaf.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import re
import shutil
from typing import Any, Mapping

import numpy as np
import torch

from .statesync.snapshot import (flatten_state, iter_leaves,
                                 load_state_into, reshard_ring_state,
                                 state_digest, unflatten_state)

FORMAT = "horovod_tpu_torch.checkpoint/1"
MANIFEST = "manifest.json"
IMAGE = "state.bin"


def _not_rank0() -> bool:
    """True on every rank but 0 of an eager (``hvd.init``) world or of a
    ``torch.distributed`` world: only rank 0 writes."""
    from . import core
    if core.is_initialized() and core.rank() != 0:
        return True
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_rank() != 0


def _is_train_state(state: Any) -> bool:
    return hasattr(state, "model") and hasattr(state, "optimizer") \
        and hasattr(state, "step")


def _leaf(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def _hyper(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.item()
    if isinstance(value, tuple):
        return list(value)
    return value


def _initial_state(opt, group: dict, p: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
    """The per-parameter state ``opt``'s first step creates for ``p``, as
    the values that step starts from (``tx.init``'s zeros): what a
    parameter the optimizer has not stepped yet holds in a state tree."""
    name = type(opt).__name__
    if name in ("Adam", "AdamW"):
        on_device = group.get("capturable") or group.get("fused")
        out = {"step": torch.zeros((), dtype=torch.float32,
                                   device=p.device if on_device else "cpu"),
               "exp_avg": torch.zeros_like(p),
               "exp_avg_sq": torch.zeros_like(p)}
        if group.get("amsgrad"):
            out["max_exp_avg_sq"] = torch.zeros_like(p)
        return out
    if name == "SGD" and not group.get("momentum"):
        return {}
    if name == "SGD" and not group.get("dampening"):
        # Its first step sets the buffer to the gradient, which is what
        # momentum times a zero buffer plus the gradient gives.
        return {"momentum_buffer": torch.zeros_like(p)}
    raise ValueError(f"no initial state of {name} for a state tree "
                     f"(Adam, AdamW and SGD without dampening have one)")


def _whole(state, name: str, p: torch.Tensor,
           value: torch.Tensor) -> torch.Tensor:
    """``value`` (parameter ``name`` ``p`` or a tensor of its shape) whole:
    gathered from every rank's chunk when the state shards ``name``."""
    sharding = getattr(state, "sharding", None)
    if sharding is None or name not in sharding.leaves \
            or tuple(value.shape) != tuple(p.shape):
        return value
    return sharding.gather(name, value)


def _optimizer_leaves(state, initial: bool = False, whole=_whole
                      ) -> tuple[dict[str, torch.Tensor], dict]:
    """The optimizer's per-parameter state as ``opt/<name>/<key>`` leaves
    and its class and param groups (hyperparameters, parameter names).
    With ``initial``, a parameter the optimizer has not stepped yet
    contributes the state its first step starts from, so a fresh state's
    tree has the leaves of a stepped one.  ``whole(state, name, p,
    value)`` makes each leaf whole (default: gathered)."""
    from .training import _leaf_order
    opt = state.optimizer
    by_id = {id(p): n for n, p in state.model.named_parameters()}
    meta = {"class": type(opt).__name__}
    group_params = [p for g in opt.param_groups for p in g["params"]]
    if not all(id(p) in by_id for p in group_params):
        # The optimizer-in-ring shard optimizer: its state is the ring
        # checkpoint's.
        meta["ring"] = True
        return {}, meta
    meta["param_groups"] = [
        {**{k: _hyper(v) for k, v in g.items() if k != "params"},
         "params": [by_id[id(p)] for p in g["params"]]}
        for g in opt.param_groups]
    params = dict(state.model.named_parameters())
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    leaves = {}
    for name in _leaf_order(state.model):
        p = params[name]
        entry = opt.state.get(p, {})
        if initial and not entry and id(p) in group_of:
            entry = _initial_state(opt, group_of[id(p)], p)
        for key, value in sorted(entry.items()):
            leaves[f"opt/{name}/{key}"] = whole(state, name, p, _leaf(value))
    return leaves, meta


def _model_leaves(state) -> dict[str, torch.Tensor]:
    """The live parameter (``params/<name>``, flax leaf order) and buffer
    (``batch_stats/<name>``) tensors of a ``TrainState``, detached."""
    from .training import _leaf_order
    params = dict(state.model.named_parameters())
    tree = {f"params/{n}": params[n].detach()
            for n in _leaf_order(state.model)}
    tree.update({f"batch_stats/{n}": b.detach()
                 for n, b in state.model.named_buffers()})
    return tree


def _whole_shape(state, name: str, t: torch.Tensor) -> tuple[int, ...]:
    """The shape of model leaf ``name`` whole (a sharded parameter's
    chunk has a smaller one)."""
    sharding = getattr(state, "sharding", None)
    pname = name[len("params/"):]
    if sharding is not None and name.startswith("params/") \
            and pname in sharding.leaves:
        return tuple(sharding.shapes[pname])
    return tuple(t.shape)


def _tree(state: Any, initial: bool = False
          ) -> tuple[dict[str, torch.Tensor], dict]:
    if not _is_train_state(state):
        return {str(k): _leaf(v) for k, v in state.items()}, {}
    tree = _model_leaves(state)
    for name, t in tree.items():
        if name.startswith("params/"):
            tree[name] = _whole(state, name[len("params/"):], t, t)
    opt_leaves, opt_meta = _optimizer_leaves(state, initial)
    tree.update(opt_leaves)
    return tree, {"step": int(state.step), "optimizer": opt_meta}


_SHARDED_STATESYNC = (
    "train_state_tree of a state with sharded parameters needs "
    "gather=True, called alike on every rank of its mesh: the tree is "
    "the unsharded state's, gathered from every rank's chunks")


def _sharded(state) -> bool:
    sharding = getattr(state, "sharding", None)
    return sharding is not None and bool(sharding.leaves)


def train_state_tree(state, *, gather: bool = False
                     ) -> dict[str, torch.Tensor]:
    """A ``TrainState`` as one state tree, the checkpoint's leaves: the
    parameters (``params/<name>``, flax leaf order), the buffers
    (``batch_stats/<name>``), the optimizer's per-parameter state
    (``opt/<name>/<key>``; a parameter not stepped yet gives the state
    its first step starts from) and ``step`` (int64).  The tensors are
    the live ones, detached, on their devices: ``statesync.Snapshot``
    copies them into its image at a step boundary.

    A state with sharded parameters needs ``gather=True``: its sharded
    parameters and their optimizer state then come whole, gathered from
    every rank's chunks, and every rank of the mesh must call it alike
    (the tree, its image and digest are the unsharded state's).
    Without it such a state raises ``NotImplementedError``."""
    if not _is_train_state(state):
        raise TypeError("train_state_tree takes a TrainState")
    if _sharded(state) and not gather:
        raise NotImplementedError(_SHARDED_STATESYNC)
    tree, _ = _tree(state, initial=True)
    tree["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    return tree


def whole_tree_template(state) -> dict[str, torch.Tensor]:
    """The leaves of ``train_state_tree(state, gather=True)``, each a
    ``meta`` tensor of its whole shape and dtype, with no collective: the
    template ``statesync.join_world`` pulls into and
    :func:`load_train_state` checks a tree against.  A fresh unsharded
    state of the same model and optimizer has the same template as a
    sharded one (a joiner, which holds no mesh until it is admitted,
    builds its template so)."""
    if not _is_train_state(state):
        raise TypeError("whole_tree_template takes a TrainState")
    sharding = getattr(state, "sharding", None)

    def whole_meta(_, name, p, value):
        shape = tuple(value.shape)
        if sharding is not None and name in sharding.leaves \
                and shape == tuple(p.shape):
            shape = tuple(sharding.shapes[name])
        return torch.empty(shape, dtype=value.dtype, device="meta")
    tree = {name: torch.empty(_whole_shape(state, name, t), dtype=t.dtype,
                              device="meta")
            for name, t in _model_leaves(state).items()}
    tree.update(_optimizer_leaves(state, initial=True, whole=whole_meta)[0])
    tree["step"] = torch.empty((), dtype=torch.int64, device="meta")
    return tree


def load_train_state(tree: Mapping[str, Any], state) -> Any:
    """Put a whole tree of :func:`train_state_tree`'s leaves (as
    ``statesync.join_world`` returns it, CPU tensors) into ``state`` in
    place: each parameter and buffer copied onto its device, the
    optimizer's state through ``load_state_dict`` (onto its parameter's
    device), and the step.  Where the state shards a parameter (its
    Trainer's ``param_rules``), the parameter and each optimizer leaf of
    its shape take this rank's chunk of the whole leaf, cut by the
    state's own plan, as a restore does.  ``state`` must hold the same
    model and optimizer class; a tree of other leaves, shapes or dtypes
    raises ``ValueError``.  It runs no collective and returns ``state``."""
    own = whole_tree_template(state)
    if list(tree) != list(own):
        raise ValueError("the tree's leaves are not this state's")
    for name, t in own.items():
        got = tree[name]
        if tuple(got.shape) != tuple(t.shape) or got.dtype != t.dtype:
            raise ValueError(f"{name}: the tree holds {got.dtype} "
                             f"{list(got.shape)}, the state {t.dtype} "
                             f"{list(t.shape)}")
    opt = state.optimizer
    params = dict(state.model.named_parameters())
    live = _model_leaves(state)
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(_cut(state, name[name.index("/") + 1:], tree[name]))
    saved = opt.state_dict()
    index = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    states: dict[int, dict] = {}
    for name, value in tree.items():
        if not name.startswith("opt/"):
            continue
        pname, key = name[len("opt/"):].rsplit("/", 1)
        states.setdefault(index[id(params[pname])], {})[key] = \
            _cut(state, pname, value)
    opt.load_state_dict({"state": states,
                         "param_groups": saved["param_groups"]})
    state.step = int(tree["step"])
    return state


def _cut(state, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``whole``, parameter ``name`` or a tensor of its
    shape: its chunk where the state shards ``name``, else ``whole``."""
    sharding = getattr(state, "sharding", None)
    if sharding is None or name not in sharding.leaves \
            or tuple(whole.shape) != tuple(sharding.shapes[name]):
        return whole
    return sharding.cut(name, whole)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Write ``state`` (a ``TrainState``, or a mapping of names to
    tensors, arrays or numbers) as a checkpoint directory at ``path``.

    In a world of more than one rank (``hvd.init`` or
    ``torch.distributed``) only rank 0 writes, as the reference gates its
    eager worlds; a state with sharded parameters is gathered first, so
    every rank calls this.  An existing checkpoint is replaced unless
    ``force`` is False, when it raises."""
    sharded = _is_train_state(state) \
        and getattr(state, "sharding", None) is not None
    if _not_rank0() and not sharded:
        return
    tree, meta = _tree(state)
    if _not_rank0():
        return
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists")
    image = flatten_state(tree)
    leaves, offset = [], 0
    for name, t in tree.items():
        n = t.numel() * t.element_size()
        leaves.append({"name": name, "shape": list(t.shape),
                       "dtype": _dtype_name(t.dtype), "offset": offset,
                       "nbytes": n})
        offset += n
    manifest = {"format": FORMAT, **meta, "nbytes": len(image),
                "digest": state_digest(image), "leaves": leaves}
    tmp = f"{path}.tmp.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, IMAGE), "wb") as f:
        f.write(image)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _read_checked(path: str) -> tuple[dict, bytearray]:
    """The manifest and the image, its byte count and digest checked."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint "
                         f"(format {manifest.get('format')!r})")
    image_path = os.path.join(path, IMAGE)
    nbytes = os.path.getsize(image_path)
    if nbytes != int(manifest["nbytes"]):
        raise ValueError(f"checkpoint image {image_path} is {nbytes} bytes, "
                         f"the manifest says {manifest['nbytes']}")
    image = bytearray(nbytes)
    with open(image_path, "rb") as f:
        if f.readinto(image) != nbytes:
            raise ValueError(f"short read of {image_path}")
    if state_digest(image) != int(manifest["digest"]):
        raise ValueError(f"checkpoint {path} failed its digest check — "
                         f"refusing to restore corrupt state")
    return manifest, image


def _template(manifest: dict) -> dict[str, torch.Tensor]:
    return {leaf["name"]: torch.empty(leaf["shape"],
                                      dtype=getattr(torch, leaf["dtype"]),
                                      device="meta")
            for leaf in manifest["leaves"]}


def _load_optimizer(state, manifest: dict, leaves: dict) -> None:
    meta = manifest["optimizer"]
    opt = state.optimizer
    if meta.get("ring"):
        return
    if meta["class"] != type(opt).__name__:
        raise ValueError(f"the checkpoint's optimizer is {meta['class']}, "
                         f"the target's {type(opt).__name__}")
    params = dict(state.model.named_parameters())
    by_id = {id(p): n for n, p in params.items()}
    groups, index = [], 0
    if len(meta["param_groups"]) != len(opt.param_groups):
        raise ValueError("the checkpoint's optimizer has another number of "
                         "param groups than the target's")
    states = {}
    for saved, group in zip(meta["param_groups"], opt.param_groups):
        names = [by_id[id(p)] for p in group["params"]]
        if names != saved["params"]:
            raise ValueError("the checkpoint's param groups hold other "
                             "parameters than the target's")
        hyper = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in saved.items() if k != "params"}
        groups.append({**hyper,
                       "params": list(range(index, index + len(names)))})
        for name in names:
            prefix = f"opt/{name}/"
            # One copy of each leaf, onto its parameter's device (a step
            # counter stays where it is), this rank's chunk of a sharded
            # one; load_state_dict keeps it.
            p = params[name]
            entry = {k[len(prefix):]: v.clone() if k.endswith("/step")
                     else _cut(state, name, v).to(p.device, copy=True)
                     for k, v in leaves.items() if k.startswith(prefix)}
            if entry:
                states[index] = entry
            index += 1
    opt.load_state_dict({"state": states, "param_groups": groups})


def restore_checkpoint(path: str, target: Any | None = None) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint`.

    Without ``target``: the mapping of leaf names to CPU tensors (a
    ``TrainState``'s as ``params/...``, ``batch_stats/...``,
    ``opt/...``, and ``"step"``).  With a ``TrainState`` as ``target``:
    the parameters, buffers, optimizer state and step are loaded into it
    in place, on its device, and it is returned.  With a mapping of
    tensors as ``target``: each is loaded in place."""
    path = os.path.abspath(path)
    manifest, image = _read_checked(path)
    template = _template(manifest)
    if target is None:
        out = unflatten_state(image, template)
        if "step" in manifest:
            out["step"] = manifest["step"]
        return out
    if not _is_train_state(target):
        if list(target) != list(template):
            raise ValueError("the target's leaves are not the checkpoint's")
        load_state_into(image, target)
        return target
    model_leaves = _model_leaves(target)
    saved = [k for k in template if not k.startswith("opt/")]
    if list(model_leaves) != saved:
        raise ValueError("the checkpoint's parameters and buffers are not "
                         "the target model's")
    for name, t in model_leaves.items():
        shape = _whole_shape(target, name, t)
        if shape != tuple(template[name].shape) \
                or t.dtype != template[name].dtype:
            raise ValueError(f"{name}: the checkpoint holds "
                             f"{template[name].dtype} "
                             f"{list(template[name].shape)}, the target "
                             f"{t.dtype} {list(shape)}")
    # One pass over the image: each model leaf (or this rank's chunk of
    # it) straight into its tensor, each optimizer leaf as a view for
    # load_state_dict to copy.
    views = {}
    with torch.no_grad():
        for name, _, part in iter_leaves(image, template):
            if name in model_leaves:
                t = model_leaves[name]
                t.copy_(_cut(target, name[name.index("/") + 1:], part))
            else:
                views[name] = part
    _load_optimizer(target, manifest, views)
    target.step = int(manifest["step"])
    return target


# ---------------------------------------------------------------------------
# Ring-sharded (ZeRO) optimizer-state round trip
# ---------------------------------------------------------------------------
_RING_RE = re.compile(r"ring-(\d+)-of-(\d+)\.state$")

# torch state key of each leaf of the reference's optax state, in its
# leaf order, by optimizer class.
_OPTAX_LEAVES = {"Adam": (("count", "step"), ("mu", "exp_avg"),
                          ("nu", "exp_avg_sq")),
                 "AdamW": (("count", "step"), ("mu", "exp_avg"),
                           ("nu", "exp_avg_sq")),
                 "SGD": (("trace", "momentum_buffer"),)}


def _ring_leaves(optimizer) -> tuple[tuple[str, str], ...]:
    name = type(optimizer).__name__
    group = optimizer.param_groups[0]
    if name not in _OPTAX_LEAVES or group.get("amsgrad"):
        raise ValueError(f"no optax counterpart of the ring state of "
                         f"{name} (Adam, AdamW and SGD have one)")
    if name == "SGD" and not group.get("momentum"):
        return ()
    return _OPTAX_LEAVES[name]


def _ring_shard(optimizer) -> torch.nn.Parameter:
    (shard,) = optimizer.param_groups[0]["params"]
    return shard


def ring_state_tree(optimizer) -> dict[str, torch.Tensor]:
    """The ring shard optimizer's state in the optax leaf order (zeros
    for a state not created yet, as ``tx.init`` gives it)."""
    shard = _ring_shard(optimizer)
    state = optimizer.state.get(shard, {})
    tree = {}
    for leaf, key in _ring_leaves(optimizer):
        if key == "step":
            tree[leaf] = torch.tensor(int(state["step"]) if "step" in state
                                      else 0, dtype=torch.int32)
        elif key in state:
            tree[leaf] = state[key].detach()
        else:
            tree[leaf] = torch.zeros_like(shard, dtype=torch.float32)
    return tree


def _ring_template(optimizer, chunk: int) -> dict[str, torch.Tensor]:
    return {leaf: torch.empty((), dtype=torch.int32) if key == "step"
            else torch.empty(chunk, dtype=torch.float32)
            for leaf, key in _ring_leaves(optimizer)}


def _load_ring_state(optimizer, tree: Mapping[str, Any]) -> None:
    """Load a shard in the optax leaf order into the ring shard
    optimizer, in place on its device."""
    shard = _ring_shard(optimizer)
    group = optimizer.param_groups[0]
    state = optimizer.state[shard]
    for leaf, key in _ring_leaves(optimizer):
        value = torch.as_tensor(np.asarray(tree[leaf]))
        if key == "step":
            on_card = group.get("capturable") or group.get("fused")
            old = state.get("step")
            state["step"] = torch.tensor(
                float(value), dtype=torch.float32 if old is None
                else old.dtype,
                device=shard.device if on_card else "cpu")
        else:
            if value.shape != shard.shape:
                raise ValueError(f"ring leaf {leaf} holds {value.numel()} "
                                 f"elements, the shard {shard.numel()}")
            state[key] = value.to(device=shard.device, dtype=torch.float32,
                                  copy=True)


def _ring_paths(directory: str, rank: int, world: int) -> tuple[str, str]:
    base = os.path.join(os.path.abspath(directory),
                        f"ring-{rank}-of-{world}")
    return base + ".state", base + ".json"


def save_ring_checkpoint(directory: str, optimizer, *, rank: int,
                         world: int, n_params: int, step: int = 0,
                         config=None) -> str:
    """Write this rank's ring shard of the optimizer state (the shard
    optimizer of ``init_ring_optimizer``, or a mapping already in the
    optax leaf order) as a stamped flat image.  Every rank calls it with
    its own shard; no collective runs here."""
    del config
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    tree = optimizer if isinstance(optimizer, Mapping) \
        else ring_state_tree(optimizer)
    image = flatten_state(tree)
    state_path, meta_path = _ring_paths(directory, rank, world)
    with open(state_path, "wb") as f:
        f.write(image)
    with open(meta_path, "w") as f:
        json.dump({"rank": rank, "world": world, "n_params": int(n_params),
                   "step": int(step), "nbytes": len(image),
                   "digest": state_digest(image)}, f)
    return state_path


def restore_ring_checkpoint(directory: str, optimizer, *, rank: int,
                            world: int, n_params: int | None = None,
                            config=None) -> tuple[dict[str, np.ndarray], int]:
    """This rank's shard of the optimizer state for the current world,
    from a ring checkpoint written at any world size.

    Reads every saved shard, checks each digest against its stamp and
    every stamp's step against the others' (shards of different steps are
    a torn checkpoint), concatenates them to the full flat state and
    re-cuts ``rank``'s shard for ``world`` ranks.  Returns ``(shard,
    step)``, the shard as a mapping in the optax leaf order; the ring
    shard optimizer ``optimizer`` (of this world's chunk) is loaded with
    it in place."""
    from .parallel.grad_sync import GradSyncConfig, ring_chunk_size

    directory = os.path.abspath(directory)
    files = sorted(_glob.glob(os.path.join(directory, "ring-*-of-*.state")))
    if not files:
        raise FileNotFoundError(
            f"no ring checkpoint shards under {directory}")
    cfg = config if config is not None else GradSyncConfig()
    by_rank: dict[int, str] = {}
    world_old = None
    for path in files:
        m = _RING_RE.search(path)
        if not m:
            continue
        r, w = int(m.group(1)), int(m.group(2))
        if world_old is None:
            world_old = w
        if w != world_old:
            raise ValueError(
                f"mixed world sizes in {directory}: found shards of "
                f"{w} and {world_old}")
        by_rank[r] = path
    if world_old is None or sorted(by_rank) != list(range(world_old)):
        raise ValueError(
            f"incomplete ring checkpoint: have shards {sorted(by_rank)} "
            f"of a {world_old}-rank world")
    shards = []
    step = None
    meta0 = None
    for r in range(world_old):
        with open(by_rank[r][:-len(".state")] + ".json") as f:
            meta = json.load(f)
        image = bytearray(os.path.getsize(by_rank[r]))
        with open(by_rank[r], "rb") as f:
            f.readinto(image)
        if state_digest(image) != int(meta["digest"]) or \
                len(image) != int(meta["nbytes"]):
            raise ValueError(
                f"ring shard {by_rank[r]} failed its digest check — "
                f"refusing to restore corrupt optimizer state")
        if step is None:
            step, meta0 = int(meta["step"]), meta
        elif int(meta["step"]) != step:
            raise ValueError(
                f"torn ring checkpoint: shard {r} is from step "
                f"{meta['step']}, shard 0 from step {step}")
        n = int(meta["n_params"]) if n_params is None else int(n_params)
        chunk_old = ring_chunk_size(n, world_old, cfg)
        # Views of the image: the re-cut below copies what it keeps.
        shards.append({name: part.numpy() for name, _, part in iter_leaves(
            image, _ring_template(optimizer, chunk_old))})
    n = int(meta0["n_params"]) if n_params is None else int(n_params)
    shard = reshard_ring_state(shards, n, world, rank, cfg)
    _load_ring_state(optimizer, shard)
    return shard, step


def latest_checkpoint(directory: str) -> str | None:
    """Newest checkpoint subdirectory by mtime (step-named dirs)."""
    if not os.path.isdir(directory):
        return None
    entries = [os.path.join(directory, e) for e in os.listdir(directory)]
    dirs = [e for e in entries if os.path.isdir(e)]
    return max(dirs, key=os.path.getmtime) if dirs else None

"""Carry ``TransformerLM`` weights between the flax tree and PyTorch.

The flax model (``horovod_tpu/models/transformer.py``) stores

- ``embed/embedding``                  ``[vocab, d_model]``
- ``layer_i/attn/w{q,k,v}/kernel``     ``[d_model, H, D]`` (DenseGeneral)
- ``layer_i/attn/wo/kernel``           ``[H, D, d_model]`` (DenseGeneral)
- ``layer_i/mlp/{gate,up,down}/kernel`` ``[in, out]`` (Dense), or with
  ``moe_experts > 0`` ``layer_i/moe/router/kernel`` ``[d_model, E]``
  (Dense) and ``layer_i/moe/{wi,wo}`` ``[E, D, F]``/``[E, F, D]`` (the
  port keeps those two in flax's shape)
- ``layer_i/{attn,mlp}_norm/scale``, ``final_norm/scale``  ``[d_model]``
- ``lm_head/kernel``                   ``[d_model, vocab]``

and the port's ``TransformerLM`` holds Linear weights ``[out, in]``.
``params_from_flax`` and ``params_to_flax`` convert a whole tree (numpy
arrays in, numpy arrays out); ``flax_leaf_order`` gives the port's
parameter names in the order ``jax.tree_util.tree_flatten`` visits the
flax tree (keys sorted at every level: ``layer_0, layer_1, layer_10,
layer_2, ...``), which is the order gradient buckets are filled in.

A ``decode=True`` model has the same parameters, so these serve it as
they are.  Its KV cache is the flax ``cache`` collection,
``layer_i/attn/{cached_key, cached_value, cache_index}`` (dense) or
``layer_i/attn/{key_pool, value_pool}`` (paged); ``cache_from_flax`` and
``cache_to_flax`` carry it across, so that both packages can start from
one cache state.

The CNNs (``ResNet``, ``VGG``, ``InceptionV3``) name their submodules as
flax does, so their trees map by path: the port's ``a.b.weight`` is flax's
``params/a/b/kernel`` (conv ``[kh, kw, in, out]`` <-> ``[out, in, kh, kw]``,
Dense ``[in, out]`` <-> ``[out, in]``), ``scale`` and ``bias`` keep their
names, and the BatchNorm buffers ``a.b.mean``/``a.b.var`` are
``batch_stats/a/b/mean|var``.  ``cnn_params_from_flax`` and
``cnn_params_to_flax`` carry both collections; ``cnn_leaf_order`` gives
the parameter names in the flax flatten order (``BottleneckBlock_10``
before ``BottleneckBlock_2``, and upper case before ``bn_init``).

``flax_layouts`` gives, for every parameter of either kind of model, the
views between the port's shape and flax's: the element order that the
quantized gradient sync and the optimizer-in-ring buffer follow.
``leaf_views`` gives the same views for a chunk of any shape, with each
leaf's flax path and shape: the view in which ``parallel.sharding`` cuts
and gathers sharded parameters.  ``shard_state_dict`` cuts a state dict
into one rank's chunks by a rule table, as ``Trainer(param_rules=...)``
holds them, and ``unshard_state_dict`` puts every rank's chunks back
together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from .models.transformer import KVCache, PagedKVCache, TransformerConfig

# (torch name, flax path, flax shape, flax -> torch, torch -> flax) for
# every leaf.  The views take a tensor or an array of any shape, a
# chunk's too: ``to_torch(k)`` and ``to_flax(w, flax_shape)``.
_Leaf = tuple[str, tuple[str, ...], tuple[int, ...], Callable, Callable]

_SAME = (lambda k: k, lambda w, shape: w)
_DENSE = (lambda k: k.T, lambda w, shape: w.T)      # [in, out] <-> [out, in]
_QKV = (lambda k: k.reshape(k.shape[0], -1).T,      # [dm, H, D] <-> [H*D, dm]
        lambda w, shape: w.T.reshape(shape))
_OUT_PROJ = (lambda k: k.reshape(-1, k.shape[-1]).T,  # [H, D, dm] <->
             lambda w, shape: w.T.reshape(shape))     # [dm, H*D]


def _leaves(cfg: TransformerConfig) -> list[_Leaf]:
    h, d, dm = cfg.num_heads, cfg.head_dim, cfg.d_model
    ff, vocab, e = cfg.ff_dim, cfg.vocab_size, cfg.moe_experts
    leaves: list[_Leaf] = [
        ("embed.weight", ("embed", "embedding"), (vocab, dm), *_SAME),
        ("final_norm.scale", ("final_norm", "scale"), (dm,), *_SAME),
        ("lm_head.weight", ("lm_head", "kernel"), (dm, vocab), *_DENSE),
    ]
    for i in range(cfg.num_layers):
        t, f = f"layers.{i}", f"layer_{i}"
        leaves += [
            (f"{t}.attn_norm.scale", (f, "attn_norm", "scale"), (dm,),
             *_SAME),
            (f"{t}.mlp_norm.scale", (f, "mlp_norm", "scale"), (dm,), *_SAME),
            (f"{t}.attn.wo.weight", (f, "attn", "wo", "kernel"), (h, d, dm),
             *_OUT_PROJ),
        ]
        for name in ("wq", "wk", "wv"):
            leaves.append((f"{t}.attn.{name}.weight",
                           (f, "attn", name, "kernel"), (dm, h, d), *_QKV))
        if e > 0:
            leaves += [(f"{t}.moe.router.weight",
                        (f, "moe", "router", "kernel"), (dm, e), *_DENSE),
                       (f"{t}.moe.wi", (f, "moe", "wi"), (e, dm, ff), *_SAME),
                       (f"{t}.moe.wo", (f, "moe", "wo"), (e, ff, dm), *_SAME)]
            continue
        leaves += [(f"{t}.mlp.{name}.weight", (f, "mlp", name, "kernel"),
                    shape, *_DENSE)
                   for name, shape in (("gate", (dm, ff)), ("up", (dm, ff)),
                                       ("down", (ff, dm)))]
    # Lexicographic order of the paths is the flatten order of a tree
    # whose keys are sorted at every level.
    return sorted(leaves, key=lambda leaf: leaf[1])


def flax_leaf_order(cfg: TransformerConfig) -> list[str]:
    """The port's parameter names in the flax tree's flatten order."""
    return [name for name, *_ in _leaves(cfg)]


def _get(tree: Any, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def params_from_flax(tree: Any, cfg: TransformerConfig
                     ) -> dict[str, torch.Tensor]:
    """flax params tree (``variables["params"]``, arrays convertible with
    ``np.asarray``) -> ``TransformerLM`` state dict of CPU tensors."""
    return {name: torch.from_numpy(np.array(to_torch(
                np.asarray(_get(tree, path))), order="C"))
            for name, path, _, to_torch, _ in _leaves(cfg)}


def params_to_flax(state_dict: dict[str, torch.Tensor],
                   cfg: TransformerConfig) -> dict:
    """``TransformerLM`` state dict -> flax params tree of numpy arrays."""
    tree: dict = {}
    for name, path, shape, _, to_flax in _leaves(cfg):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        value = state_dict[name].detach().cpu().float().numpy()
        node[path[-1]] = np.ascontiguousarray(to_flax(value, shape))
    return tree


def cache_from_flax(cache_tree: Any, cfg: TransformerConfig,
                    device: str | torch.device = "cpu"
                    ) -> KVCache | PagedKVCache:
    """flax ``cache`` collection (dense or paged) -> the port's cache, in
    ``cfg.dtype`` (the index in int32), on ``device``."""
    attn = [_get(cache_tree, (f"layer_{i}", "attn"))
            for i in range(cfg.num_layers)]

    def tensors(key, dtype=cfg.dtype):
        # Through float32: numpy has no bfloat16, and the round trip is
        # exact for 16-bit values.
        return [torch.from_numpy(np.array(a[key], np.float32)).to(
            device=device, dtype=dtype) for a in attn]
    if "key_pool" in attn[0]:
        return PagedKVCache(tensors("key_pool"), tensors("value_pool"))
    return KVCache(tensors("cached_key"), tensors("cached_value"),
                   [torch.from_numpy(np.array(a["cache_index"], np.int32))
                    .to(device) for a in attn])


def cache_to_flax(cache: KVCache | PagedKVCache,
                  cfg: TransformerConfig) -> dict:
    """The port's cache -> flax ``cache`` collection of numpy arrays
    (16-bit values come back as float32, exactly)."""
    def arr(x):
        return x.detach().cpu().float().numpy()
    tree: dict = {}
    for i in range(cfg.num_layers):
        if isinstance(cache, PagedKVCache):
            node = {"key_pool": arr(cache.key_pool[i]),
                    "value_pool": arr(cache.value_pool[i])}
        else:
            node = {"cached_key": arr(cache.key[i]),
                    "cached_value": arr(cache.value[i]),
                    "cache_index": cache.index[i].detach().cpu().numpy()}
        tree[f"layer_{i}"] = {"attn": node}
    return tree


def _cnn_path(name: str) -> tuple[str, tuple[str, ...]]:
    """The flax collection and path of a CNN state-dict entry."""
    *modules, leaf = name.split(".")
    if leaf in ("mean", "var"):
        return "batch_stats", (*modules, leaf)
    return "params", (*modules, "kernel" if leaf == "weight" else leaf)


def _permute(x, axes):
    """``x`` with its dims in ``axes`` order: a view of a tensor or of a
    numpy array."""
    return x.permute(*axes) if isinstance(x, torch.Tensor) \
        else x.transpose(axes)


def _kernel_to_torch(k):
    if k.ndim == 4:                # [kh, kw, in, out] -> [out, in, kh, kw]
        return _permute(k, (3, 2, 0, 1))
    return k.T if k.ndim == 2 else k


def _kernel_to_flax(w):
    if w.ndim == 4:
        return _permute(w, (2, 3, 1, 0))
    return w.T if w.ndim == 2 else w


def cnn_leaf_order(model: nn.Module) -> list[str]:
    """A CNN's parameter names in the flax tree's flatten order."""
    return sorted((name for name, _ in model.named_parameters()),
                  key=lambda name: _cnn_path(name)[1])


def cnn_params_from_flax(params: Any, batch_stats: Any, model: nn.Module
                         ) -> dict[str, torch.Tensor]:
    """flax ``params`` and ``batch_stats`` trees (arrays convertible with
    ``np.asarray``) -> the CNN's state dict of CPU tensors, every entry of
    ``model.state_dict()`` filled."""
    trees = {"params": params, "batch_stats": batch_stats}
    out = {}
    for name in model.state_dict():
        collection, path = _cnn_path(name)
        value = _kernel_to_torch(np.asarray(_get(trees[collection], path)))
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def cnn_params_to_flax(state_dict: dict[str, torch.Tensor]
                       ) -> tuple[dict, dict]:
    """A CNN's state dict -> flax ``(params, batch_stats)`` trees of numpy
    arrays."""
    trees: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, tensor in state_dict.items():
        collection, path = _cnn_path(name)
        node = trees[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        value = tensor.detach().cpu().float().numpy()
        node[path[-1]] = np.ascontiguousarray(_kernel_to_flax(value))
    return trees["params"], trees["batch_stats"]


def flax_layouts(model: nn.Module
                 ) -> dict[str, tuple[Callable, Callable]] | None:
    """For each parameter of a ``TransformerLM`` or a CNN, the pair
    ``(to_flax, from_flax)``: ``to_flax(t)`` is a view of the
    torch-shaped tensor ``t`` in flax's shape (its elements in flax's
    order when flattened), and ``from_flax`` the inverse view.  The
    gradient sync packs quantized buckets and the ring's flat buffer
    through them, so that blocks and rank chunks cut the elements the
    reference cuts.  None for a model with no flax twin: the sync then
    keeps memory order."""
    from .models import VGG, InceptionV3, ResNet, TransformerLM
    if isinstance(model, TransformerLM):
        return {name: (lambda w, f=to_flax, shape=shape: f(w, shape),
                       to_torch)
                for name, _, shape, to_torch, to_flax in _leaves(model.cfg)}
    if isinstance(model, (ResNet, VGG, InceptionV3)):
        return {name: (_kernel_to_flax, _kernel_to_torch)
                for name, _ in model.named_parameters()}
    return None


@dataclasses.dataclass(frozen=True)
class LeafView:
    """A parameter's flax path (``a/b/kernel``) and shape, and the views
    between the port's layout and flax's for a chunk of any shape:
    ``to_flax(t, flax_shape)`` and ``to_torch(k)``."""
    path: str
    flax_shape: tuple[int, ...]
    to_flax: Callable
    to_torch: Callable


def leaf_views(model: nn.Module) -> dict[str, LeafView]:
    """Every parameter of ``model`` by torch name, in the flax leaf order
    for a ``TransformerLM`` or a CNN: its flax path and shape and its
    chunk views.  A model with no flax twin keeps its torch names (``/``
    for ``.``), shapes and layout."""
    from .models import VGG, InceptionV3, ResNet, TransformerLM
    params = dict(model.named_parameters())
    out = {}
    if isinstance(model, TransformerLM):
        for name, path, shape, to_torch, to_flax in _leaves(model.cfg):
            out[name] = LeafView("/".join(path), shape, to_flax, to_torch)
        return out
    if isinstance(model, (ResNet, VGG, InceptionV3)):
        for name in cnn_leaf_order(model):
            shape = tuple(_kernel_to_flax(torch.empty(
                params[name].shape, device="meta")).shape)
            out[name] = LeafView("/".join(_cnn_path(name)[1]), shape,
                                 lambda w, shape: _kernel_to_flax(w),
                                 _kernel_to_torch)
        return out
    to_torch, to_flax = _SAME
    for name, p in params.items():
        out[name] = LeafView(name.replace(".", "/"), tuple(p.shape),
                             to_flax, to_torch)
    return out


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def shard_state_dict(state_dict: dict, rules, mesh, rank: int,
                     model: nn.Module) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s chunks of a whole state dict (tensors or numpy
    arrays in the port's layout, e.g. ``params_from_flax``'s) under
    ``rules`` over ``mesh`` (a ``Mesh`` or a mapping of axis sizes, ranks
    row-major over ``DEFAULT_AXES``): each parameter cut in its flax view
    and returned in the port's layout, as ``Trainer(param_rules=...)``
    holds it on that rank; every other entry (buffers) whole.  ``model``
    gives the flax views (``leaf_views``)."""
    from .parallel.sharding import mesh_coords, plan_sharding
    plan = plan_sharding(model, mesh, rules)
    sizes = dict(mesh.shape if hasattr(mesh, "shape") else mesh)
    coords = mesh_coords(sizes, rank)
    out = {}
    for name, value in state_dict.items():
        t = _as_tensor(value)
        out[name] = plan[name].cut(t, sizes, coords) \
            if name in plan and plan[name].sharded else t
    return out


def unshard_state_dict(chunks: Sequence[dict], rules, mesh,
                       model: nn.Module) -> dict[str, torch.Tensor]:
    """Inverse of ``shard_state_dict``: the whole state dict from every
    rank's chunks (``chunks[r]`` rank ``r``'s), put together in the flax
    view on the host."""
    from .parallel.sharding import chunk_slices, mesh_coords, plan_sharding
    plan = plan_sharding(model, mesh, rules)
    sizes = dict(mesh.shape if hasattr(mesh, "shape") else mesh)
    out = {}
    for name, value in chunks[0].items():
        leaf = plan.get(name)
        if leaf is None or not leaf.sharded:
            out[name] = _as_tensor(value)
            continue
        full = torch.empty(leaf.flax_shape, dtype=_as_tensor(value).dtype)
        for rank, part in enumerate(chunks):
            index = chunk_slices(leaf.spec, leaf.flax_shape, sizes,
                                 mesh_coords(sizes, rank))
            full[index] = leaf.to_flax(_as_tensor(part[name]),
                                       leaf.chunk_flax_shape)
        out[name] = leaf.to_torch(full).contiguous()
    return out

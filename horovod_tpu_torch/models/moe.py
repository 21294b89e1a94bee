"""Mixture-of-Experts FFN with expert parallelism over the ``ep`` ranks.

The counterpart of ``horovod_tpu/models/moe.py``: Switch-style top-1
routing with a capacity, dense dispatch/combine einsums, and an
expert-parallel mode in which tokens travel to their expert's rank and
back in two all-to-alls over ``ep``.  The math is fp32 and the output is
cast to ``dtype``; the activation is GELU's tanh approximation, as
``nn.gelu``/``jax.nn.gelu`` default to.  The products stay einsums: the
reference has no kernel here.

Parameters are flax's leaves: ``router`` (a ``Dense`` d_model -> E, fp32
compute), ``wi`` ``[E, D, F]`` and ``wo`` ``[E, F, D]``.  With ``ep = n``
rank ``e`` runs experts ``e·E/n ..``; every rank holds all experts
unless ``Trainer(param_rules=...)`` shards ``moe/wi`` and ``moe/wo`` over
``ep`` on their leading dim, when rank ``e`` holds only the ``E/n`` it
runs (``held``, set by ``TransformerLM.apply_tensor_parallel``: ``wi``
and ``wo`` are then those chunks, and their gradients stay on their ep
rank).  ``lecun_normal`` on an ``[E, D, F]`` leaf takes its
fan-in over ``E·D``.

Which tokens are routed together decides the result as soon as a
capacity binds (the capacity and the queue order are counted over them):

- by default a layer routes the rows it is given, as the reference's
  layer routes the local shard it sees inside a manual region; at
  ``ep > 1`` they are this ep rank's block of the tokens;
- inside ``parallel.mesh.global_batch`` (the Trainer's pure-GSPMD step)
  the reference's layer sees the global batch: at ``ep = 1`` it routes
  all of it, at ``ep = n`` rank ``e`` routes the ``e``-th of ``n`` equal
  row blocks of it (``shard_map`` with ``P("ep")``), whichever ranks
  hold those rows.  The port regathers the global batch (a
  differentiable all-gather over the batch axes), routes the rows the
  reference's layer routes, gathers the blocks' results over ``ep`` and
  returns this rank's own rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from ..parallel.collectives import allgather, alltoall
from ..parallel.mesh import Mesh, axis_size, current_global_batch
from .layers import Dense, lecun_normal_


def _capacity(n_tokens: int, num_experts: int, factor: float) -> int:
    return max(int(factor * n_tokens / num_experts), 1)


def _dispatch_combine(router_logits: torch.Tensor, capacity: int):
    """Top-1 dispatch/combine tensors.  router_logits: [N, E].

    Returns dispatch [N, E, C] (0/1) and combine [N, E, C] fp32; tokens
    past an expert's capacity are dropped (output 0 for them)."""
    e = router_logits.shape[1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)                             # [N]
    mask = F.one_hot(expert, e).float()                       # [N, E]
    # Position of each token within its expert's queue.
    pos = torch.cumsum(mask, dim=0) * mask                    # [N, E]
    keep = (pos > 0) & (pos <= capacity)
    pos_clamped = torch.clamp(pos - 1, 0, capacity - 1).long()
    dispatch = F.one_hot(pos_clamped, capacity).float() * keep[..., None]
    gate = (probs * mask).sum(dim=-1)                         # [N]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def _experts(expert_in, wi, wo):
    """[E, C, D] tokens through their experts' FFN, fp32."""
    h = torch.einsum("ecd,edf->ecf", expert_in, wi.float())
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, wo.float())


def _dense_moe(tokens, logits, wi, wo, capacity_factor):
    """All experts here: tokens [N, D] fp32, logits [N, E] -> [N, D]."""
    n, e = logits.shape
    dispatch, combine = _dispatch_combine(
        logits, _capacity(n, e, capacity_factor))
    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    return torch.einsum("nec,ecd->nd", combine, _experts(expert_in, wi, wo))


def _expert_parallel_moe_with_logits(x, logits, wi, wo, *, group,
                                     axis_size: int,
                                     capacity_factor: float, dtype):
    """One ep rank's MoE: its block of tokens x [Bl, T, D] and their
    logits [Bl, T, E], its experts' wi [El, D, F] and wo [El, F, D]."""
    bl, t, d = x.shape
    e = logits.shape[-1]
    el = wi.shape[0]
    if el * axis_size != e:
        raise ValueError(f"{el} local experts x ep={axis_size} != {e}")
    tokens = x.reshape(bl * t, d).float()
    capacity = _capacity(bl * t, e, capacity_factor)
    dispatch, combine = _dispatch_combine(logits.reshape(bl * t, e),
                                          capacity)
    # Local dispatch for ALL experts: [E, C, D].
    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    # To the experts' ranks: split the experts, gather the token groups;
    # each rank ends with [El, n*C, D], its experts and every rank's
    # tokens.
    expert_in = alltoall(expert_in, group, split_axis=0, concat_axis=1)
    expert_out = _experts(expert_in, wi, wo)
    # Home again: the inverse reshard.
    expert_out = alltoall(expert_out, group, split_axis=1, concat_axis=0)
    out = torch.einsum("nec,ecd->nd", combine, expert_out)
    return out.reshape(bl, t, d).to(dtype)


class MoEMLP(nn.Module):
    """Switch-style MoE feed-forward: [B, T, D] -> [B, T, D].

    ``ep_mesh``/``ep_axis``: with an ep axis larger than one, experts run
    on their ep ranks and tokens move in two all-to-alls; otherwise every
    expert runs here (the dense einsums).  ``capacity_factor`` scales
    each expert's token budget.  ``device``: the CUDA card unless the
    CPU is asked for (``resolve_device``)."""

    def __init__(self, d_model: int, num_experts: int = 8, d_ff: int = 256,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 ep_mesh: Mesh | None = None, ep_axis: str = "ep",
                 device: torch.device | None = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.dtype, self.ep_mesh, self.ep_axis = dtype, ep_mesh, ep_axis
        self.router = Dense(d_model, num_experts, torch.float32, param_dtype,
                            device)
        e = num_experts
        self.wi = nn.Parameter(torch.empty(e, d_model, d_ff,
                                           dtype=param_dtype, device=device))
        self.wo = nn.Parameter(torch.empty(e, d_ff, d_model,
                                           dtype=param_dtype, device=device))
        self.n_ep = 1 if ep_mesh is None else axis_size(ep_mesh, ep_axis)
        if e % self.n_ep:
            raise ValueError(f"{e} experts not divisible by ep={self.n_ep}")
        # True when wi and wo hold this ep rank's experts alone (set by
        # TransformerLM.apply_tensor_parallel), else every expert.
        self.held = False
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """flax's lecun_normal on the expert leaves (fan-in E·D for wi,
        E·F for wo); the router is a ``Dense``, drawn by its own
        ``reset_parameters``."""
        e, d, f = self.wi.shape
        lecun_normal_(self.wi, e * d, generator)
        lecun_normal_(self.wo, e * f, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        view = current_global_batch()
        if view is not None:
            return self._global_forward(x, *view)
        return self._rows_forward(x)

    def _rows_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Route the rows of ``x`` (this ep rank's block at ep > 1)."""
        b, t, d = x.shape
        logits = self.router(x)                               # [B, T, E]
        if self.n_ep == 1:
            out = _dense_moe(x.reshape(b * t, d).float(),
                             logits.reshape(b * t, self.num_experts),
                             self.wi, self.wo, self.capacity_factor)
            return out.reshape(b, t, d).to(self.dtype)
        el = self.num_experts // self.n_ep
        wi, wo = self.wi, self.wo
        if not self.held:
            # Every expert held here: this rank runs its own.
            e0 = self.ep_mesh.axis_index(self.ep_axis) * el
            wi, wo = wi[e0:e0 + el], wo[e0:e0 + el]
        return _expert_parallel_moe_with_logits(
            x, logits, wi, wo,
            group=self.ep_mesh.axis_group(self.ep_axis),
            axis_size=self.n_ep, capacity_factor=self.capacity_factor,
            dtype=self.dtype)

    def _global_forward(self, x: torch.Tensor, mesh: Mesh,
                        batch_axes: tuple[str, ...]) -> torch.Tensor:
        """The reference's routing over the global batch (this rank's
        shard of it laid over ``mesh``'s ``batch_axes``); this rank's
        rows of the result."""
        axes = [a for a in batch_axes if axis_size(mesh, a) > 1]
        full = x
        if axes:
            full = allgather(x, [mesh.axis_group(a) for a in axes])
        if self.n_ep > 1:
            rows = full.shape[0] // self.n_ep
            e = self.ep_mesh.axis_index(self.ep_axis)
            block = self._rows_forward(full[e * rows:(e + 1) * rows])
            full = allgather(block, self.ep_mesh.axis_group(self.ep_axis))
        else:
            full = self._rows_forward(full)
        idx = 0
        for a in axes:
            idx = idx * axis_size(mesh, a) + mesh.axis_index(a)
        b = x.shape[0]
        return full[idx * b:(idx + 1) * b]

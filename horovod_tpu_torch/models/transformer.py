"""Decoder-only Transformer LM, in PyTorch: the counterpart of
``horovod_tpu/models/transformer.py``.

Same configuration, presets and mixed-precision rules as the flax model:

- parameters are ``param_dtype`` (fp32); a projection casts both its input
  and its weight to ``dtype`` (bf16) and returns ``dtype``, as flax's
  ``Dense(dtype=...)`` does; the embedding returns ``dtype``; the logits
  stay in ``dtype``;
- RMSNorm computes in fp32 and casts after multiplying by its fp32 scale;
- RoPE uses global positions and the split-halves rotation;
- attention is ``"dense"`` (``mha_reference``), ``"flash"`` (the CUDA
  kernels of ``ops/flash_attention.py``), ``"ring"`` (``parallel/
  ring_attention.py``, plain torch in fp32) or ``"ulysses"``
  (``parallel/ulysses.py``, whose head shard runs
  ``_bthd_attn_adapter``: the CUDA flash kernels on the card,
  ``mha_reference`` on the CPU, as the reference runs flash on the TPU
  and dense attention elsewhere).  Ring and Ulysses shard the sequence
  over ``cfg.mesh``'s ``sp`` axis: a model's tokens are this rank's
  sequence chunk and RoPE takes global positions (the ``sp`` coordinate
  times the chunk length, plus the position in the chunk), as inside the
  reference's manual region.  Inside ``parallel.mesh.global_batch`` (the
  Trainer's pure-GSPMD step) every ``sp`` rank holds the whole sequence,
  as the reference's model does there: attention runs on this rank's
  chunk and gathers the sequence back; where that view binds the ``sp``
  axis (a ``batch_spec`` that shards the sequence over it), the tokens
  are the chunk again;
- ``moe_experts > 0`` puts ``models/moe.py``'s ``MoEMLP`` in each block's
  place of the MLP, its experts over ``cfg.mesh``'s ``ep`` axis;
- tensor parallelism: ``Attention.split`` and ``MLP.split`` (set by
  ``TransformerLM.apply_tensor_parallel``, which ``Trainer(param_rules=
  ...)`` calls in its pure-GSPMD step; None otherwise) are the process
  groups over which the layer's weights are split, and the weights are
  then this rank's chunks: ``wq``, ``wk``, ``wv`` rows of
  ``H/n`` heads and ``wo`` their columns (flax's ``P(None, "tp",
  None)`` and ``P("tp", None, None)``), ``gate``/``up`` rows and
  ``down`` columns of ``d_ff/n`` (``P(None, "tp")``, ``P("tp", None)``).
  Attention runs RoPE and its kernels (the CUDA flash kernels, or dense)
  on the local heads and the MLP on its column slice; each layer's
  input is ``enter_split`` (an all-reduce of its gradient) and its
  output, ``wo``'s or ``down``'s partial product, ``leave_split`` (an
  all-reduce of the partial sums).  At one rank both are the identity;
- with ``decode=True`` attention runs over a KV cache passed to the
  forward: a dense ``KVCache`` or, with ``paged=True``, a
  ``PagedKVCache`` addressed through block tables.  Decode attention is
  plain torch in fp32, as the reference's is plain ``jnp``: no kernel of
  this repo runs on the serving path.

Casts are explicit rather than ``torch.autocast``, which would cast at
other places.  Parameter names follow PyTorch (``layers.0.attn.wq.weight``,
Linear weights ``[out, in]``); ``convert.py`` maps them to and from the
flax tree.  Initialisation draws from flax's default distributions with a
``torch.Generator``.

The port covers the training forward and KV-cache decoding (dense and
paged; ``prefill``, ``decode_step``, ``paged_apply``, ``paged_copy_block``;
MoE blocks included, ring and Ulysses refused as in the reference).
``remat=True`` checkpoints each block; ``remat_policy="dots"`` keeps the
products' outputs as ``jax.checkpoint_policies.checkpoint_dots`` does and
recomputes the rest of the block in the backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from functools import partial
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.device import resolve_device
from ..ops.flash_attention import NEG_INF, flash_attention, mha_reference
from ..parallel.collectives import allgather, enter_split, leave_split
from ..parallel.mesh import (axis_size, current_global_batch,
                             current_sequence_axes, current_view,
                             global_batch)
from ..parallel.ring_attention import ring_attention
from ..parallel.sharding import entry_axes
from ..parallel.ulysses import ulysses_attention
from .layers import Dense
from .moe import MoEMLP


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int | None = None           # default 4 * d_model
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16         # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    attention: str = "dense"          # dense | flash | ring | ulysses
    causal: bool = True
    remat: bool = False               # checkpoint each block
    remat_policy: str = "full"        # full | dots
    block_q: int = 128
    block_k: int = 128
    block_q_bwd: int | None = None
    block_k_bwd: int | None = None
    flash_interpret: bool = False     # JAX-only knob; must stay False here
    # Sequence and expert parallelism: a parallel.mesh.Mesh with "sp" and
    # "ep" axes.  batch_spec is the reference's (which mesh axes the batch
    # dim is sharded over); the port's model reads its rows as given.
    mesh: Any = None
    sp_axis: str = "sp"
    batch_spec: Any = None
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    ep_axis: str = "ep"
    decode: bool = False
    paged: bool = False
    kv_pool_blocks: int = 0
    kv_block_tokens: int = 16

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"num_heads {self.num_heads}")
        return self.d_model // self.num_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ValueError for what the reference refuses, and
    NotImplementedError for its JAX-only knob."""
    if cfg.flash_interpret:
        raise NotImplementedError(
            "flash_interpret runs Pallas kernels interpreted; the port's "
            "CPU path is device='cpu'")
    if cfg.attention not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"Unknown attention impl: {cfg.attention}")
    if cfg.attention in ("ring", "ulysses"):
        if cfg.decode:
            raise ValueError(
                "cfg.decode is incompatible with sequence-parallel attention "
                f"('{cfg.attention}'): the KV cache is a whole-sequence "
                "structure")
        if cfg.mesh is None:
            raise ValueError(
                f"attention='{cfg.attention}' needs cfg.mesh to shard the "
                f"sequence over axis '{cfg.sp_axis}'")
    if cfg.paged and cfg.decode and cfg.kv_pool_blocks <= 0:
        raise ValueError("cfg.paged needs kv_pool_blocks > 0 (the per-layer "
                         "block pool size)")
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected 'full' or 'dots')")


# ---------------------------------------------------------------------------
# Rematerialisation (reference: nn.remat with policy None or
# jax.checkpoint_policies.checkpoint_dots)
# ---------------------------------------------------------------------------
# "full" is torch.utils.checkpoint.  "dots" keeps every product of the
# block (each Dense output, and dense attention's two einsums) from the
# forward, and its backward recomputes the rest of the block around them:
# the block's own code runs again, each product taken back from a tape in
# the order it was written.  Flash attention is recomputed, as
# checkpoint_dots recomputes the Pallas call.  torch's selective
# checkpointing would keep the same tensors, but its policy runs every op
# of the forward and the recompute through a Python dispatch mode, which
# left the card idle most of a gpt_small step (PERF.md §6).
class _Tape(threading.local):
    """The products of the block being checkpointed under "dots" on this
    thread: ``kept`` is written while its forward runs (``recording``) and
    read back in order while its backward recomputes it; None outside."""
    kept: list | None = None
    recording: bool = False
    pos: int = 0


_TAPE = _Tape()


@contextlib.contextmanager
def _taping(kept: list, recording: bool):
    prev = _TAPE.kept, _TAPE.recording, _TAPE.pos
    _TAPE.kept, _TAPE.recording, _TAPE.pos = kept, recording, 0
    try:
        yield
    finally:
        _TAPE.kept, _TAPE.recording, _TAPE.pos = prev


def _in_view(view):
    """Re-enter ``view``, a forward's ``current_view()``, for a
    checkpointed block's recompute.  The view is this thread's, and on
    the card autograd runs a CUDA backward on a device thread of its own,
    where the recompute would otherwise see none."""
    return contextlib.nullcontext() if view is None else global_batch(*view)


def _take() -> torch.Tensor:
    y = _TAPE.kept[_TAPE.pos]
    _TAPE.pos += 1
    return y


def _dense(layer: Dense, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``, kept on the tape under "dots"."""
    if _TAPE.kept is None:
        return layer(x)
    if _TAPE.recording:
        _TAPE.kept.append(layer(x))
        return _TAPE.kept[-1]
    return _KeptDense.apply(x, layer.weight, layer.bias, _take(),
                            layer.compute_dtype)


def _einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)``, kept on the tape under "dots"."""
    if _TAPE.kept is None:
        return torch.einsum(equation, a, b)
    if _TAPE.recording:
        _TAPE.kept.append(torch.einsum(equation, a, b))
        return _TAPE.kept[-1]
    return _KeptEinsum.apply(equation, a, b, _take())


class _KeptDense(torch.autograd.Function):
    """A Dense product taken back from the tape: forward the kept output,
    backward the gradients of ``F.linear`` in the compute dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, y, dtype):
        ctx.save_for_backward(x, weight)
        ctx.dtype = dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dt = ctx.dtype
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = (g @ weight.to(dt)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (g2.t() @ x.reshape(-1, x.shape[-1]).to(dt)) \
                .to(weight.dtype)
        if ctx.needs_input_grad[2]:
            gb = g2.sum(0).to(ctx.bias_dtype)
        return gx, gw, gb, None, None


class _KeptEinsum(torch.autograd.Function):
    """A two-operand einsum taken back from the tape.  Every index of
    each operand appears in the other operand or in the output, so each
    gradient is again one einsum."""

    @staticmethod
    def forward(ctx, equation, a, b, y):
        ctx.save_for_backward(a, b)
        ctx.equation = equation
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.equation.split("->")
        ia, ib = ins.split(",")
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = torch.einsum(f"{out},{ib}->{ia}", g, b)
        if ctx.needs_input_grad[2]:
            gb = torch.einsum(f"{ia},{out}->{ib}", a, g)
        return None, ga, gb, None


class _CheckpointDots(torch.autograd.Function):
    """``block(x)`` under checkpoint_dots: the forward keeps ``x`` and the
    block's products; the backward runs the block again on them and
    differentiates that run.  ``params`` are the block's parameters, so
    that their gradients come back through this function."""

    @staticmethod
    def forward(ctx, block, x, *params):
        kept: list[torch.Tensor] = []
        with _taping(kept, recording=True):
            y = block(x)
        ctx.block, ctx.view = block, current_view()
        ctx.save_for_backward(x, *kept)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, *kept = ctx.saved_tensors
        params = list(ctx.block.parameters())
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[2:])
                  if need]
        x = x.detach().requires_grad_(ctx.needs_input_grad[1])
        with torch.enable_grad(), _taping(kept, recording=False), \
                _in_view(ctx.view):
            y = ctx.block(x)
            assert _TAPE.pos == len(kept), (_TAPE.pos, len(kept))
        inputs = ([x] if x.requires_grad else []) + [params[i]
                                                     for i in wanted]
        grads = iter(torch.autograd.grad(y, inputs, gy, allow_unused=True))
        gx = next(grads) if x.requires_grad else None
        gparams = [None] * len(params)
        for i in wanted:
            gparams[i] = next(grads)
        return (None, gx, *gparams)


# ---------------------------------------------------------------------------
# RoPE (global positions, split-halves rotation)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [T] or [B, T].  Rotates the pair
    (x[..., i], x[..., i + D/2]) — the halves, not interleaved pairs."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # [B|1, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6, device: torch.device | None = None
                 ) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                             device=device))
        self.dtype, self.eps = dtype, eps

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.num_heads * cfg.head_dim
        args = (cfg.dtype, cfg.param_dtype, device)
        self.wq = Dense(cfg.d_model, hd, *args)
        self.wk = Dense(cfg.d_model, hd, *args)
        self.wv = Dense(cfg.d_model, hd, *args)
        self.wo = Dense(hd, cfg.d_model, *args)
        # The groups the heads are split over (tensor parallelism), else
        # None; the weights are then this rank's heads.
        self.split = None

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                block_tables=None, cursors=None, lengths=None
                ) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        if self.split is not None:
            x = enter_split(x, self.split)
        # The heads this rank holds: all of them, or H/n under the split.
        shape = (b, t, -1, cfg.head_dim)
        q = _dense(self.wq, x).view(shape)
        k = _dense(self.wk, x).view(shape)
        v = _dense(self.wv, x).view(shape)
        if cache is not None and cfg.paged:
            out = self._decode_attend_paged(q, k, v, cache, layer,
                                            block_tables, cursors, lengths)
        elif cache is not None:
            out = self._decode_attend(q, k, v, cache, layer)
        else:
            positions = torch.arange(t, device=x.device)
            if cfg.attention in ("ring", "ulysses") \
                    and _sequence_chunk(cfg):
                # The tokens are a sequence chunk: global positions.
                positions = positions \
                    + cfg.mesh.axis_index(cfg.sp_axis) * t
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            if cfg.attention == "flash":
                out = flash_attention(q, k, v, causal=cfg.causal,
                                      block_q=cfg.block_q,
                                      block_k=cfg.block_k,
                                      block_q_bwd=cfg.block_q_bwd,
                                      block_k_bwd=cfg.block_k_bwd,
                                      device=x.device)
            elif cfg.attention == "dense":
                out = mha_reference(q, k, v, causal=cfg.causal,
                                    einsum=_einsum)
            else:
                out = _sequence_parallel(cfg, q, k, v)
        out = _dense(self.wo, out.to(cfg.dtype).reshape(b, t, -1))
        return out if self.split is None else leave_split(out, self.split)

    def _decode_attend(self, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, cache: "KVCache", layer: int
                       ) -> torch.Tensor:
        """Incremental attention over the dense cache: write this call's
        K/V at each row's own depth, attend causally over the cached
        prefix at absolute positions."""
        cfg = self.cfg
        b, t, _, _ = q.shape
        s = cfg.max_seq_len
        idx = cache.index[layer]                                 # [B]
        steps = torch.arange(t, device=q.device)
        # Per-row positions: each row of the batch sits at its own depth.
        positions = idx.long()[:, None] + steps[None, :]         # [B, T]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        # jax.lax.dynamic_update_slice clamps its start to [0, S - t], and
        # a free serving slot's cursor does run past S (every decode step
        # advances every row).  A slice assignment would raise there, so
        # the write start is clamped as JAX clamps it.
        start = idx.long().clamp(0, s - t)
        rows = torch.arange(b, device=q.device)[:, None]
        write = start[:, None] + steps[None, :]
        cache.key[layer][rows, write] = k.to(cfg.dtype)
        cache.value[layer][rows, write] = v.to(cfg.dtype)
        cache.index[layer] = idx + t
        # Right-padded prefill garbage sits at key positions past every
        # live query, so key_pos <= q_pos alone keeps it invisible.
        key_pos = torch.arange(s, device=q.device)
        mask = key_pos[None, None, :] <= positions[:, :, None]   # [B,T,S]
        return _cache_attention(q, cache.key[layer], cache.value[layer],
                                mask)

    def _decode_attend_paged(self, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, cache: "PagedKVCache",
                             layer: int, block_tables, cursors, lengths
                             ) -> torch.Tensor:
        """Incremental attention over the shared block pool: K/V scatter
        into pool rows through each row's block table (logical position
        p of row b lives at ``pool[tables[b, p // bt], p % bt]``), the
        table gathers the sequence back as ``[B, M*bt, H, D]``, and the
        same absolute-position causal attention runs over it.  Padded
        positions (``lengths``) write to the sink row, the pool's last."""
        cfg = self.cfg
        if block_tables is None or cursors is None:
            raise ValueError("paged decode needs block_tables [B, M] and "
                             "cursors [B] on every call")
        b, t, h, d = q.shape
        bt = cfg.kv_block_tokens
        sink = cfg.kv_pool_blocks
        tables = block_tables.long()                             # [B, M]
        m = tables.shape[1]
        steps = torch.arange(t, device=q.device)
        positions = cursors.long()[:, None] + steps[None, :]     # [B, T]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        logical = torch.clamp(positions // bt, max=m - 1)
        phys = torch.gather(tables, 1, logical)                  # [B, T]
        if lengths is not None:
            valid = steps[None, :] < lengths.long()[:, None]
            phys = torch.where(valid, phys, torch.full_like(phys, sink))
        offs = positions % bt
        # Two writes meet only in the sink row (padded positions); CUDA's
        # index_put_ then keeps either, which is harmless there alone.
        kp, vp = cache.key_pool[layer], cache.value_pool[layer]
        kp[phys.reshape(-1), offs.reshape(-1)] = \
            k.to(cfg.dtype).reshape(b * t, h, d)
        vp[phys.reshape(-1), offs.reshape(-1)] = \
            v.to(cfg.dtype).reshape(b * t, h, d)
        # Positions past the cursor (stale or sink-backed) are masked like
        # the dense path's not-yet-written tail.
        k_seq = kp[tables].reshape(b, m * bt, h, d)
        v_seq = vp[tables].reshape(b, m * bt, h, d)
        key_pos = torch.arange(m * bt, device=q.device)
        mask = key_pos[None, None, :] <= positions[:, :, None]   # [B,T,S]
        return _cache_attention(q, k_seq, v_seq, mask)


def _bthd_attn_adapter(q, k, v, causal=False, sm_scale=None, *,
                       cfg: TransformerConfig):
    """Full-sequence attention inside Ulysses' head shard: the CUDA flash
    kernels on the card, dense attention on the CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               block_q=cfg.block_q, block_k=cfg.block_k,
                               block_q_bwd=cfg.block_q_bwd,
                               block_k_bwd=cfg.block_k_bwd, device=q.device)
    return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)


def _sequence_chunk(cfg: TransformerConfig) -> bool:
    """Whether the tokens are this rank's chunk of the sequence over
    ``cfg.sp_axis``: outside ``global_batch``, or inside it where the
    view binds that axis."""
    return current_global_batch() is None \
        or cfg.sp_axis in current_sequence_axes()


def _sequence_parallel(cfg: TransformerConfig, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Ring or Ulysses attention over ``cfg.mesh``'s ``sp`` axis.  Where
    the tokens are a sequence chunk (``_sequence_chunk``) q, k and v are
    this rank's chunk; else they hold the whole sequence, and the chunk's
    result is gathered back over ``sp``."""
    mesh = cfg.mesh
    n = axis_size(mesh, cfg.sp_axis)
    group = mesh.axis_group(cfg.sp_axis) if n > 1 else None
    if cfg.attention == "ring":
        inner = partial(ring_attention, group=group, causal=cfg.causal,
                        axis_size=n)
    else:
        inner = partial(ulysses_attention, group=group, causal=cfg.causal,
                        axis_size=n,
                        attn_fn=partial(_bthd_attn_adapter, cfg=cfg))
    if n == 1 or _sequence_chunk(cfg):
        return inner(q, k, v)
    c = q.shape[1] // n
    i = mesh.axis_index(cfg.sp_axis)
    out = inner(*(x[:, i * c:(i + 1) * c] for x in (q, k, v)))
    return allgather(out.transpose(0, 1).contiguous(),
                     group).transpose(0, 1)


def _cache_attention(q: torch.Tensor, keys: torch.Tensor,
                     values: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """The decode paths' attention, at the reference's precision: q, K and
    V in fp32, masked logits set to -1e30, fp32 softmax, and probs @ V in
    fp32 (the caller casts after it).  ``mha_reference`` casts p to V's
    dtype before the product, so it is not reused here."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          keys.float()) / math.sqrt(d)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, values.float())


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        args = (cfg.dtype, cfg.param_dtype, device)
        self.gate = Dense(cfg.d_model, cfg.ff_dim, *args)
        self.up = Dense(cfg.d_model, cfg.ff_dim, *args)
        self.down = Dense(cfg.ff_dim, cfg.d_model, *args)
        # The groups d_ff is split over (tensor parallelism), else None.
        self.split = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split is None:
            return _dense(self.down, F.silu(_dense(self.gate, x))
                          * _dense(self.up, x))
        x = enter_split(x, self.split)
        out = _dense(self.down, F.silu(_dense(self.gate, x))
                     * _dense(self.up, x))
        return leave_split(out, self.split)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        norm = (cfg.dtype, cfg.param_dtype)
        self.attn_norm = RMSNorm(cfg.d_model, *norm, device=device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, *norm, device=device)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(cfg.d_model, num_experts=cfg.moe_experts,
                              d_ff=cfg.ff_dim,
                              capacity_factor=cfg.moe_capacity_factor,
                              dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                              ep_mesh=cfg.mesh, ep_axis=cfg.ep_axis,
                              device=device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, cache=None, layer: int = 0,
                block_tables=None, cursors=None, lengths=None
                ) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), cache, layer, block_tables,
                          cursors, lengths)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.mlp_norm(x))


class TransformerLM(nn.Module):
    """Decoder-only LM: ``model(tokens [B, T] int64) -> logits
    [B, T, vocab]`` in ``cfg.dtype``.  Built on the card unless
    ``device="cpu"``; parameters drawn from ``generator`` (or ``seed``)."""

    def __init__(self, cfg: TransformerConfig,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 seed: int = 0) -> None:
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=dev,
                                  dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.dtype, cfg.param_dtype,
                                  device=dev)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype,
                             cfg.param_dtype, dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        self.init_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def apply_tensor_parallel(self, plan=None, groups=None,
                              batch_axes: Sequence[str] = ()
                              ) -> dict[str, bool]:
        """Set the tensor-parallel split of every block whose leaves have
        the canonical layout in ``plan`` (torch name -> ``LeafShard``,
        ``parallel.sharding.plan_sharding``) over axes that are not
        ``batch_axes``; ``groups(axes)`` gives the process groups of those
        axes.  With no plan every split is cleared.  Returns the leaves
        the model then uses as chunks: the split layers' (True: every
        rank of the split's group computes the same loss) and the experts
        held over ``ep`` (``MoEMLP.held``; False: each rank's loss is its
        own rows')."""
        direct: dict[str, bool] = {}
        for block in self.layers:
            block.attn.split = None
            if hasattr(block, "mlp"):
                block.mlp.split = None
            else:
                block.moe.held = False
        if plan is None:
            return direct
        batch = set(batch_axes)

        def spec(name):
            return tuple(entry_axes(e) for e in plan[name].spec)

        def free(axes):
            return bool(axes) and not batch & set(axes)
        for i, block in enumerate(self.layers):
            pre = f"layers.{i}."
            qkv = [pre + f"attn.{w}.weight" for w in ("wq", "wk", "wv")]
            axes = spec(qkv[0])[1]
            if self.cfg.attention in ("dense", "flash") and free(axes) \
                    and all(spec(n) == ((), axes, ()) for n in qkv) \
                    and spec(pre + "attn.wo.weight") == (axes, (), ()):
                block.attn.split = groups(axes)
                direct.update(dict.fromkeys(qkv + [pre + "attn.wo.weight"],
                                            True))
            if hasattr(block, "mlp"):
                gate = spec(pre + "mlp.gate.weight")
                axes = gate[1]
                if free(axes) and gate == ((), axes) \
                        and spec(pre + "mlp.up.weight") == gate \
                        and spec(pre + "mlp.down.weight") == (axes, ()):
                    block.mlp.split = groups(axes)
                    direct.update(dict.fromkeys(
                        [pre + f"mlp.{w}.weight"
                         for w in ("gate", "up", "down")], True))
            else:
                held = ((self.cfg.ep_axis,), (), ())
                if spec(pre + "moe.wi") == held \
                        and spec(pre + "moe.wo") == held:
                    block.moe.held = True
                    direct[pre + "moe.wi"] = direct[pre + "moe.wo"] = False
        return direct

    def init_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: Embed normal(0, 1/sqrt(d_model)), Dense and
        the experts' leaves lecun_normal, RMSNorm ones."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, self.cfg.d_model ** -0.5,
                                      generator=generator)
        for module in self.modules():
            if isinstance(module, (Dense, MoEMLP)):
                module.reset_parameters(generator)
            elif isinstance(module, RMSNorm):
                module.reset_parameters()

    def forward(self, tokens: torch.Tensor, train: bool = False,
                cache=None, block_tables=None, cursors=None,
                lengths=None) -> torch.Tensor:
        """``cache`` (a ``KVCache``, or a ``PagedKVCache`` with
        ``block_tables`` and ``cursors``) is required when ``cfg.decode``
        and refused otherwise; it is updated in place."""
        cfg = self.cfg
        if cfg.decode:
            kind = PagedKVCache if cfg.paged else KVCache
            if not isinstance(cache, kind):
                raise ValueError(f"a decode=True model takes a "
                                 f"{kind.__name__} (see prefill, "
                                 f"decode_step and paged_apply)")
        elif cache is not None:
            raise ValueError("a KV cache needs cfg.decode=True")
        x = self.embed.weight.to(cfg.dtype)[tokens]
        for i, block in enumerate(self.layers):
            if cache is not None:
                x = block(x, cache, i, block_tables, cursors, lengths)
            elif cfg.remat and train and torch.is_grad_enabled():
                # The recompute re-enters this forward's global view.
                view = current_view()
                x = (checkpoint(block, x, use_reentrant=False,
                                context_fn=lambda: (contextlib.nullcontext(),
                                                    _in_view(view)))
                     if cfg.remat_policy == "full" else
                     _CheckpointDots.apply(block, x, *block.parameters()))
            else:
                x = block(x)
        return self.lm_head(self.final_norm(x))


# ---------------------------------------------------------------------------
# KV-cache incremental decoding (inference serving; serving/replica.py)
# ---------------------------------------------------------------------------
# Every helper runs under torch.inference_mode(): the caches they make are
# inference tensors, which may be written in place only inside that mode,
# so every write to a cache (these helpers and the serving replica) runs
# in it.
@dataclasses.dataclass
class KVCache:
    """Dense KV cache of a ``decode=True`` model, the flax ``cache``
    collection as tensors: per layer ``key`` and ``value`` ``[B, S, H, D]``
    in ``cfg.dtype`` (``cached_key``, ``cached_value``) and the write
    cursor ``index`` ``[B]`` int32 (``cache_index``)."""
    key: list[torch.Tensor]
    value: list[torch.Tensor]
    index: list[torch.Tensor]

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int,
              device: torch.device) -> "KVCache":
        shape = (batch, cfg.max_seq_len, cfg.num_heads, cfg.head_dim)
        n = cfg.num_layers

        def kv():
            return [torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(n)]
        return cls(kv(), kv(), [torch.zeros(batch, dtype=torch.int32,
                                            device=device)
                                for _ in range(n)])


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache: per layer ``key_pool`` and ``value_pool``
    ``[kv_pool_blocks + 1, kv_block_tokens, H, D]`` in ``cfg.dtype``; the
    last row is the sink that padded positions write to."""
    key_pool: list[torch.Tensor]
    value_pool: list[torch.Tensor]

    @classmethod
    def zeros(cls, cfg: TransformerConfig,
              device: torch.device) -> "PagedKVCache":
        shape = (cfg.kv_pool_blocks + 1, cfg.kv_block_tokens,
                 cfg.num_heads, cfg.head_dim)

        def pool():
            return [torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for _ in range(cfg.num_layers)]
        return cls(pool(), pool())


def _as_index(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _with_cache_index(cache: KVCache, lengths) -> KVCache:
    """``cache`` with every layer's write cursor set to ``lengths``
    (scalar or ``[B]``): prefill() rewinds past padding with it, and the
    serving replica resets its slots.  The K/V tensors are shared."""
    b = cache.key[0].shape[0]
    device = cache.key[0].device
    index = torch.as_tensor(lengths, dtype=torch.int32,
                            device=device).expand(b)
    return dataclasses.replace(cache, index=[index.clone()
                                             for _ in cache.index])


@torch.inference_mode()
def prefill(model: TransformerLM, tokens, lengths=None
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt through a dense ``decode=True`` model into a fresh
    cache and return ``(logits [B, T, vocab], cache)``.

    ``lengths`` ([B] or scalar) gives each row's true prompt length when
    ``tokens`` is right-padded to a shared bucket: the write cursor
    rewinds to it, so the first decode_step overwrites the padding, and
    the causal mask hides the rest.  The next-token logits of row b are
    ``logits[b, lengths[b] - 1]``.  The reference's ``variables`` argument
    is the module's own parameters here."""
    if model.cfg.paged:
        raise ValueError("prefill is the dense path; a paged model "
                         "prefills through paged_apply")
    tokens = _as_index(tokens, model.device)
    cache = KVCache.zeros(model.cfg, tokens.shape[0], model.device)
    logits = model(tokens, cache=cache)
    if lengths is not None:
        cache = _with_cache_index(cache, lengths)
    return logits, cache


@torch.inference_mode()
def decode_step(model: TransformerLM, cache: KVCache, tokens
                ) -> tuple[torch.Tensor, KVCache]:
    """One incremental step: ``tokens`` [B, 1] (or [B]) -> ``(logits
    [B, 1, vocab], cache)``, each row at its own cache depth (what lets
    continuous batching admit a prefill into a half-decoded batch)."""
    tokens = _as_index(tokens, model.device)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    return model(tokens, cache=cache), cache


@torch.inference_mode()
def paged_apply(model: TransformerLM, cache: PagedKVCache, tokens,
                block_tables, cursors, lengths=None
                ) -> tuple[torch.Tensor, PagedKVCache]:
    """One paged call, prefill and decode alike: ``tokens [B, T]`` write
    into the pool through each row's ``block_tables`` entry from its
    ``cursors`` position and attend over the gathered prefix.
    ``lengths`` sends padded positions to the sink row."""
    dev = model.device
    tokens = _as_index(tokens, dev)
    if tokens.dim() == 1:
        tokens = tokens[:, None]
    logits = model(tokens, cache=cache,
                   block_tables=_as_index(block_tables, dev),
                   cursors=_as_index(cursors, dev),
                   lengths=None if lengths is None
                   else _as_index(lengths, dev))
    return logits, cache


@torch.inference_mode()
def paged_copy_block(cache: PagedKVCache, src: int, dst: int
                     ) -> PagedKVCache:
    """The tensor half of a copy-on-write: copy pool row ``src`` to
    ``dst`` in every layer (the id half is ``KVBlockPool.cow``)."""
    for pool in (*cache.key_pool, *cache.value_pool):
        pool[dst] = pool[src]
    return cache


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------
def gpt_small(**overrides) -> TransformerConfig:
    """~124M params (GPT-2 small shape)."""
    return TransformerConfig(**{**dict(
        vocab_size=50304, num_layers=12, num_heads=12, d_model=768,
        max_seq_len=1024), **overrides})


def gpt_medium(**overrides) -> TransformerConfig:
    """~350M params."""
    return TransformerConfig(**{**dict(
        vocab_size=50304, num_layers=24, num_heads=16, d_model=1024,
        max_seq_len=2048), **overrides})


def gpt_tiny(**overrides) -> TransformerConfig:
    """Test-sized config."""
    return TransformerConfig(**{**dict(
        vocab_size=256, num_layers=2, num_heads=4, d_model=64,
        max_seq_len=256), **overrides})

"""Decoder-only Transformer LM, in PyTorch: the counterpart of
``horovod_tpu/models/transformer.py``.

Same configuration, presets and mixed-precision rules as the flax model:

- parameters are ``param_dtype`` (fp32); a projection casts both its input
  and its weight to ``dtype`` (bf16) and returns ``dtype``, as flax's
  ``Dense(dtype=...)`` does; the embedding returns ``dtype``; the logits
  stay in ``dtype``;
- RMSNorm computes in fp32 and casts after multiplying by its fp32 scale;
- RoPE uses global positions and the split-halves rotation;
- attention is ``"dense"`` (``mha_reference``) or ``"flash"`` (the CUDA
  kernels of ``ops/flash_attention.py``).

Casts are explicit rather than ``torch.autocast``, which would cast at
other places.  Parameter names follow PyTorch (``layers.0.attn.wq.weight``,
Linear weights ``[out, in]``); ``convert.py`` maps them to and from the
flax tree.  Initialisation draws from flax's default distributions with a
``torch.Generator``.

The slice covers the training forward.  KV-cache decoding, paged caches,
sequence parallelism (ring/ulysses), MoE and the "dots" remat policy raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.device import resolve_device
from ..ops.flash_attention import flash_attention, mha_reference

# flax's truncated normal draws N(0, 1) cut to [-2, 2], rescaled by this
# constant so that the truncated distribution has unit variance.
_TRUNC_STD = 0.87962566103423978


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
    attention: str = "dense"          # dense | flash (ring | ulysses later)
    causal: bool = True
    remat: bool = False               # checkpoint each block
    remat_policy: str = "full"        # full ("dots" later)
    block_q: int = 128
    block_k: int = 128
    block_q_bwd: int | None = None
    block_k_bwd: int | None = None
    flash_interpret: bool = False     # JAX-only knob; must stay False here
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
    """Raise NotImplementedError for what this slice does not port yet."""
    unported = [
        (cfg.decode or cfg.paged,
         "KV-cache decoding (decode/paged) is ROADMAP queue A item 5 "
         "(serving)"),
        (cfg.attention in ("ring", "ulysses"),
         f"attention={cfg.attention!r} is ROADMAP queue A item 10 "
         "(sequence parallelism)"),
        (cfg.moe_experts > 0,
         "moe_experts > 0 is ROADMAP queue A item 10 (expert parallelism)"),
        (cfg.remat and cfg.remat_policy == "dots",
         "remat_policy='dots' is ROADMAP queue A item 6 (models, rest)"),
        (cfg.flash_interpret,
         "flash_interpret runs Pallas kernels interpreted; the port's "
         "CPU path is device='cpu'"),
    ]
    for unsupported, what in unported:
        if unsupported:
            raise NotImplementedError(what)
    if cfg.attention not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"Unknown attention impl: {cfg.attention}")
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected 'full' or 'dots')")


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
class Dense(nn.Linear):
    """Bias-free projection with flax's mixed precision: input and weight
    are cast to ``dtype`` and the product is ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        # lecun_normal: truncated normal, std sqrt(1 / fan_in).
        std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        shape = (b, t, cfg.num_heads, cfg.head_dim)
        q = self.wq(x).view(shape)
        k = self.wk(x).view(shape)
        v = self.wv(x).view(shape)
        positions = torch.arange(t, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if cfg.attention == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal,
                                  block_q=cfg.block_q, block_k=cfg.block_k,
                                  block_q_bwd=cfg.block_q_bwd,
                                  block_k_bwd=cfg.block_k_bwd,
                                  device=x.device)
        else:
            out = mha_reference(q, k, v, causal=cfg.causal)
        return self.wo(out.to(cfg.dtype).reshape(b, t, -1))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        args = (cfg.dtype, cfg.param_dtype, device)
        self.gate = Dense(cfg.d_model, cfg.ff_dim, *args)
        self.up = Dense(cfg.d_model, cfg.ff_dim, *args)
        self.down = Dense(cfg.ff_dim, cfg.d_model, *args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device) -> None:
        super().__init__()
        norm = (cfg.dtype, cfg.param_dtype)
        self.attn_norm = RMSNorm(cfg.d_model, *norm, device=device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, *norm, device=device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


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

    def init_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: Embed normal(0, 1/sqrt(d_model)), Dense
        lecun_normal, RMSNorm ones."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, self.cfg.d_model ** -0.5,
                                      generator=generator)
        for module in self.modules():
            if isinstance(module, Dense):
                module.reset_parameters(generator)
            elif isinstance(module, RMSNorm):
                module.reset_parameters()

    def forward(self, tokens: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed.weight.to(cfg.dtype)[tokens]
        for block in self.layers:
            if cfg.remat and train and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.lm_head(self.final_norm(x))


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

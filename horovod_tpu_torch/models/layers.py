"""flax's layers as the port's models use them, in PyTorch: ``Dense``,
``Conv``, ``BatchNorm``, ``max_pool`` and ``avg_pool``.

Each keeps flax's semantics where torch.nn's differ:

- parameters are ``param_dtype`` (fp32); ``Dense`` and ``Conv`` cast their
  input, weight and bias to ``dtype`` per call and return ``dtype``, as
  ``nn.Dense``/``nn.Conv(dtype=, param_dtype=)`` do;
- ``Conv`` and the pools take flax's padding.  ``"SAME"`` pads
  ``max((ceil(n/s) - 1)·s + k - n, 0)`` in all, half of it (rounded down)
  before and the rest after: a stride-2 3x3 over an even map pads (0, 1),
  where ``padding=1`` would pad (1, 1) and shift every window by a pixel.
  ``"VALID"`` pads nothing; explicit ``[(lo, hi), (lo, hi)]`` pairs are
  taken as given.  Unequal sides are padded with ``F.pad``;
- ``BatchNorm`` is ``flax.linen.BatchNorm``: in train mode it normalises
  with the batch mean and the *biased* batch variance, reduced over N, H,
  W in fp32, and moves its running statistics by
  ``ra = m·ra + (1 - m)·batch`` with that biased variance (torch's
  ``BatchNorm2d`` feeds the unbiased one into ``running_var``); in eval
  mode it uses the running statistics.  It normalises in fp32 and casts
  the result to ``dtype``.  ``F.batch_norm`` does the normalisation (its
  variance is the same biased one, summed in another order than flax's
  ``E[x²] - E[x]²``); the running update is done here;
- ``max_pool`` pads with -inf; ``avg_pool`` divides by the whole window,
  padding included (flax's ``count_include_pad=True``).

Activations are NCHW tensors in ``torch.channels_last`` memory (the
reference's NHWC), and conv weights ``[out, in, kh, kw]`` are kept in
channels_last too, so that cuDNN runs its NHWC kernels without
transposes.  Initialisation follows flax's defaults: lecun_normal kernels,
zero biases, BatchNorm scale one (or zero) and bias zero, running mean zero
and running variance one.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal draws N(0, 1) cut to [-2, 2], rescaled by this
# constant so that the truncated distribution has unit variance.
_TRUNC_STD = 0.87962566103423978

Padding = Union[str, Sequence[tuple[int, int]]]


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> None:
    """flax's lecun_normal: a normal truncated at ±2σ, std sqrt(1/fan_in)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class Dense(nn.Linear):
    """Projection with flax's mixed precision: input, weight and bias are
    cast to ``dtype`` and the product is ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 device: torch.device, bias: bool = False) -> None:
        super().__init__(in_features, out_features, bias=bias,
                         device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def _pads(padding: Padding, size: Sequence[int], window: Sequence[int],
          strides: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """(lo, hi) pads of each spatial dim, as lax.padtype_to_pads gives
    them for "SAME" and "VALID"."""
    if padding == "VALID":
        return ((0, 0),) * len(size)
    if padding == "SAME":
        pads = []
        for n, k, s in zip(size, window, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, str):
        raise ValueError(f"unknown padding {padding!r}")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _pad(x: torch.Tensor, pads: tuple[tuple[int, int], ...], value: float,
         limit: Sequence[int] | None = None
         ) -> tuple[torch.Tensor, tuple[int, int]]:
    """``x`` and the symmetric padding left for the op: equal sides go to
    the op (within ``limit``: a pool pads at most half its window), others
    are padded here with ``value``."""
    (top, bottom), (left, right) = pads
    if top == bottom and left == right and (
            limit is None or (2 * top <= limit[0] and 2 * left <= limit[1])):
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


class Conv(nn.Module):
    """2-D convolution with flax's padding and mixed precision; weight
    ``[out, in, kh, kw]`` in channels_last memory, no bias by default."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int],
                 strides: tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 device: torch.device | None = None) -> None:
        super().__init__()
        kh, kw = kernel_size
        weight = torch.empty(features, in_features, kh, kw, device=device,
                             dtype=param_dtype)
        self.weight = nn.Parameter(
            weight.contiguous(memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(features, device=device,
                                             dtype=param_dtype)) \
            if use_bias else None
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding, self.dtype = padding, dtype

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        pads = _pads(self.padding, x.shape[-2:], self.kernel_size,
                     self.strides)
        x, padding = _pad(x.to(dt), pads, 0.0)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.strides, padding)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of an NCHW tensor:
    ``forward(x, train)``.  Parameters ``scale`` and ``bias``
    (``param_dtype``), running statistics in the fp32 buffers ``mean``
    and ``var``."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 scale_init: str = "ones", axis_name: str | None = None,
                 device: torch.device | None = None) -> None:
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "cross-replica BatchNorm (axis_name) is ROADMAP queue A "
                "item 9 (the torch binding's sync_batch_norm)")
        if scale_init not in ("ones", "zeros"):
            raise ValueError(f"unknown scale_init {scale_init!r}")
        kw = dict(device=device, dtype=param_dtype)
        self.scale = nn.Parameter(torch.empty(features, **kw))
        self.bias = nn.Parameter(torch.empty(features, **kw))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale_init = scale_init
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0 if self.scale_init == "ones" else 0.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        # F.batch_norm computes in fp32 and returns its input's dtype: a
        # 16-bit input of the layer's own dtype goes in as it is, any
        # other is widened first, and the result is cast to ``dtype``.
        inp = x if x.dtype == self.dtype else x.float()
        if not train:
            y = F.batch_norm(inp, self.mean, self.var, self.scale, self.bias,
                             False, 0.0, self.epsilon)
            return y.to(self.dtype)
        # Momentum 1 writes the batch mean and the unbiased batch variance
        # into fresh buffers; flax's running update takes the biased one.
        batch_mean = torch.zeros_like(self.mean)
        batch_var = torch.zeros_like(self.var)
        y = F.batch_norm(inp, batch_mean, batch_var, self.scale, self.bias,
                         True, 1.0, self.epsilon)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.mean.mul_(m).add_(batch_mean, alpha=1 - m)
            self.var.mul_(m).add_(batch_var, alpha=(1 - m) * (n - 1) / n)
        return y.to(self.dtype)


def max_pool(x: torch.Tensor, window: tuple[int, int],
             strides: tuple[int, int] = (1, 1),
             padding: Padding = "VALID") -> torch.Tensor:
    """flax's ``nn.max_pool`` over NCHW: padding counts as -inf."""
    pads = _pads(padding, x.shape[-2:], window, strides)
    x, pad = _pad(x, pads, -math.inf, window)
    return F.max_pool2d(x, window, strides, pad)


def avg_pool(x: torch.Tensor, window: tuple[int, int],
             strides: tuple[int, int] = (1, 1),
             padding: Padding = "VALID") -> torch.Tensor:
    """flax's ``nn.avg_pool`` over NCHW: every window is divided by its full
    size, padding included."""
    pads = _pads(padding, x.shape[-2:], window, strides)
    x, pad = _pad(x, pads, 0.0, window)
    return F.avg_pool2d(x, window, strides, pad, count_include_pad=True)


def add_named(parent: nn.Module, prefix: str,
              modules: Sequence[nn.Module]) -> list[nn.Module]:
    """Register ``modules`` on ``parent`` as ``{prefix}_0, {prefix}_1, ...``,
    flax's automatic names in the order flax builds them; returns them."""
    for i, module in enumerate(modules):
        parent.add_module(f"{prefix}_{i}", module)
    return list(modules)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation of every ``Dense``, ``Conv`` and
    ``BatchNorm`` in ``model``, drawn from ``generator``."""
    for module in model.modules():
        if isinstance(module, (Dense, Conv)):
            module.reset_parameters(generator)
        elif isinstance(module, BatchNorm):
            module.reset_parameters()

"""ResNet v1.5, in PyTorch: the counterpart of
``horovod_tpu/models/resnet.py``.

Same presets, blocks, stems and rounding points as the flax model:

- the model takes the reference's NHWC batch ``[N, H, W, 3]`` and casts it
  to ``dtype`` first; ``x.permute(0, 3, 1, 2)`` of that tensor is NCHW
  with channels_last strides, the layout every layer keeps, so cuDNN runs
  its NHWC kernels;
- v1.5 stride placement (on the 3x3, not the 1x1), flax's ``"SAME"``
  padding (a stride-2 3x3 over an even map pads (0, 1), not torchvision's
  (1, 1)), the last BatchNorm of each block zero-initialised;
- the global mean over H and W is taken in ``dtype`` and the classifier
  ``head`` is an fp32 Dense;
- ``stem="space_to_depth"`` folds 2x2 cells into channels and runs a 4x4
  stride-1 conv; ``fold_conv7_stem_weights`` turns conv7 weights into it.

Submodules carry flax's names (``conv_init``, ``bn_init``,
``BottleneckBlock_0`` ... with ``Conv_0..2``, ``BatchNorm_0..2``,
``conv_proj``, ``norm_proj``, and ``head``), so ``convert.py`` maps the
two trees by path.  Cross-replica BatchNorm (``axis_name``) raises
``NotImplementedError``.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from .layers import BatchNorm, Conv, Dense, add_named, init_parameters, \
    max_pool


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/b, W/b, b*b*C], folding b×b spatial cells into
    channels (cell-major, then input-row, input-col, channel)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"space_to_depth needs H and W divisible by {block} "
            f"(got {h}x{w}); pad or resize the input")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def fold_conv7_stem_weights(w7: torch.Tensor) -> torch.Tensor:
    """[F, C, 7, 7] conv7/s2/p3 weight -> the equivalent [F, 4C, 4, 4]
    weight of a stride-1 conv over the 2×2 space-to-depth input with cell
    padding ((2, 1), (2, 1)).  A zero row and column are padded at the
    front (8×8 taps), and each 2×2 group of taps becomes one tap over the
    4C channels of a cell."""
    f, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {kh}x{kw}")
    w8 = w7.new_zeros(8, 8, c, f)
    w8[1:, 1:] = w7.permute(2, 3, 1, 0)              # [7, 7, C, F]
    w8 = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    return w8.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1).contiguous()


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""
    expansion = 1

    def __init__(self, in_features: int, filters: int, conv: Callable,
                 norm: Callable, act: Callable,
                 strides: tuple[int, int] = (1, 1)) -> None:
        super().__init__()
        self.act = act
        self.Conv_0 = conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = norm(filters, scale_init="zeros")
        self.conv_proj = self.norm_proj = None
        if tuple(strides) != (1, 1) or in_features != filters:
            self.conv_proj = conv(in_features, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), train)
        return self.act(x + y)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (strided: v1.5) -> 1x1 expand (ResNet-50+)."""
    expansion = 4

    def __init__(self, in_features: int, filters: int, conv: Callable,
                 norm: Callable, act: Callable,
                 strides: tuple[int, int] = (1, 1)) -> None:
        super().__init__()
        self.act = act
        out = filters * self.expansion
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, (1, 1))
        # Zero-init the last norm scale so that each block starts as the
        # identity (Goyal et al.), as the reference does.
        self.BatchNorm_2 = norm(out, scale_init="zeros")
        self.conv_proj = self.norm_proj = None
        if tuple(strides) != (1, 1) or in_features != out:
            self.conv_proj = conv(in_features, out, (1, 1), strides)
            self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.act(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.act(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), train)
        return self.act(x + y)


class ResNet(nn.Module):
    """Configurable ResNet v1.5: ``model(images [N, H, W, 3], train)`` ->
    fp32 logits ``[N, num_classes]``.  Built on the card unless
    ``device="cpu"``; parameters drawn from ``generator`` (or ``seed``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 act: Callable = F.relu, axis_name: str | None = None,
                 stem: str = "conv7", device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        conv = partial(Conv, use_bias=False, dtype=dtype,
                       param_dtype=param_dtype, device=dev)
        norm = partial(BatchNorm, momentum=0.9, epsilon=1e-5, dtype=dtype,
                       param_dtype=param_dtype, axis_name=axis_name,
                       device=dev)
        self.dtype, self.act, self.stem = dtype, act, stem
        if stem == "space_to_depth":
            self.conv_init = conv(12, num_filters, (4, 4),
                                  padding=[(2, 1), (2, 1)])
        elif stem == "conv7":
            self.conv_init = conv(3, num_filters, (7, 7), (2, 2),
                                  padding=[(3, 3), (3, 3)])
        else:
            raise ValueError(f"unknown stem {stem!r} "
                             "(expected 'conv7' or 'space_to_depth')")
        self.bn_init = norm(num_filters)
        blocks, width = [], num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                blocks.append(block_cls(width, filters, conv, norm, act,
                                        strides))
                width = filters * block_cls.expansion
        self.blocks = add_named(self, block_cls.__name__, blocks)
        # Classifier in fp32: small matmul, and fp32 logits keep the
        # softmax cross entropy stable.
        self.head = Dense(width, num_classes, torch.float32, param_dtype,
                          dev, bias=True)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)                 # channels_last NCHW
        x = self.act(self.bn_init(self.conv_init(x), train))
        x = max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)))
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3),
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3),
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3),
                    block_cls=BottleneckBlock)

"""Inception V3, in PyTorch: the counterpart of
``horovod_tpu/models/inception.py`` (no aux head).

Every branch is conv + BatchNorm (epsilon 1e-3) + ReLU (``ConvBN``).  The
blocks build their ``ConvBN_i`` in the order flax names them: flax names a
submodule when it is constructed, and in ``cbn(64, (5, 5))(cbn(48, (1,
1))(x))`` the outer one is constructed first, so it is ``ConvBN_1`` and the
inner one ``ConvBN_2``.  The branches are concatenated in the reference's
order along the channels (``dim=1`` of the channels_last NCHW tensors; the
reference's last axis).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from .layers import BatchNorm, Conv, Dense, Padding, add_named, avg_pool, \
    init_parameters, max_pool


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | None = None) -> None:
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, epsilon=1e-3,
                                     dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x), train))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return avg_pool(x, (3, 3), padding="SAME")


def _reduce_pool(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, (3, 3), strides=(2, 2), padding="VALID")


class _Block(nn.Module):
    """A block of ``ConvBN_i`` built from ``(in, out, kernel[, strides,
    padding])`` specs in flax's naming order."""

    def __init__(self, specs: Sequence[tuple], dtype: torch.dtype,
                 device: torch.device | None) -> None:
        super().__init__()
        self.c = add_named(self, "ConvBN", [
            ConvBN(*spec, dtype=dtype, device=device) for spec in specs])


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | None = None) -> None:
        super().__init__([(in_features, 64, (1, 1)),
                          (48, 64, (5, 5)), (in_features, 48, (1, 1)),
                          (96, 96, (3, 3)), (64, 96, (3, 3)),
                          (in_features, 64, (1, 1)),
                          (in_features, pool_features, (1, 1))],
                         dtype, device)
        self.out_features = 224 + pool_features

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.c
        b1 = c[0](x, train)
        b2 = c[1](c[2](x, train), train)
        b3 = c[3](c[4](c[5](x, train), train), train)
        b4 = c[6](_pool(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class ReductionA(_Block):
    def __init__(self, in_features: int, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | None = None) -> None:
        super().__init__([(in_features, 384, (3, 3), (2, 2), "VALID"),
                          (96, 96, (3, 3), (2, 2), "VALID"),
                          (64, 96, (3, 3)), (in_features, 64, (1, 1))],
                         dtype, device)
        self.out_features = 480 + in_features

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.c
        b1 = c[0](x, train)
        b2 = c[1](c[2](c[3](x, train), train), train)
        return torch.cat([b1, b2, _reduce_pool(x)], dim=1)


class InceptionB(_Block):
    """Factorised 7x7 block (1x7 / 7x1 pairs)."""

    def __init__(self, in_features: int, channels_7x7: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | None = None) -> None:
        c = channels_7x7
        super().__init__([(in_features, 192, (1, 1)),
                          (c, 192, (7, 1)), (c, c, (1, 7)),
                          (in_features, c, (1, 1)),
                          (in_features, c, (1, 1)), (c, c, (7, 1)),
                          (c, c, (1, 7)), (c, c, (7, 1)), (c, 192, (1, 7)),
                          (in_features, 192, (1, 1))], dtype, device)
        self.out_features = 768

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.c
        b1 = c[0](x, train)
        b2 = c[1](c[2](c[3](x, train), train), train)
        b3 = x
        for i in range(4, 9):
            b3 = c[i](b3, train)
        b4 = c[9](_pool(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class ReductionB(_Block):
    def __init__(self, in_features: int, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | None = None) -> None:
        super().__init__([(192, 320, (3, 3), (2, 2), "VALID"),
                          (in_features, 192, (1, 1)),
                          (in_features, 192, (1, 1)), (192, 192, (1, 7)),
                          (192, 192, (7, 1)),
                          (192, 192, (3, 3), (2, 2), "VALID")],
                         dtype, device)
        self.out_features = 512 + in_features

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.c
        b1 = c[0](c[1](x, train), train)
        b2 = x
        for i in range(2, 6):
            b2 = c[i](b2, train)
        return torch.cat([b1, b2, _reduce_pool(x)], dim=1)


class InceptionC(_Block):
    """Expanded-filter-bank output block (split 1x3 / 3x1 branches)."""

    def __init__(self, in_features: int, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | None = None) -> None:
        super().__init__([(in_features, 320, (1, 1)),
                          (in_features, 384, (1, 1)), (384, 384, (1, 3)),
                          (384, 384, (3, 1)),
                          (448, 384, (3, 3)), (in_features, 448, (1, 1)),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (in_features, 192, (1, 1))], dtype, device)
        self.out_features = 2048

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.c
        b1 = c[0](x, train)
        b2 = c[1](x, train)
        b2 = torch.cat([c[2](b2, train), c[3](b2, train)], dim=1)
        b3 = c[4](c[5](x, train), train)
        b3 = torch.cat([c[6](b3, train), c[7](b3, train)], dim=1)
        b4 = c[8](_pool(x), train)
        return torch.cat([b1, b2, b3, b4], dim=1)


class InceptionV3(nn.Module):
    """``model(images [N, 299, 299, 3], train)`` -> fp32 logits.  Built on
    the card unless ``device="cpu"``; parameters drawn from ``generator``
    (or ``seed``)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=dev)
        # Stem: 299x299x3 -> 35x35x192.
        self.c = add_named(self, "ConvBN", [
            ConvBN(3, 32, (3, 3), (2, 2), "VALID", **kw),
            ConvBN(32, 32, (3, 3), padding="VALID", **kw),
            ConvBN(32, 64, (3, 3), **kw),
            ConvBN(64, 80, (1, 1), padding="VALID", **kw),
            ConvBN(80, 192, (3, 3), padding="VALID", **kw)])
        # 3x InceptionA -> ReductionA -> 4x InceptionB -> ReductionB ->
        # 2x InceptionC (the V3 layer plan).
        self.blocks, width = [], 192
        for cls, args in ((InceptionA, [(32,), (64,), (64,)]),
                          (ReductionA, [()]),
                          (InceptionB, [(128,), (160,), (160,), (192,)]),
                          (ReductionB, [()]),
                          (InceptionC, [(), ()])):
            made = []
            for a in args:
                made.append(cls(width, *a, **kw))
                width = made[-1].out_features
            self.blocks += add_named(self, cls.__name__, made)
        self.head = Dense(width, num_classes, torch.float32, torch.float32,
                          dev, bias=True)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        init_parameters(self, generator)

    def stem(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The layers before the first InceptionA, over channels_last
        NCHW in ``dtype``."""
        c = self.c
        x = c[2](c[1](c[0](x, train), train), train)
        x = _reduce_pool(x)
        x = c[4](c[3](x, train), train)
        return _reduce_pool(x)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.stem(x.to(self.dtype).permute(0, 3, 1, 2), train)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3))                    # global average pool
        return self.head(x.float())

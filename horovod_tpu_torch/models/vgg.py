"""VGG, in PyTorch: the counterpart of ``horovod_tpu/models/vgg.py``.

BatchNorm after every conv (the "VGG-BN" variant; without it each conv
has a bias), ``"SAME"`` 3x3 convs, 2x2/2 ``"VALID"`` max pools, two
4096-wide ``dtype`` Dense layers with bias and an fp32 ``head``.  The
flatten before the first Dense is in NHWC order, as the reference
reshapes its ``[N, 7, 7, 512]`` map, so that the 25088x4096 kernel carries
across as a plain transpose.  Those two layers hold about 100 M
parameters: VGG is the reference's fusion stress test.

flax infers the first Dense's width from the input; the port builds it
eagerly, so ``VGG`` takes the ``image_size`` it will see (224 by
default).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from .layers import BatchNorm, Conv, Dense, add_named, init_parameters, \
    max_pool

# Stage plan: (convs per stage, filters); a max pool ends each stage.
_VGG16_STAGES: tuple[tuple[int, int], ...] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
_VGG19_STAGES: tuple[tuple[int, int], ...] = (
    (2, 64), (2, 128), (4, 256), (4, 512), (4, 512))


class VGG(nn.Module):
    """``model(images [N, image_size, image_size, 3], train)`` -> fp32
    logits.  Built on the card unless ``device="cpu"``; parameters drawn
    from ``generator`` (or ``seed``)."""

    def __init__(self, stages: Sequence[tuple[int, int]],
                 num_classes: int = 1000, batch_norm: bool = True,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        convs, norms, width, size = [], [], 3, image_size
        for n_convs, filters in stages:
            for _ in range(n_convs):
                convs.append(Conv(width, filters, (3, 3), padding="SAME",
                                  use_bias=not batch_norm, dtype=dtype,
                                  device=dev))
                if batch_norm:
                    norms.append(BatchNorm(filters, momentum=0.9,
                                           epsilon=1e-5, dtype=dtype,
                                           device=dev))
                width = filters
            size //= 2
        self.convs = add_named(self, "Conv", convs)
        self.norms = add_named(self, "BatchNorm", norms)
        self.stages = [n for n, _ in stages]
        # The (convs, filters) plan, the reference's ``stages`` (the FLOP
        # count of telemetry/perfmodel.py walks it).
        self.stage_plan = tuple((n, f) for n, f in stages)
        dense = [Dense(size * size * width, 4096, dtype, torch.float32, dev,
                       bias=True),
                 Dense(4096, 4096, dtype, torch.float32, dev, bias=True)]
        self.dense = add_named(self, "Dense", dense)
        self.head = Dense(4096, num_classes, torch.float32, torch.float32,
                          dev, bias=True)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # channels_last NCHW
        i = 0
        for n_convs in self.stages:
            for _ in range(n_convs):
                x = self.convs[i](x)
                if self.norms:
                    x = self.norms[i](x, train)
                x = F.relu(x)
                i += 1
            x = max_pool(x, (2, 2), strides=(2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        for dense in self.dense:
            x = F.relu(dense(x))
        return self.head(x)


VGG16 = partial(VGG, stages=_VGG16_STAGES)
VGG19 = partial(VGG, stages=_VGG19_STAGES)

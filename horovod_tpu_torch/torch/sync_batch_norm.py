"""Cross-rank synchronized batch normalization for torch (the port's copy
of ``horovod_tpu/torch/sync_batch_norm.py``; upstream
horovod/torch/sync_batch_norm.py:40-218).

The batch statistics are combined across all ranks in the forward pass
(an allgather of each rank's sums and count) and the reduction terms of
the gradient are allreduced in the backward pass, so the layer behaves as
if the global batch lived on one device.  The statistics travel on the
input's device: on the card they ride the NCCL device plane.  Weight and
bias gradients stay local: ``DistributedOptimizer`` allreduces them like
every other gradient.  In a world of one the layer is ``F.batch_norm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _BatchNorm

from ..eager import Sum, size
from .mpi_ops import allgather, allreduce


class SyncBatchNorm(_BatchNorm):
    """Drop-in `nn.BatchNorm*d` replacement with cross-rank statistics."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, input):
        self._check_input_dim(input)
        if not self.training and self.track_running_stats:
            return F.batch_norm(input, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        if size() <= 1:
            return F.batch_norm(input, self.running_mean, self.running_var,
                                self.weight, self.bias, True,
                                self.momentum, self.eps)
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, self.momentum)


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum):
        c = input.shape[1]
        reduce_dims = [0] + list(range(2, input.dim()))
        count = input.numel() // c

        local_mean = input.mean(dim=reduce_dims)
        local_sqmean = (input * input).mean(dim=reduce_dims)

        # Combine stats across ranks, weighting by per-rank element count
        # (supports uneven local batches, reference: sync_batch_norm.py
        # allgathers count tensors).
        packed = torch.cat([local_mean.float() * count,
                            local_sqmean.float() * count,
                            torch.tensor([float(count)],
                                         device=input.device)])
        gathered = allgather(packed.unsqueeze(0), name=f"syncbn.{c}")
        totals = gathered.sum(dim=0)
        total_count = totals[-1]
        mean = totals[:c] / total_count
        sqmean = totals[c:2 * c] / total_count
        var = sqmean - mean * mean
        invstd = torch.rsqrt(var + eps)

        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * (total_count / (total_count - 1))
                running_mean.mul_(1 - momentum).add_(
                    mean.to(running_mean.dtype), alpha=momentum)
                running_var.mul_(1 - momentum).add_(
                    unbiased.to(running_var.dtype), alpha=momentum)

        shape = [1, c] + [1] * (input.dim() - 2)
        xhat = (input - mean.view(shape).to(input.dtype)) \
            * invstd.view(shape).to(input.dtype)
        out = xhat
        if weight is not None:
            out = out * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, total_count)
        return out

    @staticmethod
    def backward(ctx, grad_output):
        xhat, weight, invstd, total_count = ctx.saved_tensors
        c = grad_output.shape[1]
        reduce_dims = [0] + list(range(2, grad_output.dim()))
        shape = [1, c] + [1] * (grad_output.dim() - 2)

        dxhat = grad_output
        if weight is not None:
            dxhat = grad_output * weight.view(shape)

        # Global reduction terms (reference allreduces sum_dy /
        # sum_dy_xmu, sync_batch_norm.py backward).
        sum_dxhat = dxhat.sum(dim=reduce_dims)
        sum_dxhat_xhat = (dxhat * xhat).sum(dim=reduce_dims)
        packed = torch.stack([sum_dxhat.float(), sum_dxhat_xhat.float()])
        packed = allreduce(packed, op=Sum, name=f"syncbn.bwd.{c}")
        sum_dxhat, sum_dxhat_xhat = packed[0], packed[1]

        n = total_count
        grad_input = (dxhat
                      - (sum_dxhat / n).view(shape).to(dxhat.dtype)
                      - xhat * (sum_dxhat_xhat / n).view(shape).to(
                          dxhat.dtype)) \
            * invstd.view(shape).to(dxhat.dtype)

        grad_weight = grad_bias = None
        if weight is not None:
            grad_weight = (grad_output * xhat).sum(dim=reduce_dims) \
                .to(weight.dtype)
            grad_bias = grad_output.sum(dim=reduce_dims).to(weight.dtype)
        return grad_input, grad_weight, grad_bias, None, None, None, None

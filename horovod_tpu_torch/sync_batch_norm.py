# Ported from horovod_tpu/torch/sync_batch_norm.py:1-159.
"""Cross-rank synchronized batch normalization.

Parity: reference ``horovod/torch/sync_batch_norm.py`` — a drop-in
``_BatchNorm`` subclass whose training-mode statistics are computed over the
GLOBAL batch (all ranks), via one allreduce of per-rank sums in forward and
one of gradient sums in backward, both through the collective engine.  The
statistics stay on the input's device, and the per-channel sums are taken
in float32 whatever the input's dtype (the JAX package's binding sums in
the input's dtype, on the host, and then converts).
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch.autograd.function import Function
from torch.nn.modules.batchnorm import _BatchNorm

from . import mpi_ops
from .common import basics
from .ops.eager import register_name_counter_reset

# Collective names must be identical across ranks for negotiation to match;
# every rank executes the same module sequence, so call-order counters align
# (and restart together with the runtime).
_fwd_counter = itertools.count(0)
_bwd_counter = itertools.count(0)


def _reset_counters():
    global _fwd_counter, _bwd_counter
    _fwd_counter = itertools.count(0)
    _bwd_counter = itertools.count(0)


register_name_counter_reset(_reset_counters)


class SyncBatchNorm(_BatchNorm):
    """BatchNorm with statistics synchronized across all ranks.

    In eval mode (or at world size 1) it is exactly ``torch.nn.BatchNorm*``;
    in training mode mean and variance come from the global batch.
    """

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_set=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self.process_set = process_set

    def _run_bn(self, input):
        return F.batch_norm(
            input, self.running_mean, self.running_var, self.weight,
            self.bias, self.training or not self.track_running_stats,
            self.momentum, self.eps)

    def forward(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")
        if not (self.training and
                (basics.is_initialized() and basics.size() > 1)):
            return self._run_bn(input)
        if self.num_batches_tracked is not None:
            self.num_batches_tracked = self.num_batches_tracked + 1
        # momentum=None is _BatchNorm's cumulative-moving-average mode.
        momentum = self.momentum
        if momentum is None:
            momentum = (1.0 / float(self.num_batches_tracked)
                        if self.num_batches_tracked is not None else 0.1)
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, momentum, self.process_set)


class _SyncBatchNormFn(Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var, eps,
                momentum, process_set):
        c = input.shape[1]
        reduce_dims = [0] + list(range(2, input.dim()))
        x = input.float()
        # One fused allreduce for [sum, sqsum, count]: exact for per-rank
        # batch sizes that differ.
        stats = torch.empty(2 * c + 1, dtype=torch.float32,
                            device=input.device)
        stats[:c] = x.sum(dim=reduce_dims)
        stats[c:2 * c] = (x * x).sum(dim=reduce_dims)
        stats[2 * c] = float(input.numel() // c)
        g = mpi_ops.allreduce(stats, op=mpi_ops.Sum,
                              name=f"sync_bn.fwd.{next(_fwd_counter)}",
                              process_set=process_set)
        total = g[2 * c].clamp(min=1.0)
        mean = g[:c] / total
        var = (g[c:2 * c] / total - mean * mean).clamp(min=0.0)

        if running_mean is not None:
            unbiased = var * (total / (total - 1.0).clamp(min=1.0))
            running_mean.mul_(1 - momentum).add_(mean.to(running_mean.dtype),
                                                 alpha=momentum)
            running_var.mul_(1 - momentum).add_(unbiased.to(running_var.dtype),
                                                alpha=momentum)

        shape = [1, c] + [1] * (input.dim() - 2)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        out = xhat
        if weight is not None:
            out = out * weight.float().reshape(shape)
        if bias is not None:
            out = out + bias.float().reshape(shape)
        ctx.save_for_backward(xhat, weight, invstd, total)
        ctx.process_set = process_set
        ctx.has_bias = bias is not None
        return out.to(input.dtype)

    @staticmethod
    def backward(ctx, grad_output):
        xhat, weight, invstd, total = ctx.saved_tensors
        c = xhat.shape[1]
        reduce_dims = [0] + list(range(2, xhat.dim()))
        shape = [1, c] + [1] * (xhat.dim() - 2)

        go = grad_output.float()
        # Local per-channel gradient sums, then one fused global Sum.
        sums = torch.empty(2 * c, dtype=torch.float32, device=go.device)
        sums[:c] = go.sum(dim=reduce_dims)
        sums[c:] = (go * xhat).sum(dim=reduce_dims)
        g = mpi_ops.allreduce(sums, op=mpi_ops.Sum,
                              name=f"sync_bn.bwd.{next(_bwd_counter)}",
                              process_set=ctx.process_set)
        sum_dy = g[:c]
        sum_dy_xhat = g[c:]

        # The affine parameters' gradients stay local: the optimizer's
        # allreduce averages them, as for every other parameter.
        grad_weight = (go * xhat).sum(dim=reduce_dims) \
            if weight is not None else None
        grad_bias = go.sum(dim=reduce_dims) if ctx.has_bias else None

        w = weight.float().reshape(shape) if weight is not None else 1.0
        gx = (w * invstd.reshape(shape)) * (
            go - (sum_dy / total).reshape(shape)
            - xhat * (sum_dy_xhat / total).reshape(shape))
        return (gx.to(grad_output.dtype),
                grad_weight.to(weight.dtype) if weight is not None else None,
                grad_bias, None, None, None, None, None)

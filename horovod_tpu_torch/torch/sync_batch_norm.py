"""Cross-rank synchronized BatchNorm (counterpart of
``horovod_tpu/torch/sync_batch_norm.py``; parity:
horovod/torch/sync_batch_norm.py ``SyncBatchNorm``).

Training-mode statistics are computed over the global batch: the local
(sum, sum of squares, count) are summed across ranks with one packed
allreduce (``sync_bn.stats``), and the backward pass allreduces the two
reduction terms of the batchnorm gradient (Σdy, Σdy·x̂) with another
(``sync_bn.grad``), both through ``mpi_ops.allreduce`` with ``op=Sum``.
At one rank and in eval mode it is plain ``_BatchNorm``.

One departure: the reference builds the count as a CPU tensor, which
cannot be concatenated with a card tensor; here it is made on the
input's device.
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..core import state as core_state
from . import mpi_ops


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``torch.nn.BatchNorm*d`` with cross-rank statistics."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_set=None):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self._process_set = process_set

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)"
            )

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(input)
        if not self.training or core_state.size() == 1:
            # eval mode / single rank: vanilla batchnorm semantics
            return super().forward(input)
        # momentum=None is torch's cumulative-moving-average mode: the
        # effective factor is 1/num_batches_tracked.
        if self.track_running_stats and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                factor = 1.0 / float(self.num_batches_tracked)
            else:
                factor = self.momentum
        else:
            factor = 0.0 if self.momentum is None else self.momentum
        return _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, factor, self._process_set,
        )


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, running_mean, running_var,
                eps, momentum, process_set):
        c = input.shape[1]
        reduce_dims = [0] + list(range(2, input.dim()))
        x = input.float()
        local_count = x.numel() // c
        local_sum = x.sum(dim=reduce_dims)
        local_sqsum = (x * x).sum(dim=reduce_dims)

        packed = torch.cat([
            local_sum, local_sqsum,
            torch.tensor([float(local_count)], device=x.device),
        ])
        packed = mpi_ops.allreduce(packed, op=mpi_ops.Sum,
                                   name="sync_bn.stats",
                                   process_set=process_set)
        g_sum, g_sqsum = packed[:c], packed[c:2 * c]
        g_count = packed[2 * c].item()

        mean = g_sum / g_count
        var = g_sqsum / g_count - mean * mean
        invstd = torch.rsqrt(var + eps)

        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * g_count / max(g_count - 1, 1)
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(momentum * unbiased)

        shape = [1, c] + [1] * (input.dim() - 2)
        x_hat = (x - mean.view(shape)) * invstd.view(shape)
        out = x_hat
        if weight is not None:
            out = out * weight.view(shape).float()
        if bias is not None:
            out = out + bias.view(shape).float()

        ctx.save_for_backward(x_hat, weight, mean, invstd)
        ctx.g_count = g_count
        ctx.process_set = process_set
        ctx.reduce_dims = reduce_dims
        ctx.shape = shape
        return out.to(input.dtype)

    @staticmethod
    def backward(ctx, grad_output):
        x_hat, weight, mean, invstd = ctx.saved_tensors
        g = grad_output.float()
        reduce_dims, shape = ctx.reduce_dims, ctx.shape
        c = x_hat.shape[1]

        sum_dy = g.sum(dim=reduce_dims)
        sum_dy_xhat = (g * x_hat).sum(dim=reduce_dims)

        # the weight and bias gradients are local sums: the data-parallel
        # reduction (DistributedOptimizer) reduces them as any other
        # parameter's.  With affine=False the forward's weight and bias
        # are None, and autograd wants None gradients there.
        grad_weight = (sum_dy_xhat
                       if weight is not None and ctx.needs_input_grad[1]
                       else None)
        grad_bias = sum_dy if ctx.needs_input_grad[2] else None

        packed = torch.cat([sum_dy, sum_dy_xhat])
        packed = mpi_ops.allreduce(packed, op=mpi_ops.Sum,
                                   name="sync_bn.grad",
                                   process_set=ctx.process_set)
        g_sum_dy, g_sum_dy_xhat = packed[:c], packed[c:]

        n = ctx.g_count
        w = (weight.view(shape).float() if weight is not None else 1.0)
        grad_input = (
            w * invstd.view(shape) * (
                g - (g_sum_dy.view(shape)
                     + x_hat * g_sum_dy_xhat.view(shape)) / n
            )
        ).to(grad_output.dtype)

        return (grad_input, grad_weight, grad_bias,
                None, None, None, None, None)

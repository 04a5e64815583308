"""``TpuBatchNorm`` in PyTorch.

Counterpart of ``horovod_tpu/models/tpu_norm.py``: flax BatchNorm's
function over the channel axis of an NCHW tensor, its statistics over the
flattened ``(N*H*W, C)`` view.

* Statistics in float32 whatever the compute dtype: the mean and the mean
  of squares, the variance ``max(mean_sq - mean^2, 0)`` (biased).
* ``axis_name`` (with ``mesh=``, a ``DeviceMesh`` holding that axis; the
  world mesh by default): synchronized BatchNorm, the moments (not the
  variances) averaged over the axis by ``parallel/_collectives.pmean``,
  whose backward is its exact adjoint, as ``lax.pmean``'s is.  Every rank
  of the axis calls each layer in the same order.
* Running stats in flax's sense: ``ra = momentum * ra + (1 - momentum) *
  stat``, the variance biased; updated in training only, where
  ``update_running`` is true (a recomputation under ``remat`` leaves them
  alone).  ``eval()`` normalizes by them.
* ``(mean, inv, bias)`` fold into per-channel ``(a, b)`` in float32, then
  ``x * a + b`` in the compute dtype.

The reference's class defaults are kept (``momentum=0.99``,
``epsilon=1e-5``); the models pass their own (ResNet 0.9 / 1e-5,
Inception 0.9 / 1e-3).  ``BatchNorm`` is another name of the class.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class TpuBatchNorm(nn.Module):
    """flax-BatchNorm semantics over dim 1 of an NCHW tensor; float32
    ``scale`` / ``bias`` and ``mean`` / ``var`` buffers."""

    def __init__(self, features: int, zero_init: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None, *,
                 momentum: float = 0.99, epsilon: float = 1e-5,
                 axis_name: Optional[str] = None, mesh=None):
        super().__init__()
        self.dtype, self.zero_init = dtype, zero_init
        self.momentum, self.epsilon = momentum, epsilon
        self.axis_name, self.mesh = axis_name, mesh
        self.update_running = True
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def reset_parameters(self, generator=None):
        del generator
        if self.scale.is_meta:
            return
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        if self.training:
            x2 = x.permute(0, 2, 3, 1).reshape(-1, c)
            mean = x2.mean(dim=0, dtype=torch.float32)
            mean_sq = x2.float().square().mean(dim=0)
            if self.axis_name is not None:
                from ..parallel._collectives import pmean

                mean = pmean(mean, self.axis_name, mesh=self.mesh)
                mean_sq = pmean(mean_sq, self.axis_name, mesh=self.mesh)
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            if self.update_running:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        shift = -mean * inv + self.bias
        a = inv.to(self.dtype).view(1, c, 1, 1)
        b = shift.to(self.dtype).view(1, c, 1, 1)
        return (x * a + b).to(self.dtype)


BatchNorm = TpuBatchNorm

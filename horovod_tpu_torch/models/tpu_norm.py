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
* ``forward(x, residual=None, relu=False)`` also takes the layer's
  epilogue: ``F.relu(residual + bn(x))``, ``F.relu(bn(x))``; the models
  call it through ``norm_relu``, which keeps a norm module swapped in for
  this one (``forward(x)`` alone) working.  It is
  ``ops/norm.py`` ``fused_norm``: on a CPU tensor the eager composition
  (``batch_norm_plain``), on a CUDA tensor the kernels of
  ``csrc/norm.cu`` (statistics, normalize and epilogue, and their
  backward) under one autograd node.

The reference's class defaults are kept (``momentum=0.99``,
``epsilon=1e-5``); the models pass their own (ResNet 0.9 / 1e-5,
Inception 0.9 / 1e-3).  ``BatchNorm`` is another name of the class.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import fused_norm


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

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                relu: bool = False) -> torch.Tensor:
        """The norm of ``x``; then ``residual + y`` where a residual is
        given, and the ReLU where ``relu``: ``F.relu(residual + bn(x))`` as
        one call."""
        return fused_norm(
            x, self.scale, self.bias, self.mean, self.var,
            training=self.training, update_running=self.update_running,
            momentum=self.momentum, epsilon=self.epsilon, dtype=self.dtype,
            residual=residual, relu=relu, axis_name=self.axis_name,
            mesh=self.mesh)


def norm_relu(norm: nn.Module, x: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(residual + norm(x))`` (``relu(norm(x))`` without a
    residual): one call of a ``TpuBatchNorm``, its fused epilogue; a norm
    swapped in from elsewhere (``hvd.SyncBatchNorm``, ``nn.BatchNorm2d``)
    takes ``x`` alone and the epilogue follows in torch."""
    if isinstance(norm, TpuBatchNorm):
        return norm(x, residual=residual, relu=True)
    y = norm(x)
    return F.relu(y if residual is None else residual + y)


BatchNorm = TpuBatchNorm

"""ResNet v1.5 (bottleneck) in PyTorch.

Counterpart of ``horovod_tpu/models/resnet.py`` (``ResNet`` with
``BottleneckBlock``) and ``horovod_tpu/models/tpu_norm.py``
(``TpuBatchNorm``), computing the same function:

* The public input is NHWC, as in JAX; inside, activations are NCHW views
  in channels-last memory.
* ``padding="SAME"`` is flax's: the total padding ``(out-1)*s + k - in``
  splits as ``(total//2, total - total//2)``, so the 7x7/2 stem on 224
  pads (2, 3) and a 3x3/2 conv on an even size pads (0, 1); max-pool pads
  with -inf.  PyTorch's symmetric padding computes a different function,
  so asymmetric cases pad explicitly.
* ``BatchNorm`` is ``TpuBatchNorm``: float32 statistics over the
  flattened (N*H*W, C) view, the running variance from the *biased*
  batch variance, momentum 0.9 in the flax sense, then ``x*a + b`` in
  the compute dtype with (a, b) folded in float32.
* Parameters are float32 and cast to ``dtype`` per call (explicit casts,
  not autocast, so bfloat16 rounds where JAX rounds); the Dense layer
  and the logits are float32.
* The last BatchNorm scale of each block starts at zero.
* Submodule names follow the flax scope names (``conv_init``,
  ``BottleneckBlock_3.Conv_1``, ``TpuBatchNorm_2``, ``Dense_0``...), so
  ``weights.resnet_params_from_jax`` maps parameters one to one.

Convolutions are cuDNN calls, as XLA computed them outside any Pallas
kernel in the JAX package.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978
# the flax ResNet's BatchNorm settings (horovod_tpu/models/resnet.py:135)
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    with torch.no_grad():
        w.copy_(cpu)


class Conv(nn.Module):
    """Bias-free conv with flax ``padding="SAME"``; float32 OIHW weight
    cast to ``dtype`` per call."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel, kernel, dtype=torch.float32,
            device=device))

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        _lecun_normal_(self.weight, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel, self.stride
        h0, h1 = _same_pads(x.shape[2], k, s)
        w0, w1 = _same_pads(x.shape[3], k, s)
        w = self.weight.to(self.dtype)
        if h0 == h1 and w0 == w1:
            return F.conv2d(x, w, stride=s, padding=(h0, w0))
        return F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, stride=s)


class BatchNorm(nn.Module):
    """``TpuBatchNorm`` over the channel axis of an NCHW tensor."""

    def __init__(self, features: int, zero_init: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype, self.zero_init = dtype, zero_init
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def reset_parameters(self, generator=None):
        del generator
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
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPSILON) * self.scale
        shift = -mean * inv + self.bias
        a = inv.to(self.dtype).view(1, c, 1, 1)
        b = shift.to(self.dtype).view(1, c, 1, 1)
        return (x * a + b).to(self.dtype)


class BottleneckBlock(nn.Module):
    """ResNet v1.5 bottleneck (stride on the 3x3, as in torchvision)."""

    def __init__(self, in_ch: int, filters: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(in_ch, filters, 1, **kw)
        self.TpuBatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.TpuBatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, filters * 4, 1, **kw)
        self.TpuBatchNorm_2 = BatchNorm(filters * 4, zero_init=True, **kw)
        if stride != 1 or in_ch != filters * 4:
            self.conv_proj = Conv(in_ch, filters * 4, 1, stride, **kw)
            self.norm_proj = BatchNorm(filters * 4, **kw)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.TpuBatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.TpuBatchNorm_1(self.Conv_1(y)))
        y = self.TpuBatchNorm_2(self.Conv_2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


def _max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    h0, h1 = _same_pads(x.shape[2], k, s)
    w0, w1 = _same_pads(x.shape[3], k, s)
    if h0 or h1 or w0 or w1:
        x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, k, s)


class ResNet(nn.Module):
    """ResNet v1.5 with bottleneck blocks; input NHWC, logits float32."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv_init = Conv(3, num_filters, 7, 2, **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        self.block_names = []
        in_ch = num_filters
        for i, block_size in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(block_size):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"BottleneckBlock_{len(self.block_names)}"
                self.add_module(name, BottleneckBlock(in_ch, filters,
                                                      stride, **kw))
                self.block_names.append(name)
                in_ch = filters * 4
        self.Dense_0 = nn.Linear(in_ch, num_classes, dtype=torch.float32,
                                 device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(generator)
        _lecun_normal_(self.Dense_0.weight, self.Dense_0.in_features,
                       generator)
        with torch.no_grad():
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view in channels-last memory
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = _max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x.float())


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])

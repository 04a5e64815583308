"""ResNet v1.5 (He et al., arXiv:1512.03385; the stride on the 3x3 conv
of the bottleneck) in plain PyTorch, the frozen reference of the
``resnet`` configurations.

The input is an NHWC batch; inside, NCHW in the compute dtype.  The stem
is a 7x7/2 convolution, the norm, a ReLU and a 3x3/2 max pool; then the
bottleneck blocks of ``stage_sizes`` with ``num_filters * 2**i`` filters
(x4 out), a projection (1x1 conv and norm) where the shape changes; the
mean over the map in float32, and the logits by a float32 dense layer.

Departures from the paper, each also in the program it is held against:
flax's ``SAME`` padding (a strided conv on an even size pads one more on
the far side; the stem pads (2, 3)), the norm's variance as ``E[x^2] -
E[x]^2`` clipped at 0, and the logits layer in float32.  Parameter names
are the flax scope names (``conv_init``, ``BottleneckBlock_3.Conv_1``,
``Dense_0``...), so one state dict of weights serves both sides.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, Dense, Norm, max_pool_same, nhwc_input

EPS = 1e-5


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, device=None):
        super().__init__()
        cout = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, device=device)
        self.TpuBatchNorm_0 = Norm(filters, EPS, device)
        self.Conv_1 = Conv(filters, filters, 3, stride, device=device)
        self.TpuBatchNorm_1 = Norm(filters, EPS, device)
        self.Conv_2 = Conv(filters, cout, 1, device=device)
        self.TpuBatchNorm_2 = Norm(cout, EPS, device)
        if stride != 1 or cin != cout:
            self.conv_proj = Conv(cin, cout, 1, stride, device=device)
            self.norm_proj = Norm(cout, EPS, device)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        # the control "fp8_branches": fp8 in the branch's convolutions
        # alone, the projection and the norms as stated
        p, q = (("fp8", "bf16") if precision == "fp8_branches"
                else (precision, precision))
        y = F.relu(self.TpuBatchNorm_0(self.Conv_0(x, p), q))
        y = F.relu(self.TpuBatchNorm_1(self.Conv_1(y, p), q))
        y = self.TpuBatchNorm_2(self.Conv_2(y, p), q)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x, q), q)
        return F.relu(x + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_filters: int = 64,
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.channels_last = False
        self.conv_init = Conv(3, num_filters, 7, 2, device=device)
        self.bn_init = Norm(num_filters, EPS, device)
        self.blocks = []
        cin = num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"BottleneckBlock_{len(self.blocks)}"
                self.add_module(name, Bottleneck(cin, num_filters * 2 ** i,
                                                 stride, device))
                self.blocks.append(name)
                cin = num_filters * 2 ** i * 4
        self.Dense_0 = Dense(cin, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor, precision: str = "bf16"
                ) -> torch.Tensor:
        x = nhwc_input(x, self.dtype, self.channels_last)
        outer = "bf16" if precision == "fp8_branches" else precision
        x = F.relu(self.bn_init(self.conv_init(x, outer), outer))
        x = max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x, precision)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x, outer)


def build(config: dict, device=None) -> ResNet:
    return ResNet(config["stage_sizes"], config["num_filters"],
                  config["num_classes"],
                  getattr(torch, config["compute_dtype"]), device)

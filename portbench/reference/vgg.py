"""VGG (Simonyan & Zisserman, arXiv:1409.1556; configuration D is
VGG-16) in plain PyTorch, the frozen reference of the ``vgg``
configurations.

3x3 convolutions with bias, padded to keep the size, each followed by a
ReLU, a 2x2/2 max pool after each stage; the map flattened in (h, w, c)
order; two dense layers (4096 wide in the paper) with ReLUs in the
compute dtype and the logits in float32.  The stages' depths and widths
and the dense width are the configuration's.

Departures from the paper, each also in the program it is held against:
no dropout (a random mask per step would leave nothing to compare), the
flatten in NHWC order, the logits layer in float32.  Parameter names are
the program's (``conv{stage}_{i}``, ``Dense_0``...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, Dense, nhwc_input

class VGG(nn.Module):
    def __init__(self, stages: Sequence[int], widths: Sequence[int],
                 dense_width: int, image_size: int = 224,
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.channels_last = False
        self.convs = []
        cin, side = 3, image_size
        for s, (reps, width) in enumerate(zip(stages, widths)):
            for i in range(reps):
                name = f"conv{s}_{i}"
                self.add_module(name, Conv(cin, width, 3, bias=True,
                                           device=device))
                self.convs.append((name, i == reps - 1))
                cin = width
            side //= 2
        self.Dense_0 = Dense(cin * side * side, dense_width, dtype, device)
        self.Dense_1 = Dense(dense_width, dense_width, dtype, device)
        self.Dense_2 = Dense(dense_width, num_classes, torch.float32, device)

    def forward(self, x: torch.Tensor, precision: str = "bf16"
                ) -> torch.Tensor:
        x = nhwc_input(x, self.dtype, self.channels_last)
        for name, pool in self.convs:
            x = F.relu(getattr(self, name)(x, precision))
            if pool:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x, precision))
        x = F.relu(self.Dense_1(x, precision))
        return self.Dense_2(x, precision)


def build(config: dict, device=None) -> VGG:
    return VGG(config["stages"], config["widths"], config["dense_width"],
               config["image_size"], config["num_classes"],
               getattr(torch, config["compute_dtype"]), device)

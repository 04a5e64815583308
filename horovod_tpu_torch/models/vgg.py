"""VGG in PyTorch.

Counterpart of ``horovod_tpu/models/vgg.py`` (``VGG``, ``VGG16``,
``VGG19``), computing the same function: 3x3 ``SAME`` convs with bias
named ``conv{stage}_{i}``, each followed by a ReLU, a 2x2/2 max pool a
stage, then the 4096-wide Dense stack (``Dense_0``, ``Dense_1``) in the
compute dtype and the logits (``Dense_2``) in float32.

The flatten before ``Dense_0`` is flax's ``x.reshape(n, -1)`` of an NHWC
activation: the port's activations are NCHW views, so they are flattened
in (h, w, c) order (``_layers.flatten_nhwc``), and a kernel carried from
flax maps row for row.  Torch needs the first Dense layer's width when
the model is made: it follows from ``image_size`` (224 by default; the
last map is ``image_size / 32`` on a side).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._layers import (
    Conv,
    Dense,
    flatten_nhwc,
    max_pool,
    nhwc_to_nchw,
    reset_all,
)

# Each entry: number of 3x3 convs in the stage, then a 2x2/2 max pool.
_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """VGG-``depth``; input NHWC of ``image_size`` on a side, logits
    float32.  ``device="meta"`` makes the shapes alone."""

    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None, *,
                 image_size: int = 224):
        super().__init__()
        self.dtype = dtype
        self.conv_names = []
        in_ch, size = 3, image_size
        for stage, (reps, width) in enumerate(zip(_CFG[depth], _WIDTHS)):
            for i in range(reps):
                name = f"conv{stage}_{i}"
                self.add_module(name, Conv(in_ch, width, 3, dtype=dtype,
                                           device=device, use_bias=True))
                self.conv_names.append((name, i == reps - 1))
                in_ch = width
            size //= 2
        if size < 1:
            raise ValueError(f"image_size {image_size}: the last of 5 "
                             "max pools leaves no pixel")
        self.Dense_0 = Dense(in_ch * size * size, 4096, dtype, device)
        self.Dense_1 = Dense(4096, 4096, dtype, device)
        self.Dense_2 = Dense(4096, num_classes, torch.float32, device)
        reset_all(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x, self.dtype)
        for name, pool in self.conv_names:
            x = F.relu(getattr(self, name)(x))
            if pool:
                x = max_pool(x, 2, 2)
        x = flatten_nhwc(x)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


VGG16 = functools.partial(VGG, depth=16)
VGG19 = functools.partial(VGG, depth=19)

"""Small MLP classifier in PyTorch.

Counterpart of ``horovod_tpu/models/mlp.py`` (``MLP``): flatten the
input, a ReLU Dense layer a width of ``features``, then the logits;
float32 throughout, layers ``Dense_0``, ``Dense_1``, ...  Torch needs the
first layer's width when the model is made: ``in_features`` (784, an
MNIST image, by default).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._layers import Dense, reset_all


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 64),
                 num_classes: int = 10, *, in_features: int = 784,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_features, *features, num_classes]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                                device=device))
        reset_all(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x

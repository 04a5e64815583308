"""``image_classification``: NHWC float32 images from a standard normal
and one label a row, uniform over the classes; the loss the cross
entropy of the float32 logits ``[B, classes]``, the mean over the rank's
rows; every logit read; the work the convolutions' and dense layers'
(``counters/conv_flops.py``)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..counters import conv_flops
from ..data import generator


def make_batches(traffic: dict, config: dict, seed: int, rank: int, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    b, side = traffic["batch_per_rank"], config["image_size"]
    out = []
    for k in range(traffic["distinct_batches"]):
        g = generator(device, seed, 1, rank, k)
        x = torch.randn(b, side, side, 3, generator=g, device=device)
        y = torch.randint(0, config["num_classes"], (b,), generator=g,
                          device=device)
        out.append((x, y))
    return out


def loss(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(z, y)


def reading(z: torch.Tensor) -> torch.Tensor:
    return z.detach().float().flatten()


def reference_step(model, x, y, params, precision: str):
    z = model(x, precision)
    value = F.cross_entropy(z, y)
    grads = torch.autograd.grad(value, params)
    return value, grads, reading(z)


def step_work(config: dict, traffic: dict) -> dict:
    work = conv_flops.step_work(config, traffic["batch_per_rank"])
    return dict(work, attention_min_s=0.0)

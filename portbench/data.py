"""What the benchmark makes from ``--seed``: the weights and the batches,
on the card, in a few large calls.

Weights (the configuration's ``init``): every weight of two or more
dims draws from one standard normal of all of them, clipped at +-2 and
scaled by its layer kind's rule (He et al., arXiv:1502.01852: ``sqrt(2 /
fan)``, or a fixed standard deviation); biases start at 0, norm scales at
1 or, where the configuration names them, at 0.  Batches (the traffic's
``distinct_batches`` a rank): NHWC float32 images from a standard normal
and labels uniform over the classes; a rank's batch ``k`` comes from its
own generator, so a rank makes only its own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

MASK63 = (1 << 63) - 1


def _generator(device, *parts: int) -> torch.Generator:
    key = 0
    for p in parts:
        key = (key * 0x9E3779B97F4A7C15 + int(p) + 1) & MASK63
    return torch.Generator(device=device).manual_seed(key)


def make_weights(specs: Sequence[Tuple[str, torch.Size]], seed: int,
                 device, init: dict) -> Dict[str, torch.Tensor]:
    """float32 weights of the parameters ``specs`` (name, shape) in that
    order, on ``device``, as the configuration's ``init`` says:
    ``conv`` and ``dense`` each ``he_fan_in``, ``he_fan_out`` or a
    standard deviation; ``zero_scales``, the endings of the names of the
    norm scales that start at 0 (the others start at 1)."""
    dense = [(n, s) for n, s in specs if len(s) >= 2]
    total = sum(math.prod(s) for _, s in dense)
    flat = torch.randn(total, generator=_generator(device, seed, 0),
                       device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    for n, s in dense:
        k = math.prod(s)
        rule = init["conv" if len(s) == 4 else "dense"]
        if rule == "he_fan_in":
            std = math.sqrt(2.0 / (k // s[0]))
        elif rule == "he_fan_out":
            std = math.sqrt(2.0 / (k // s[1]))
        else:
            std = float(rule)
        out[n] = flat[off:off + k].view(s).mul_(std)
        off += k
    zero_scales = tuple(init.get("zero_scales", ()))
    for n, s in specs:
        if len(s) >= 2:
            continue
        if n.endswith(".scale"):
            zero = n.endswith(zero_scales) if zero_scales else False
            out[n] = (torch.zeros if zero else torch.ones)(s, device=device)
        elif n.endswith(".bias"):
            out[n] = torch.zeros(s, device=device)
        else:
            raise ValueError(f"no init for parameter {n} of shape {s}")
    return out


def make_batches(traffic: dict, config: dict, seed: int, rank: int, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Rank ``rank``'s ``distinct_batches`` batches of
    ``batch_per_rank`` rows."""
    b, side = traffic["batch_per_rank"], config["image_size"]
    out = []
    for k in range(traffic["distinct_batches"]):
        g = _generator(device, seed, 1, rank, k)
        x = torch.randn(b, side, side, 3, generator=g, device=device)
        y = torch.randint(0, config["num_classes"], (b,), generator=g,
                          device=device)
        out.append((x, y))
    return out

"""``causal_lm``: rows of ``seq_len + 1`` token ids, uniform over the
vocabulary held (the configuration's ``vocab_size``); a row's input is
its first ``seq_len`` ids and each position's label the id after it.

The loss: the mean cross entropy over every token of the rank's rows,
on float32 logits ``[B, T, V]``, in the program and the reference
alike.  Read for the check: the first row's last ``READ_POSITIONS``
positions over the whole vocabulary held (at most about 256 K numbers at
the vocabularies a chip holds, where every logit of a batch would be
hundreds of millions).  A sample is a sequence, so tokens/s is
``seq_len`` times ``images_per_s``.  The work: the GEMM and attention
terms of ``counters/<arch>_layers.py`` (``counters/transformer_flops.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..counters import transformer_flops
from ..data import generator

READ_POSITIONS = 16


def make_batches(traffic: dict, config: dict, seed: int, rank: int, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    b, t = traffic["batch_per_rank"], traffic["seq_len"]
    out = []
    for k in range(traffic["distinct_batches"]):
        g = generator(device, seed, 1, rank, k)
        ids = torch.randint(0, config["vocab_size"], (b, t + 1), generator=g,
                            device=device)
        out.append((ids[:, :-1].contiguous(), ids[:, 1:].contiguous()))
    return out


def loss(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(z.float().flatten(0, 1), y.flatten())


def reading(z: torch.Tensor) -> torch.Tensor:
    # a copy, so that the read keeps no step's whole logits alive
    return z[0, -READ_POSITIONS:].detach().float().flatten().clone()


def reference_step(model, x, y, params, precision: str):
    """The rank's loss and gradients, one row at a time, so that the
    reference fits beside its activations at the published widths: each
    row's loss is its tokens' summed cross entropy over the number of the
    rank's tokens, so the rows' losses and their gradients sum to the
    whole batch's mean and its gradient."""
    tokens = y.numel()
    total, grads, read = None, None, None
    for i in range(x.shape[0]):
        z = model(x[i:i + 1], precision)
        part = F.cross_entropy(z.float().flatten(0, 1), y[i].flatten(),
                               reduction="sum") / tokens
        got = torch.autograd.grad(part, params)
        if read is None:
            read = reading(z)
        del z
        part = part.detach()
        if grads is None:
            total, grads = part, list(got)
        else:
            total = total + part
            for a, b in zip(grads, got):
                a.add_(b)
        del got
    return total, grads, read


def step_work(config: dict, traffic: dict) -> dict:
    return transformer_flops.step_work(config, traffic["batch_per_rank"],
                                       traffic["seq_len"])

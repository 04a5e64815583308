"""What the benchmark makes from ``--seed``: the weights, the buffers'
values and the seeded generators the batches come from, on the card, in
a few large calls.

Weights (the configuration's ``init``): every weight of two or more
dims draws from one standard normal of all of them, clipped at +-2 and
scaled by its rule (He et al., arXiv:1502.01852: ``sqrt(2 / fan)``, or a
fixed standard deviation); biases start at 0, norm scales at 1 or, where
the configuration names them, at 0.  Buffers take the rule the
configuration's ``init`` names for them.  The batches themselves are the
task's (``tasks/``): a rank's batch ``k`` comes from its own generator,
so a rank makes only its own.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

MASK63 = (1 << 63) - 1
# the buffers' rules where the configuration names none: a batch norm's
# running statistics
BUFFER_RULES = {".mean": "zeros", ".var": "ones"}


def generator(device, *parts: int) -> torch.Generator:
    key = 0
    for p in parts:
        key = (key * 0x9E3779B97F4A7C15 + int(p) + 1) & MASK63
    return torch.Generator(device=device).manual_seed(key)


def _by_suffix(name: str, rules: dict):
    """The rule of the longest suffix of ``name`` that ``rules`` holds,
    or None."""
    hits = [s for s in rules if name.endswith(s)]
    return rules[max(hits, key=len)] if hits else None


def _std(name: str, shape: torch.Size, rule) -> float:
    """A weight's standard deviation under ``rule``: a number; ``he_fan_in``
    / ``he_fan_out`` of a dense ``(out, in)`` or a convolution's ``(out,
    in, h, w)`` weight; or ``{"gain": g, "fan_dims": [...]}``, ``sqrt(g /
    fan)`` with the fan the product of those dims (a stacked ``[E, in,
    out]`` expert weight takes ``[-2]``, the fan of one expert)."""
    if isinstance(rule, (int, float)):
        return float(rule)
    if isinstance(rule, dict):
        fan = math.prod(shape[d] for d in rule["fan_dims"])
        return math.sqrt(float(rule["gain"]) / fan)
    if len(shape) not in (2, 4):
        raise ValueError(f"{name} of shape {tuple(shape)}: a rule by fan "
                         "of this weight needs its own rule by suffix")
    k = math.prod(shape)
    if rule == "he_fan_in":
        return math.sqrt(2.0 / (k // shape[0]))
    if rule == "he_fan_out":
        return math.sqrt(2.0 / (k // shape[1]))
    raise ValueError(f"no init rule {rule!r} for {name}")


def make_weights(specs: Sequence[Tuple[str, torch.Size]], seed: int,
                 device, init: dict) -> Dict[str, torch.Tensor]:
    """float32 weights of the parameters ``specs`` (name, shape) in that
    order, on ``device``, as the configuration's ``init`` says:
    ``conv`` (four dims) and ``dense`` (the rest) each ``he_fan_in``,
    ``he_fan_out`` or a standard deviation; ``suffix``, rules by the
    endings of the names, before those two (any rule ``_std`` takes);
    ``zero_scales``, the endings of the names of the norm scales that
    start at 0 (the others start at 1)."""
    dense = [(n, s) for n, s in specs if len(s) >= 2]
    total = sum(math.prod(s) for _, s in dense)
    flat = torch.randn(total, generator=generator(device, seed, 0),
                       device=device).clamp_(-2.0, 2.0)
    out, off = {}, 0
    suffix = init.get("suffix", {})
    for n, s in dense:
        k = math.prod(s)
        rule = _by_suffix(n, suffix)
        if rule is None:
            rule = init["conv" if len(s) == 4 else "dense"]
        out[n] = flat[off:off + k].view(s).mul_(_std(n, s, rule))
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


def fill_buffers(model: torch.nn.Module, init: dict) -> None:
    """Give each of the program's buffers its value after ``to_empty``,
    by the rule of its name's longest matching suffix in ``init``'s
    ``buffers`` (``BUFFER_RULES`` where it names none): ``zeros``,
    ``ones``, or ``computed``: the module that holds the buffer
    recomputes it itself, in its ``reset_buffers()``, called once.  A
    buffer no rule names is an error."""
    rules = dict(BUFFER_RULES, **init.get("buffers", {}))
    owners = {}
    with torch.no_grad():
        for n, b in model.named_buffers():
            rule = _by_suffix(n, rules)
            if rule == "zeros":
                b.zero_()
            elif rule == "ones":
                b.fill_(1.0)
            elif rule == "computed":
                path = n.rpartition(".")[0]
                owners[path] = model.get_submodule(path)
            else:
                raise RuntimeError(f"no value for the program's buffer {n}")
        for path, owner in owners.items():
            if not hasattr(owner, "reset_buffers"):
                raise RuntimeError(f"the buffers of {path or 'the model'} "
                                   "are computed, but it has no "
                                   "reset_buffers()")
            owner.reset_buffers()

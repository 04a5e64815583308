"""The operations and bytes of a configuration's convolutions and dense
layers, worked out from the published layer shapes (not counted from
what an implementation runs, which a fused or recomputing change would
move).

Each layer runs three passes a training step: the forward pass, the
weight gradient and the input gradient; the first layer has no input
gradient, since nothing upstream needs it.  A pass's least time on the
card is the larger of its operations over the peak of its dtype and its
bytes over the HBM bandwidth, each input byte read once and each output
byte written once (``kernels.py``'s peaks).  The layers of each
architecture are listed by ``counters/<arch>_layers.py``, found by the
configuration's ``arch``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List

from .. import kernels

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Layer:
    """One convolution (``k`` x ``k``) or dense layer (``k`` = 1, a 1x1
    map) of one image."""

    name: str
    cin: int
    cout: int
    k: int
    h_in: int
    w_in: int
    h_out: int
    w_out: int
    dtype: str
    first: bool = False

    @property
    def macs(self) -> int:
        return self.h_out * self.w_out * self.cout * self.cin * self.k ** 2


def out_size(size: int, stride: int) -> int:
    """A ``SAME`` convolution's output size."""
    return -(-size // stride)


def layers(config: dict) -> List[Layer]:
    """The layers of ``config``, from the ``layers`` function of
    ``counters/<arch>_layers.py``."""
    module = importlib.import_module(f"{__package__}.{config['arch']}_layers")
    return module.layers(config)


def forward_macs(config: dict) -> int:
    """Multiply-adds of one image's forward pass."""
    return sum(layer.macs for layer in layers(config))


def step_work(config: dict, batch: int) -> dict:
    """``flops``: the operations of one training step of ``batch`` images
    (forward, weight gradient, input gradient where needed);
    ``min_s``: the sum of each pass's least time on the card."""
    flops = min_s = 0.0
    for layer in layers(config):
        e = DTYPE_BYTES[layer.dtype]
        x = batch * layer.cin * layer.h_in * layer.w_in * e
        y = batch * layer.cout * layer.h_out * layer.w_out * e
        w = layer.cout * layer.cin * layer.k ** 2 * e
        passes = [x + w + y, x + y + w]           # forward, weight grad
        if not layer.first:
            passes.append(y + w + x)              # input grad
        pass_flops = 2.0 * batch * layer.macs
        peak = kernels.PEAK_FLOPS[layer.dtype]
        for nbytes in passes:
            flops += pass_flops
            min_s += max(pass_flops / peak,
                         nbytes / kernels.PEAK_BYTES_PER_S)
    return {"flops": flops, "min_s": min_s}

"""The layers of a ``resnet`` configuration for ``conv_flops.py``:
ResNet v1.5 with bottleneck blocks (the stride on the 3x3), the stem,
each block's three convolutions and its projection, the logits."""

from __future__ import annotations

from typing import List

from .conv_flops import Layer, out_size


def layers(config: dict) -> List[Layer]:
    dt = config["compute_dtype"]
    side = config["image_size"]
    f = config["num_filters"]
    half = out_size(side, 2)
    out = [Layer("conv_init", 3, f, 7, side, side, half, half, dt,
                 first=True)]
    h = out_size(half, 2)               # the stem's 3x3/2 max pool
    cin = f
    for i, size in enumerate(config["stage_sizes"]):
        filters = f * 2 ** i
        for j in range(size):
            s = 2 if i > 0 and j == 0 else 1
            ho = out_size(h, s)
            b = f"block{i}.{j}"
            out += [Layer(f"{b}.conv0", cin, filters, 1, h, h, h, h, dt),
                    Layer(f"{b}.conv1", filters, filters, 3, h, h, ho, ho,
                          dt),
                    Layer(f"{b}.conv2", filters, filters * 4, 1, ho, ho, ho,
                          ho, dt)]
            if s != 1 or cin != filters * 4:
                out.append(Layer(f"{b}.proj", cin, filters * 4, 1, h, h, ho,
                                 ho, dt))
            cin, h = filters * 4, ho
    out.append(Layer("logits", cin, config["num_classes"], 1, 1, 1, 1, 1,
                     "float32"))
    return out

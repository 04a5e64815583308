"""The layers of a ``vgg`` configuration for ``conv_flops.py``: the 3x3
convolutions of each stage at the configuration's ``widths``, then the
two dense layers of ``dense_width`` and the logits."""

from __future__ import annotations

from typing import List

from .conv_flops import Layer


def layers(config: dict) -> List[Layer]:
    dt = config["compute_dtype"]
    side = config["image_size"]
    out, cin = [], 3
    dense = config["dense_width"]
    for s, (reps, width) in enumerate(zip(config["stages"],
                                          config["widths"])):
        for i in range(reps):
            out.append(Layer(f"conv{s}_{i}", cin, width, 3, side, side,
                             side, side, dt, first=not out))
            cin = width
        side //= 2
    out += [Layer("fc6", cin * side * side, dense, 1, 1, 1, 1, 1, dt),
            Layer("fc7", dense, dense, 1, 1, 1, 1, 1, dt),
            Layer("logits", dense, config["num_classes"], 1, 1, 1, 1, 1,
                  "float32")]
    return out

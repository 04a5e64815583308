"""A cell cut to a size the CPU runs in seconds, for the tests: the
same files and path, narrower, smaller images, a small batch.

``python -m portbench.tests.tiny <cell> <trace> [fault] [ranks]`` runs
it on the CPU and prints the run's line.  With ``ranks`` past 1 the
cell's batches run on that many ranks through the program's launcher
(``--cpu-devices 1``), the path a cell on several chips takes, and the
ranks' bits are compared as such a cell's limits would (0 differing)."""

from __future__ import annotations

import json
import sys

from portbench import run


def tiny_spec(cell: str, trace: int = 0, fault=None, ranks: int = 1) -> dict:
    spec = run.make_spec(cell, 2 ** 31 + 4242, 0.2, trace)
    spec["device"] = "cpu"
    spec["fault"] = fault
    if ranks > 1:
        spec["chips"] = spec["traffic"]["ranks"] = ranks
        spec["limits"]["ranks_differing"] = {"limit": 0}
    c = spec["config"]
    if c["arch"] == "resnet":
        # float32: at 8 filters bfloat16's rounding swamps the signal
        c.update(num_filters=8, num_classes=10, image_size=64,
                 compute_dtype="float32")
        c["port_kwargs"] = {"num_filters": 8, "num_classes": 10}
    else:
        c.update(num_classes=10, image_size=32)
        c["port_kwargs"] = {"image_size": 32, "num_classes": 10}
    spec["traffic"].update(batch_per_rank=4, warmup_steps=2, trace_steps=2)
    return spec


if __name__ == "__main__":
    fault = sys.argv[3] if len(sys.argv) > 3 and sys.argv[3] else None
    ranks = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    spec = tiny_spec(sys.argv[1], int(sys.argv[2]), fault, ranks)
    line = run.execute(spec)
    run.report(line)
    json.dumps(line)

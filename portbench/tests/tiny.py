"""A cell cut to a size the CPU runs in seconds, for the tests: the
same files and path, narrower, smaller inputs, a small batch.

``python -m portbench.tests.tiny <cell> <trace> [fault] [ranks]`` runs
it on the CPU and prints the run's line.  ``<cell>`` is a cell of
``BENCHMARK.json``, or ``tiny_lm``: the tests' causal language model
(``tiny_lm.json``: its configuration, traffic and limits; its program
``tiny_lm.py``), which no cell of ``BENCHMARK.json`` names.  With
``ranks`` past 1 the cell's batches run on that many ranks through the
program's launcher (``--cpu-devices 1``), the path a cell on several
chips takes, and the ranks' bits are compared as such a cell's limits
would (0 differing)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

from portbench import run

SEED = 2 ** 31 + 4242
TINY_LM = Path(__file__).with_name("tiny_lm.json")


def tiny_lm_spec(trace: int = 0) -> dict:
    """The tests' causal language model at its own (tiny) size."""
    files = json.loads(TINY_LM.read_text())
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    return run.spec_of(bench, "tiny_lm", files["config"], files["traffic"],
                       files["limits"], SEED, 0.2, trace)


def tiny_spec(cell: str, trace: int = 0, fault=None, ranks: int = 1) -> dict:
    if cell == "tiny_lm":
        spec = tiny_lm_spec(trace)
    else:
        spec = run.make_spec(cell, SEED, 0.2, trace)
        c = spec["config"]
        if c["arch"] == "resnet":
            # float32: at 8 filters bfloat16's rounding swamps the signal
            c.update(num_filters=8, num_classes=10, image_size=64,
                     compute_dtype="float32")
            c["port_kwargs"] = {"num_filters": 8, "num_classes": 10}
        else:
            c.update(num_classes=10, image_size=32)
            c["port_kwargs"] = {"image_size": 32, "num_classes": 10}
        spec["traffic"].update(batch_per_rank=4, warmup_steps=2,
                               trace_steps=2)
    spec["device"] = "cpu"
    spec["fault"] = fault
    if ranks > 1:
        spec["chips"] = spec["traffic"]["ranks"] = ranks
        spec["limits"]["ranks_differing"] = {"limit": 0}
    return spec


if __name__ == "__main__":
    fault = sys.argv[3] if len(sys.argv) > 3 and sys.argv[3] else None
    ranks = int(sys.argv[4]) if len(sys.argv) > 4 else 1
    spec = tiny_spec(sys.argv[1], int(sys.argv[2]), fault, ranks)
    line = run.execute(spec)
    run.report(line)
    json.dumps(line)

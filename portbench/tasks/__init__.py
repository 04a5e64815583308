"""What a configuration trains on, by its ``task``: one module a task,
each with the same functions, so that nothing else in the benchmark
branches on it.

* ``make_batches(traffic, config, seed, rank, device)``: rank ``rank``'s
  ``distinct_batches`` batches ``(x, y)`` of ``batch_per_rank`` rows;
* ``loss(z, y)``: the program's loss of its output ``z``;
* ``reading(z)``: the part of the output the check reads, flat, float32;
* ``reference_step(model, x, y, params, precision)``: the
  reference's ``(loss, grads, reading)`` over one rank's batch;
* ``step_work(config, traffic)``: the operations a step needs
  (``flops``), the least time of its convolutions and matrix products
  (``min_s``) and of its attention (``attention_min_s``).

A row is a sample, what ``images_per_s`` counts: an image, or a
sequence.  ``image_classification`` (``images.py``) is the task where a
configuration names none; ``causal_lm`` is ``causal_lm.py``.
"""

from __future__ import annotations

import importlib

TASKS = {"image_classification": "images", "causal_lm": "causal_lm"}


def of(config: dict):
    """The module of ``config``'s task."""
    task = config.get("task", "image_classification")
    if task not in TASKS:
        raise ValueError(f"task {task!r}: one of {sorted(TASKS)}")
    return importlib.import_module(f"{__name__}.{TASKS[task]}")

"""The benchmark of ``horovod_tpu_torch``, the PyTorch and CUDA port.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``BENCHMARK.json``) once.  Configurations,
traffic, limits and per-layer metrics are files of their own under
``configs/``, ``traffic/``, ``limits/`` and ``metrics/``; ``reference/``
is the frozen plain-PyTorch reference the check holds the program to;
``counters/`` works out operations and bytes from shapes; ``tasks/``
holds what a configuration's task decides (the batches, the loss, the
logits read, the work).  Nothing here
imports JAX or the JAX package.
"""

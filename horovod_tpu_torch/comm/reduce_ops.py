"""Reduction op identifiers, matching the reference's ``ReduceOp`` surface
(horovod/common/common.h and the ``op=`` argument of hvd.allreduce in
horovod/torch/mpi_ops.py: Average, Sum, Adasum, Min, Max, Product).

Counterpart of ``horovod_tpu/comm/reduce_ops.py``, copied so the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Module-level aliases matching `hvd.Average` / `hvd.Sum` / `hvd.Adasum`.
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


def normalize_op(op, average=None) -> ReduceOp:
    """Resolve the (op, legacy average=) argument pair like the reference
    does in horovod/torch/mpi_ops.py (`handle_average_backwards_compatibility`).
    """
    if average is not None:
        if op is not None:
            raise ValueError("specify either op= or average=, not both")
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    if op is None:
        return ReduceOp.AVERAGE
    return ReduceOp(op)

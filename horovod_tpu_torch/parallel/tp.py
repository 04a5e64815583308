"""Tensor parallelism: Megatron-style column/row-parallel projections.

Counterpart of ``horovod_tpu/parallel/tp.py``.  Column-parallel: weight
``[F_in, F_out/tp]``, the output feature dim sharded, no collective on
forward; the backward sum over tp comes from the collective that feeds
``x`` (its adjoint).  Row-parallel: weight ``[F_in/tp, F_out]``, the
contraction dim sharded, one ``psum`` over tp on forward.  A column ->
row pair costs one forward psum and one backward psum.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._collectives import psum


def column_parallel(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` with ``w``'s output dim sharded over tp.

    x: [..., F_in] (replicated over tp), w: [F_in, F_out_local].
    Returns [..., F_out_local].
    """
    y = torch.einsum("...i,io->...o", x, w)
    if b is not None:
        y = y + b
    return y


def row_parallel(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                 b: Optional[torch.Tensor] = None, *,
                 mesh=None) -> torch.Tensor:
    """``psum(x @ w) (+ b)`` with ``w``'s input dim sharded over tp.

    x: [..., F_in_local], w: [F_in_local, F_out].  The psum completes
    the contraction across the tp group; the bias is added after it (it
    is replicated, so adding it before would count it tp times).
    """
    partial = torch.einsum("...i,io->...o", x, w)
    y = psum(partial, axis_name, mesh=mesh)
    if b is not None:
        y = y + b
    return y


def tp_shard_dim(n: int, tp_size: int, name: str = "dim") -> int:
    """Validate and return the per-device size of a tp-sharded dim."""
    if n % tp_size != 0:
        raise ValueError(f"{name}={n} not divisible by tp={tp_size}")
    return n // tp_size

"""Synchronous collectives on torch tensors over ``torch.distributed``.

Counterpart of the public eager ops of ``horovod_tpu/comm/eager.py``
(``allreduce``, ``broadcast``, ``barrier``) with the reduction semantics
of ``horovod_tpu/comm/spmd.py`` ``allreduce``: prescale in the tensor's
dtype, sum, Average divides by the participant count (floor division for
integers), postscale in the output's dtype.  Each op returns a new
tensor.  Only Sum and Average exist so far.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import state as core_state
from ..core.process_set import ProcessSet, global_process_set
from .reduce_ops import ReduceOp, normalize_op


def _resolve_process_set(process_set: Optional[ProcessSet], name: str):
    core_state.require_init(name)
    ps = global_process_set if process_set is None else process_set
    if ps is not global_process_set:
        raise NotImplementedError(
            "only the global process set is supported so far")
    return ps


def _scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    # spmd.py parity: ``t * jnp.asarray(factor, t.dtype)`` — the factor
    # takes the tensor's dtype first (integers truncate it).
    return t * torch.tensor(factor, dtype=t.dtype, device=t.device)


def average_(t: torch.Tensor, n: int) -> torch.Tensor:
    """In-place Average over ``n`` participants (spmd.py parity:
    integers floor-divide, floats divide)."""
    if t.is_floating_point():
        return t.div_(n)
    return t.floor_divide_(n)


def allreduce(
    tensor: torch.Tensor,
    *,
    op: Optional[ReduceOp] = None,
    average: Optional[bool] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    process_set: Optional[ProcessSet] = None,
) -> torch.Tensor:
    rop = normalize_op(op, average)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise NotImplementedError(
            f"allreduce op {rop.name} is not ported yet (Sum, Average)")
    ps = _resolve_process_set(process_set, "allreduce")
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    if prescale_factor != 1.0:
        out = _scale(out, prescale_factor)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ps.group)
    if rop == ReduceOp.AVERAGE:
        average_(out, ps.size)
    if postscale_factor != 1.0:
        out = _scale(out, postscale_factor)
    return out


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Return a new tensor holding ``root_rank``'s value."""
    ps = _resolve_process_set(process_set, "broadcast")
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=root_rank, group=ps.group)
    return out


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """In-place broadcast from ``root_rank``."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank, process_set))
    return tensor


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    ps = _resolve_process_set(process_set, "barrier")
    dist.barrier(group=ps.group)

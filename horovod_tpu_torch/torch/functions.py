"""State fan-out helpers for torch models (parity:
horovod/torch/functions.py ``broadcast_parameters`` /
``broadcast_optimizer_state`` / ``broadcast_object`` /
``allgather_object``; counterpart of ``horovod_tpu/torch/functions.py``).
Each takes a process set; a root is a global rank.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..comm.eager import _group, _resolve_process_set, broadcast_
from ..core import state as core_state
from ..core.process_set import ProcessSet


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None):
    """Broadcast a ``model.state_dict()`` or ``named_parameters`` from
    ``root_rank`` in place, one tensor at a time."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    for _, p in items:
        if torch.is_tensor(p):
            broadcast_(p, root_rank=root_rank, process_set=process_set)


def broadcast_object(obj: Any, root_rank: int = 0, name: str = None,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """Pickle-broadcast an arbitrary object from ``root_rank``; ``name``
    is accepted and dropped, as the reference drops it."""
    del name
    ps = _resolve_process_set(process_set, "broadcast_object")
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank, group=_group(ps))
    return box[0]


def allgather_object(obj: Any, process_set=None) -> list:
    """Gather a picklable object from every rank of the set; returns a
    list ordered by rank (parity: hvd.allgather_object; in a world of
    one, ``[obj]``)."""
    st = core_state.require_init("allgather_object")
    if st.size == 1:
        return [obj]
    ps = _resolve_process_set(process_set, "allgather_object")
    out = [None] * ps.size
    dist.all_gather_object(out, obj, group=_group(ps))
    return out


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None):
    """Broadcast a torch optimizer's state (momentum buffers, step
    counters, ...) from ``root_rank``.

    Like the reference, an optimizer with no state yet first takes one
    step on zero gradients, so every rank has state entries to receive
    into.
    """
    if len(optimizer.state) == 0:
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
    new_state = broadcast_object(optimizer.state_dict(), root_rank=root_rank,
                                 process_set=process_set)
    if core_state.rank() != root_rank:
        optimizer.load_state_dict(new_state)

"""State fan-out helpers for torch models (parity:
horovod/torch/functions.py ``broadcast_parameters`` /
``broadcast_optimizer_state`` / ``broadcast_object`` /
``allgather_object``; counterpart of ``horovod_tpu/torch/functions.py``).
Each takes a process set; a root is a global rank.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..comm.eager import _group, _resolve_process_set, broadcast, broadcast_
from ..core import state as core_state
from ..core.process_set import ProcessSet


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None):
    """Broadcast a ``model.state_dict()`` or ``named_parameters`` from
    ``root_rank`` in place.

    As the reference does, every contiguous CPU tensor rides one byte
    buffer: the native core's thread pool packs them (parity:
    FusionBufferManager + thread_pool.cc's parallel
    MemcpyInFusionBuffer), one broadcast named ``bp.fused.{n}.{bytes}``
    moves the bytes, and the pool scatters them straight back into each
    tensor's storage.  The rest (tensors on the card, non-contiguous
    ones, a lone contiguous one) go one by one as ``bp.{name}``.
    """
    from ..native import core as native_core

    items = list(params.items()) if hasattr(params, "items") else list(params)
    items = [(n, p) for n, p in items if p is not None and torch.is_tensor(p)]
    fused, single = [], []
    for name, p in items:
        if p.is_contiguous() and p.device.type == "cpu":
            fused.append((name, p))
        else:
            single.append((name, p))
    if len(fused) == 1:
        single += fused
        fused = []
    if fused:
        # byte views alias each tensor's storage: the scatter lands the
        # result in the parameters themselves
        views = [p.detach().view(-1).view(torch.uint8).numpy()
                 for _, p in fused]
        total = sum(v.nbytes for v in views)
        buf = np.empty(total, np.uint8)
        native_core.parallel_gather(memoryview(buf),
                                    [memoryview(v) for v in views])
        out = broadcast(torch.from_numpy(buf), root_rank, process_set,
                        name=f"bp.fused.{len(fused)}.{total}")
        native_core.parallel_scatter(memoryview(out.numpy()),
                                     [memoryview(v) for v in views])
    for name, p in single:
        broadcast_(p, root_rank=root_rank, process_set=process_set,
                   name=f"bp.{name}")


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

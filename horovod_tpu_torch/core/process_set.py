"""Process sets: subsets of ranks that collectives are scoped to.

Counterpart of ``horovod_tpu/core/process_set.py``.  Here a process set
maps onto a ``torch.distributed`` group; only the global set (every rank,
the default group) exists so far.
"""

from __future__ import annotations

from typing import List, Optional


class ProcessSet:
    """The ranks of a process set and their ``torch.distributed`` group
    (``None``: the default group)."""

    def __init__(self):
        self.ranks: Optional[List[int]] = None
        self.process_set_id: Optional[int] = None
        self.group = None

    def _bind(self, process_set_id: int, world_size: int):
        self.process_set_id = process_set_id
        self.ranks = list(range(world_size))

    def _unbind(self):
        self.process_set_id = None
        self.ranks = None

    @property
    def size(self) -> int:
        if self.ranks is None:
            raise ValueError("process set is not bound; call init() first")
        return len(self.ranks)


global_process_set = ProcessSet()

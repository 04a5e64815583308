"""Process sets: subsets of ranks that collectives are scoped to.

Counterpart of ``horovod_tpu/core/process_set.py`` (parity: the
reference's ``horovod/common/process_set.cc`` ``ProcessSetTable`` and
``horovod/common/process_sets.py``): named rank subsets addressed by id
in every collective.

Here a process set is a pair of ``torch.distributed`` groups over its
ranks: ``group`` for the synchronous collectives, which run on the
caller's thread, and ``controller_group`` for the collectives the async
controller runs on its executor thread (two threads never share a
communicator, so their streams cannot interleave differently on
different ranks).  The global set uses the default group for the first
and one group over the world, made at ``init()``, for the second.  Both
are made by ``core/state.py`` (``init``, ``add_process_set``): creating
a group is collective, so every rank adds its sets in the same order.

The JAX package's per-set ``proc_mesh`` has no counterpart: a group is
what a set is here.  ``device_groups`` is the set as a partition of the
world mesh's axis, for the collectives over a mesh axis
(``comm/spmd.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


class _CallableInt(int):
    """An int answering reference method-call syntax: upstream's
    ProcessSet exposes size()/rank() as METHODS while this engine reads
    them as values — ``x`` and ``x()`` both yield the count."""

    __slots__ = ()

    def __call__(self) -> int:
        return int(self)


class ProcessSet:
    """A subset of ranks that collectives can be scoped to.

    ``ranks=None`` denotes the global set (all ranks).
    """

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(set(ranks)) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        # None: the default group (the global set's sync group)
        self.group = None
        self.controller_group = None

    def _bind(self, process_set_id: int, world_size: int):
        self.process_set_id = process_set_id
        if self.ranks is None:
            self.ranks = list(range(world_size))

    def _unbind(self, global_set: bool = False):
        self.process_set_id = None
        self.group = self.controller_group = None
        if global_set:
            self.ranks = None

    @property
    def size(self) -> _CallableInt:
        """Member count; ``ps.size`` and ``ps.size()`` both work."""
        if self.ranks is None:
            raise ValueError("process set is not bound; call init() first")
        return _CallableInt(len(self.ranks))

    @property
    def rank(self):
        """This process's rank within the set (parity:
        ProcessSet.rank()), a callable int, or None when this process is
        not a member."""
        from . import state as _state

        st = _state.require_init("ProcessSet.rank")
        r = self.rank_in_set(st.rank)
        return None if r < 0 else _CallableInt(r)

    def rank_in_set(self, global_rank: int) -> int:
        """Position of ``global_rank`` within the set (-1 if absent)."""
        if self.ranks is None:
            raise ValueError("process set is not bound; call init() first")
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            return -1

    def included(self, global_rank: Optional[int] = None) -> bool:
        """Membership of this process (parity: ProcessSet.included()),
        or of ``global_rank`` when given."""
        if global_rank is None:
            from . import state as _state

            global_rank = _state.require_init("ProcessSet.included").rank
        return self.rank_in_set(global_rank) >= 0

    def device_groups(self) -> Optional[List[List[int]]]:
        """The set as a partition of the world mesh's axis (the
        reference's ``axis_index_groups``; a device is a rank here): the
        members form one group, the other ranks equal groups of the
        members' count where that divides them, singletons otherwise
        (which Sum, Average, Min and Max accept, and the gather- and
        scatter-shaped collectives refuse).  None for the global set."""
        from . import state as _state

        st = _state.require_init("ProcessSet.device_groups")
        if self.ranks is None:
            raise ValueError("process set is not bound; call init() first")
        if len(self.ranks) == st.size:
            return None
        member = list(self.ranks)
        others = [r for r in range(st.size) if r not in member]
        m = len(member)
        if m and len(others) % m == 0:
            rest = [others[i:i + m] for i in range(0, len(others), m)]
        else:
            rest = [[r] for r in others]
        return [member] + rest

    def __repr__(self):
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


global_process_set = ProcessSet()


def participant_rank(process_set) -> int:
    """This process's rank within the collective's span: its index in the
    set, or the global rank when no set is given."""
    from . import state as core_state

    st = core_state.require_init("process-set lookup")
    if process_set is None:
        return st.rank
    if isinstance(process_set, int):
        process_set = st.process_set_table.get(process_set)
    return process_set.rank_in_set(st.rank)


def participant_count(process_set) -> int:
    """Number of ranks a collective spans: the set's size, or the world
    when no set is given."""
    from . import state as core_state

    if process_set is None:
        return core_state.global_state().size
    if isinstance(process_set, int):
        st = core_state.require_init("process-set lookup")
        return st.process_set_table.get(process_set).size
    return process_set.size


class ProcessSetTable:
    """Registry of process sets; id 0 is always the global set (parity:
    ``ProcessSetTable`` in horovod/common/process_set.cc)."""

    def __init__(self, world_size: int,
                 global_set: Optional[ProcessSet] = None):
        self._lock = threading.Lock()
        self._world_size = world_size
        self._table: Dict[int, ProcessSet] = {}
        self._next_id = 0
        self.global_process_set = global_set or ProcessSet(None)
        self._register(self.global_process_set)

    def _register(self, ps: ProcessSet) -> int:
        psid = self._next_id
        self._next_id += 1
        ps._bind(psid, self._world_size)
        self._table[psid] = ps
        return psid

    def check(self, ps: ProcessSet) -> None:
        """Raise when ``ps`` cannot be added: ranks out of range, or an
        added set with the same ranks exists.  Unlike the JAX package's
        table, a set with the global set's ranks may be added: it gets
        groups of its own (in a world of one, the only set there can
        be)."""
        with self._lock:
            if ps.ranks is None:
                return
            bad = [r for r in ps.ranks if not 0 <= r < self._world_size]
            if bad:
                raise ValueError(f"ranks {bad} out of range for world size "
                                 f"{self._world_size}")
            for psid, existing in self._table.items():
                if psid != 0 and existing.ranks == ps.ranks:
                    raise ValueError(
                        f"a process set with ranks {ps.ranks} already "
                        f"exists (id {existing.process_set_id})")

    def add(self, ps: ProcessSet) -> int:
        self.check(ps)
        with self._lock:
            return self._register(ps)

    def remove(self, psid: int) -> ProcessSet:
        with self._lock:
            if psid == 0:
                raise ValueError("cannot remove the global process set")
            if psid not in self._table:
                raise ValueError(f"unknown process set id {psid}")
            return self._table.pop(psid)

    def get(self, psid: int) -> ProcessSet:
        with self._lock:
            if psid not in self._table:
                raise ValueError(f"unknown process set id {psid}")
            return self._table[psid]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._table)

    def items(self) -> Dict[int, ProcessSet]:
        with self._lock:
            return dict(self._table)

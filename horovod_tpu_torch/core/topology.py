"""Process topology: the world, local and cross groups.

Counterpart of ``horovod_tpu/core/topology.py`` (parity: the reference's
global / local / cross communicators, ``MPIContext::Initialize``).  The
JAX package builds meshes over devices; the port keeps one device a
process, so its counterpart of the mesh factory is a set of
``torch.distributed`` groups beside the world group ``init()`` made:

* one **local** group a host (the reference's ``ici`` axis): the ranks
  that share a host;
* one **cross** group a local rank (the reference's ``dcn`` axis): the
  ranks with the same local rank, one a host.

They follow the host-major rank layout of ``runner/hosts.py``: on a
uniform layout of ``cross_size`` hosts with ``local_size`` ranks each,
host ``h`` holds ranks ``h * local_size ... h * local_size +
local_size - 1`` and its cross rank is ``h``.  A rank learns only its
own placement from the launcher, so the groups need the launcher's
certificate that the layout is uniform (``HVTPU_UNIFORM_LOCAL_SIZE``);
a non-uniform layout has no groups, as the reference's hierarchical
mesh refuses unequal device counts.  Only the hierarchical route reads
them, so ``init()`` makes a :class:`Topology` only when
:func:`hierarchical_layout` holds.

``new_group`` is collective: every rank creates every group in the same
order, members or not.  :class:`Topology` creates them all when it is
made (local groups, cross groups, then the same two for the async
controller, whose executor never shares a communicator with the
caller's thread), at the same point of every rank's ``init()``.
``shutdown()`` destroys them before the world group.

The reference's ``world_mesh`` and ``nd_mesh`` (N-D device meshes for
the SPMD layers) wait for the parallel layers and DeviceMesh (ROADMAP
Queue A item 9).
"""

from __future__ import annotations

from typing import List, Sequence

import torch.distributed as dist


class GroupView:
    """A set of global ranks and its groups, read by the comm code the
    way it reads a ``ProcessSet`` (``ranks``, ``size``, ``rank_in_set``,
    ``group`` and ``controller_group``), so ``comm/eager._reduce`` and
    ``comm/adasum.adasum_reduce`` run over it unchanged."""

    process_set_id = None

    def __init__(self, ranks: Sequence[int], group, controller_group):
        self.ranks = list(ranks)
        self.group = group
        self.controller_group = controller_group

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank_in_set(self, rank: int) -> int:
        try:
            return self.ranks.index(rank)
        except ValueError:
            return -1


def host_major_grid(cross_size: int, local_size: int) -> List[List[int]]:
    """``grid[h][l]``: the global rank of local rank ``l`` on host ``h``
    (the layout ``runner/hosts.get_host_assignments`` gives)."""
    return [[h * local_size + l for l in range(local_size)]
            for h in range(cross_size)]


def hierarchical_layout(cfg, size: int, local_size: int,
                        cross_size: int) -> bool:
    """The layout conditions of the hierarchical route, the reference's
    (``horovod_tpu/comm/eager.py`` ``_hierarchical_mesh_or_none``): the
    flag, a launcher-certified uniform layout of more than one rank a
    host that this rank's local size matches, more than one host, and
    the grid covering the world."""
    return (cfg is not None and cfg.hierarchical_allreduce
            and cfg.uniform_local_size > 1
            and local_size == cfg.uniform_local_size
            and cross_size > 1
            and cross_size * local_size == size)


class Topology:
    """This rank's local and cross groups (``local``, ``cross``) on a
    uniform layout of ``cross_size`` hosts of ``local_size`` ranks;
    making one is collective."""

    def __init__(self, rank: int, local_size: int, cross_size: int,
                 timeout=None):
        grid = host_major_grid(cross_size, local_size)
        cross_lists = [list(col) for col in zip(*grid)]
        self._owned: list = []
        groups = [self._new_groups(lists, rank, timeout)
                  for lists in (grid, cross_lists, grid, cross_lists)]
        host, lrank = divmod(rank, local_size)
        self.local = GroupView(grid[host], groups[0], groups[2])
        self.cross = GroupView(cross_lists[lrank], groups[1], groups[3])

    def _new_groups(self, lists: List[List[int]], rank: int, timeout):
        """One group a list, in order, on every rank; this rank's."""
        mine = None
        for ranks in lists:
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine = g
                self._owned.append(g)
        return mine

    def destroy(self) -> None:
        """Destroy the groups this rank belongs to (before the world
        group goes away)."""
        for g in self._owned:
            if g not in (None, dist.GroupMember.NON_GROUP_MEMBER):
                try:
                    dist.destroy_process_group(g)
                except Exception:  # noqa: BLE001 — teardown goes on
                    pass
        self._owned = []

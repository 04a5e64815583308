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

The reference's mesh factory (``world_mesh``, ``hierarchical_mesh``,
``proc_mesh``, ``nd_mesh``) is :class:`Meshes`: ``torch.distributed``
``DeviceMesh`` objects over the world, made at their first use and
cached.  A device is a rank here (NCCL refuses two ranks of one
communicator on one card), so a mesh over the world's devices is a mesh
over its ranks, and ``("dcn", "ici")`` are the cross and local groups
above.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

# the reference's axis names (horovod_tpu/core/topology.py)
WORLD_AXIS = "world"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"
PROC_AXIS = "proc"


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


class Meshes:
    """The meshes of a world of ``size`` ranks on ``device_type``
    (``"cuda"`` or ``"cpu"``), each a ``DeviceMesh`` made once, under a
    lock, at its first use.  Making a mesh is collective: every rank asks
    for the same meshes in the same order.  The groups come from the
    world's backend (NCCL on the card, gloo on the CPU):

    * :meth:`world_mesh` and :meth:`proc_mesh` are the default group under
      the axis names ``world`` and ``proc`` (one device a process, so the
      two are the same ranks);
    * :meth:`hierarchical_mesh` is ``(dcn, ici)`` over the cross and local
      groups of ``topology`` (the hierarchical route's, when ``init()``
      made one), or of a :class:`Topology` it makes and owns;
    * :meth:`nd_mesh` is ``init_device_mesh`` over the world, row-major,
      so the trailing axes are the fast ones: the ranks of a host are
      adjacent on the host-major layout.

    :meth:`destroy` drops them, and destroys the groups they made,
    before the world group goes away."""

    def __init__(self, device_type: str, rank: int, size: int,
                 local_rank: int, local_size: int, cross_rank: int,
                 cross_size: int, topology: Optional[Topology] = None,
                 timeout=None):
        self.device_type = device_type
        self.rank, self.size = rank, size
        self.local_rank, self.local_size = local_rank, local_size
        self.cross_rank, self.cross_size = cross_rank, cross_size
        self._topology = topology
        self._owned_topology: Optional[Topology] = None
        self._timeout = timeout
        self._lock = threading.Lock()
        self._world = None
        self._proc = None
        self._hier = None
        self._nd: Dict[Tuple[Tuple[str, ...], Tuple[int, ...]], object] = {}

    @property
    def num_devices(self) -> int:
        return self.size

    def _over_world(self, axis: str):
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh.from_group(dist.group.WORLD, self.device_type,
                                     mesh_dim_names=(axis,))

    def world_mesh(self):
        """1-D mesh, axis ``world``, over every rank."""
        with self._lock:
            if self._world is None:
                self._world = self._over_world(WORLD_AXIS)
            return self._world

    def proc_mesh(self):
        """1-D mesh, axis ``proc``: one device a process."""
        with self._lock:
            if self._proc is None:
                self._proc = self._over_world(PROC_AXIS)
            return self._proc

    def _placements(self) -> List[Tuple[int, int]]:
        """Every rank's ``(cross_rank, local_rank)``, in rank order (an
        allgather past one rank)."""
        if self.size == 1:
            return [(self.cross_rank, self.local_rank)]
        places: list = [None] * self.size
        dist.all_gather_object(places, (self.cross_rank, self.local_rank))
        return [tuple(p) for p in places]

    def hierarchical_mesh(self):
        """2-D ``(dcn, ici)`` mesh: hosts x ranks of a host.  Raises the
        reference's error when hosts hold unequal numbers of ranks."""
        from torch.distributed.device_mesh import DeviceMesh

        with self._lock:
            if self._hier is None:
                places = self._placements()
                counts: Dict[int, int] = {}
                for host, _ in places:
                    counts[host] = counts.get(host, 0) + 1
                if len(set(counts.values())) != 1:
                    raise ValueError(
                        "hierarchical mesh requires equal device counts "
                        f"per process; got {sorted(set(counts.values()))}")
                grid = host_major_grid(self.cross_size, self.local_size)
                if any(h >= self.cross_size or r != h * self.local_size + l
                       for r, (h, l) in enumerate(places)):
                    raise ValueError(
                        "hierarchical mesh requires the host-major rank "
                        "layout (host h holds ranks h * local_size ... "
                        f"h * local_size + local_size - 1); got {places}")
                topo = self._topology
                if topo is None:
                    topo = self._owned_topology = Topology(
                        self.rank, self.local_size, self.cross_size,
                        timeout=self._timeout)
                self._hier = DeviceMesh.from_group(
                    [topo.cross.group, topo.local.group], self.device_type,
                    mesh=grid, mesh_dim_names=(DCN_AXIS, ICI_AXIS))
            return self._hier

    def nd_mesh(self, axis_names: Sequence[str], shape: Sequence[int]):
        """An N-D mesh (e.g. ``("dp", "tp")``) over every rank."""
        from torch.distributed.device_mesh import init_device_mesh

        axis_names, shape = tuple(axis_names), tuple(int(d) for d in shape)
        if math.prod(shape) != self.num_devices:
            raise ValueError(
                f"mesh shape {shape} does not cover {self.num_devices} "
                "devices")
        with self._lock:
            key = (axis_names, shape)
            if key not in self._nd:
                self._nd[key] = init_device_mesh(
                    self.device_type, shape, mesh_dim_names=axis_names)
            return self._nd[key]

    def destroy(self) -> None:
        """Drop the meshes and destroy the groups they made (collective
        where the backend's destruction is)."""
        with self._lock:
            made = list(self._nd.values())
            meshes = [m for m in (self._world, self._proc, self._hier)
                      if m is not None] + made
            self._world = self._proc = self._hier = None
            self._nd = {}
            if self._owned_topology is not None:
                self._owned_topology.destroy()
                self._owned_topology = None
        for mesh in made:
            _destroy(mesh.get_all_groups())
        for mesh in meshes:
            _destroy(v.group for v in vars(mesh).pop(_PARTS, {}).values())


def _destroy(groups) -> None:
    for g in {id(g): g for g in groups}.values():
        if g not in (None, dist.GroupMember.NON_GROUP_MEMBER,
                     dist.group.WORLD):
            try:
                dist.destroy_process_group(g)
            except Exception:  # noqa: BLE001 — teardown goes on
                pass


# the attribute of a DeviceMesh that caches its partitions' groups
_PARTS = "_hvtpu_partitions"


def axis_view(mesh, axis_name: str, groups=None) -> GroupView:
    """This rank's span of ``mesh``'s axis ``axis_name``: a
    :class:`GroupView` over the axis's group (its ranks in the group's
    order, which is the axis order), or, with ``groups`` (the reference's
    ``axis_index_groups``: a partition of the axis indices), over the
    part that holds this rank.  A partition's groups are made at its
    first use on the mesh, for every instance of the axis (collective:
    every rank of the mesh passes the same partition), and cached on the
    mesh."""
    group = mesh.get_group(axis_name)
    if groups is None:
        return GroupView(dist.get_process_group_ranks(group), group, group)
    key = (axis_name, tuple(tuple(int(i) for i in g) for g in groups))
    cache = vars(mesh).setdefault(_PARTS, {})
    if key not in cache:
        dim = mesh.mesh_dim_names.index(axis_name)
        n = mesh.mesh.shape[dim]
        if sorted(i for g in key[1] for i in g) != list(range(n)):
            raise ValueError(
                f"groups {[list(g) for g in key[1]]} are not a partition "
                f"of the {n} indices of axis {axis_name!r}")
        me = dist.get_rank()
        rows = mesh.mesh.movedim(dim, -1).reshape(-1, n).tolist()
        for row in rows:
            row = sorted(row)
            for g in key[1]:
                members = sorted(row[i] for i in g)
                pg = dist.new_group(members)
                if me in members:
                    cache[key] = GroupView(members, pg, pg)
    return cache[key]

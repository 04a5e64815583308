"""Process-global lifecycle of the PyTorch port.

Counterpart of ``horovod_tpu/core/state.py`` (``init`` / ``shutdown`` and
the rank/size queries) over ``torch.distributed``:

* ``init()`` runs on the card: NCCL on ``cuda:{local_rank}``.  It raises
  when CUDA is absent, unless the caller asks for the CPU with
  ``init(device="cpu")``, which uses gloo.
* Rank and size come from the launcher env (``HVTPU_RANK`` /
  ``HOROVOD_RANK``, ``..._SIZE``, ``..._LOCAL_RANK``).  A world of one
  needs no launcher: its store is a ``TCPStore`` on localhost.  A larger
  world rendezvouses through ``MASTER_ADDR`` / ``MASTER_PORT``
  (``env://``).
* A process that already called ``torch.distributed.init_process_group``
  keeps its group; ``init()`` adopts its rank and size.
* ``init()`` makes the process-set table (the global set, id 0) and one
  group over the world for the async controller;
  ``add_process_set`` / ``remove_process_set`` add and remove sets.  The
  controller itself (``horovod_tpu_torch.eager``) starts at the first
  async op, and ``shutdown()`` stops it before it destroys any group.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from .config import Config
from .exceptions import NotInitializedError
from .process_set import ProcessSet, ProcessSetTable, global_process_set


@dataclasses.dataclass
class GlobalState:
    initialized: bool = False
    config: Optional[Config] = None
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: Optional[torch.device] = None
    backend: str = ""
    # True when init() created the default group (shutdown destroys it)
    owns_group: bool = False
    store: Any = None
    process_set_table: Optional[ProcessSetTable] = None
    # the async controller (horovod_tpu_torch.eager), started lazily
    controller: Any = None


_state = GlobalState()
_lock = threading.Lock()


def global_state() -> GlobalState:
    return _state


def require_init(name: str = "this operation") -> GlobalState:
    if not _state.initialized:
        raise NotInitializedError(name)
    return _state


def _resolve_device(device, cfg: Config) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): CUDA is not available; pass "
                "device='cpu' to run on the CPU over gloo")
        return torch.device("cuda", cfg.local_rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"horovod_tpu_torch.init(): device {dev} requested but "
                "CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", cfg.local_rank)
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev!r}: use 'cuda' or 'cpu'")


def init(device=None) -> GlobalState:
    """Initialize the port (idempotent)."""
    with _lock:
        if _state.initialized:
            return _state
        cfg = Config.from_env()
        dev = _resolve_device(device, cfg)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = None
        if dist.is_initialized():
            owns = False
            rank, size = dist.get_rank(), dist.get_world_size()
        else:
            rank, size = cfg.rank, cfg.size
            if size == 1:
                store = dist.TCPStore("127.0.0.1", 0, 1, True)
                dist.init_process_group(backend, store=store, rank=0,
                                        world_size=1)
            else:
                missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                           if k not in os.environ]
                if missing:
                    raise RuntimeError(
                        f"horovod_tpu_torch.init(): a world of {size} "
                        f"ranks needs {' and '.join(missing)} in the env "
                        "(or an initialized torch.distributed group)")
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=size)
            owns = True
        _state.config = cfg
        _state.rank, _state.size = rank, size
        _state.local_rank = cfg.local_rank
        _state.device, _state.backend = dev, backend
        _state.owns_group, _state.store = owns, store
        _state.process_set_table = ProcessSetTable(size, global_process_set)
        _make_groups(global_process_set)
        _state.initialized = True
        return _state


def _make_groups(ps: ProcessSet) -> None:
    """The set's groups: the sync ops' (the default group for the global
    set) and the controller's.  ``new_group`` is collective: every rank
    calls it, members or not, in the same order."""
    if ps.process_set_id != 0:
        ps.group = dist.new_group(ps.ranks)
    ps.controller_group = dist.new_group(ps.ranks)


def _destroy_groups(ps: ProcessSet) -> None:
    for group in (ps.group, ps.controller_group):
        if group not in (None, dist.GroupMember.NON_GROUP_MEMBER):
            dist.destroy_process_group(group)


def add_process_set(ps) -> ProcessSet:
    """Add a process set (a ``ProcessSet`` or a list of ranks) and make
    its groups.  Collective, as Horovod's is: every rank calls it, members
    or not, with the same sets in the same order, so that every rank
    gives the set the same id and ``new_group`` pairs up.  A live async
    controller learns the set at once (``horovod_tpu/core/state.py:659``).
    """
    st = require_init("add_process_set")
    if not isinstance(ps, ProcessSet):
        ps = ProcessSet(ps)
    st.process_set_table.add(ps)
    _make_groups(ps)
    if st.controller is not None:
        st.controller.register_process_set(ps.process_set_id, ps.ranks)
    return ps


def remove_process_set(ps) -> bool:
    """Remove a process set and destroy its groups; False when it is not
    in the table (the global set cannot be removed).  Collective: every
    rank removes the same sets, with no op of the set in flight."""
    st = require_init("remove_process_set")
    psid = ps.process_set_id if isinstance(ps, ProcessSet) else int(ps)
    try:
        removed = st.process_set_table.remove(psid)
    except ValueError:
        return False
    _destroy_groups(removed)
    removed._unbind()
    return True


def shutdown():
    """Tear down: stop the async controller (every pending op fails),
    then destroy the groups, and the default group if ``init()`` created
    it."""
    with _lock:
        if not _state.initialized:
            return
        if _state.controller is not None:
            _state.controller.request_shutdown()
            _state.controller.stop()
            _state.controller = None
        for psid, ps in _state.process_set_table.items().items():
            if dist.is_initialized():
                _destroy_groups(ps)
            ps._unbind(global_set=psid == 0)
        if _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _state.__init__()


def is_initialized() -> bool:
    return _state.initialized


def rank() -> int:
    return require_init("rank()").rank


def size() -> int:
    return require_init("size()").size


def local_rank() -> int:
    return require_init("local_rank()").local_rank


def device() -> torch.device:
    """The device collectives and the training step run on."""
    return require_init("device()").device

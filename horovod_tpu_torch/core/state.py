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
from .process_set import global_process_set


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
        global_process_set._bind(0, size)
        _state.initialized = True
        return _state


def shutdown():
    """Tear down; destroys the default group if ``init()`` created it."""
    with _lock:
        if not _state.initialized:
            return
        if _state.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        global_process_set._unbind()
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

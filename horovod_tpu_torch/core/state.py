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
* ``init()`` builds the coordination client (``core/kv.py``) on the
  default group's store, arms the fault harness from
  ``HVTPU_FAULT_SPEC`` (``core/faults.py``) and counts the init
  generation that namespaces the stall watchdog's keys; the watchdog
  itself (``comm/stall.py``) starts at the first guarded collective.
  ``shutdown()`` stops it (its goodbye rides the store) before any group
  goes away.  When the watchdog abandoned a wedged collective, the
  teardown is bounded: the NCCL communicators are aborted
  (:func:`abort_group`), a gloo group's destruction gets 15 s, and an
  exit hook hard-exits past what is still stuck.

The observability planes (``horovod_tpu_torch/obs``) install at
``init()`` as the reference's do (``horovod_tpu/core/state.py``): the
identity gauges and the metrics endpoint (``HVTPU_METRICS_PORT``), the
rendezvous histogram, the timeline (``HVTPU_TIMELINE``), tracing
(``HVTPU_TRACE``, with its clock handshake over a fenced store client
past one rank), the ``job`` debug provider, the step profiler
(``HVTPU_STEPPROF``), the flight recorder (``HVTPU_FLIGHT``,
``HVTPU_FLIGHT_DIR``) and anomaly detection (``HVTPU_ANOMALY``).  A plane
that fails to install logs a warning and stays off; ``shutdown()``
tears them down.

Not yet ported: the journal replay at ``init()`` (``core/journal.py``)
comes with the elastic plane, and so do the preemption watcher and the
fleet health publisher of the reference's ``init()``.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..comm import stall
from ..obs import metrics as obs_metrics
from . import faults
from .config import Config
from .exceptions import NotInitializedError
from .kv import StoreKV
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
    # the coordination client over the default group's store (core/kv.py)
    kv: Any = None
    # the sync-path stall inspector (comm/stall.py), made at the first
    # guarded collective; False = probed, no store
    sync_stall: Any = None
    # per-process init counter: namespaces the watchdog's store keys so
    # a shutdown -> init cycle never reads the previous init's marks
    init_generation: int = 0
    # the timeout of the groups init() creates (None: the backend's)
    group_timeout: Optional[datetime.timedelta] = None
    # the Chrome-trace timeline (obs/timeline.py), HVTPU_TIMELINE or
    # start_timeline
    timeline: Any = None


_state = GlobalState()
_lock = threading.Lock()
_atexit_registered = False
logger = logging.getLogger("horovod_tpu_torch")


def global_state() -> GlobalState:
    return _state


def _job_debug_state() -> dict:
    """Job identity for the metrics server's /debug endpoint
    (registered by init(), removed by shutdown())."""
    return {
        "initialized": _state.initialized,
        "rank": _state.rank,
        "size": _state.size,
        "local_rank": _state.local_rank,
        "init_generation": _state.init_generation,
        "elastic_generation": int(
            os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0),
        "device": str(_state.device),
        "backend": _state.backend,
    }


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


def _group_timeout(cfg: Config, backend: str):
    """The timeout of the groups ``init()`` creates: the backend's own
    (NCCL's collective timeout, 10 min by default; gloo's 30 min), raised
    when a stall abort time is set so that the watchdog's abort, which
    names the ranks, comes at least 60 s before the backend's watchdog
    ends the process.  None when it needs no raising."""
    abort = cfg.stall_shutdown_time_seconds
    if cfg.stall_check_disable or abort <= 0:
        return None
    from torch.distributed import constants

    default = constants.default_pg_timeout
    if backend == "nccl":
        default = getattr(constants, "default_pg_nccl_timeout", default)
    want = datetime.timedelta(seconds=abort + 60)
    return want if want > default else None


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
        timeout = _group_timeout(cfg, backend)
        if dist.is_initialized():
            owns = False
            rank, size = dist.get_rank(), dist.get_world_size()
        else:
            rank, size = cfg.rank, cfg.size
            if size == 1:
                store = dist.TCPStore("127.0.0.1", 0, 1, True)
                dist.init_process_group(backend, store=store, rank=0,
                                        world_size=1, timeout=timeout)
            else:
                missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                           if k not in os.environ]
                if missing:
                    raise RuntimeError(
                        f"horovod_tpu_torch.init(): a world of {size} "
                        f"ranks needs {' and '.join(missing)} in the env "
                        "(or an initialized torch.distributed group)")
                t_rdv = time.monotonic()
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=size,
                                        timeout=timeout)
                obs_metrics.histogram(
                    "hvtpu_rendezvous_seconds",
                    "Coordination-service rendezvous duration at init "
                    "(per incarnation; elastic restarts re-observe it).",
                ).observe(time.monotonic() - t_rdv)
            owns = True
        _state.config = cfg
        _state.rank, _state.size = rank, size
        _state.local_rank = cfg.local_rank
        _state.device, _state.backend = dev, backend
        _state.owns_group, _state.store = owns, store
        _state.group_timeout = timeout if owns else None
        _state.process_set_table = ProcessSetTable(size, global_process_set)
        _make_groups(global_process_set)
        _state.kv = StoreKV(dist.PrefixStore(
            "hvt_kv", dist.distributed_c10d._get_default_store()), size)
        _state.init_generation += 1
        # armed once the true rank is known, so rank-selected clauses
        # bind correctly; a malformed spec fails init loudly
        if cfg.fault_spec:
            faults.install_from_config(cfg, rank)
        _install_obs(cfg)
        global _atexit_registered
        if not _atexit_registered:
            atexit.register(_shutdown_at_exit)
            _atexit_registered = True
        _state.initialized = True
        return _state


def _install_obs(cfg: Config) -> None:
    """The observability planes, in the reference's order.  A plane
    that fails to install logs a warning and stays off: telemetry never
    takes a healthy job down."""
    from ..obs import anomaly, flight, stepprof, tracing
    from ..obs.timeline import Timeline
    from .retry import fenced_kv

    # identity gauges for the cluster view (summed by
    # metrics.aggregate, the worker gauge is the cluster worker count)
    obs_metrics.gauge(
        "hvtpu_elastic_workers",
        "Live worker (rank) count of this incarnation's world as "
        "seen by this rank.",
    ).set(_state.size)
    obs_metrics.gauge(
        "hvtpu_elastic_generation",
        "Elastic incarnation counter (0 = first launch; bumps on "
        "every driver relaunch).",
    ).set(int(os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0))
    obs_metrics.serve_from_env(local_rank=_state.local_rank)
    if cfg.timeline_filename:
        _state.timeline = Timeline(cfg.timeline_filename, _state.rank,
                                   mark_cycles=cfg.timeline_mark_cycles)
    if cfg.trace_dir:
        try:
            client = (fenced_kv(_state.kv, rank=_state.rank)
                      if _state.size > 1 else None)
            tracing.install(cfg.trace_dir, rank=_state.rank,
                            size=_state.size, client=client,
                            pings=cfg.trace_clock_pings)
        except Exception:  # noqa: BLE001 — tracing must not kill init
            logger.warning("distributed tracing disabled: install failed",
                           exc_info=True)
    obs_metrics.register_debug_provider("job", _job_debug_state)
    try:
        if stepprof.ACTIVE:
            stepprof.install()
    except Exception:  # noqa: BLE001
        pass
    try:
        if flight.env_enabled():
            flight.install(
                rank=_state.rank, size=_state.size,
                generation=int(os.environ.get(
                    "HVTPU_ELASTIC_GENERATION", "0") or 0),
                out_dir=(os.environ.get("HVTPU_FLIGHT_DIR")
                         or cfg.trace_dir
                         or os.environ.get("HVTPU_ELASTIC_STATE_DIR")
                         or "."),
                window=flight.env_window())
    except Exception:  # noqa: BLE001
        logger.warning("flight recorder disabled: install failed",
                       exc_info=True)
    try:
        if anomaly.env_enabled():
            anomaly.install(rank=_state.rank, size=_state.size)
    except Exception:  # noqa: BLE001
        logger.warning("anomaly detection disabled: install failed",
                       exc_info=True)


def _uninstall_obs() -> None:
    """Tear the planes down (each idempotent): the timeline and the
    trace files are flushed, the anomaly engine and the flight recorder
    dropped (postmortems exist for fatal paths only), the providers
    unregistered and the metrics endpoint stopped."""
    from ..obs import anomaly, flight, stepprof, tracing

    if _state.timeline is not None:
        try:
            _state.timeline.close()
        except Exception:  # noqa: BLE001
            pass
        _state.timeline = None
    for teardown in (tracing.uninstall, anomaly.uninstall,
                     flight.uninstall,
                     lambda: obs_metrics.unregister_debug_provider("job"),
                     stepprof.uninstall, obs_metrics.stop_http_server):
        try:
            teardown()
        except Exception:  # noqa: BLE001 — teardown goes on
            pass


def _make_groups(ps: ProcessSet) -> None:
    """The set's groups: the sync ops' (the default group for the global
    set) and the controller's.  ``new_group`` is collective: every rank
    calls it, members or not, in the same order."""
    timeout = _state.group_timeout
    if ps.process_set_id != 0:
        ps.group = dist.new_group(ps.ranks, timeout=timeout)
    ps.controller_group = dist.new_group(ps.ranks, timeout=timeout)


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


def abort_group(group=None) -> None:
    """Abort a NCCL group's communicators (None: every group, the
    default one included), so that teardown does not wait on a
    collective the watchdog abandoned.  torch's
    ``distributed_c10d._abort_process_group``."""
    dist.distributed_c10d._abort_process_group(group)


def _teardown_groups() -> None:
    for psid, ps in _state.process_set_table.items().items():
        if dist.is_initialized():
            _destroy_groups(ps)
        ps._unbind(global_set=psid == 0)
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def _abandon_groups() -> None:
    """Teardown past a wedged collective: abort the NCCL communicators
    first; a gloo group's destruction runs on a daemon thread that gets
    15 s, as the reference bounds its distributed shutdown."""
    if _state.backend == "nccl" and dist.is_initialized():
        try:
            abort_group()
        except Exception:  # noqa: BLE001 — teardown goes on
            logger.warning("aborting the NCCL groups failed",
                           exc_info=True)
    t = threading.Thread(target=_teardown_groups, daemon=True)
    t.start()
    t.join(timeout=15.0)
    for psid, ps in _state.process_set_table.items().items():
        ps._unbind(global_set=psid == 0)


def shutdown():
    """Tear down: stop the async controller (every pending op fails),
    the observability planes, the stall watchdog (its goodbye rides the
    store), then destroy the groups, and the default group if ``init()``
    created it."""
    with _lock:
        if not _state.initialized:
            return
        if _state.controller is not None:
            _state.controller.request_shutdown()
            _state.controller.stop()
            _state.controller = None
        # the trace files are flushed before the store goes away
        _uninstall_obs()
        try:
            stall.stop(_state)
        except Exception:  # noqa: BLE001 — teardown goes on
            _state.sync_stall = None
        if stall.poisoned():
            _abandon_groups()
        else:
            _teardown_groups()
        generation = _state.init_generation
        _state.__init__()
        _state.init_generation = generation


def _shutdown_at_exit():
    try:
        shutdown()
    except Exception:  # noqa: BLE001
        pass
    if stall.poisoned():
        # Interpreter teardown would park on the stuck collective:
        # hard-exit like the reference's stall shutdown does.  Handlers
        # registered before this one (atexit runs LIFO) do not run.
        logger.critical(
            "hard-exiting past a wedged collective abandoned by the stall "
            "watchdog; atexit handlers registered before "
            "horovod_tpu_torch will not run")
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(stall.poison_exit_status())


def start_timeline(filename: str, mark_cycles: bool = False):
    """Begin writing a Chrome-trace timeline (parity: hvd.start_timeline,
    ``horovod_tpu/__init__.py``).  A timeline already running is closed;
    its open spans carry over into the new file, and a live async
    controller gets the new timeline."""
    from ..obs.timeline import Timeline

    st = require_init("start_timeline")
    old = st.timeline
    new_tl = Timeline(filename, st.rank, mark_cycles=mark_cycles)
    if old is not None:
        # carry in-flight spans over so their 'E' events land in the
        # new file; close() below writes matching 'E's into the old one
        for name, phase in list(old._open_spans.items()):
            new_tl.begin(name, phase)
    st.timeline = new_tl
    if st.controller is not None:
        st.controller._timeline = new_tl
    if old is not None:
        old.close()
    return new_tl


def stop_timeline():
    """Stop and flush the timeline (parity: hvd.stop_timeline)."""
    st = require_init("stop_timeline")
    if st.timeline is not None:
        st.timeline.close()
        st.timeline = None
    if st.controller is not None:
        st.controller._timeline = None


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

"""Process-global lifecycle of the PyTorch port.

Counterpart of ``horovod_tpu/core/state.py`` (``init`` / ``shutdown`` and
the rank/size queries) over ``torch.distributed``:

* ``init()`` runs on the card: NCCL on ``cuda:{local_rank}``.  It raises
  when CUDA is absent, unless the caller asks for the CPU with
  ``init(device="cpu")``, which uses gloo.
* Rank, size and the host layout come from the launcher env
  (``HVTPU_RANK`` / ``HOROVOD_RANK``, ``..._SIZE``, ``..._LOCAL_RANK``,
  ``..._LOCAL_SIZE``, ``..._CROSS_RANK``, ``..._CROSS_SIZE``).  Under the
  port's launcher (``python -m horovod_tpu_torch.runner``) every rank
  rendezvouses on its coordinator, ``HVTPU_COORDINATOR_ADDR`` /
  ``HVTPU_COORDINATOR_PORT``: rank 0 serves a ``TCPStore`` there, the
  others connect within ``HVTPU_START_TIMEOUT``, and the store is the
  default group's.  Without a coordinator a world of one uses a
  ``TCPStore`` on localhost, and a larger world rendezvouses through
  ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``, as ``torchrun`` sets
  them).
* The device is ``cuda:{local_rank}``, checked against the cards this
  process sees; ``HVTPU_CPU_DEVICES=1`` (the launcher's
  ``--cpu-devices 1``) or ``init(device="cpu")`` asks for the CPU, and
  an explicit ``device`` wins over the env.
* A process that already called ``torch.distributed.init_process_group``
  keeps its group; ``init()`` adopts its rank and size.
* ``init()`` makes the process-set table (the global set, id 0), one
  group over the world for the async controller, and the mesh factory
  (``core/topology.Meshes``: ``world_mesh()``, ``hierarchical_mesh()``,
  ``mesh(axis_names, shape)``, each made at its first use; ``shutdown()``
  destroys their groups);
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

Under ``HVTPU_ELASTIC=1`` ``init()`` also arms the preemption watcher
(``core/preempt.py``: the signal handler, the notice file, the drain
protocol over a fenced, journaled store client past one rank) and, in a
relaunched incarnation (``HVTPU_ELASTIC_GENERATION`` > 0), replays this
rank's journaled keys (``core/journal.py``) into the fresh store, as the
reference's ``init()`` does; ``shutdown()`` uninstalls the watcher
before the store goes away.  The reference's fleet health publisher is
not part of the port.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import logging
import os
import threading
import time
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..comm import stall
from ..obs import metrics as obs_metrics
from . import faults
from .config import Config
from .exceptions import NotInitializedError
from .kv import StoreKV
from .process_set import ProcessSet, ProcessSetTable, global_process_set
from .topology import Meshes, Topology, hierarchical_layout


@dataclasses.dataclass
class GlobalState:
    initialized: bool = False
    config: Optional[Config] = None
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    device: Optional[torch.device] = None
    backend: str = ""
    # True when init() created the default group (shutdown destroys it)
    owns_group: bool = False
    store: Any = None
    process_set_table: Optional[ProcessSetTable] = None
    # the async controller (horovod_tpu_torch.eager), started lazily
    controller: Any = None
    # the autotuner (obs/autotune.py) when HVTPU_AUTOTUNE is set; the
    # controller scores its cycles with it
    autotuner: Any = None
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
    # the local and cross groups (core/topology.py)
    topology: Any = None
    # the meshes (core/topology.Meshes), each made at its first use
    meshes: Any = None


_state = GlobalState()
_lock = threading.Lock()
# the ring communicators (ops/ring.py ProcessRing) of the
# HVTPU_QUANTIZED_RING route, one a torch.distributed group, in the order
# made; apart from GlobalState because the route serves groups made
# without init() too
_rings: List[Tuple[Any, Any]] = []
_rings_lock = threading.Lock()
_atexit_registered = False
logger = logging.getLogger("horovod_tpu_torch")
# HVTPU_LOG_LEVEL's names, as the reference maps them onto ``logging``
_LOG_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
               "info": logging.INFO, "warning": logging.WARNING,
               "error": logging.ERROR, "fatal": logging.CRITICAL}


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
        "local_size": _state.local_size,
        "cross_rank": _state.cross_rank,
        "cross_size": _state.cross_size,
        "init_generation": _state.init_generation,
        "elastic_generation": int(
            os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0),
        "device": str(_state.device),
        "backend": _state.backend,
    }


def _coordination_client_active() -> bool:
    """True when the coordination client is up past one rank: a
    ``torch.distributed`` store and more than one rank (the reference's
    test of a live ``jax.distributed`` client)."""
    return (_state.initialized and _state.kv is not None
            and _state.size > 1)


def _replay_journal(kv, rank: int) -> None:
    """Relaunched incarnation: re-publish this rank's journaled durable
    keys (restore-quorum votes, drain accounting: ``core/journal.py``)
    into the fresh store.  Every relaunch starts an EMPTY store, so
    without replay a relaunch also loses the accounting the recovery
    protocols need.  Best-effort: a failed replay degrades to the
    protocols recomputing from scratch."""
    if kv is None:
        return
    if int(os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0) <= 0:
        return
    try:
        from ..obs import flight
        from .journal import default_journal

        journal = default_journal(rank)
        if journal is None or len(journal) == 0:
            return
        replayed = journal.replay(kv)
        if flight.ACTIVE:
            flight.note("journal_replayed", rank=rank, keys=replayed,
                        journaled=len(journal))
        logger.info("kv journal: rank %d replayed %d of %d durable "
                    "key(s) into the fresh store", rank, replayed,
                    len(journal))
    except Exception:  # noqa: BLE001 — best-effort
        logger.warning("kv journal: replay failed (protocols will "
                       "recompute)", exc_info=True)


def _install_preempt(cfg: Config) -> None:
    """Graceful-preemption watcher (``core/preempt.py``) for an elastic
    job: the drain coordinator authors durable keys, so its client is
    fenced and journaled.  Failure degrades to plain SIGTERM death, not
    a broken init."""
    try:
        from . import preempt
        from .journal import default_journal
        from .retry import fenced_kv

        client = None
        if _state.size > 1:
            client = fenced_kv(_state.kv, rank=_state.rank,
                               journal=default_journal(_state.rank))
        preempt.install(cfg, rank=_state.rank, size=_state.size,
                        client=client)
        _replay_journal(client, _state.rank)
    except Exception:  # noqa: BLE001
        logger.warning("graceful preemption disabled: install failed",
                       exc_info=True)


def require_init(name: str = "this operation") -> GlobalState:
    if not _state.initialized:
        raise NotInitializedError(name)
    return _state


def _cuda_device(index: int, cfg: Config) -> torch.device:
    """``cuda:{index}``, checked against the cards this process sees: a
    launch of more ranks a host than cards would otherwise die in
    ``set_device`` with CUDA's "invalid device ordinal", naming no rank,
    while its peers wait in the rendezvous."""
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"horovod_tpu_torch.init(): rank {cfg.rank} (local rank "
            f"{cfg.local_rank}) needs cuda:{index}, but this process "
            f"sees {count} CUDA device(s); launch at most {count} "
            "rank(s) a host, or pass --cpu-devices 1 to run on the CPU")
    return torch.device("cuda", index)


def _resolve_device(device, cfg: Config) -> torch.device:
    if cfg.cpu_devices > 1:
        raise ValueError(
            f"HVTPU_CPU_DEVICES={cfg.cpu_devices}: the port runs one "
            "device a process (NCCL takes one rank of a communicator a "
            "card); use --cpu-devices 1 and a rank a device, and the "
            "meshes (world_mesh(), mesh(axis_names, shape)) over the "
            "ranks")
    if device is None and cfg.cpu_devices == 1:
        return torch.device("cpu")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): CUDA is not available; pass "
                "device='cpu' (or launch with --cpu-devices 1) to run on "
                "the CPU over gloo")
        return _cuda_device(cfg.local_rank, cfg)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"horovod_tpu_torch.init(): device {dev} requested but "
                "CUDA is not available")
        return _cuda_device(
            cfg.local_rank if dev.index is None else dev.index, cfg)
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
        logger.setLevel(_LOG_LEVELS.get(cfg.log_level.lower(),
                                        logging.WARNING))
        if cfg.elastic:
            # before the (possibly long) rendezvous: a host update that
            # arrives meanwhile sets the flag instead of killing the
            # process with the default disposition
            from ..elastic.worker import _install_sigusr1_handler

            _install_sigusr1_handler()
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
            if cfg.coordinator_addr and cfg.coordinator_port:
                # the launcher's coordinator: rank 0 serves the store
                t_rdv = time.monotonic()
                store = dist.TCPStore(
                    cfg.coordinator_addr, cfg.coordinator_port, size,
                    is_master=rank == 0,
                    timeout=datetime.timedelta(seconds=cfg.start_timeout))
                dist.init_process_group(backend, store=store, rank=rank,
                                        world_size=size, timeout=timeout)
                _observe_rendezvous(time.monotonic() - t_rdv)
            elif size == 1:
                store = dist.TCPStore("127.0.0.1", 0, 1, True)
                dist.init_process_group(backend, store=store, rank=0,
                                        world_size=1, timeout=timeout)
            else:
                missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                           if k not in os.environ]
                if missing:
                    raise RuntimeError(
                        f"horovod_tpu_torch.init(): a world of {size} "
                        "ranks needs a rendezvous: launch it with "
                        "python -m horovod_tpu_torch.runner "
                        "(HVTPU_COORDINATOR_ADDR / HVTPU_COORDINATOR_PORT)"
                        f" or set {' and '.join(missing)} (or initialize "
                        "a torch.distributed group first)")
                t_rdv = time.monotonic()
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=size,
                                        timeout=timeout)
                _observe_rendezvous(time.monotonic() - t_rdv)
            owns = True
        _state.config = cfg
        _state.rank, _state.size = rank, size
        _state.local_rank = cfg.local_rank
        # the host layout comes from the launcher past one rank; a world
        # of one is its own host (the reference's rule)
        if size > 1:
            _state.local_size = cfg.local_size
            _state.cross_rank = cfg.cross_rank
            _state.cross_size = cfg.cross_size
        _state.device, _state.backend = dev, backend
        _state.owns_group, _state.store = owns, store
        _state.group_timeout = timeout if owns else None
        _state.process_set_table = ProcessSetTable(size, global_process_set)
        _make_groups(global_process_set)
        if hierarchical_layout(cfg, size, _state.local_size,
                               _state.cross_size):
            # the hierarchical route's groups, made here so that every
            # rank creates them at the same point of its program
            _state.topology = Topology(rank, _state.local_size,
                                       _state.cross_size,
                                       timeout=_state.group_timeout)
        _state.meshes = Meshes(dev.type, rank, size, _state.local_rank,
                               _state.local_size, _state.cross_rank,
                               _state.cross_size, _state.topology,
                               timeout=_state.group_timeout)
        _state.kv = StoreKV(dist.PrefixStore(
            "hvt_kv", dist.distributed_c10d._get_default_store()), size)
        _state.init_generation += 1
        # armed once the true rank is known, so rank-selected clauses
        # bind correctly; a malformed spec fails init loudly
        if cfg.fault_spec:
            faults.install_from_config(cfg, rank)
        _install_obs(cfg)
        if cfg.elastic:
            _install_preempt(cfg)
        if cfg.autotune:
            from ..obs.autotune import Autotuner

            _state.autotuner = Autotuner(cfg)
        global _atexit_registered
        if not _atexit_registered:
            atexit.register(_shutdown_at_exit)
            _atexit_registered = True
        _state.initialized = True
        return _state


def _observe_rendezvous(seconds: float) -> None:
    obs_metrics.histogram(
        "hvtpu_rendezvous_seconds",
        "Coordination-service rendezvous duration at init "
        "(per incarnation; elastic restarts re-observe it).",
    ).observe(seconds)


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


def process_ring(group=None):
    """The ``ProcessRing`` of ``group`` (None: the default group), made at
    its first use.  A process set, and the hierarchical route's local and
    cross views, each get the ring of the group they pass."""
    from ..ops.ring import ProcessRing

    if group is not None and group is dist.group.WORLD:
        group = None          # the default group by its own name
    with _rings_lock:
        for g, ring in _rings:
            if g is group:
                return ring
        ring = ProcessRing(group)
        _rings.append((group, ring))
        return ring


def close_rings(groups=None, abandon: bool = False) -> None:
    """Close the rings of ``groups`` (None: every ring) in the order they
    were made, before their groups go away: each unmaps its neighbours'
    memory, then frees its own (collective over its group).  ``abandon``,
    past a wedged collective: forget them without touching the card; the
    process's exit frees the memory."""
    with _rings_lock:
        gone = [(g, r) for g, r in _rings
                if groups is None or any(g is x for x in groups)]
        _rings[:] = [e for e in _rings if e not in gone]
    if abandon:
        return
    for _, ring in gone:
        try:
            ring.close()
        except Exception:  # noqa: BLE001 — teardown goes on
            logger.warning("closing a ring communicator failed",
                           exc_info=True)


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
    close_rings([removed.group, removed.controller_group])
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
    close_rings()
    if _state.meshes is not None and dist.is_initialized():
        _state.meshes.destroy()
    if _state.topology is not None and dist.is_initialized():
        _state.topology.destroy()
    for psid, ps in _state.process_set_table.items().items():
        if dist.is_initialized():
            _destroy_groups(ps)
        ps._unbind(global_set=psid == 0)
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()


def _abandon_groups() -> None:
    """Teardown past a wedged collective: abort the NCCL communicators
    first; a gloo group's destruction runs on a daemon thread that gets
    15 s, as the reference bounds its distributed shutdown.  The ring
    communicators are forgotten, not closed (a close syncs the card and
    waits on the group)."""
    close_rings(abandon=True)
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
        # the preemption watcher polls the store: stop it first (it also
        # restores the previous signal handler)
        try:
            from . import preempt

            preempt.uninstall()
        except Exception:  # noqa: BLE001 — teardown goes on
            pass
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


def local_size() -> int:
    return require_init("local_size()").local_size


def cross_rank() -> int:
    return require_init("cross_rank()").cross_rank


def cross_size() -> int:
    return require_init("cross_size()").cross_size


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks (parity:
    ``hvd.is_homogeneous``, the reference's rule): a world of one host
    is, and a world of several relies on the launcher's uniformity
    certificate (``HVTPU_UNIFORM_LOCAL_SIZE``)."""
    st = require_init("is_homogeneous()")
    if st.size == 1 or st.cross_size == 1:
        return True
    return bool(st.config and st.config.uniform_local_size > 0)


def num_devices() -> int:
    """Devices in the job: one a rank (``size()``)."""
    return require_init("num_devices()").meshes.num_devices


def local_devices() -> List[torch.device]:
    """This process's devices: its one device."""
    return [require_init("local_devices()").device]


def world_mesh():
    """The 1-D ``DeviceMesh`` (axis ``world``) over every rank."""
    return require_init("world_mesh()").meshes.world_mesh()


def hierarchical_mesh():
    """The ``(dcn, ici)`` ``DeviceMesh``: hosts x ranks of a host."""
    return require_init("hierarchical_mesh()").meshes.hierarchical_mesh()


def mesh(axis_names, shape):
    """An N-D ``DeviceMesh``, e.g. ``mesh(("dp", "tp"), (4, 2))``."""
    return require_init("mesh()").meshes.nd_mesh(tuple(axis_names),
                                                 tuple(shape))


def device() -> torch.device:
    """The device collectives and the training step run on."""
    return require_init("device()").device

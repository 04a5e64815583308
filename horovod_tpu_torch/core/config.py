"""Environment-variable configuration of the PyTorch port.

Counterpart of ``horovod_tpu/core/config.py``: the same env names, read
the same way (``HVTPU_<NAME>`` first, then the reference's
``HOROVOD_<NAME>``), for the fields this part of the port uses — the
fusion threshold, the controller's cycle time and response-cache
capacity, the hierarchical allreduce and the launcher's layout
certificate, the timeline and the trace directory, the stall watchdog's
settings, the fault-injection spec and seed, the topology and the
coordinator the launcher sets (rank, size, local and cross rank and
size, address, port, start timeout), the launcher's CPU request, the
log level, and elastic training (the elastic flag, the preemption
signal, notice file and drain grace, and the timeout the elastic driver
takes when ``--elastic-timeout`` is not given).

It also carries the reference's fields that nothing of either package
applies (``batch_d2d_memcopies``, ``compression``, ``adasum``,
``controller_addr``, ``controller_port``), read from the same variables
so that a setting is never dropped without a trace, and the elastic
driver's discovery interval, restart budget and blacklist cooldowns,
which the driver and the discovery read from the env themselves, as
the reference's do.  The reference's ``eager_multidevice`` is left out:
the port runs one device a process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default=None):
    """HVTPU_x, falling back to HOROVOD_x, falling back to default."""
    for prefix in ("HVTPU_", "HOROVOD_"):
        v = os.environ.get(prefix + name)
        if v is not None:
            return v
    return default


def _env_int(name: str, default: int) -> int:
    v = _env(name)
    return int(v) if v not in (None, "") else default


def _env_float(name: str, default: float) -> float:
    v = _env(name)
    return float(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = _env(name)
    if v in (None, ""):
        return default
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def _env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = _env(name)
    return v if v not in (None, "") else default


@dataclasses.dataclass
class Config:
    """Runtime configuration snapshot, read once at ``init()``."""

    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 1.0
    cache_capacity: int = 1024
    batch_d2d_memcopies: bool = True

    # --- wire format / reduction: read, and applied by neither package
    # (the launcher refuses --compression; ROADMAP Queue C) ---
    # "none" | "fp16" | "bf16" | "int8"
    compression: str = "none"
    adasum: bool = False

    # two-stage allreduce over the local and cross groups
    # (core/topology.py; parity: HOROVOD_HIERARCHICAL_ALLREDUCE)
    hierarchical_allreduce: bool = False
    # set by the launcher when every host has the SAME slot count (0 =
    # non-uniform or unknown); the hierarchical route requires it so
    # all ranks agree on the (cross, local) grid
    uniform_local_size: int = 0

    # --- timeline / tracing ---
    timeline_filename: Optional[str] = None
    timeline_mark_cycles: bool = False
    # directory for per-rank cross-rank trace files (obs/tracing.py);
    # None disables tracing entirely (the hot-path guard is a single
    # module-attribute check)
    trace_dir: Optional[str] = None
    # store clock-sync pings per rank at trace install (min-RTT sample
    # wins; more pings tighten the offset error bound)
    trace_clock_pings: int = 8

    # --- stall inspector (comm/stall.py) ---
    stall_check_disable: bool = False
    stall_check_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0  # 0 = never abort
    # "amortized" (default: local bookkeeping + background heartbeat,
    # ~zero per-op cost, detection within one heartbeat) | "strict"
    # (pre-dispatch store rendezvous per op: nothing dispatches until all
    # members confirm the same descriptor, at one round trip per op)
    stall_check_mode: str = "amortized"
    stall_heartbeat_seconds: float = 0.5

    # --- fault injection (core/faults.py) ---
    fault_spec: Optional[str] = None
    fault_seed: int = 0

    # --- autotune (obs/autotune.py) ---
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    # samples the GP (Bayesian) tuner takes before pinning the best
    autotune_gp_samples: int = 12
    # "gp" (Bayesian, reference parity) | "grid" (deterministic sweep)
    autotune_mode: str = "gp"

    # --- process topology (set by the launcher, like HOROVOD_RANK/SIZE) ---
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1

    # --- rendezvous: the launcher's coordinator (a TCPStore that rank 0
    # serves; core/state.py) ---
    coordinator_addr: Optional[str] = None
    coordinator_port: int = 0
    # startup/rendezvous window (parity: horovodrun --start-timeout)
    start_timeout: float = 600.0

    # --- the reference's controller transport; the port's controller
    # rides the coordinator's store, so these are read and not used ---
    controller_addr: Optional[str] = None
    controller_port: int = 0

    # --- elastic (elastic/, core/durable.py) ---
    elastic: bool = False
    elastic_timeout: float = 600.0
    elastic_discovery_interval: float = 1.0
    # restart budget: total relaunches the elastic driver may perform
    # (-1 = unlimited); with restart_window_seconds > 0 the budget
    # applies to a sliding window instead of the whole job
    max_restarts: int = -1
    restart_window_seconds: float = 0.0
    # blacklist cooldown (seconds): the first strike sidelines a host
    # this long, doubling per strike up to the max
    blacklist_cooldown_seconds: float = 300.0
    blacklist_cooldown_max_seconds: float = 3600.0

    # --- graceful preemption / drain (core/preempt.py) ---
    # signal interpreted as a preemption notice; a name that does not
    # resolve (the empty one included) falls back to SIGTERM. The
    # notice file and the fault action work whatever the signal.
    preempt_signal: str = "SIGTERM"
    # optional path polled for a preemption notice
    preempt_notice_file: Optional[str] = None
    # seconds a preempted worker may spend reaching a drain commit
    # before force-exiting with the planned-departure code anyway
    drain_grace_seconds: float = 30.0

    # the level of the package's loggers (parity: HOROVOD_LOG_LEVEL;
    # trace|debug|info|warning|error|fatal)
    log_level: str = "warning"

    # --- the launcher's CPU request (``--cpu-devices N``): run this
    # process on the CPU over gloo; the port keeps one device a
    # process, so N above 1 is refused at init() ---
    cpu_devices: int = 0

    @staticmethod
    def from_env() -> "Config":
        fusion_mb = _env_str("FUSION_THRESHOLD_MB")
        if fusion_mb is not None:
            fusion_bytes = int(float(fusion_mb) * 1024 * 1024)
        else:
            fusion_bytes = _env_int("FUSION_THRESHOLD", 64 * 1024 * 1024)
        return Config(
            fusion_threshold_bytes=fusion_bytes,
            cycle_time_ms=_env_float("CYCLE_TIME", 1.0),
            cache_capacity=_env_int("CACHE_CAPACITY", 1024),
            batch_d2d_memcopies=_env_bool("BATCH_D2D_MEMCOPIES", True),
            compression=_env_str("COMPRESSION", "none"),
            adasum=_env_bool("ADASUM", False),
            hierarchical_allreduce=_env_bool("HIERARCHICAL_ALLREDUCE",
                                             False),
            uniform_local_size=_env_int("UNIFORM_LOCAL_SIZE", 0),
            timeline_filename=_env_str("TIMELINE"),
            timeline_mark_cycles=_env_bool("TIMELINE_MARK_CYCLES", False),
            trace_dir=_env_str("TRACE"),
            trace_clock_pings=_env_int("TRACE_CLOCK_PINGS", 8),
            stall_check_disable=_env_bool("STALL_CHECK_DISABLE", False),
            stall_check_time_seconds=_env_float(
                "STALL_CHECK_TIME_SECONDS", 60.0),
            stall_shutdown_time_seconds=_env_float(
                "STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            stall_check_mode=_env_str("STALL_CHECK_MODE", "amortized"),
            stall_heartbeat_seconds=_env_float(
                "STALL_HEARTBEAT_SECONDS", 0.5),
            fault_spec=_env_str("FAULT_SPEC"),
            fault_seed=_env_int("FAULT_SEED", 0),
            autotune=_env_bool("AUTOTUNE", False),
            autotune_log=_env_str("AUTOTUNE_LOG"),
            autotune_warmup_samples=_env_int("AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int("AUTOTUNE_STEPS_PER_SAMPLE",
                                               10),
            autotune_gp_samples=_env_int("AUTOTUNE_GP_SAMPLES", 12),
            autotune_mode=_env_str("AUTOTUNE_MODE", "gp"),
            rank=_env_int("RANK", 0),
            size=_env_int("SIZE", 1),
            local_rank=_env_int("LOCAL_RANK", 0),
            local_size=_env_int("LOCAL_SIZE", 1),
            cross_rank=_env_int("CROSS_RANK", 0),
            cross_size=_env_int("CROSS_SIZE", 1),
            coordinator_addr=_env_str("COORDINATOR_ADDR"),
            coordinator_port=_env_int("COORDINATOR_PORT", 0),
            start_timeout=_env_float("START_TIMEOUT", 600.0),
            controller_addr=_env_str("CONTROLLER_ADDR"),
            controller_port=_env_int("CONTROLLER_PORT", 0),
            elastic=_env_bool("ELASTIC", False),
            elastic_timeout=_env_float("ELASTIC_TIMEOUT", 600.0),
            elastic_discovery_interval=_env_float(
                "ELASTIC_DISCOVERY_INTERVAL", 1.0),
            max_restarts=_env_int("MAX_RESTARTS", -1),
            restart_window_seconds=_env_float("RESTART_WINDOW_SECONDS", 0.0),
            blacklist_cooldown_seconds=_env_float(
                "BLACKLIST_COOLDOWN_SECONDS", 300.0),
            blacklist_cooldown_max_seconds=_env_float(
                "BLACKLIST_COOLDOWN_MAX_SECONDS", 3600.0),
            preempt_signal=_env_str("PREEMPT_SIGNAL", "SIGTERM"),
            preempt_notice_file=_env_str("PREEMPT_NOTICE_FILE"),
            drain_grace_seconds=_env_float("DRAIN_GRACE_SECONDS", 30.0),
            log_level=_env_str("LOG_LEVEL", "warning"),
            cpu_devices=_env_int("CPU_DEVICES", 0),
        )

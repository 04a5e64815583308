"""Environment-variable configuration of the PyTorch port.

Counterpart of ``horovod_tpu/core/config.py``: the same env names, read
the same way (``HVTPU_<NAME>`` first, then the reference's
``HOROVOD_<NAME>``), for the fields this part of the port uses — the
fusion threshold, the controller's cycle time and response-cache
capacity, the timeline and the trace directory, the stall watchdog's
settings, the fault-injection spec and seed, and the rank, size and
local rank the launcher sets.
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

    rank: int = 0
    size: int = 1
    local_rank: int = 0

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
            rank=_env_int("RANK", 0),
            size=_env_int("SIZE", 1),
            local_rank=_env_int("LOCAL_RANK", 0),
        )

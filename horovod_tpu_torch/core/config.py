"""Environment-variable configuration of the PyTorch port.

Counterpart of ``horovod_tpu/core/config.py``: the same env names, read
the same way (``HVTPU_<NAME>`` first, then the reference's
``HOROVOD_<NAME>``), for the fields this part of the port uses — the
fusion threshold, the controller's cycle time and response-cache
capacity, and the rank, size and local rank the launcher sets.
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


def _env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    v = _env(name)
    return v if v not in (None, "") else default


@dataclasses.dataclass
class Config:
    """Runtime configuration snapshot, read once at ``init()``."""

    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 1.0
    cache_capacity: int = 1024
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
            rank=_env_int("RANK", 0),
            size=_env_int("SIZE", 1),
            local_rank=_env_int("LOCAL_RANK", 0),
        )

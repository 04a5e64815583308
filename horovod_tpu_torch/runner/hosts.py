"""Host-spec parsing and rank/slot assignment for the port's launcher
(a copy of ``horovod_tpu/runner/hosts.py``, which the port does not
import).

Parity surface: ``horovod/runner/common/util/hosts.py``
(``parse_hosts``, ``get_host_assignments``) — the ``-H h1:2,h2:4``
syntax and the rank → (host, local_rank, cross_rank) assignment the
reference launcher computes before exporting ``HOROVOD_RANK/LOCAL_RANK/
CROSS_RANK`` to each worker.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class HostSlots:
    hostname: str
    slots: int


@dataclasses.dataclass
class SlotInfo:
    """One rank's placement (parity: horovod.runner.common.util.hosts
    SlotInfo: rank/size/local_rank/local_size/cross_rank/cross_size)."""

    hostname: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def parse_host_spec(spec: str) -> List[HostSlots]:
    """Parse ``h1:2,h2:4`` (slots default to 1 when omitted)."""
    out: List[HostSlots] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots_s = part.rsplit(":", 1)
            slots = int(slots_s)
        else:
            name, slots = part, 1
        if slots <= 0:
            raise ValueError(f"host {name!r} has non-positive slots {slots}")
        out.append(HostSlots(name, slots))
    if not out:
        raise ValueError(f"empty host spec {spec!r}")
    return out


def get_host_assignments(hosts: List[HostSlots], np: int) -> List[SlotInfo]:
    """Assign ``np`` ranks to hosts in order, filling each host's slots.

    Rank numbering is host-major (all of host 0's slots, then host 1's),
    matching the reference.  ``cross_rank`` is the index of the rank's
    host among hosts that have a worker at the same ``local_rank`` —
    the communicator layout hierarchical collectives use.
    """
    total = sum(h.slots for h in hosts)
    if np > total:
        raise ValueError(
            f"requested -np {np} exceeds available slots {total} "
            f"({','.join(f'{h.hostname}:{h.slots}' for h in hosts)})"
        )
    placements: List[tuple] = []  # (hostname, local_rank)
    remaining = np
    for h in hosts:
        take = min(h.slots, remaining)
        for lr in range(take):
            placements.append((h.hostname, lr))
        remaining -= take
        if remaining == 0:
            break

    # local_size per host, cross layout per local_rank
    local_sizes: dict = {}
    for hn, _ in placements:
        local_sizes[hn] = local_sizes.get(hn, 0) + 1
    by_local_rank: dict = {}
    for hn, lr in placements:
        by_local_rank.setdefault(lr, []).append(hn)

    out: List[SlotInfo] = []
    for rank, (hn, lr) in enumerate(placements):
        cross_hosts = by_local_rank[lr]
        out.append(
            SlotInfo(
                hostname=hn,
                rank=rank,
                size=np,
                local_rank=lr,
                local_size=local_sizes[hn],
                cross_rank=cross_hosts.index(hn),
                cross_size=len(cross_hosts),
            )
        )
    return out


def is_local_host(hostname: str) -> bool:
    return hostname in ("localhost", "127.0.0.1", "::1")

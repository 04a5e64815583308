"""Tensor fusion: deterministic size-bounded buckets.

Counterpart of ``horovod_tpu/comm/fusion.py`` ``BucketEntry`` /
``BucketPlan`` / ``plan_buckets`` (parity surface: the reference's
fusion step, ``Controller::FuseResponses``): tensors are ordered by
name, so every rank builds the same plan, and packed greedily up to a
byte threshold (``HVTPU_FUSION_THRESHOLD``); a tensor larger than the
threshold gets a bucket of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BucketEntry:
    name: str
    index: int          # position in the original flat list
    shape: Tuple[int, ...]
    dtype: Any
    size: int           # element count
    nbytes: int


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Tuple[BucketEntry, ...], ...]

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def plan_buckets(
    names: Sequence[str],
    tensors: Sequence[Any],
    threshold_bytes: int,
) -> BucketPlan:
    """Greedy size-bounded bucketing in deterministic (sorted-name) order.

    ``tensors`` need ``shape`` and a torch ``dtype``; their data is not
    read.
    """
    entries = []
    for i, (name, t) in enumerate(zip(names, tensors)):
        shape = tuple(t.shape)
        size = 1
        for d in shape:
            size *= d
        nbytes = size * t.dtype.itemsize
        entries.append(BucketEntry(name, i, shape, t.dtype, size, nbytes))
    entries.sort(key=lambda e: e.name)

    buckets: List[List[BucketEntry]] = []
    cur: List[BucketEntry] = []
    cur_bytes = 0
    for e in entries:
        if cur and cur_bytes + e.nbytes > threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(e)
        cur_bytes += e.nbytes
        if e.nbytes > threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return BucketPlan(tuple(tuple(b) for b in buckets))

"""Interval algebra over sorted, disjoint lists of (start, end), copied
from the program's step profiler (its ``union`` / ``intersect`` /
``subtract``) so that the yardstick does not move with the program."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(ivs: Iterable[Interval]) -> List[Interval]:
    """Merge intervals into a sorted, disjoint cover."""
    out: List[Interval] = []
    for t0, t1 in sorted((a, b) for a, b in ivs if b > a):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def intersect(a: Sequence[Interval], b: Sequence[Interval]
              ) -> List[Interval]:
    """Intersection of two disjoint sorted interval lists."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        t0 = max(a[i][0], b[j][0])
        t1 = min(a[i][1], b[j][1])
        if t1 > t0:
            out.append((t0, t1))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Sequence[Interval], b: Sequence[Interval]
             ) -> List[Interval]:
    """``a - b`` over disjoint sorted interval lists."""
    out: List[Interval] = []
    j = 0
    for t0, t1 in a:
        cur = t0
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t1:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < t1:
            out.append((cur, t1))
    return out


def total(ivs: Iterable[Interval]) -> float:
    return sum(t1 - t0 for t0, t1 in ivs)


def gaps(ivs: Sequence[Interval], t0: float, t1: float) -> List[Interval]:
    """The parts of ``[t0, t1)`` that the disjoint ``ivs`` leave free."""
    return subtract([(t0, t1)], ivs)

"""Topology-aware placement: the pool as a torus grid, contiguity-
scored carving, fragmentation-minimizing backfill, and a measured
fragmentation metric (the port's copy of
``horovod_tpu/fleet/placement.py``: the same carve order and distances).

The torus is the reference's model of a pool, kept as it is: pure host
logic over host names, with no model of NVLink.  A gang spread across
distant hosts pays cross-host hops on every ring step.  ``core/topology.py``
models the *device* mesh inside one job — this module models the
*host* grid the arbiter carves jobs from.  Host names carry no
coordinates, so the grid is virtual but stable: the sorted host-name
list is folded row-major onto a near-square 2-D torus, giving every
pool the same deterministic geometry on every arbiter incarnation.

Carving policy (the reference's, which replaced a name-order greedy):

1. **Tightest single-host fit** — a gang that fits on one host takes
   the host with the LEAST free capacity that still fits (classic
   best-fit), keeping big contiguous hosts whole for big gangs.
2. **Anchored torus walk** — a multi-host gang anchors on the host
   with the most free slots (ties: name order) and grows outward in
   (torus-distance, name) order, so allocations stay contiguous and
   the leftover free space stays clustered rather than checkerboarded.
3. **Near-set preference** — expansion / autoscale-grow passes the
   job's current hosts as ``near``; slots on or adjacent to them win.

The **fragmentation metric** is external fragmentation over the torus:
``1 - largest connected free region / total free slots`` (hosts with
free capacity, 4-neighbour torus adjacency).  0.0 means all free
capacity is one contiguous region (any fitting gang can be placed
contiguously); values near 1.0 mean the free space is confetti.

Thread safety: a :class:`PlacementPolicy` is owned by the arbiter and
only touched under its ``_lock``; the grid cache is plain state.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

from ..obs import metrics as obs_metrics

__all__ = ["TorusGrid", "PlacementPolicy"]

_M_FRAG = obs_metrics.gauge(
    "hvtpu_fleet_fragmentation",
    "External fragmentation of the fleet pool's free capacity on the "
    "virtual host torus: 1 - largest contiguous free region / total "
    "free slots (0 = one contiguous region).")


class TorusGrid:
    """Sorted host names folded row-major onto a near-square 2-D
    torus; distances are wrap-around Manhattan.

    Non-square pools leave the last row partial (``last_w`` cells
    wide), so the torus is irregular: wraps fold within the VALID
    extent of the row/column in question — the last row wraps at its
    own width, a column over the missing tail wraps one row short —
    rather than landing on missing cells.  :meth:`neighbors` and
    :meth:`distance` use the same folded geometry, so every neighbor
    is at distance 1 and connectivity (the fragmentation metric's
    view) never disagrees with proximity (the carver's view)."""

    def __init__(self, hosts: Iterable[str]):
        self.names: List[str] = sorted(hosts)
        n = len(self.names)
        self.cols = max(1, int(math.ceil(math.sqrt(n))))
        self.rows = max(1, int(math.ceil(n / self.cols)))
        # width of the (possibly partial) last row: == cols when the
        # grid is a full rectangle
        self.last_w = n - (self.rows - 1) * self.cols
        self.coord: Dict[str, Tuple[int, int]] = {
            h: (i // self.cols, i % self.cols)
            for i, h in enumerate(self.names)}

    def _row_w(self, r: int) -> int:
        return self.last_w if r == self.rows - 1 else self.cols

    def _col_h(self, c: int) -> int:
        return self.rows if c < self.last_w else self.rows - 1

    def distance(self, a: str, b: str) -> int:
        (ra, ca), (rb, cb) = self.coord[a], self.coord[b]
        dr = abs(ra - rb)
        dc = abs(ca - cb)
        # wrap extents match neighbors(): a same-row pair wraps at
        # that row's width, a same-column pair at that column's
        # height; mixed pairs can route through full rows/columns
        w = self._row_w(ra) if ra == rb else self.cols
        hgt = self._col_h(ca) if ca == cb else self.rows
        return min(dr, max(0, hgt - dr)) + min(dc, max(0, w - dc))

    def neighbors(self, h: str) -> List[str]:
        r, c = self.coord[h]
        w = self._row_w(r)
        hgt = self._col_h(c)
        cand = []
        if hgt > 1:
            cand += [((r - 1) % hgt, c), ((r + 1) % hgt, c)]
        if w > 1:
            cand += [(r, (c - 1) % w), (r, (c + 1) % w)]
        out: List[str] = []
        for nr, nc in cand:
            n = self.names[nr * self.cols + nc]
            if n != h and n not in out:
                out.append(n)
        return out


class PlacementPolicy:
    """Deterministic, fragmentation-minimizing slot carving over a
    cached :class:`TorusGrid` of the current pool."""

    def __init__(self):
        self._grid: Optional[TorusGrid] = None
        self._grid_key: Optional[Tuple[str, ...]] = None

    def grid_for(self, hosts: Iterable[str]) -> TorusGrid:
        key = tuple(sorted(hosts))
        if key != self._grid_key:
            self._grid = TorusGrid(key)
            self._grid_key = key
        return self._grid

    # -- carving ---------------------------------------------------------
    def carve(self, free: Dict[str, int], n: int,
              pool_hosts: Iterable[str],
              near: Optional[Iterable[str]] = None) -> Dict[str, int]:
        """Carve ``n`` slots out of ``free`` (mutated in place, like
        the old ``_take``), preferring a tight single-host fit, else a
        contiguous torus walk from the best anchor (or from ``near``,
        the job's existing hosts, when expanding)."""
        out: Dict[str, int] = {}
        if n <= 0:
            return out
        grid = self.grid_for(pool_hosts)
        avail = {h: c for h, c in free.items() if c > 0}
        near_set = set(near or ()) & set(grid.coord)
        if not near_set:
            # best-fit: smallest host that holds the whole gang
            fits = sorted((c, h) for h, c in avail.items() if c >= n)
            if fits:
                _, h = fits[0]
                out[h] = n
                free[h] -= n
                return out
        anchor = self._anchor(avail, grid, near_set)
        if anchor is None:
            return out
        order = sorted(
            avail,
            key=lambda h: (min((grid.distance(h, a)
                                for a in (near_set or {anchor})),
                               default=0), h))
        for h in order:
            if n <= 0:
                break
            got = min(avail[h], n)
            if got > 0:
                out[h] = out.get(h, 0) + got
                free[h] -= got
                n -= got
        return out

    @staticmethod
    def _anchor(avail: Dict[str, int], grid: TorusGrid,
                near_set) -> Optional[str]:
        if not avail:
            return None
        if near_set:
            # expanding: anchor on an existing host
            return sorted(near_set)[0]
        # fresh gang: anchor where the most capacity lives
        return sorted(avail, key=lambda h: (-avail[h], h))[0]

    # -- fragmentation ---------------------------------------------------
    def fragmentation(self, free: Dict[str, int],
                      pool_hosts: Iterable[str]) -> float:
        """External fragmentation of the free capacity (see module
        docstring); publishes the ``hvtpu_fleet_fragmentation``
        gauge."""
        grid = self.grid_for(pool_hosts)
        avail = {h: c for h, c in free.items()
                 if c > 0 and h in grid.coord}
        total = sum(avail.values())
        if total <= 0:
            _M_FRAG.set(0.0)
            return 0.0
        seen = set()
        largest = 0
        for h in sorted(avail):
            if h in seen:
                continue
            stack, comp = [h], 0
            seen.add(h)
            while stack:
                cur = stack.pop()
                comp += avail[cur]
                for nb in grid.neighbors(cur):
                    if nb in avail and nb not in seen:
                        seen.add(nb)
                        stack.append(nb)
            largest = max(largest, comp)
        frag = 1.0 - largest / total
        _M_FRAG.set(frag)
        return frag

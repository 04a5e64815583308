"""The comparison that decides ``correct``: the program's first training
steps against the reference's, on the same weights and batches.

Per leaf (parameter tensor) norms are compared: of the first gradient as
the optimizer got it (SGD's momentum buffer after step 1, the reduced
``.grad`` under AdamW), of the momentum after the last checked step
(SGD's buffer, AdamW's ``exp_avg``), and of the parameters' change over
the checked steps.  A leaf's gap is ``| |p| - |r| |`` over the larger of
``|r|`` and the floor, the median ``|r|`` of the leaves whose reference
norm is not 0.  The change and the last buffer are compared on the
moving leaves only: those whose reference change is at least a
thousandth of the median leaf's (a leaf below it moves under round-off
alone).  Leaves behind a norm whose scale starts at 0 have no first
gradient; from the second step on they have one, but it can be too small
to move them past that rule in a few steps, or rounded to 0 by a float16
wire.

Numbers read (those with a limit in ``limits/<cell>.json`` are
compared; which, and why, ``PERF.md`` says):

* ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` of rank 0's loss
  over the checked steps; ``loss1_gap`` the same of the first step's
  alone (the forward pass on the seed's weights);
* ``logits_gap`` / ``logits_last_gap``: ``|z - z_ref| / |z_ref|`` of
  the logits the task reads of rank 0 (``tasks/``: all of an image
  net's; a causal LM's first row's last 16 positions) at the first and
  at the last checked step (1 when their shapes differ);
* ``grad_gap`` / ``grad_median_gap``: the worst leaf's and the median
  leaf's gap of the first gradient, over the leaves whose reference
  gradient is not 0 (and every leaf where the program's is not 0);
* ``momentum_gap`` / ``momentum_median_gap``: the same of the last
  buffer, over the moving leaves;
* ``grad_diff_gap`` / ``grad_diff_median_gap``: the worst and the median
  leaf's ``|p - r|`` of the first gradient over the larger of ``|r|``
  and the floor: a difference, where the gaps above compare norms, which
  rounding that is random in sign hardly moves.  Both sides take the
  first step from the same weights and batch, so nothing but the step's
  own arithmetic sets it;
* ``change_gap`` / ``change_median_gap``: the same as the grad gaps, of
  the change, over the moving leaves;
* ``grad_total_gap`` / ``momentum_total_gap`` / ``change_total_gap``: the
  gap of the norm of all leaves together (of the moving leaves, for the
  last buffer);
* ``ranks_differing`` (past one rank): the leaves whose bits after the
  checked steps differ between rank 0 and any other rank.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

SMALL_CHANGE = 1e-3


def _floor(norms: Dict[str, float]) -> float:
    nonzero = [v for v in norms.values() if v > 0]
    return statistics.median(nonzero) if nonzero else 0.0


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          names: Sequence[str], diff: Optional[Dict[str, float]] = None
          ) -> List[float]:
    """Each leaf's gap of norms, or with ``diff`` (the norm of each
    leaf's difference) its difference, over the larger of ``|r|`` and
    the floor."""
    floor = _floor({n: ref[n] for n in names})
    out = []
    for n in names:
        den = max(ref[n], floor)
        num = diff[n] if diff is not None else abs(prog.get(n, 0.0) - ref[n])
        out.append(num / den if den > 0 else 0.0)
    return out


def _total_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    p = sum(prog.get(n, 0.0) ** 2 for n in ref) ** 0.5
    r = sum(v ** 2 for v in ref.values()) ** 0.5
    return abs(p - r) / r if r > 0 else 0.0


def _logits_gap(p: Sequence[float], r: Sequence[float]) -> float:
    if len(p) != len(r):
        return 1.0
    num = math.fsum((a - b) ** 2 for a, b in zip(p, r))
    den = math.fsum(b * b for b in r)
    return math.sqrt(num / den) if den > 0 else 0.0


def readings(prog: dict, ref: dict,
             digests: Optional[Sequence[Sequence[int]]] = None
             ) -> Dict[str, float]:
    """The numbers compared: ``prog`` and ``ref`` hold ``losses``,
    ``logits``, ``logits_last``, ``grad_norms``, ``momentum_norms`` and
    ``change_norms``, and ``ref`` the ``grad_diff_norms`` between the
    two; ``digests`` each rank's bit digests of the leaves, rank 0
    first."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g, c, m = ref["grad_norms"], ref["change_norms"], ref["momentum_norms"]
    live = sorted(n for n in g
                  if g[n] > 0 or prog["grad_norms"].get(n, 0.0) > 0)
    moving = sorted(n for n in c if c[n] >= SMALL_CHANGE * _floor(c))
    grad = _gaps(prog["grad_norms"], g, live)
    change = _gaps(prog["change_norms"], c, moving)
    momentum = _gaps(prog["momentum_norms"], m, moving)
    out = {"loss_gap": loss_gap,
           "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
           / abs(ref["losses"][0]),
           "logits_gap": _logits_gap(prog["logits"], ref["logits"]),
           "logits_last_gap": _logits_gap(prog["logits_last"],
                                          ref["logits_last"]),
           "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
           "grad_total_gap": _total_gap(prog["grad_norms"], g),
           "momentum_gap": max(momentum),
           "momentum_median_gap": statistics.median(momentum),
           "momentum_total_gap": _total_gap(
               {n: prog["momentum_norms"][n] for n in moving},
               {n: m[n] for n in moving}),
           "change_gap": max(change),
           "change_median_gap": statistics.median(change),
           "change_total_gap": _total_gap(prog["change_norms"], c)}
    if ref.get("grad_diff_norms") is not None:
        diff = _gaps(prog["grad_norms"], g, live, ref["grad_diff_norms"])
        out.update(grad_diff_gap=max(diff),
                   grad_diff_median_gap=statistics.median(diff))
    if digests is not None and len(digests) > 1:
        first = digests[0]
        out["ranks_differing"] = float(sum(
            any(d[i] != first[i] for d in digests[1:])
            for i in range(len(first))))
    return out


def judge(values: Dict[str, float], limits: Dict[str, dict]
          ) -> Tuple[bool, List[Tuple[str, float, Optional[float]]]]:
    """``(correct, rows)``: each number that has a limit, with it; a
    number passes at or under its limit.  No limits: not correct."""
    rows, ok = [], bool(limits)
    for name, entry in limits.items():
        value = values.get(name, float("nan"))
        rows.append((name, value, entry["limit"]))
        if not value <= entry["limit"]:
            ok = False
    return ok, rows

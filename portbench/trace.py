"""The reduction of a ``torch.profiler`` Chrome trace of a traced window
to what the per-layer metrics read.

The trace holds the device's operations (``kernel``, ``gpu_memcpy``,
``gpu_memset``), the host's ``record_function`` ranges
(``user_annotation``), its operators (``cpu_op``) and the runtime calls
that launched each kernel (``cuda_runtime`` / ``cuda_driver``, tied to
their kernel by ``correlation``).  The window is the benchmark's own
range around the traced steps and the synchronize that ends them; a
kernel belongs to the optimizer when the call that launched it lies
inside one of the benchmark's ranges around ``opt.step()``.
"""

from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
from typing import Dict, List, Optional, Sequence, Tuple

from . import intervals, kernels

WINDOW = "portbench.window"
FORWARD = "portbench.forward"
BACKWARD = "portbench.backward"
OPT_STEP = "portbench.opt_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    """One device operation inside the window (µs, clipped to it)."""

    name: str
    cat: str
    group: str
    t0: float
    t1: float
    in_opt: bool

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Window:
    """What one rank's traced window holds, and the work it did."""

    t0: float
    t1: float
    steps: int
    ops: List[Op]
    has_opt_ranges: bool
    # worked out by the benchmark from shapes: see counters/
    flops_per_step: float
    conv_min_s_per_step: float
    a1_bytes_per_step: int
    a1_passes_per_step: int
    a1_launches: Optional[int]
    # the attention terms' least time a step (counters/transformer_flops.py)
    attention_min_s_per_step: float = 0.0
    # the host clock's time of a step, the same steps run untraced just
    # before the window (the profiler slows the host's side of a step)
    untraced_step_s: Optional[float] = None
    host: List[Tuple[float, float, str]] = dataclasses.field(
        default_factory=list)
    annotations: List[Tuple[float, float, str]] = dataclasses.field(
        default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        return intervals.union((o.t0, o.t1) for o in self.ops)

    def busy_s(self) -> float:
        return intervals.total(self.busy()) * 1e-6

    def seconds(self, groups: Sequence[str] = (), cats=("kernel",),
                in_opt: Optional[bool] = None) -> float:
        """Summed device seconds of the ops of ``groups`` (all when
        empty) and ``cats``, launched inside ``opt.step()`` or outside it
        when ``in_opt`` says so."""
        return 1e-6 * sum(
            o.dur for o in self.ops
            if (not groups or o.group in groups) and o.cat in cats
            and (in_opt is None or o.in_opt == in_opt))


def load_events(path: str) -> list:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def window_of(events: list, **work) -> Optional[Window]:
    """The window of ``events`` (None when the trace holds no
    ``WINDOW`` range); ``work`` fills the worked-out fields of
    :class:`Window`."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    main_tid = win[0].get("tid")
    opt = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                 if e.get("cat") == "user_annotation"
                 and e.get("name") == OPT_STEP)
    starts = [a for a, _ in opt]
    opt_corr = set()
    for e in spans:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if corr is not None and i >= 0 and e["ts"] <= opt[i][1]:
            opt_corr.add(corr)
    ops = []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0, t1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t1 <= t0:
            continue
        corr = (e.get("args") or {}).get("correlation")
        ops.append(Op(e.get("name", ""), e["cat"],
                      kernels.group_of(e.get("name", "")), t0, t1,
                      corr in opt_corr))
    host = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", ""))
                  for e in spans
                  if e.get("tid") == main_tid
                  and e.get("cat") in ("cpu_op",) + LAUNCH_CATS
                  and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    notes = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", ""))
                   for e in spans
                   if e.get("cat") == "user_annotation"
                   and e.get("tid") == main_tid
                   and e.get("name") != WINDOW)
    return Window(w0, w1, ops=ops, has_opt_ranges=bool(opt), host=host,
                  annotations=notes, **work)


def _innermost(spans: List[Tuple[float, float, str]], starts: List[float],
               t: float, reach: int) -> str:
    """The shortest of the spans that cover ``t``, looking back at most
    ``reach`` spans from the last that starts before it."""
    i = bisect.bisect_right(starts, t) - 1
    best, best_len = "", float("inf")
    for j in range(i, max(i - reach, -1), -1):
        a, b, name = spans[j]
        if b >= t and b - a < best_len:
            best, best_len = name, b - a
    return best


def breakdown(w: Window, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the window, by name
    (its group first), and the device's idle time by what the host was
    doing meanwhile (the benchmark's innermost range, then the innermost
    host operation or runtime call); seconds."""
    by_op: Dict[str, float] = {}
    for o in w.ops:
        key = f"{o.group}:{o.name[:100]}"
        by_op[key] = by_op.get(key, 0.0) + o.dur * 1e-6
    idle: Dict[str, float] = {}
    hs = [a for a, _, _ in w.host]
    ns = [a for a, _, _ in w.annotations]
    for a, b in intervals.gaps(w.busy(), w.t0, w.t1):
        mid = (a + b) / 2
        note = _innermost(w.annotations, ns, mid, len(w.annotations))
        op = _innermost(w.host, hs, mid, 400)
        key = f"{note or 'outside'}>{op or 'python'}"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    pick = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in pick],
            "idle_gaps": [[k, v] for k, v in gaps]}

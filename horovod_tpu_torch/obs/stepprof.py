"""Step-level compute/communication overlap profiler.

Counterpart of ``horovod_tpu/obs/stepprof.py``.  It joins two timelines:

  * the **device trace** — ``obs/profile.load_profile`` reads the
    Chrome trace ``torch.profiler`` writes into timestamped per-kernel
    intervals, NCCL kernels flagged (``is_comm_op``); this is device
    truth for what the card was doing and when, and
  * the host's **collective windows** — ``comm/eager.py`` and the
    optimizer's buckets record each collective's wall-clock window
    (:func:`note_comm`), and ``metrics.note_step`` marks step
    boundaries.

Per step window it computes a six-way wall decomposition by interval
algebra (:func:`decompose`, the reference's, bitwise)::

    pure compute | overlapped comm | EXPOSED comm | data wait
                 | host/controller gap | idle

whose parts sum to the step wall time by construction.  The MFU
numerator is a step's FLOPs counted once by
``torch.utils.flop_counter.FlopCounterMode`` (:func:`measured_flops`);
the denominator is the card's own dense bf16 peak
(:func:`peak_flops`: the H100 SXM's 989 TFLOP/s and the PCIe card's 756
from NVIDIA's data sheets, or ``HVTPU_STEPPROF_PEAK_TFLOPS``).  On a
card the table does not know, and without the variable, no MFU is
reported.

Two consumers:

  * **runtime collector** (always on unless ``HVTPU_STEPPROF=0``):
    collective windows and data waits feed the per-step metrics
    ``hvtpu_step_exposed_comm_seconds``, ``hvtpu_step_overlap_fraction``,
    ``hvtpu_mfu`` and a ``stepprof`` /debug provider.  Without a device
    trace the host cannot see overlap, so the per-step comm time is
    reported as exposed (an upper bound); :func:`profile_window` /
    :func:`join_device_profile` upgrade it to device truth and add the
    card's idle share of the window.
  * **offline analysis** — ``python -m tools.hvtputrace overlap`` over
    the port's span files (host-only mode).

Clocks: the collector records ``time.time()`` windows; the device trace
has the profiler's own time base.  :func:`profile_window` records a
``record_function`` marker at a known wall time inside the capture, and
:func:`align_device_intervals` shifts the device intervals by the
marker's offset.

Hot call sites guard with ``if stepprof.ACTIVE:`` (one module
attribute read, same contract as ``tracing.ACTIVE``/``faults.ACTIVE``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Iterable, List, Optional, Sequence, Tuple

from . import metrics as obs_metrics
from . import profile as obs_profile
from . import tracing

Interval = Tuple[float, float]

# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

# HVTPU_STEPPROF=0 disables the runtime collector entirely (call sites
# fall back to one attribute read).
ACTIVE = os.environ.get("HVTPU_STEPPROF", "1").lower() not in (
    "0", "false", "off")

# HVTPU_STEPPROF_PEAK_TFLOPS: the card's peak for the MFU denominator
# (default: the card's own, from _CARD_PEAK_TFLOPS).
PEAK_TFLOPS: Optional[float] = (
    float(os.environ["HVTPU_STEPPROF_PEAK_TFLOPS"])
    if os.environ.get("HVTPU_STEPPROF_PEAK_TFLOPS") else None)

# Dense bf16 tensor-core peak, TFLOP/s, by device-name fragment (NVIDIA's
# H100 data sheet: SXM 989, PCIe 756).  "H100 80GB HBM3" is the SXM
# card's name as torch.cuda.get_device_name reports it.
_CARD_PEAK_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 SXM", 989.0),
                     ("H100 PCIe", 756.0))
_card_peak: List[Optional[float]] = []

# HVTPU_STEPPROF_WINDOW: max collective/data windows retained between
# step boundaries (bounds collector memory on pathological loops).
_WINDOW = int(os.environ.get("HVTPU_STEPPROF_WINDOW", "4096"))


def card_peak_tflops() -> Optional[float]:
    """The current card's dense bf16 peak from the table, or None (no
    card, or one the table does not know).  Looked up once."""
    if not _card_peak:
        peak = None
        try:
            import torch

            if torch.cuda.is_available():
                name = torch.cuda.get_device_name()
                peak = next((t for frag, t in _CARD_PEAK_TFLOPS
                             if frag in name), None)
        except Exception:
            peak = None
        _card_peak.append(peak)
    return _card_peak[0]


def peak_flops() -> Optional[float]:
    """The card's peak FLOP/s used as the MFU denominator
    (``HVTPU_STEPPROF_PEAK_TFLOPS`` first); None when unknown."""
    tflops = PEAK_TFLOPS if PEAK_TFLOPS is not None else card_peak_tflops()
    return None if tflops is None else tflops * 1e12


# ---------------------------------------------------------------------------
# interval algebra (timestamps are floats; unit is the caller's — the
# runtime collector uses wall seconds, hvtputrace uses trace µs)
# ---------------------------------------------------------------------------


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
    """``a − b`` over disjoint sorted interval lists."""
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


def clip(ivs: Iterable[Interval], t0: float, t1: float) -> List[Interval]:
    return intersect(union(ivs), [(t0, t1)])


def decompose(t0: float, t1: float, *,
              compute: Iterable[Interval] = (),
              comm: Iterable[Interval] = (),
              data: Iterable[Interval] = (),
              host: Iterable[Interval] = ()) -> dict:
    """Six-way wall decomposition of the step window ``[t0, t1)``.

    Priority order resolves multi-bucket instants: comm∩compute is
    *overlapped* comm; comm alone is *exposed*; data and host windows
    only count where neither device timeline is busy; the remainder is
    idle.  Invariant (pinned by tests/test_stepprof.py)::

        compute + overlapped + exposed + data_wait + host + idle
            == step_wall
    """
    if t1 < t0:
        t0, t1 = t1, t0
    window = [(t0, t1)]
    comp_u = intersect(union(compute), window)
    comm_u = intersect(union(comm), window)
    overlapped = intersect(comp_u, comm_u)
    pure = subtract(comp_u, comm_u)
    exposed = subtract(comm_u, comp_u)
    busy = union(list(comp_u) + list(comm_u))
    data_w = subtract(intersect(union(data), window), busy)
    not_attributed = union(list(busy) + list(data_w))
    host_w = subtract(intersect(union(host), window), not_attributed)
    wall = t1 - t0
    parts = {
        "compute": total(pure),
        "overlapped_comm": total(overlapped),
        "exposed_comm": total(exposed),
        "data_wait": total(data_w),
        "host": total(host_w),
    }
    parts["idle"] = max(wall - sum(parts.values()), 0.0)
    comm_total = parts["overlapped_comm"] + parts["exposed_comm"]
    parts["step_wall"] = wall
    parts["overlap_fraction"] = (
        parts["overlapped_comm"] / comm_total if comm_total > 0 else None)
    return parts


def exposed_span(span: Interval, compute_u: Sequence[Interval]) -> float:
    """Exposed (non-compute-overlapped) time of one comm span — the
    per-collective blame number behind the overlap report's top-N."""
    return total(subtract(union([span]), compute_u))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

EXPOSED_COMM = obs_metrics.REGISTRY.histogram(
    "hvtpu_step_exposed_comm_seconds",
    "Per-step exposed (not compute-overlapped) communication time. "
    "Host-side collection reports the union of collective dispatch "
    "windows per step (an upper bound; exact for the blocking sync "
    "plane); a device-profile join (stepprof.join_device_profile / "
    "hvtputrace overlap) measures it against the card's kernel "
    "timeline.",
    buckets=obs_metrics.DEFAULT_TIME_BUCKETS)
OVERLAP_FRACTION = obs_metrics.REGISTRY.gauge(
    "hvtpu_step_overlap_fraction",
    "Measured comm/compute overlap fraction "
    "(overlapped / (overlapped + exposed)) from the most recent "
    "device-profile join; 0 until a join has run.")
MFU = obs_metrics.REGISTRY.gauge(
    "hvtpu_mfu",
    "Measured model FLOPs utilization: FlopCounterMode FLOPs per step "
    "/ (step wall time x the card's peak). 0 until the host loop "
    "provides step FLOPs (stepprof.set_step_flops) on a card with a "
    "known peak.")


# ---------------------------------------------------------------------------
# runtime collector
# ---------------------------------------------------------------------------


class _Collector:
    """Per-process overlap collector.

    Fed from three places: ``comm/eager.py`` (collective dispatch
    windows, executor and sync threads), ``data/loader.py`` (input
    waits, loader threads), and ``metrics.note_step`` (step boundaries,
    host loop) — hence the lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # hvtpulint: guarded-by(_lock)
        self._comm: deque = deque(maxlen=_WINDOW)
        # hvtpulint: guarded-by(_lock)
        self._data: deque = deque(maxlen=_WINDOW)
        self._step_t: Optional[float] = None  # hvtpulint: guarded-by(_lock)
        self._steps = 0  # hvtpulint: guarded-by(_lock)
        self._flops_per_step: Optional[float] = None
        self._last: dict = {}  # hvtpulint: guarded-by(_lock)

    def note_comm(self, name: str, t0: float, t1: float, nbytes: int = 0):
        with self._lock:
            self._comm.append((t0, t1, name, nbytes))

    def note_data_wait(self, t0: float, t1: float):
        with self._lock:
            self._data.append((t0, t1))

    def set_step_flops(self, flops: Optional[float]):
        with self._lock:
            self._flops_per_step = flops

    @staticmethod
    def _windows_since(ring, prev: float, now: float) -> list:
        """Windows of ``ring`` overlapping ``(prev, now)``, scanning
        newest-first and stopping once the ring is clearly older than
        the step.  Entries append in ~completion order, so instead of
        filtering all ``maxlen`` (4096) entries every step we bail
        after a slack run of pre-``prev`` windows; the slack absorbs
        mild cross-thread append reordering."""
        out = []
        stale = 0
        for item in reversed(ring):
            t0, t1 = item[0], item[1]
            if t1 > prev:
                stale = 0
                if t0 < now:
                    out.append((t0, t1))
            else:
                stale += 1
                if stale >= 64:
                    break
        out.reverse()
        return out

    def note_step_boundary(self, steps: float = 1.0) -> Optional[dict]:
        """Close the step window ending now; emit per-step metrics.

        Called (via ``metrics.note_step``) once per host-loop dispatch;
        ``steps`` is the optimizer steps folded into the dispatch
        (several steps a call).  Without a device profile the comm union is
        reported as exposed — the host-side upper bound.  Returns the
        step record (also kept as ``last_step`` in the /debug state) —
        the feed for the anomaly detectors and the flight ring — or
        None on the first/degenerate boundary.
        """
        now = time.time()
        if tracing.ACTIVE:
            # Every boundary is marked — including the first, which
            # opens the first step window for hvtputrace overlap.
            tracing.step_boundary(wall_us=now * 1e6, steps=steps)
        with self._lock:
            prev = self._step_t
            self._step_t = now
            self._steps += steps
            if prev is None or now <= prev:
                return None
            # Windows stay in the ring (join_device_profile reads them
            # across step boundaries); the step only counts overlap
            # with its own window, so stale entries age out via maxlen
            # without double counting.
            comm = self._windows_since(self._comm, prev, now)
            data = self._windows_since(self._data, prev, now)
            flops = self._flops_per_step
        parts = decompose(prev, now, comm=comm, data=data)
        EXPOSED_COMM.observe(parts["exposed_comm"])
        wall = now - prev
        peak = peak_flops() if flops else None
        if peak:
            MFU.set(flops * steps / (wall * peak))
        rec = {
            "step_wall_s": round(wall, 6),
            "steps": steps,
            "exposed_comm_s": round(parts["exposed_comm"], 6),
            "data_wait_s": round(parts["data_wait"], 6),
            "collectives": len(comm),
        }
        with self._lock:
            self._last = rec
        return rec

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "active": ACTIVE,
                "steps": self._steps,
                "flops_per_step": self._flops_per_step,
                "peak_tflops": (PEAK_TFLOPS if PEAK_TFLOPS is not None
                                else card_peak_tflops()),
                "overlap_fraction": OVERLAP_FRACTION.value(),
                "mfu": MFU.value(),
                "last_step": dict(self._last),
                "pending_comm_windows": len(self._comm),
            }


_collector = _Collector()


def note_comm(name: str, t0: float, t1: float, nbytes: int = 0):
    """Record one collective's wall-clock dispatch window (seconds)."""
    _collector.note_comm(name, t0, t1, nbytes)


def note_data_wait(t0: float, t1: float):
    """Record one input-pipeline wait window (wall seconds)."""
    _collector.note_data_wait(t0, t1)


def note_step_boundary(steps: float = 1.0) -> Optional[dict]:
    return _collector.note_step_boundary(steps)


def set_step_flops(flops: Optional[float]):
    """Provide the per-step per-chip FLOPs numerator for the live
    ``hvtpu_mfu`` gauge (from :func:`measured_flops`)."""
    _collector.set_step_flops(flops)


def get_collector() -> _Collector:
    return _collector


def install():
    """Register the /debug provider (idempotent; core/state.init)."""
    obs_metrics.register_debug_provider(
        "stepprof", lambda: _collector.debug_state())


def uninstall():
    obs_metrics.unregister_debug_provider("stepprof")


def reset():
    """Fresh collector (tests / re-init)."""
    global _collector
    _collector = _Collector()


# ---------------------------------------------------------------------------
# measured MFU: FLOPs counted from the step itself
# ---------------------------------------------------------------------------


def measured_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)`` (a training step's
    forward and backward), counted by
    ``torch.utils.flop_counter.FlopCounterMode``: the call runs once
    under the counter, so pass a step without side effects the caller
    minds.  Returns None when counting fails or finds nothing — callers
    report no MFU, never crash."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            fn(*args, **kwargs)
        flops = float(counter.get_total_flops())
    except Exception:
        return None
    return flops if flops > 0 else None


def mfu(flops_per_step: Optional[float], step_seconds: float,
        peak: Optional[float] = None) -> Optional[float]:
    """MFU from measured FLOPs and measured step time (None without a
    peak)."""
    if not flops_per_step or step_seconds <= 0:
        return None
    peak = peak or peak_flops()
    if not peak:
        return None
    return flops_per_step / (step_seconds * peak)


# ---------------------------------------------------------------------------
# device-profile join
# ---------------------------------------------------------------------------

# Device timestamps are joined on the wall clock when they look like
# epoch time; profilers that emit boot-relative or trace-relative
# timestamps are re-anchored onto the observed comm windows instead.
_CLOCK_SANITY_US = 86400e6  # 1 day

# The record_function marker profile_window opens at a known wall time.
WINDOW_MARKER = "hvtpu.profile_window"


def align_device_intervals(intervals: List[dict], anchor_us: float,
                           origin_us: Optional[float] = None
                           ) -> Tuple[List[dict], float]:
    """Map device-profile intervals onto the caller's timebase.

    With ``origin_us`` (the profiler-clock time of an event known to
    happen at wall time ``anchor_us``, e.g. :data:`WINDOW_MARKER`) the
    intervals shift by ``anchor_us - origin_us``.  Without it, the
    reference's rule: device timestamps within a day of ``anchor_us``
    are already wall-clock and pass through; otherwise the whole device
    timeline is shifted so its first event lands on the anchor.
    Returns (intervals, shift_us).
    """
    if not intervals:
        return intervals, 0.0
    if origin_us is not None:
        shift = anchor_us - origin_us
    else:
        first = min(iv["t0_us"] for iv in intervals)
        if abs(first - anchor_us) <= _CLOCK_SANITY_US:
            return intervals, 0.0
        shift = anchor_us - first
    return [dict(iv, t0_us=iv["t0_us"] + shift,
                 t1_us=iv["t1_us"] + shift)
            for iv in intervals], shift


@contextlib.contextmanager
def profile_window(logdir: str):
    """Capture a device trace around the body, then join it against the
    collector's recorded comm windows: yields a dict that is filled with
    the join summary on exit (:func:`join_device_profile`).  The window
    ends after the card finished the body's work."""
    import torch

    result: dict = {}
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    with obs_profile.trace(logdir):
        t0 = time.time()
        with torch.profiler.record_function(WINDOW_MARKER):
            yield result
            if cuda:
                torch.cuda.synchronize()
        t1 = time.time()
    result.update(join_device_profile(logdir, window=(t0, t1)))


def join_device_profile(logdir: str,
                        window: Optional[Interval] = None) -> dict:
    """Join a captured device trace against the collector's comm windows
    and publish the measured overlap fraction.

    Returns ``{"status", "overlap_fraction", "exposed_comm_s",
    "overlapped_comm_s", "compute_s", "device_planes", "shift_us"}``,
    and with a ``window`` also ``"window"`` (its wall-clock ends),
    ``"window_s"``, ``"idle_s"`` and
    ``"idle_share"`` (the window's wall time the card spent in no kernel
    and no copy); status is passed through from
    :func:`obs_profile.load_profile` (never raises —
    "no-profile"/"empty"/"truncated" leave the gauges alone).
    """
    prof = obs_profile.load_profile(logdir)
    if prof["status"] != "ok":
        return {"status": prof["status"], "reason": prof["reason"],
                "overlap_fraction": None}
    with _collector._lock:
        host_comm_us = [(t0 * 1e6, t1 * 1e6)
                        for t0, t1, _n, _b in _collector._comm]
    compute_us: List[Interval] = []
    comm_us: List[Interval] = []
    anchor = (window[0] * 1e6 if window
              else (host_comm_us[0][0] if host_comm_us else None))
    origin = (obs_profile.marker_us(prof["doc"], WINDOW_MARKER)
              if window else None)
    shift = 0.0
    for _pname, ivs in sorted(prof["planes"].items()):
        if anchor is not None:
            ivs, shift = align_device_intervals(ivs, anchor, origin)
        for iv in ivs:
            (comm_us if iv["comm"] else compute_us).append(
                (iv["t0_us"], iv["t1_us"]))
    # the card's own busy time, before host windows stand in for comm
    device_u = union(compute_us + comm_us)
    if not comm_us:
        # the device saw no collectives: fall back to host windows so
        # single-plane captures still yield an overlap number
        comm_us = host_comm_us
    comp_u = union(compute_us)
    comm_u = union(comm_us)
    out = {}
    if window is not None:
        w0, w1 = window[0] * 1e6, window[1] * 1e6
        comp_u = clip(comp_u, w0, w1)
        comm_u = clip(comm_u, w0, w1)
        busy = clip(device_u, w0, w1)
        wall = w1 - w0
        idle = max(wall - total(busy), 0.0)
        out = {"window": [window[0], window[1]], "window_s": wall / 1e6,
               "idle_s": idle / 1e6,
               "idle_share": idle / wall if wall > 0 else None}
    overlapped = total(intersect(comp_u, comm_u))
    exposed = total(subtract(comm_u, comp_u))
    frac = (overlapped / (overlapped + exposed)
            if (overlapped + exposed) > 0 else None)
    if frac is not None:
        OVERLAP_FRACTION.set(frac)
    return {
        "status": "ok",
        "overlap_fraction": frac,
        "overlapped_comm_s": overlapped / 1e6,
        "exposed_comm_s": exposed / 1e6,
        "compute_s": total(comp_u) / 1e6,
        "device_planes": sorted(prof["planes"]),
        "shift_us": shift,
        **out,
    }

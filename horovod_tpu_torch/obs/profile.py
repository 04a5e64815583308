"""Device-trace op profiling: capture + summarize kernel time.

Counterpart of ``horovod_tpu/obs/profile.py``.  The JAX package parses
the XLA device trace (``*.xplane.pb``) that ``jax.profiler`` writes; the
port reads the Chrome-trace JSON that ``torch.profiler`` writes (through
``tensorboard_trace_handler`` or ``export_chrome_trace`` into a log
directory, ``*.json`` or ``*.json.gz``), with the same functions a
caller uses:

- :func:`trace` captures one (host and, when CUDA is available, card);
- :func:`plane_names` lists the trace's lanes, ``"<process> / <thread>"``
  from its metadata events (a card's lanes are its streams, e.g.
  ``"GPU 0 / stream 7"``);
- :func:`op_summary` and :func:`device_time_ms` aggregate the device
  events (kernels, memcpys, memsets);
- :func:`is_comm_op` flags NCCL kernels (``nccl*Kernel*``);
- :func:`load_profile` returns timestamped device intervals for the
  overlap join (``obs/stepprof.py``) and never raises;
- :class:`TruncatedProfile` is raised for a cut file.

Timestamps: Kineto writes ``ts`` (µs) relative to ``baseTimeNanoseconds``
when the trace carries one; :func:`load_profile` adds it back, so the
intervals are on the profiler's own clock.  ``obs/stepprof`` maps them
onto the host's wall clock (``align_device_intervals``).

Typical use::

    from horovod_tpu_torch.obs import profile
    with profile.trace("/tmp/prof"):
        step(); torch.cuda.synchronize()
    for row in profile.op_summary("/tmp/prof")[:10]:
        print(row)
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple


class TruncatedProfile(ValueError):
    """A trace file ended mid-document (a partial profiler flush, e.g.
    the process died while the trace was being written).
    :func:`load_profile` converts it into a ``status="truncated"``
    result instead of propagating."""


#: Chrome-trace event categories that are work on the card.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


# --- capture -------------------------------------------------------------


def export(prof, logdir: str) -> str:
    """Write a stopped ``torch.profiler.profile``'s trace into
    ``logdir`` as ``<host>.<pid>.<n>.pt.trace.json`` and return the
    path (the name ``tensorboard_trace_handler`` would give it)."""
    import socket

    os.makedirs(logdir, exist_ok=True)
    n = len(_find_traces(logdir))
    path = os.path.join(
        logdir, f"{socket.gethostname()}.{os.getpid()}.{n}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the body into ``logdir``:
    the host, and the card when CUDA is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    export(prof, logdir)


def _find_traces(logdir: str) -> List[str]:
    """Trace files under ``logdir``, oldest first (by modification time,
    then name)."""
    paths = set()
    for pat in ("*.json", "*.json.gz"):
        paths.update(glob.glob(os.path.join(logdir, "**", pat),
                               recursive=True))
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))


def newest(logdir: str) -> str:
    """The newest trace file under ``logdir``."""
    paths = _find_traces(logdir)
    if not paths:
        raise FileNotFoundError(f"no *.json / *.json.gz trace under "
                                f"{logdir}")
    return paths[-1]


def read_trace(path: str) -> dict:
    """The trace document at ``path``; raises :class:`TruncatedProfile`
    for a cut or malformed file."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                doc = json.load(f)
        else:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
    except (EOFError, gzip.BadGzipFile, json.JSONDecodeError,
            UnicodeDecodeError) as e:
        raise TruncatedProfile(f"{path}: {e}") from None
    if isinstance(doc, list):      # the bare-array form of the format
        doc = {"traceEvents": doc}
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise TruncatedProfile(f"{path}: no traceEvents array")
    return doc


def _lane_names(events: List[dict]) -> Tuple[Dict, Dict]:
    procs: Dict = {}
    threads: Dict = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        name = (e.get("args") or {}).get("name")
        if name is None:
            continue
        if e.get("name") == "process_name":
            procs[e.get("pid")] = str(name)
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = str(name)
    return procs, threads


def _lane(e: dict, procs: Dict, threads: Dict) -> str:
    pid, tid = e.get("pid"), e.get("tid")
    return (f"{procs.get(pid, f'pid {pid}')} / "
            f"{threads.get((pid, tid), f'tid {tid}')}")


def _is_device(e: dict) -> bool:
    return (e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATEGORIES)


def _group_name(name: str) -> str:
    """A kernel's family: its name without ``void``, template arguments
    and parameter list (``ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)``
    -> ``ncclDevKernel_AllReduce_Sum_f32_RING_LL``)."""
    name = re.sub(r"^void\s+", "", name.strip())
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


# --- public API ----------------------------------------------------------


def plane_names(logdir: str) -> List[str]:
    """The lanes (``"<process> / <thread>"``) holding complete events in
    the newest trace (debugging aid)."""
    events = read_trace(newest(logdir))["traceEvents"]
    procs, threads = _lane_names(events)
    return sorted({_lane(e, procs, threads) for e in events
                   if e.get("ph") == "X"})


def op_summary(logdir: str, *, group: bool = True,
               categories=DEVICE_CATEGORIES) -> List[dict]:
    """Aggregate per-op durations of the device events in the newest
    trace under ``logdir``.

    Returns rows ``{"op": name, "total_ms": t, "count": c}`` sorted by
    time, descending.  ``group=True`` buckets kernels by family
    (:func:`_group_name`), the actionable granularity.  ``categories``
    selects events by their ``cat`` (pass ``("cpu_op",)`` for a host-only
    trace).
    """
    events = read_trace(newest(logdir))["traceEvents"]
    agg: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e \
                or e.get("cat") not in categories:
            continue
        name = str(e.get("name", ""))
        if group:
            name = _group_name(name)
        cell = agg.setdefault(name, [0.0, 0])
        cell[0] += float(e["dur"]) / 1e3  # µs -> ms
        cell[1] += 1
    rows = [{"op": k, "total_ms": round(v[0], 3), "count": v[1]}
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def device_time_ms(logdir: str, **kw) -> float:
    """Total device busy time in the trace (sum over op rows)."""
    return round(sum(r["total_ms"] for r in op_summary(logdir, **kw)), 3)


# --- timestamped intervals for the overlap join (obs/stepprof.py) -------

# NCCL's device kernels: ncclKernel_*, ncclDevKernel_*.
_COMM_OP_RE = re.compile(r"nccl\w*kernel", re.IGNORECASE)


def is_comm_op(name: str) -> bool:
    """True when a kernel name denotes a NCCL communication kernel."""
    return bool(_COMM_OP_RE.search(name))


def base_time_us(doc: dict) -> float:
    """The trace's time base in µs (``baseTimeNanoseconds``; 0 when the
    trace has absolute ``ts``)."""
    try:
        return float(doc.get("baseTimeNanoseconds") or 0) / 1e3
    except (TypeError, ValueError):
        return 0.0


def marker_us(doc: dict, name: str) -> Optional[float]:
    """Start (profiler clock, µs) of the host's ``record_function``
    marker ``name`` (its ``user_annotation`` event, not the copy the card's
    lane shows), or None."""
    base = base_time_us(doc)
    for e in doc["traceEvents"]:
        if (e.get("ph") == "X" and e.get("name") == name
                and e.get("cat") == "user_annotation"):
            return base + float(e["ts"])
    return None


def load_profile(logdir: str) -> dict:
    """Timestamped device intervals from the newest trace — the overlap
    profiler's device-truth input.  NEVER raises: a host-only capture,
    an empty one or a cut file come back as an explicit status.

    Returns::

        {"status": "ok" | "no-profile" | "empty" | "truncated",
         "reason": str,          # human-readable when status != ok
         "path":   str | None,   # trace file parsed (newest)
         "planes": {lane: [interval, ...]},
         "doc":    dict | None}  # the parsed trace (markers)

    where each interval is ``{"op", "t0_us", "t1_us", "comm"}`` on the
    profiler's clock (``baseTimeNanoseconds`` + ``ts``), and ``comm``
    flags NCCL kernels.  Only device events (kernels, memcpys, memsets)
    are kept, one plane a stream.
    """
    paths = _find_traces(logdir) if os.path.isdir(logdir) else []
    if not paths:
        return {"status": "no-profile", "path": None, "planes": {},
                "doc": None,
                "reason": f"no *.json / *.json.gz trace under {logdir}"}
    path = paths[-1]
    try:
        if os.path.getsize(path) == 0:
            return {"status": "empty", "path": path, "planes": {},
                    "doc": None, "reason": "zero-byte trace file"}
        doc = read_trace(path)
    except OSError as e:
        return {"status": "no-profile", "path": path, "planes": {},
                "doc": None, "reason": f"unreadable trace: {e}"}
    except TruncatedProfile as e:
        return {"status": "truncated", "path": path, "planes": {},
                "doc": None, "reason": str(e)}
    events = doc["traceEvents"]
    base = base_time_us(doc)
    procs, threads = _lane_names(events)
    planes: Dict[str, List[dict]] = {}
    for e in events:
        if not _is_device(e):
            continue
        name = str(e.get("name", ""))
        t0 = base + float(e["ts"])
        planes.setdefault(_lane(e, procs, threads), []).append({
            "op": name,
            "t0_us": t0,
            "t1_us": t0 + float(e["dur"]),
            "comm": is_comm_op(name),
        })
    for ivs in planes.values():
        ivs.sort(key=lambda r: r["t0_us"])
    if not planes:
        return {"status": "empty", "path": path, "planes": planes,
                "doc": doc,
                "reason": "no device events (kernels, memcpys, memsets) "
                          "in the trace (a host-only capture?)"}
    return {"status": "ok", "path": path, "planes": planes, "doc": doc,
            "reason": ""}

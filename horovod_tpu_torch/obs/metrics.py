"""Unified metrics registry: always-on numeric telemetry for every layer.

Counterpart of ``horovod_tpu/obs/metrics.py``, copied so that the port
imports nothing of the JAX package; the families, their names, the
Prometheus text and the snapshots are the reference's, byte for byte:

- a dependency-free, thread-safe registry of **Counter** / **Gauge** /
  **Histogram** (fixed log-scale buckets) families, with optional
  Prometheus-style labels;
- a **Prometheus text-format exposition endpoint** (``/metrics``) and
  the ``/debug`` introspection plane, served from a background
  ``http.server`` thread when ``HVTPU_METRICS_PORT`` is set; each worker
  binds ``port + local_rank`` so multi-slot hosts don't collide;
- ``snapshot()`` (JSON-serializable dump of every family) and
  ``aggregate(process_set)`` — an allgather of per-rank snapshots over
  the ``torch.distributed`` store (``core/kv.py``'s client under
  ``core/retry.py``'s policies, the same store the async controller and
  the stall heartbeat ride), so rank 0 can export a cluster-wide view.

Instrumented producers in the port: ``comm/eager.py`` (per-collective
counts, wire bytes before and after compression, allreduce latency),
``torch/optimizer.py`` (one allreduce a bucket), ``eager/controller.py``
(cycle duration, queue depth, negotiation latency, cache hits,
prediction, arrival skew), ``comm/stall.py`` (heartbeat age,
warnings/aborts), ``comm/wirefault.py`` (retries, consensus time, link
health), ``core/retry.py`` (KV retries, fences), ``obs/flight.py``,
``obs/anomaly.py`` and ``obs/stepprof.py``.  The elastic, data and
fleet planes, which feed more families in the reference, are not
ported yet.

Cost model: a counter increment is a lock + dict add (~1 µs on a host
CPU), so the registry always counts; only the HTTP endpoint is opt-in.
"""

from __future__ import annotations

import bisect
import http.server
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("horovod_tpu_torch")

# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------


def log_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` log-scale bucket upper bounds: start * factor**k."""
    return tuple(start * factor ** k for k in range(count))


# 10 µs .. ~42 s in 4x steps — spans a sub-ms CPU op to a stalled pod.
DEFAULT_TIME_BUCKETS = log_buckets(1e-5, 4.0, 12)
# 256 B .. ~1 GiB in 4x steps — a scalar barrier to a fused VGG bucket.
DEFAULT_BYTE_BUCKETS = log_buckets(256.0, 4.0, 12)


def _labelstr(labels: Dict[str, str]) -> str:
    """Canonical (sorted) Prometheus label block, '' when unlabeled."""
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    """Prometheus sample value: integral counters render without '.0'."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[str, float] = {}

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_labelstr(labels), 0.0)

    def _reset(self):
        self._values.clear()

    # -- snapshot / exposition ------------------------------------------
    def _snapshot_values(self):
        return dict(self._values)

    def _expo_lines(self) -> List[str]:
        return [f"{self.name}{k} {_fmt(v)}"
                for k, v in sorted(self._values.items())]


class Counter(_Family):
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labelstr(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Family):
    """Point-in-time value (Prometheus gauge)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._values[_labelstr(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = _labelstr(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)


class Histogram(_Family):
    """Distribution over fixed log-scale buckets (Prometheus histogram).

    Internally stores per-bucket (non-cumulative) counts plus an
    overflow slot; exposition emits the cumulative ``_bucket{le=...}``
    series, ``_sum`` and ``_count``.
    """

    kind = "histogram"

    def __init__(self, name, help, lock, buckets=None):
        super().__init__(name, help, lock)
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else DEFAULT_TIME_BUCKETS)
        )
        # label key -> [counts (len buckets + 1 overflow), sum, count]
        self._values: Dict[str, list] = {}

    def observe(self, value: float, **labels):
        key = _labelstr(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            cell = self._values.get(key)
            if cell is None:
                cell = self._values[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0]
            cell[0][i] += 1
            cell[1] += float(value)
            cell[2] += 1

    def observe_many(self, values, **labels):
        """Record a batch of observations under ONE lock acquisition —
        the per-fused-group bookkeeping path of the eager controller
        (one metrics update per group instead of per op)."""
        values = [float(v) for v in values]
        if not values:
            return
        key = _labelstr(labels)
        idxs = [bisect.bisect_left(self.buckets, v) for v in values]
        with self._lock:
            cell = self._values.get(key)
            if cell is None:
                cell = self._values[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0]
            for i in idxs:
                cell[0][i] += 1
            cell[1] += sum(values)
            cell[2] += len(values)

    def value(self, **labels):
        with self._lock:
            cell = self._values.get(_labelstr(labels))
            return 0 if cell is None else cell[2]

    def _snapshot_values(self):
        return {
            k: {"counts": list(c[0]), "sum": c[1], "count": c[2]}
            for k, c in self._values.items()
        }

    def _expo_lines(self) -> List[str]:
        lines = []
        for key, (counts, total, n) in sorted(self._values.items()):
            base = key[1:-1] if key else ""  # strip {} to splice 'le' in

            def lbl(le: str) -> str:
                return "{" + (base + "," if base else "") + \
                    f'le="{le}"' + "}"

            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket{lbl('{:g}'.format(b))} {cum}")
            lines.append(f"{self.name}_bucket{lbl('+Inf')} {n}")
            lines.append(f"{self.name}_sum{key} {repr(float(total))}")
            lines.append(f"{self.name}_count{key} {n}")
        return lines


class MetricsRegistry:
    """Named families, created idempotently; one coarse lock (metric
    updates are far off any sub-microsecond path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, cls, name, help, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {cls.kind}")
                return fam
            fam = cls(name, help, self._lock, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self._family(Histogram, name, help, buckets=buckets)

    def reset(self):
        """Zero every family's samples (families stay registered so
        cached accessor objects remain valid) — test hook."""
        with self._lock:
            for fam in self._families.values():
                fam._reset()

    # -- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable dump of every family (the unit that rides
        the coordination KV in ``aggregate`` and embeds in bench.py's
        report)."""
        with self._lock:
            return {
                name: {
                    "type": fam.kind,
                    "help": fam.help,
                    **({"buckets": list(fam.buckets)}
                       if isinstance(fam, Histogram) else {}),
                    "values": fam._snapshot_values(),
                }
                for name, fam in sorted(self._families.items())
            }

    def exposition(self) -> str:
        """Prometheus text format 0.0.4."""
        out = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                help_ = fam.help.replace("\\", r"\\").replace("\n", r"\n")
                out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} {fam.kind}")
                out.extend(fam._expo_lines())
        return "\n".join(out) + "\n"


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> Dict[str, dict]:
    return REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# hot-path accessors (pre-registered so call sites are one cached lookup)
# ---------------------------------------------------------------------------

_OP_COUNTERS: Dict[str, Counter] = {}
_OP_LOCK = threading.Lock()


def op_counter(kind: str) -> Counter:
    """Per-collective-kind counter, e.g. ``hvtpu_allreduce_total``."""
    c = _OP_COUNTERS.get(kind)
    if c is None:
        with _OP_LOCK:
            c = _OP_COUNTERS.setdefault(kind, REGISTRY.counter(
                f"hvtpu_{kind}_total",
                f"Eager {kind} collectives executed by this rank."))
    return c


TENSOR_BYTES = REGISTRY.counter(
    "hvtpu_tensor_bytes_total",
    "Collective payload bytes BEFORE wire compression/quantization.")
WIRE_BYTES = REGISTRY.counter(
    "hvtpu_wire_bytes_total",
    "Bytes actually moved on the wire (after compression/quantization, "
    "including quantization scale sidecars).")
ALLREDUCE_LATENCY = REGISTRY.histogram(
    "hvtpu_allreduce_latency_seconds",
    "Eager allreduce dispatch-to-ready latency as seen by the caller.",
    buckets=DEFAULT_TIME_BUCKETS)

_STEP_STATE = {"t": None}
_STEP_LOCK = threading.Lock()
# EWMA weight for the steps/examples-per-second gauges: ~last 10 steps.
_RATE_ALPHA = 0.2


def note_step(examples: float = 0.0, steps: float = 1.0):
    """Record optimizer/training progress.  Increments the step and
    example counters and maintains EWMA ``*_per_second`` gauges from
    inter-call time.  The training loop calls it once a step from the
    host, passing the steps and examples per call (the torch
    ``DistributedOptimizer`` calls it nowhere, as the reference's does
    not).  With stepprof on, it closes the step window: the step record
    feeds the flight ring and the anomaly detectors."""
    REGISTRY.counter(
        "hvtpu_optimizer_steps_total", "Optimizer steps applied."
    ).inc(steps)
    if examples:
        REGISTRY.counter(
            "hvtpu_examples_total", "Training examples processed."
        ).inc(examples)
    # Step-boundary hook for the overlap profiler (import deferred:
    # stepprof imports this module for its registry).  The returned
    # step record feeds the flight ring and the anomaly detectors —
    # both behind single module-attribute guards when disabled.
    from . import stepprof as _stepprof
    if _stepprof.ACTIVE:
        rec = _stepprof.note_step_boundary(steps=steps)
        if rec is not None:
            from . import anomaly as _anomaly
            from . import flight as _flight
            if _flight.ACTIVE:
                _flight.note("step", **rec)
            if _anomaly.ACTIVE:
                _anomaly.on_step(rec)
    now = time.monotonic()
    with _STEP_LOCK:
        prev = _STEP_STATE["t"]
        _STEP_STATE["t"] = now
    if prev is None or now <= prev:
        return
    dt = now - prev
    sps = REGISTRY.gauge(
        "hvtpu_steps_per_second", "EWMA optimizer steps per second.")
    old = sps.value()
    rate = steps / dt
    sps.set((1 - _RATE_ALPHA) * old + _RATE_ALPHA * rate
            if old else rate)
    if examples:
        eps = REGISTRY.gauge(
            "hvtpu_examples_per_second", "EWMA training examples per "
            "second (requires callers to pass examples to note_step).")
        old = eps.value()
        rate = examples / dt
        eps.set((1 - _RATE_ALPHA) * old + _RATE_ALPHA * rate
                if old else rate)


# ---------------------------------------------------------------------------
# live /debug introspection plane
# ---------------------------------------------------------------------------
# Subsystems (eager controller, stall inspector, core state) register a
# zero-argument callable returning a JSON-serializable dict; the HTTP
# server's /debug route snapshots all of them so "what is my job doing"
# is one curl away.  A provider that raises is reported in place as an
# {"error": ...} entry — introspection never takes the endpoint down.

_debug_providers: Dict[str, Callable[[], dict]] = {}
_debug_lock = threading.Lock()


def register_debug_provider(name: str, fn: Callable[[], dict]) -> None:
    with _debug_lock:
        _debug_providers[name] = fn


def unregister_debug_provider(name: str) -> None:
    with _debug_lock:
        _debug_providers.pop(name, None)


def debug_snapshot() -> dict:
    """One coherent-ish dump of every registered provider (each
    provider snapshots under its own lock; cross-provider skew is the
    wall time between calls)."""
    with _debug_lock:
        items = list(_debug_providers.items())
    out: dict = {"time_unix": time.time()}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — isolate provider faults
            out[name] = {"error": str(e)}
    return out


# ---------------------------------------------------------------------------
# Prometheus exposition endpoint
# ---------------------------------------------------------------------------

_server: Optional[http.server.ThreadingHTTPServer] = None
_server_thread: Optional[threading.Thread] = None
_server_lock = threading.Lock()


def _make_handler(registry: MetricsRegistry):
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            path = self.path.split("?", 1)[0]
            if path == "/debug":
                body = json.dumps(
                    debug_snapshot(), indent=2, default=str,
                ).encode("utf-8")
                ctype = "application/json"
            elif path in ("/", "/metrics"):
                body = registry.exposition().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-scrape stderr noise
            pass

    return Handler


def start_http_server(port: int, addr: str = "",
                      registry: Optional[MetricsRegistry] = None) -> int:
    """Serve ``registry`` (default: the global one) at
    ``http://<addr>:<port>/metrics`` from a daemon thread.  ``port=0``
    binds an ephemeral port.  Returns the bound port.  Idempotent per
    process: a second call while a server is live returns its port."""
    global _server, _server_thread
    with _server_lock:
        if _server is not None:
            return _server.server_address[1]
        srv = http.server.ThreadingHTTPServer(
            (addr, port), _make_handler(registry or REGISTRY))
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="hvt-metrics-http", daemon=True)
        t.start()
        _server, _server_thread = srv, t
        return srv.server_address[1]


def stop_http_server():
    global _server, _server_thread
    with _server_lock:
        srv, t = _server, _server_thread
        _server = _server_thread = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if t is not None:
        t.join(timeout=5)


def serve_from_env(local_rank: int = 0) -> Optional[int]:
    """Start the endpoint when ``HVTPU_METRICS_PORT`` (reference
    spelling ``HOROVOD_METRICS_PORT`` honored too) is set: each worker
    binds ``port + local_rank`` so multi-slot hosts don't collide.  A
    bind failure logs a warning and returns None — telemetry must never
    take a healthy job down."""
    raw = (os.environ.get("HVTPU_METRICS_PORT")
           or os.environ.get("HOROVOD_METRICS_PORT"))
    if not raw:
        return None
    try:
        base = int(raw)
    except ValueError:
        logger.warning("HVTPU_METRICS_PORT=%r is not an integer; "
                       "metrics endpoint disabled", raw)
        return None
    if base <= 0:
        return None
    try:
        return start_http_server(base + local_rank)
    except OSError as e:
        logger.warning(
            "metrics endpoint disabled: could not bind port %d: %s",
            base + local_rank, e)
        return None


# ---------------------------------------------------------------------------
# cross-rank aggregation over the coordination KV
# ---------------------------------------------------------------------------

_agg_seq: Dict[Tuple[int, int], int] = {}
_agg_lock = threading.Lock()
_AGG_NS = "hvtmetrics"


def merge_snapshots(snaps: List[Dict[str, dict]]) -> Dict[str, dict]:
    """Element-wise merge of per-rank snapshots: counters, gauges and
    histogram cells SUM across ranks (a summed gauge is the natural
    cluster view for worker counts and rates; per-rank values stay
    available in ``aggregate``'s per_rank map)."""
    merged: Dict[str, dict] = {}
    for snap in snaps:
        for name, fam in snap.items():
            m = merged.get(name)
            if m is None:
                merged[name] = json.loads(json.dumps(fam))  # deep copy
                continue
            if fam["type"] == "histogram":
                if fam.get("buckets") != m.get("buckets"):
                    raise ValueError(
                        f"histogram {name!r} bucket mismatch across ranks")
                for key, cell in fam["values"].items():
                    mc = m["values"].get(key)
                    if mc is None:
                        m["values"][key] = json.loads(json.dumps(cell))
                    else:
                        mc["counts"] = [a + b for a, b in
                                        zip(mc["counts"], cell["counts"])]
                        mc["sum"] += cell["sum"]
                        mc["count"] += cell["count"]
            else:
                for key, v in fam["values"].items():
                    m["values"][key] = m["values"].get(key, 0.0) + v
    return merged


def aggregate(process_set=None, timeout_s: float = 60.0,
              registry: Optional[MetricsRegistry] = None) -> dict:
    """Allgather every member rank's ``snapshot()`` through the
    ``torch.distributed`` store and return ``{"per_rank": {rank: snap},
    "merged": snap}``.

    COLLECTIVE contract: every member rank of the process set must call
    ``aggregate`` the same number of times (each call uses a fresh
    per-set sequence number, like a controller cycle).  Single-process
    worlds — or processes without a coordination client — degrade to the
    local snapshot.  The keys are the reference's
    (``hvtmetrics/<init generation>/<set id>/<seq>/<rank>``), under the
    client's own prefix.
    """
    registry = registry or REGISTRY
    snap = registry.snapshot()

    try:
        from ..core import state as core_state

        st = core_state.global_state()
    except Exception:
        st = None
    if st is None or not st.initialized or st.size <= 1:
        rank = st.rank if st is not None else 0
        return {"per_rank": {rank: snap}, "merged": snap}

    client = st.kv
    if client is None:
        return {"per_rank": {st.rank: snap}, "merged": snap}

    if process_set is None:
        ps = st.process_set_table.global_process_set
    elif isinstance(process_set, int):
        ps = st.process_set_table.get(process_set)
    else:
        ps = process_set
    members = list(ps.ranks) if ps.ranks is not None else list(
        range(st.size))
    if st.rank not in members:
        raise ValueError(
            f"rank {st.rank} is not a member of process set "
            f"{ps.process_set_id}")

    # One shared retry engine (core/retry.py): the KV wrapper retries
    # transient put failures with backoff (counted in
    # hvtpu_kv_retries_total), and the per-peer blocking poll rides a
    # deadline-bounded policy where NOT_FOUND/timeout just means "the
    # peer hasn't posted yet".
    from ..core import retry as core_retry

    kv = core_retry.resilient_kv(client, rank=st.rank)

    with _agg_lock:
        key = (st.init_generation, ps.process_set_id)
        seq = _agg_seq.get(key, 0)
        _agg_seq[key] = seq + 1
    prefix = (f"{_AGG_NS}/{st.init_generation}/{ps.process_set_id}/"
              f"{seq}/")
    kv.key_value_set(prefix + str(st.rank), json.dumps(snap))

    per_rank: Dict[int, dict] = {st.rank: snap}
    deadline = time.monotonic() + timeout_s
    poll_policy = core_retry.RetryPolicy(
        name="metrics-aggregate",
        max_attempts=1_000_000,  # the deadline is the real bound
        base_delay_s=0.02, max_delay_s=0.25,
        deadline_s=timeout_s,
        retryable=core_retry.kv_blocking_retryable)

    def _fetch(r: int) -> dict:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            # non-retryable by design: the GLOBAL deadline bounds the
            # whole aggregate, not each peer's poll loop
            raise RuntimeError("aggregate budget spent")
        budget_ms = max(1, int(remaining * 1000))
        return json.loads(kv.blocking_key_value_get(
            prefix + str(r), min(budget_ms, 2000)))

    for r in sorted(members):
        if r == st.rank:
            continue
        try:
            per_rank[r] = core_retry.call(poll_policy, _fetch, r)
        except Exception:
            raise TimeoutError(
                f"metrics snapshot from rank {r} not posted "
                f"within {timeout_s:.0f}s") from None
    # rolling cleanup: every member posted seq, so nobody still needs
    # this rank's previous round (each rank deletes only its own key)
    if seq > 0:
        try:
            kv.key_value_delete(
                f"{_AGG_NS}/{st.init_generation}/{ps.process_set_id}/"
                f"{seq - 1}/{st.rank}")
        except Exception:
            pass
    return {"per_rank": per_rank, "merged": merge_snapshots(
        [per_rank[r] for r in sorted(per_rank)])}

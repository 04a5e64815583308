"""Cross-rank distributed tracing with clock alignment.

Counterpart of ``horovod_tpu/obs/tracing.py``, copied so that the port
imports nothing of the JAX package.  The span files are the ones
``tools/hvtputrace`` reads (``rank<N>.trace.json`` with the
``clock_anchor`` and ``clock_offset`` instants), so ``python -m
tools.hvtputrace merge|report|overlap <dir>`` takes the port's traces
unchanged.

Each rank writes a Chrome-trace JSON (through the existing
:class:`~horovod_tpu.obs.timeline.Timeline` writer) in which every
collective carries a **rank-agnostic trace id**: ``"{tensor}#{k}"``
where ``k`` counts how many times this rank has begun a span for that
tensor name.  Because the negotiation protocol (eager controller) and
the SPMD contract (sync data plane) force every member rank to process
a given tensor name the same number of times in the same order, the
same ``(name, k)`` pair on two ranks names the *same* collective —
no cross-rank coordination is needed to correlate spans.

Spans progress through the phases

    NEGOTIATE -> QUEUE -> FUSE -> EXEC  (then a DONE instant)

NEGOTIATE covers enqueue until the coordinator's response is applied,
QUEUE until the executor picks the op up, FUSE the fusion-buffer pack
window, EXEC the wire collective itself.  The sync data plane has no
negotiation, so its spans begin directly in EXEC.

Clock alignment: at install time every non-zero rank runs an NTP-style
ping/pong over the ``torch.distributed`` store (``core/kv.py``'s client,
fenced by ``core/retry.py``) against a responder thread on
rank 0.  For each ping, ``offset = t2 - (t1 + t4) / 2`` where t1/t4
are the peer's send/receive wall-clock times and t2 is rank 0's
wall-clock reply; the sample with the smallest round trip wins and its
error is bounded by ``rtt / 2``.  The offset (rank0-relative: adding
it to a local wall timestamp yields rank-0 time) is recorded as a
``clock_offset`` instant in the trace; ``tools/hvtputrace merge``
applies it when fusing per-rank files.

Zero-cost-when-off contract (mirrors ``core/faults.ACTIVE``): hot call
sites guard every emission with ``if tracing.ACTIVE:`` — a single
module-attribute check when ``HVTPU_TRACE`` is unset.

Step spans (the port's own; the JAX package has none): while a
``torch.profiler`` session is on, the optimizer's step path
(``torch/optimizer.py``) records ``hvd.*`` spans of its hooks, bucket
launches, ``synchronize`` and update, in memory and on one host clock
(``time.perf_counter_ns``) for all threads, each also a
``record_function`` range (``user_annotation``) of the same name in the
profiler's trace.  A site tests
``torch.autograd.profiler._is_profiler_enabled`` before it opens a
span, so with the profiler off it costs that one read.
:func:`step_spans` returns the record and :func:`trace_offset` maps it
onto a profiler trace's clock.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .timeline import Timeline

logger = logging.getLogger("horovod_tpu_torch.tracing")

# Span phases (NEGOTIATE/QUEUE deliberately match timeline.py's
# reference-parity names; FUSE/EXEC/DONE are tracing-specific).
NEGOTIATE = "NEGOTIATE"
QUEUE = "QUEUE"
FUSE = "FUSE"
EXEC = "EXEC"
DONE = "DONE"
# Predicted fast path (eager/controller._try_predict): the agreed
# schedule was reconstructed locally and execution started without
# waiting for the coordinator round trip; the span jumps
# NEGOTIATE -> PREDICT -> QUEUE and the post-hoc confirmation rides
# the request stream.
PREDICT = "PREDICT"
# Input-pipeline wait (data/loader.py): time the training loop blocked
# on the prefetch queue.  hvtputrace report buckets it separately from
# the collective wait phases so stragglers attribute to input vs
# compute vs comms.
DATA_WAIT = "DATA_WAIT"

# Module-level fast-path flag: call sites do `if tracing.ACTIVE:` so
# the disabled path is one attribute load (same contract as
# core/faults.ACTIVE, enforced by tests/test_tracing.py).
ACTIVE = False
_tracer: Optional["Tracer"] = None

_KV_NS = "hvttrace"
# Per-pong wait and total budget for the install-time clock handshake;
# on expiry tracing degrades to offset=None rather than blocking init.
_PONG_TIMEOUT_MS = 5000
_SYNC_DEADLINE_S = 30.0


class Tracer:
    """Per-rank span writer over a Timeline file in ``trace_dir``.

    Thread-safe: span bookkeeping (occurrence counters and the live-id
    map) is serialized under ``_lock``, which is also held across the
    Timeline emission so B/E ordering per tensor name is preserved even
    when phases arrive from different controller threads (enqueue
    thread -> fetcher -> executor).
    """

    def __init__(self, trace_dir: str, rank: int = 0, size: int = 1):
        self.rank = rank
        self.size = size
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(trace_dir, f"rank{rank}.trace.json")
        self._tl = Timeline(self.path, rank=rank)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}  # hvtpulint: guarded-by(_lock)
        self._live: Dict[str, str] = {}  # hvtpulint: guarded-by(_lock)
        self.offset_us: Optional[float] = 0.0 if rank == 0 else None
        self.offset_error_us: Optional[float] = 0.0 if rank == 0 else None
        self._responder: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Anchor instant: maps this file's relative timestamps (µs
        # since Timeline._t0) onto the local wall clock for the merge
        # tool.  Written first so it survives truncated traces.
        self._tl.instant(
            "clock_anchor",
            rank=rank,
            size=size,
            wall_t0_us=int(self._tl.wall_t0 * 1e6),
        )

    # ---- span API (call sites hold no locks) ----

    def op_begin(self, name: str, kind: str = "", phase: str = NEGOTIATE,
                 **args):
        with self._lock:
            k = self._counts.get(name, 0)
            self._counts[name] = k + 1
            trace_id = f"{name}#{k}"
            self._live[name] = trace_id
            self._tl.begin(name, phase, trace_id=trace_id, kind=kind, **args)

    def op_phase(self, name: str, phase: str, **args):
        with self._lock:
            trace_id = self._live.get(name)
            if trace_id is None:
                # Not a live traced op on this rank (e.g. a response for
                # a process set this rank is not a member of).
                return
            self._tl.begin(name, phase, trace_id=trace_id, **args)

    def op_done(self, name: str, **args):
        with self._lock:
            trace_id = self._live.pop(name, None)
            if trace_id is None:
                return
            self._tl.end(name)
            self._tl.instant(DONE, tensor=name, trace_id=trace_id, **args)

    # Batched variants: one lock acquisition (and one Timeline flush
    # window) for a whole fused group instead of per-op round trips —
    # the bookkeeping half of the zero-copy fusion-buffer plane.

    def op_phase_many(self, names, phase: str, **args):
        with self._lock:
            for name in names:
                trace_id = self._live.get(name)
                if trace_id is None:
                    continue
                self._tl.begin(name, phase, trace_id=trace_id, **args)

    def op_done_many(self, items, **shared):
        """``items``: iterable of ``(name, per-op-args dict)``;
        ``shared`` kwargs ride on every DONE instant."""
        with self._lock:
            for name, args in items:
                trace_id = self._live.pop(name, None)
                if trace_id is None:
                    continue
                self._tl.end(name)
                self._tl.instant(DONE, tensor=name, trace_id=trace_id,
                                 **shared, **args)

    def instant(self, name: str, **args):
        self._tl.instant(name, **args)

    # ---- clock alignment over the coordination store ----

    def sync_clock(self, client, pings: int = 8):
        """Run the install-time clock handshake.

        rank 0 spawns a responder daemon; every other rank pings it
        ``pings`` times and keeps the minimum-RTT offset sample.  Any
        KV failure degrades to ``offset=None`` (the merge tool then
        skips offset correction for this rank) — tracing never takes
        the job down.
        """
        if client is None or self.size <= 1:
            self._emit_offset(pings_ok=0)
            return
        if self.rank == 0:
            self._responder = threading.Thread(
                target=self._respond_pings, args=(client, pings),
                name="hvtpu-trace-clock", daemon=True)
            self._responder.start()
            self._emit_offset(pings_ok=0)
            return
        best_rtt = None
        ok = 0
        try:
            for i in range(pings):
                t1 = time.time()
                client.key_value_set(
                    f"{_KV_NS}/ping/{self.rank}/{i}", repr(t1))
                t2 = float(client.blocking_key_value_get(
                    f"{_KV_NS}/pong/{self.rank}/{i}", _PONG_TIMEOUT_MS))
                t4 = time.time()
                ok += 1
                rtt = t4 - t1
                if best_rtt is None or rtt < best_rtt:
                    best_rtt = rtt
                    self.offset_us = (t2 - (t1 + t4) / 2.0) * 1e6
                    self.offset_error_us = rtt / 2.0 * 1e6
        except Exception as e:  # noqa: BLE001 - tracing must not kill init
            logger.warning("trace clock sync degraded on rank %d: %s",
                           self.rank, e)
        self._emit_offset(pings_ok=ok)

    def _respond_pings(self, client, pings: int):
        """rank-0 responder: answer each peer ping with our wall clock."""
        deadline = time.monotonic() + _SYNC_DEADLINE_S
        for i in range(pings):
            for r in range(1, self.size):
                while not self._stop.is_set():
                    try:
                        client.blocking_key_value_get(
                            f"{_KV_NS}/ping/{r}/{i}", 1000)
                    except Exception:
                        if time.monotonic() > deadline:
                            return
                        continue
                    try:
                        client.key_value_set(
                            f"{_KV_NS}/pong/{r}/{i}", repr(time.time()))
                    except Exception:
                        return
                    break

    def _emit_offset(self, pings_ok: int):
        self._tl.instant(
            "clock_offset",
            rank=self.rank,
            offset_us=self.offset_us,
            error_bound_us=self.offset_error_us,
            pings=pings_ok,
        )

    def close(self):
        self._stop.set()
        # Timeline.close() ends dangling spans itself, so an abnormal
        # shutdown still yields a parseable trace.
        self._tl.close()


# ---- module-level hot-path shims -----------------------------------------
# Call sites do `if tracing.ACTIVE: tracing.op_begin(...)`; the second
# _tracer check makes a lost race with uninstall() a no-op.

def op_begin(name: str, kind: str = "", phase: str = NEGOTIATE, **args):
    t = _tracer
    if t is not None:
        t.op_begin(name, kind, phase, **args)


def op_phase(name: str, phase: str, **args):
    t = _tracer
    if t is not None:
        t.op_phase(name, phase, **args)


def op_done(name: str, **args):
    t = _tracer
    if t is not None:
        t.op_done(name, **args)


def op_phase_many(names, phase: str, **args):
    t = _tracer
    if t is not None:
        t.op_phase_many(names, phase, **args)


def op_done_many(items, **shared):
    t = _tracer
    if t is not None:
        t.op_done_many(items, **shared)


def instant(name: str, **args):
    t = _tracer
    if t is not None:
        t.instant(name, **args)


# Step-boundary instants: the host loop (metrics.note_step via
# obs/stepprof) marks the end of each training-step window so
# ``hvtputrace overlap`` can cut the span timeline into per-step
# decompositions.  ``wall_us`` carries the local wall clock of the
# boundary — the merge tool's clock_anchor/clock_offset pipeline maps
# trace timestamps the same way, so the two stay joinable.
STEP_BOUNDARY = "step_boundary"


def step_boundary(wall_us: float, steps: float = 1.0, **args):
    t = _tracer
    if t is not None:
        t.instant(STEP_BOUNDARY, wall_us=wall_us, steps=steps, **args)


def install(trace_dir: str, rank: int = 0, size: int = 1, client=None,
            pings: int = 8) -> Tracer:
    """Create the process tracer and flip the ACTIVE fast-path flag.

    ``client`` is the coordination store client used for the clock
    handshake (None skips it, e.g. single-process runs and unit tests).
    """
    global _tracer, ACTIVE
    if _tracer is not None:
        uninstall()
    tracer = Tracer(trace_dir, rank=rank, size=size)
    tracer.sync_clock(client, pings=pings)
    _tracer = tracer
    ACTIVE = True
    logger.info("distributed tracing enabled: %s", tracer.path)
    return tracer


def uninstall():
    """Flush and disable tracing (idempotent; called at shutdown and
    registered via atexit through core/state so traces survive
    abnormal exits)."""
    global _tracer, ACTIVE
    ACTIVE = False
    tracer, _tracer = _tracer, None
    if tracer is not None:
        tracer.close()


def get_tracer() -> Optional[Tracer]:
    return _tracer


# ---- step spans ------------------------------------------------------------
# The names of the optimizer's spans (torch/optimizer.py), each on the
# thread that does the work: the hooks on the autograd engine's device
# thread, a bucket's launch where its last gradient became ready, the
# rest on the thread that calls ``step()``.
HOOK = "hvd.hook"
BUCKET_LAUNCH = "hvd.bucket.launch"
BUCKET_PACK = "hvd.bucket.pack"
BUCKET_DISPATCH = "hvd.bucket.dispatch"
OPTIMIZER_STEP = "hvd.optimizer.step"
SYNCHRONIZE = "hvd.synchronize"
BUCKET_WAIT = "hvd.bucket.wait"
BUCKET_UNPACK = "hvd.bucket.unpack"
UPDATE = "hvd.update"

# the record keeps the newest spans: ~400 a ResNet-50 step
STEP_SPAN_CAPACITY = 1 << 16


class StepSpan(NamedTuple):
    """One closed step span.  ``tid`` is the OS thread id, which the
    profiler's trace gives its threads; ``parent`` is the ``id`` of the
    span that encloses it on the same thread."""

    name: str
    tid: int
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    attrs: dict
    id: int


class OpenSpan:
    """A step span that is open; :func:`span_close` ends it.  ``attrs``
    may be filled in until then."""

    __slots__ = ("name", "tid", "id", "parent", "attrs", "range", "t0_ns")

    def __init__(self, name, tid, id, parent, attrs, rng, t0_ns):
        self.name, self.tid, self.id, self.parent = name, tid, id, parent
        self.attrs, self.range, self.t0_ns = attrs, rng, t0_ns


# appends and next() are atomic under the interpreter lock; each thread
# keeps its own stack of open spans, and its OS thread id, read once
# since that is a system call
_step_spans: "collections.deque[StepSpan]" = collections.deque(
    maxlen=STEP_SPAN_CAPACITY)
_span_ids = itertools.count()
_open = threading.local()


def span_open(name: str, **attrs) -> OpenSpan:
    """Open a step span on this thread, inside the span open there, and
    enter its range in the profiler's trace.  Call sites call it only
    while ``torch.autograd.profiler._is_profiler_enabled``.

    The range is the ``user_annotation`` that ``record_function``
    makes, entered through the binding that keeps the interpreter lock:
    ``record_function`` enters through an operator call, which releases
    the lock, and each range then waits to take it back while another
    thread runs Python."""
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
        _open.tid = threading.get_native_id()
    # the clock is read next to the profiler's own stamps, just before
    # the range's enter and just after its exit, so the span holds it
    t0 = time.perf_counter_ns()
    rng = torch._C._autograd._record_function_with_args_enter(name)
    span = OpenSpan(name, _open.tid, next(_span_ids),
                    stack[-1].id if stack else None, attrs, rng, t0)
    stack.append(span)
    return span


def span_close(span: OpenSpan) -> None:
    """Close ``span`` and record it.  Spans opened inside it and left
    open by an exception are closed with it and not recorded."""
    stack = _open.stack
    while stack:
        top = stack.pop()
        torch._C._autograd._record_function_with_args_exit(top.range)
        if top is span:
            break
    t1 = time.perf_counter_ns()
    _step_spans.append(StepSpan(span.name, span.tid, span.t0_ns, t1,
                                span.parent, span.attrs, span.id))


def step_spans() -> List[StepSpan]:
    """The recorded step spans, oldest first (at most
    ``STEP_SPAN_CAPACITY``)."""
    return list(_step_spans)


def trace_offset(spans: Sequence[StepSpan],
                 marks: Sequence[Tuple[float, float, str]]
                 ) -> Optional[float]:
    """The offset, in µs, from the step spans' clock to a profiler
    trace's: a span's time in the trace is ``t_ns / 1e3 + offset``.

    ``spans`` are one thread's spans, ``marks`` the same thread's ranges
    as the trace shows them, ``(t0_us, t1_us, name)``.  Spans and ranges
    of one name are matched in order; where one side holds more of a
    name (the record spans several profiler sessions), the run of
    consecutive pairs whose offsets agree best is taken.  Returns the
    median of the matched pairs' offsets at both ends, or None when no
    name is on both sides.  ``obs/stepprof.align_device_intervals``
    shifts by one anchor; this takes many, so one late range moves
    nothing."""
    offsets: List[float] = []
    for name in sorted({m[2] for m in marks}):
        ranges = sorted((a, b) for a, b, n in marks if n == name)
        mine = sorted((s.t0_ns / 1e3, s.t1_ns / 1e3) for s in spans
                      if s.name == name)
        short, long_, sign = ((ranges, mine, -1) if len(ranges) <= len(mine)
                              else (mine, ranges, 1))
        if not short:
            continue
        runs = ([sign * (lt - st) for pair in zip(short, long_[k:])
                 for st, lt in zip(*pair)]
                for k in range(len(long_) - len(short) + 1))
        offsets += min(runs, key=lambda run: max(run) - min(run))
    return statistics.median(offsets) if offsets else None

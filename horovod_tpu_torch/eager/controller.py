"""The async controller: negotiation, the streamed plane and the executor.

Counterpart of ``horovod_tpu/eager/controller.py`` (parity surface:
``horovod/common/operations.cc`` ``BackgroundThreadLoop`` /
``RunLoopOnce`` / ``PerformOperation`` and the coordination of
``horovod/common/controller.cc`` ``ComputeResponseList``).  Ranks
enqueue async collectives in any order; their controllers agree on one
fused schedule and every rank executes it in the same order.

Division of labor, as in the reference:

- decisions (queueing, readiness, fusion, the response cache, burst
  units, schedule prediction) live in the negotiation core,
  ``horovod_tpu_torch.native``: the C++ core (``NativeController``), or
  ``PyController`` under ``HVTPU_FORCE_PY_CONTROLLER``;
- this module owns the threads, the transport of the wire-v5 blobs
  between ranks, and the executor that runs the agreed responses through
  ``comm/eager.py`` and resolves each op's ``OpFuture``.

Two control planes.  A world of one, or ``HVTPU_EAGER_STREAM=0``, takes
the lockstep plane: one cycle thread, every cycle every rank posts its
request blob and rank 0 answers (``LocalTransport`` at one rank,
``KVTransport.exchange`` otherwise).  A larger world takes the streamed
plane by default: a drainer posts this rank's request blobs when it has
work (rank 0 also ingests every rank's stream and appends the agreed
ResponseLists to a response stream), and a fetcher applies that stream
in order on every rank; idle ranks post nothing.  On the streamed plane
a steady burst whose schedule the replicated response cache determines
is predicted and executed at once, and confirmed after the fact
(``_try_predict``, ``HVTPU_EAGER_PREDICT``); a confirmation that does not
come forces a full negotiation (``_on_mispredict``).  Both planes ride
the ``torch.distributed`` store (``KVTransport``).

CUDA streams: ``enqueue`` records an event on the caller's current
stream; the executor runs on a stream of its own that waits on it before
it touches the tensor, and records a done event that ``OpFuture.result``
makes the caller's current stream wait on.  Each tensor that crosses
streams is marked with ``record_stream``.  The executor's collectives
run over the process sets' controller groups
(``eager.controller_execution``), never over a communicator the caller's
thread uses.

The fused path (``_execute_allreduce``) has two routes.  The staged one
reduces a group with one prescale, one postscale and one codec through
the optimizer's ``GroupReduction``, which runs kernel A1's grouped
passes (``ops/scale_cast.py``): one ``scale_cast_pack`` launch in place
of the per-tensor prescale, compress and pack, and one
``unpack_cast_scale`` launch in place of the per-tensor unpack,
decompress and postscale.  The zero-copy one (``HVTPU_FUSION_ZERO_COPY``)
serves a group whose grouping a steady schedule has shown: every op was
copied at enqueue into its slot of a pooled exchange buffer on the
device (``comm/packing.py``), the collective reduces that buffer in
place, and the futures resolve with lazy pieces whose first consumer
unpacks the whole group in one ``unpack_cast_scale`` launch, straight
into the tensors of the in-place ops.  It takes plain groups only (no
codec, prescale 1, one dtype of float32, bfloat16 or float16: the
dtypes A1 reads); everything else stays staged.

Stall inspection (parity: ``stall_inspector.cc``): rank 0 names every
op some rank announced that others have not, from the negotiation
core's message table (``check_stalls``), warns once per op
past ``stall_warn_s`` and fails the controller past ``stall_abort_s``;
the other ranks watch the age of their own pending ops.  The lockstep
plane inspects every 256 cycles, the streamed plane on a time cadence
(at most every 2 s, at half the tighter limit when it is shorter).  The
controller's threads call ``comm/stall.bypass_thread()``: their ops were
negotiated and are inspected here, so the sync watchdog skips them.
Faults and retry: an async op is the ``collective.pre`` fault site at
its enqueue (``core/faults.py``), the transport's store writes are the
``kv.put`` site under ``core/retry.py``'s KV policy, and its reads the
``kv.get`` site, polled again on a transient error.

Observability at the reference's sites: the ``hvtpu_controller_*``,
``hvtpu_negotiation_seconds``, ``hvtpu_collective_arrival_skew_seconds``
/ ``_last_arriver_total`` and ``hvtpu_fusion_*`` families; the
``controller`` /debug provider; the timeline's ``NEGOTIATE_<OP>`` span
of each op from enqueue until its response is applied (``hvd.start_timeline``
hands a live controller its new timeline) and ``CYCLE`` marks; the trace
phase chain NEGOTIATE → (PREDICT) → QUEUE → FUSE → EXEC → DONE with the
``mispredict``, ``predict_confirm``, ``arrival_skew`` and
``stall_warning`` instants; the anomaly plane's straggler feed; flight
notes of mispredicts, resyncs and stall aborts, and a postmortem on a
stall abort.

While a drain is pending (``core/preempt.py``) ``_try_predict`` makes no
new prediction and ``_gate_burst`` drains at once, as the reference's
gates do.

With an autotuner (``obs/autotune.py``, ``HVTPU_AUTOTUNE``), rank 0
scores each cycle's bytes and publishes the tuner's fusion threshold and
cycle time in its ResponseLists; every rank applies them from there, and
once tuning is in play ``_try_predict`` predicts nothing (a tuned
threshold could reach the ranks at different times).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import native
from ..comm import eager as eager_comm
from ..comm import packing as comm_packing
from ..comm.compression import NoneCompressor
from ..comm.eager import _is_int8
from ..comm.packing import pack_flat, unpack_flat
from ..comm import stall as sync_stall
from ..comm.reduce_ops import ReduceOp
from ..core import clock
from ..core import faults
from ..core import preempt
from ..core import retry as core_retry
from ..core import state as core_state
from ..core.exceptions import HorovodInternalError, HvtpuMismatchError
from ..native import wire
from ..obs import anomaly
from ..obs import flight
from ..obs import metrics as obs_metrics
from ..obs import tracing
from ..ops.scale_cast import casts_to_wire, unpack_cast_scale
from ..torch.optimizer import GroupReduction, apply_scale

logger = logging.getLogger("horovod_tpu_torch.eager")

# Controller telemetry (obs/metrics.py), the reference's families.
_M_CYCLES = obs_metrics.counter(
    "hvtpu_controller_cycles_total", "Coordination cycles run.")
_M_CYCLE_S = obs_metrics.histogram(
    "hvtpu_controller_cycle_seconds",
    "Coordination cycle duration (coalescing gate + drain + transport "
    "exchange; execution overlaps on the pipelined executor thread, "
    "inline only in manual/test mode).")
_M_QUEUE_DEPTH = obs_metrics.gauge(
    "hvtpu_controller_queue_depth",
    "Ops enqueued but not yet executed, sampled after each cycle.")
_M_NEGOTIATION_S = obs_metrics.histogram(
    "hvtpu_negotiation_seconds",
    "Enqueue-to-agreed-response latency through the controller.")
_M_CACHE_HITS = obs_metrics.counter(
    "hvtpu_controller_cache_hits_total",
    "Requests answered from the response cache (name+signature only "
    "on the wire).")
_M_CACHE_SIZE = obs_metrics.gauge(
    "hvtpu_controller_cache_size", "Live response-cache entries.")
_M_BYPASS = obs_metrics.counter(
    "hvtpu_controller_bypass_cycles_total",
    "Steady-state cycles negotiated via the compact cache-bit vector "
    "(no serialized requests on the wire).")
_M_RESYNC = obs_metrics.counter(
    "hvtpu_controller_resync_cycles_total",
    "Full-resync cycles (periodic cadence or coordinator-forced) that "
    "re-anchor the coordinator's message table on full entries.")
_M_PREDICTED = obs_metrics.counter(
    "hvtpu_controller_predicted_cycles_total",
    "Steady-state bypass cycles whose agreed schedule was predicted "
    "locally from the replicated response cache and executed without "
    "waiting for the coordinator round trip.")
_M_MISPREDICT = obs_metrics.counter(
    "hvtpu_controller_mispredicts_total",
    "Predicted schedules the coordinator did NOT confirm (the released "
    "schedule differed); every one forces immediate full negotiation "
    "and a cache-resync re-anchor — fail back to correct, never to "
    "fast.")
_M_MISMATCH = obs_metrics.counter(
    "hvtpu_controller_mismatch_errors_total",
    "Error responses for cross-rank tensor-metadata disagreement "
    "(mismatched type/red_op/dtype/shape/root for one tensor name), "
    "surfaced as HvtpuMismatchError on every member rank.")
_M_ARRIVAL_SKEW = obs_metrics.histogram(
    "hvtpu_collective_arrival_skew_seconds",
    "Per-collective spread between the first and last member rank's "
    "announcement reaching the coordinator (rank 0 only; straggler "
    "signal).",
    buckets=(0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))
_M_LAST_ARRIVER = obs_metrics.counter(
    "hvtpu_collective_last_arriver_total",
    "Times each rank was the LAST member to announce a collective "
    "(rank 0 only; labeled by the straggling rank).")
_M_FUSION_ZC = obs_metrics.counter(
    "hvtpu_fusion_zero_copy_ops_total",
    "Fused allreduce ops that rode the zero-copy fusion-buffer plane: "
    "payload bytes packed into the pooled exchange buffer at enqueue "
    "time (offsets fixed by the steady predicted schedule) and "
    "unpacked as lazy views — no drain-time staging copies.")
_M_FUSION_STAGED = obs_metrics.counter(
    "hvtpu_fusion_staged_copies_total",
    "Fused allreduce ops that took the drain-time staged-copy path "
    "(pack_flat concatenate + eager per-tensor unpack) because the "
    "drain was unpredicted, mispredicted, or the group was not "
    "prepack-eligible — fail back to correct, never to fast.")

#: Error-text marker the negotiation core emits for cross-rank metadata
#: disagreement; raised as the typed error instead of the generic one.
_MISMATCH_MARKER = "cross-rank tensor mismatch"

_RED_TO_WIRE = {
    ReduceOp.SUM: wire.RED_SUM,
    ReduceOp.AVERAGE: wire.RED_AVERAGE,
    ReduceOp.MIN: wire.RED_MIN,
    ReduceOp.MAX: wire.RED_MAX,
    ReduceOp.PRODUCT: wire.RED_PRODUCT,
    ReduceOp.ADASUM: wire.RED_ADASUM,
}
_WIRE_TO_RED = {v: k for k, v in _RED_TO_WIRE.items()}

_KIND_TO_TYPE = {
    "allreduce": wire.ALLREDUCE,
    "allgather": wire.ALLGATHER,
    "broadcast": wire.BROADCAST,
    "alltoall": wire.ALLTOALL,
    "reducescatter": wire.REDUCESCATTER,
    "barrier": wire.BARRIER,
}
_TYPE_TO_KIND = {v: k for k, v in _KIND_TO_TYPE.items()}

# one namespace of store keys a controller, so a controller made after a
# re-init never reads the keys an earlier one left behind; every rank
# makes its controllers in the same order
_GENERATION = itertools.count()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _tensors(value):
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


class _GroupUnpack:
    """The deferred unpack of one zero-copy fused group (the reference's
    deferred MemcpyOutFusionBuffer): the first consumer unpacks EVERY
    piece in one launch of kernel A1's ``unpack_cast_scale``, on its own
    stream after the collective's done event, into the in-place ops'
    tensors where they can take it and into new tensors elsewhere.  The
    group's postscale is folded into the launch when every piece shares
    it; otherwise the launch runs at scale 1 and each piece's postscale
    follows through ``fused_scale_cast``.  The exchange buffer goes back
    to the pool with an event after the launch, which every later write
    into it waits for."""

    __slots__ = ("_lock", "_red", "_specs", "_pack", "_pool", "_psid",
                 "_posts", "_outs", "_pieces", "_event")

    def __init__(self, red, specs, pack, pool, psid, posts, outs):
        self._lock = threading.Lock()
        self._red = red
        self._specs = specs
        self._pack = pack
        self._pool = pool
        self._psid = psid
        self._posts = posts
        self._outs = outs
        self._pieces = None
        self._event = None

    def piece(self, i: int, done):
        """Piece ``i`` and the event after which it is ready (None off
        the card); ``done`` is the collective's done event."""
        with self._lock:
            if self._pieces is None:
                self._unpack(done)
            return self._pieces[i], self._event

    def _unpack(self, done):
        red = self._red
        stream = None
        if red.is_cuda:
            stream = torch.cuda.current_stream(red.device)
            if done is not None:
                stream.wait_event(done)
            self._pack.buf.record_stream(stream)
        shared = all(s == self._posts[0] for s in self._posts)
        outs = [o if (o is not None and o.dtype == dtype
                      and tuple(o.shape) == shape and o.is_contiguous()
                      and o.device == red.device)
                else torch.empty(shape, dtype=dtype, device=red.device)
                for o, (shape, dtype, _n) in zip(self._outs, self._specs)]
        pieces = unpack_cast_scale(red, self._specs, [None] * len(outs),
                                   self._posts[0] if shared else 1.0, outs)
        if not shared:
            pieces = [apply_scale(t, s) if s != 1.0 else t
                      for t, s in zip(pieces, self._posts)]
        after = None
        if stream is not None:
            self._event = torch.cuda.Event()
            self._event.record(stream)
            after = [self._event]
        self._pool.release(self._psid, self._pack, after)
        self._pieces = pieces
        self._red = self._pack = self._outs = None


class _LazyPiece:
    """What a zero-copy fused op's future resolves with:
    :meth:`OpFuture.result` materializes (and caches) the real tensor on
    first access, so the group's unpack runs on the consumer's stream
    instead of the executor's."""

    __slots__ = ("_group", "_index")

    def __init__(self, group: _GroupUnpack, index: int):
        self._group = group
        self._index = index

    def materialize(self, done):
        return self._group.piece(self._index, done)


class OpFuture:
    """Completion future for one enqueued op (parity: the handle slots of
    horovod/torch/handle_manager.cc — done flag + result/exception).

    A result computed on the card carries the executor's done event:
    :meth:`result` makes the caller's current stream wait on it and
    marks the result's tensors as used on that stream."""

    def __init__(self, name: str):
        self.name = name
        self._event = threading.Event()
        self._result = None
        self._done_event = None
        self._error: Optional[BaseException] = None

    def set_result(self, value, done_event=None):
        self._result = value
        self._done_event = done_event
        self._event.set()

    def set_error(self, err: BaseException):
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"collective '{self.name}' did not complete in {timeout}s")
        if self._error is not None:
            raise self._error
        r = self._result
        if type(r) is _LazyPiece:
            r, self._done_event = r.materialize(self._done_event)
            self._result = r
        if self._done_event is not None:
            for t in _tensors(r):
                if t.is_cuda:
                    stream = torch.cuda.current_stream(t.device)
                    stream.wait_event(self._done_event)
                    t.record_stream(stream)
        return r


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------

class TransportClosed(Exception):
    """The transport was closed while a cycle was blocked on it — a
    clean shutdown signal, not a failure."""


class LocalTransport:
    """Single-process world: coordinator == the only member."""

    #: what ``EagerController.start`` consults to pick the plane
    supports_streaming = False

    def exchange(self, ctrl, cycle: int, request_blob: bytes) -> bytes:
        ctrl.ingest(request_blob)
        return ctrl.compute_responses()

    def close(self):
        pass


class KVTransport:
    """Coordination blobs over a ``torch.distributed`` store (replaces
    MPI_Gatherv/MPI_Bcast of mpi_controller.cc), under a ``PrefixStore``
    of ``client``: by default the default group's store, in a namespace
    of its own a controller; a store the caller passes (the tests' one
    ``HashStore`` for several in-process controllers) under
    ``hvt_eager``.

    The coordinator reads one key a rank (the reference's per-key path)
    and probes with the non-blocking ``check``: the ranks are known, so
    no directory listing is needed.  The stores do list their keys
    (``list_keys`` on ``HashStore``, ``TCPStore``, ``FileStore`` and
    ``PrefixStore``, in torch 2.11 on the card and 2.13 on the CPU; a
    ``PrefixStore`` lists them without its prefix); the transport does
    not use it.  A blocking get polls ``check`` with a backoff from 0.2 ms
    up to ``poll_s`` until its deadline: ``close()`` ends it at the next
    poll, and the store's client is never held inside a long ``wait`` (a
    ``FileStore`` waits a whole second whatever the timeout asked, and a
    ``TCPStore`` logs every ``wait`` that times out).  Deleted keys are
    the garbage collection of both planes; every one of those stores
    deletes, a ``FileStore`` included."""

    supports_streaming = True

    def __init__(self, rank: int, size: int, client=None,
                 timeout_s: float = 600.0, poll_s: float = 0.05):
        import torch.distributed as dist

        if client is None:
            client = dist.distributed_c10d._get_default_store()
            self.ns = f"hvt_eager/g{next(_GENERATION)}"
        else:
            self.ns = "hvt_eager"   # the caller's store: its namespace
        self._kv = dist.PrefixStore(self.ns, client)
        self.rank = rank
        self.size = size
        self.timeout_ms = int(timeout_s * 1000)
        self.poll_s = poll_s
        self._closed = threading.Event()
        # Transient store blips (and injected kv.put faults) retry with
        # backoff instead of killing the control thread
        # (core/retry.py); the retries count in hvtpu_kv_retries_total.
        self._put_policy = core_retry.kv_policy()

    def _set(self, key: str, blob: bytes):
        def _put():
            if faults.ACTIVE and faults.inject("kv.put", detail=key):
                return  # dropped writes stay dropped (peer times out)
            self._kv.set(key, blob)

        core_retry.call(
            self._put_policy, _put,
            on_retry=lambda a, e: obs_metrics.counter(
                "hvtpu_kv_retries_total").inc())

    def _get(self, key: str, deadline_s: Optional[float] = None) -> bytes:
        wait = self.timeout_ms / 1000.0 if deadline_s is None else deadline_s
        deadline = clock.monotonic() + wait
        sleep = 0.0
        while True:
            if self._closed.is_set():
                raise TransportClosed(key)
            try:
                # a dropped read is "not posted yet" this poll
                if (not (faults.ACTIVE
                         and faults.inject("kv.get", detail=key))
                        and self._kv.check([key])):
                    return bytes(self._kv.get(key))
            except Exception as e:
                # transient channel blips (injected UNAVAILABLE faults
                # included) poll again under the same deadline
                if not core_retry.kv_retryable(e):
                    raise
            if clock.monotonic() > deadline:
                raise TimeoutError(
                    f"coordination key {key!r} not posted within "
                    f"{wait:.0f}s")
            sleep = min(self.poll_s, sleep * 2 if sleep else 2e-4)
            clock.sleep(sleep)

    def _delete(self, key: str):
        try:
            self._kv.delete_key(key)
        except Exception:  # noqa: BLE001 — GC only, best effort
            pass

    def _gather_requests(self, ctrl, cycle: int):
        """Coordinator-side gather of every rank's request blob for this
        cycle, ingested in rank order (coordinator decisions must not
        depend on arrival order)."""
        prefix = f"c{cycle}/"
        for r in range(self.size):
            ctrl.ingest(self._get(f"{prefix}r{r}"))

    def exchange(self, ctrl, cycle: int, request_blob: bytes) -> bytes:
        req_key = f"c{cycle}/r{self.rank}"
        resp_key = f"c{cycle}/resp"
        self._set(req_key, request_blob)
        if self.rank == 0:
            self._gather_requests(ctrl, cycle)
            resp = ctrl.compute_responses()
            self._set(resp_key, resp)
            # GC the previous cycle's keys: every rank posting its
            # cycle-N blob proves it consumed cycle N-1's response
            if cycle > 0:
                for r in range(self.size):
                    self._delete(f"c{cycle - 1}/r{r}")
                self._delete(f"c{cycle - 1}/resp")
            return resp
        return self._get(resp_key)

    # ---- the streamed plane ------------------------------------------
    # Workers post request blobs to a per-rank stream whenever they
    # drain work, the coordinator ingests them at its own cadence and
    # appends agreed ResponseLists to a response stream, and every rank
    # applies that stream in order (which keeps response caches and
    # fusion state identical).  Idle ranks post nothing.

    def post_request(self, idx: int, blob: bytes):
        self._set(f"q/{self.rank}/{idx}", blob)

    def post_response(self, idx: int, blob: bytes):
        self._set(f"resp/{idx}", blob)

    def fetch_response(self, idx: int) -> Optional[bytes]:
        """Next ResponseList of the stream; polls for up to ``poll_s``
        and returns None when none came, so the caller can check its
        stop conditions.  TransportClosed on close()."""
        try:
            return self._get(f"resp/{idx}", deadline_s=self.poll_s)
        except TimeoutError:
            return None

    def post_ack(self, idx: int):
        """Advertise the highest applied response index (GC input)."""
        self._set(f"ack/{self.rank}", str(idx).encode())

    def poll_requests(self, next_idx: Dict[int, int]
                      ) -> List[Tuple[int, int, bytes]]:
        """Coordinator-side: the request blobs posted since the last poll,
        in (rank, stream index) order, each consumed (deleted).
        ``next_idx`` is every rank's read cursor, updated in place.  One
        non-blocking ``check`` a rank and blob: an idle poll waits on
        nothing."""
        out: List[Tuple[int, int, bytes]] = []
        if faults.ACTIVE and faults.inject("kv.get", detail="q/"):
            return out  # a dropped poll finds nothing this time
        for r in range(self.size):
            if r == self.rank:
                continue
            i = next_idx.get(r, 0)
            while True:
                key = f"q/{r}/{i}"
                if not self._kv.check([key]):
                    break
                out.append((r, i, bytes(self._kv.get(key))))
                self._delete(key)
                i += 1
            next_idx[r] = i
        return out

    def gc_responses(self, last_gc: int) -> int:
        """Delete the response-stream entries every other rank has
        acknowledged; returns the new GC floor.  The coordinator reads
        the ``size - 1`` ack keys one by one: their count is known."""
        acks = []
        for r in range(self.size):
            if r == self.rank:
                continue
            key = f"ack/{r}"
            if not self._kv.check([key]):
                return last_gc  # some rank has never acked yet
            try:
                acks.append(int(bytes(self._kv.get(key)).decode()))
            except (ValueError, UnicodeDecodeError):
                return last_gc
        if not acks:
            return last_gc
        floor = min(acks)
        for i in range(last_gc, floor):
            self._delete(f"resp/{i}")
        return max(last_gc, floor)

    def close(self):
        self._closed.set()


# --------------------------------------------------------------------------
# controller
# --------------------------------------------------------------------------

class _PackSlot:
    """One op's learned place in a fused group: pack the bytes of
    ``name`` at index ``index`` of the exchange buffer for ``gkey`` =
    (psid, agreed tensor-name order).  Learned by
    ``_maybe_learn_pack_plan`` from an executed fused group, consulted by
    ``_maybe_prepack`` on the enqueue path."""

    __slots__ = ("gkey", "index", "spec", "rop", "psid")

    def __init__(self, gkey, index, spec, rop, psid):
        self.gkey = gkey
        self.index = index
        self.spec = spec
        self.rop = rop
        self.psid = psid


class _Payload:
    __slots__ = ("seq", "name", "future", "tensor", "rop", "prescale",
                 "postscale", "compressor", "splits", "kind",
                 "process_set", "psid", "root_rank", "t_enqueue", "ready",
                 "prepacked", "out")

    def __init__(self, **kw):
        self.ready = None      # the caller's CUDA event at enqueue
        self.prepacked = None  # the gkey of the exchange buffer it is in
        self.out = None        # where an in-place op's result may land
        for k, v in kw.items():
            setattr(self, k, v)


class EagerController:
    """The control planes and the executor around the negotiation core.

    One instance per process; started lazily on first async enqueue
    (parity: InitializeHorovodOnce starting BackgroundThreadLoop).
    ``device`` is where zero contributions of a joined rank are made,
    where the exchange buffers live and, on the card, where the
    executor's stream lives.

    ``zero_copy_ops``, ``staged_copies``, ``mispredicts`` and
    ``predicted_bursts`` count this controller's share of what the
    ``hvtpu_fusion_*`` and ``hvtpu_controller_*`` families count
    process-wide (``debug_state`` reports them).  ``timeline``: the
    state's timeline (``hvd.start_timeline`` replaces it).
    ``autotuner``: the state's ``Autotuner``, scored by rank 0.
    """

    def __init__(self, rank: int, size: int, *,
                 cycle_time_ms: float = 1.0,
                 fusion_threshold: int = 64 << 20,
                 cache_capacity: int = 1024,
                 stall_warn_s: float = 60.0,
                 stall_abort_s: float = 0.0,
                 transport=None,
                 process_sets: Optional[Dict[int, List[int]]] = None,
                 device: Optional[torch.device] = None,
                 timeline=None,
                 autotuner=None,
                 manual: bool = False):
        self.rank, self.size = rank, size
        self._timeline = timeline
        self._autotuner = autotuner
        # manual=True: no background thread; tests drive run_cycle_once.
        self.manual = manual
        self.device = torch.device("cpu") if device is None else device
        self.cycle_time_s = cycle_time_ms / 1000.0
        self.stall_warn_s = stall_warn_s
        self.stall_abort_s = stall_abort_s
        self._ctrl = native.make_controller(
            rank, size, fusion_threshold, cache_capacity,
            stall_warn_s, stall_abort_s)
        # Local mirror of process-set membership so the executor can
        # skip responses scoped to sets this rank is not part of.
        self._ps_ranks: Dict[int, List[int]] = {0: list(range(size))}
        if process_sets:
            for psid, ranks in process_sets.items():
                self._ps_ranks[psid] = sorted(ranks)
                if psid != 0:
                    self._ctrl.register_process_set(psid, list(ranks))
        self._transport = transport or (
            LocalTransport() if size == 1 else KVTransport(rank, size))
        self._seq = itertools.count(1)
        self._noname: Dict[str, itertools.count] = {}
        self._group_ids = itertools.count(1)
        # Coalescing-gate state: enqueues not yet drained, and when the
        # most recent one landed (see _gate_burst).
        self._undrained = 0
        self._last_enqueue_t = 0.0
        # Steady-state burst tracking: once the same burst size repeats
        # (the per-step DistributedOptimizer pattern), the gate exits
        # the moment the expected count lands.
        self._expected_burst = 0
        self._burst_stable = 0
        self._burst_hint = 0
        # RLock: grouped_enqueue holds it across validate+declare+member
        # enqueues so no concurrent enqueue can slip a colliding name in.
        self._lock = threading.RLock()
        self._payloads: Dict[int, _Payload] = {}
        self._by_name: Dict[str, int] = {}
        self._join_futures: List[OpFuture] = []
        self._joined_local = False
        self._cycle = 0
        self._stall_logged: set = set()
        self._stop = threading.Event()
        # Wakes the cycle loop the moment work arrives.
        self._wake = threading.Event()
        # set when a ResponseList carries shutdown=True (every rank
        # announced) — the coordinated-quiesce signal
        self._shutdown_seen = threading.Event()
        self.shutdown_linger_s = 600.0
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[BaseException] = None
        # Pipelined data plane: agreed ResponseLists run on a FIFO
        # executor thread, so cycle N's execution overlaps cycle N+1's
        # drain/exchange; one ordered queue keeps the agreed order.
        self._exec_queue: Optional["queue.Queue"] = None
        self._exec_thread: Optional[threading.Thread] = None
        self._exec_stream = None
        # The streamed plane (see KVTransport's streamed section): a
        # drainer and a fetcher thread in place of the cycle loop.
        self._stream = False
        self._fetch_thread: Optional[threading.Thread] = None
        self._req_idx = 0
        self._next_resp = 0
        self._post_needed = False     # join/shutdown/resync announcements
        self._next_req_idx: Dict[int, int] = {}   # rank 0's read cursors
        self._resp_idx = 0            # rank 0's response stream head
        self._resp_gc = 0
        self._svc_dirty = False
        # the tuned pair rank 0 last posted: a change is not trivial
        self._last_tuned = (-1, -1)
        self._local_resp: "collections.deque" = collections.deque()
        self._local_resp_ev = threading.Event()
        # Schedule prediction (see _try_predict): names enqueued since
        # the last drain, names drained but not yet scheduled onto the
        # executor, and the FIFO of predicted-and-executed bursts
        # awaiting the coordinator's confirmation — each record
        # {"hash", "responses", "names"}: the FNV-1a 64 of the predicted
        # ResponseList blob (what a fully predicted burst confirms as),
        # the predicted Responses (what a partially predicted burst
        # streams back as), and the tensor names.
        self._cache_capacity = cache_capacity
        self._pending_buf: List[str] = []
        self._unsched: set = set()
        self._predicted: "collections.deque" = collections.deque()
        # Names whose predicted execution already resolved their futures
        # when a reset or mispredict abandoned the confirmation: late
        # real responses for them are bookkeeping, not corruption.
        self._mispredict_names: set = set()
        # bit-sets whose predicted schedule the real response stream has
        # verified once, and the FIFO of first occurrences awaiting that
        self._verified_bits: set = set()
        self._observe: "collections.deque" = collections.deque()
        # set once a ResponseList carried tuned values: prediction off
        self._tuned_seen = False
        # on unless "0" (the reference's "auto")
        self._predict_on = (
            os.environ.get("HVTPU_EAGER_PREDICT", "auto") != "0")
        # Atomic-burst drain cap: once the steady burst size is
        # established, drain exactly one burst per wire unit ("0"
        # restores uncapped drains).
        self._burst_cap_on = (
            os.environ.get("HVTPU_EAGER_BURST_CAP", "1") != "0")
        # The zero-copy plane: once a steady schedule has shown the
        # fused groupings, _maybe_learn_pack_plan records each op's slot
        # so enqueue packs its bytes straight into a pooled exchange
        # buffer ("0": no enqueue-time packing; the staged route is the
        # always-correct fallback).
        self._zero_copy_on = (
            os.environ.get("HVTPU_FUSION_ZERO_COPY", "1") != "0")
        self._fusion_pool = comm_packing.FusionBufferPool()
        # name -> _PackSlot learned from executed fused groups
        self._pack_plan: Optional[Dict[str, _PackSlot]] = None
        # gkey -> byte-spec list for pool acquisition
        self._pack_group_specs: Dict[tuple, list] = {}
        # gkey -> partially or fully filled ExchangeBuffer awaiting drain
        self._open_packs: Dict[tuple, comm_packing.ExchangeBuffer] = {}
        self.zero_copy_ops = 0
        self.staged_copies = 0
        self.mispredicts = 0
        self.predicted_bursts = 0
        # (name, skew_s, last_rank) of the latest released ops (rank 0)
        self._arrival_skew: "collections.deque" = collections.deque(
            maxlen=64)

    # ---- lifecycle ----
    def start(self):
        if self.manual:
            return
        with self._lock:
            if self._thread is not None:
                return
            self._stream = (
                self.size > 1
                and getattr(self._transport, "supports_streaming", False)
                and os.environ.get("HVTPU_EAGER_STREAM", "1") != "0")
            self._exec_queue = queue.Queue(maxsize=4)
            self._exec_thread = threading.Thread(
                target=self._exec_loop, name="hvt-eager-executor",
                daemon=True)
            self._exec_thread.start()
            if self._stream:
                self._fetch_thread = threading.Thread(
                    target=self._fetch_loop, name="hvt-eager-fetcher",
                    daemon=True)
                self._fetch_thread.start()
                self._thread = threading.Thread(
                    target=self._drain_loop, name="hvt-eager-controller",
                    daemon=True)
            else:
                self._thread = threading.Thread(
                    target=self._loop, name="hvt-eager-controller",
                    daemon=True)
            self._thread.start()
            obs_metrics.register_debug_provider(
                "controller", self.debug_state)

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Wait until this rank has no queued or in-flight ops; True when
        the controller went idle within ``timeout``.  A predicted burst
        still awaiting the coordinator's confirmation also blocks
        idleness; if the confirmation does not come within ``timeout``
        while everything else is idle, the predictor rolls back to full
        negotiation (the outstanding confirmations abandoned, a resync
        forced) and the quiesce succeeds.  Idle, it returns the open
        exchange buffers to the pool (the pack plan stays)."""
        deadline = clock.monotonic() + timeout
        while True:
            with self._lock:
                busy = bool(self._payloads) or self._undrained != 0
                unconfirmed = bool(self._predicted)
                if not busy and not unconfirmed:
                    self._release_open_packs()
            if not busy and not unconfirmed:
                return True
            if clock.monotonic() >= deadline:
                rolled_back = 0
                with self._lock:
                    if (not self._payloads and self._undrained == 0
                            and self._predicted):
                        rolled_back = len(self._predicted)
                        self._reset_predict_state()
                        self._ctrl.force_resync()
                        self._post_needed = True
                if rolled_back:
                    logger.warning(
                        "quiesce: %d predicted burst(s) unconfirmed at "
                        "deadline; rolled back to full negotiation",
                        rolled_back)
                    self._wake.set()
                    return True
                return False
            self._wake.set()
            clock.sleep(0.01)

    def request_shutdown(self):
        """Announce this rank's shutdown WITHOUT stopping the threads
        (the non-blocking half of the coordinated shutdown: several
        controllers of one process call this on all of them before
        ``stop()`` so none lingers)."""
        self._ctrl.set_shutdown()
        # the streamed plane posts nothing while idle: the announcement
        # rides an otherwise empty request blob
        self._post_needed = True
        self._wake.set()

    def stop(self):
        # Coordinated shutdown (parity: horovod_shutdown negotiating
        # DONE via the controller): announce, then KEEP SERVING peers'
        # coordination until every rank announced.
        if (self.size > 1 and not self.manual
                and self._thread is not None and self._thread.is_alive()
                and self._thread_error is None):
            self._ctrl.set_shutdown()
            self._post_needed = True
            self._wake.set()
            # the streamed fetcher polls patiently forever: bound the
            # linger by the transport's budget, as the lockstep plane's
            # blocking get is
            linger = self.shutdown_linger_s
            t_ms = getattr(self._transport, "timeout_ms", None)
            if t_ms:
                linger = min(linger, t_ms / 1000.0)
            deadline = clock.monotonic() + linger
            while clock.monotonic() < deadline:
                if self._shutdown_seen.wait(timeout=0.1):
                    break
                if (self._thread is None or not self._thread.is_alive()
                        or self._thread_error is not None):
                    break
        self._stop.set()
        self._wake.set()
        obs_metrics.unregister_debug_provider("controller")
        # Close the transport so a thread blocked in a store get
        # unblocks promptly (TransportClosed).
        self._transport.close()
        thread_exited = True
        for attr in ("_thread", "_fetch_thread"):
            t = getattr(self, attr)
            if t is not None:
                self._local_resp_ev.set()
                t.join(timeout=30)
                thread_exited = thread_exited and not t.is_alive()
                setattr(self, attr, None)
        # Drain the executor AFTER the other threads stopped producing:
        # queued responses still execute (their futures resolve), then
        # the sentinel ends the thread.
        if self._exec_thread is not None:
            try:
                self._exec_queue.put_nowait(None)
            except queue.Full:
                pass  # executor is stuck mid-dispatch; join times out
            self._exec_thread.join(timeout=30)
            thread_exited = thread_exited and not self._exec_thread.is_alive()
            self._exec_thread = None
        # Fail anything still outstanding, like the reference's shutdown
        # path completing callbacks with an aborted status.
        with self._lock:
            payloads = list(self._payloads.values())
            self._payloads.clear()
            self._by_name.clear()
            joins, self._join_futures = self._join_futures, []
        for p in payloads:
            p.future.set_error(HorovodInternalError(
                "controller shut down with pending ops"))
        for f in joins:
            f.set_error(HorovodInternalError(
                "controller shut down with pending ops"))
        if thread_exited:
            self._ctrl.close()
        else:
            # A thread may still be blocked in a transport call holding
            # a reference to the core; leaking the native handle beats a
            # use-after-free when the call finally returns.
            logger.warning("controller threads did not exit within 30s; "
                           "leaking the negotiation core's handle")

    # ---- enqueue API ----
    def _auto_name(self, kind: str) -> str:
        # Parity: mpi_ops.py's "allreduce.noname.<n>" counters — one
        # counter PER KIND so unnamed ops of different kinds pair up
        # across ranks by per-kind issuance count.
        ctr = self._noname.setdefault(kind, itertools.count(0))
        return f"{kind}.noname.{next(ctr)}"

    def _psid(self, process_set) -> int:
        if process_set is None:
            return 0
        return (process_set if isinstance(process_set, int)
                else process_set.process_set_id)

    def enqueue(self, kind: str, tensor: torch.Tensor, *,
                name: Optional[str] = None,
                op: ReduceOp = ReduceOp.SUM, process_set=None,
                prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                compression=NoneCompressor, root_rank: int = -1,
                splits=None, group_id: int = -1,
                out: Optional[torch.Tensor] = None) -> OpFuture:
        """Queue one collective; ``compression`` is an engine codec.  A
        rank outside ``process_set`` raises the reference's error here
        (the sync ops raise it too): it would never be answered.
        ``out``: a tensor the result may be written into (the in-place
        ops pass their own tensor; only the zero-copy route's unpack
        takes it)."""
        if self._thread_error is not None:
            raise HorovodInternalError(
                f"controller thread died: {self._thread_error!r}")
        psid = self._psid(process_set)
        members = self._ps_ranks.get(psid)
        if members is not None and self.rank not in members:
            raise RuntimeError(
                "calling process is not a member of this process set")
        x = tensor.detach()
        if faults.ACTIVE:
            # the ``collective.pre`` site fires HERE for async ops, at
            # the issuance boundary; the executor's dispatch skips it
            # (comm/eager.controller_execution)
            x = faults.inject_tensor("collective.pre", x, pset=psid,
                                     detail=kind)
        name = name or self._auto_name(kind)
        op_type = _KIND_TO_TYPE[kind]
        # The wire dtype — what the collective actually moves — is the
        # fusion/caching signature (fusion_buffer_manager.cc keys fusion
        # on the buffer dtype).
        wire_name = _dtype_name(compression.wire_dtype(x.dtype))
        dtype_id = wire.DTYPE_IDS.get(
            wire_name, wire.DTYPE_IDS.get(_dtype_name(x.dtype), 6))
        fut = OpFuture(name)
        payload = _Payload(
            seq=None, name=name, future=fut, tensor=x,
            rop=op, prescale=prescale_factor, postscale=postscale_factor,
            compressor=compression, splits=splits, kind=kind,
            process_set=process_set, psid=psid, root_rank=root_rank,
            t_enqueue=clock.monotonic(),
            out=None if out is None else out.detach(),
        )
        with self._lock:
            seq = next(self._seq)
            payload.seq = seq
            ok = self._ctrl.enqueue(
                seq, name, op_type, _RED_TO_WIRE[op], dtype_id,
                tuple(int(d) for d in x.shape), psid, group_id, root_rank,
            )
            if not ok:
                fut.set_error(HorovodInternalError(
                    f"duplicate tensor name in queue: {name!r} "
                    "(parity: TensorQueue DUPLICATE_NAME_ERROR)"))
                return fut
            self._payloads[seq] = payload
            self._by_name[name] = seq
            self._undrained += 1
            self._pending_buf.append(name)
            self._last_enqueue_t = clock.monotonic()
            # the zero-copy plane: when a learned pack plan covers this
            # op, its bytes go into the pooled exchange buffer now
            self._maybe_prepack(payload)
            if x.is_cuda:
                # after the pack's copy, and before any drain can hand
                # the payload to the executor, which waits on it
                payload.ready = torch.cuda.Event()
                payload.ready.record(torch.cuda.current_stream(x.device))
            if self._timeline is not None:
                # parity: timeline.cc NEGOTIATE_<OP> span from enqueue
                # until the agreed response arrives; inside the lock, or
                # the cycle thread could end() before begin()
                self._timeline.begin(name, f"NEGOTIATE_{kind.upper()}")
            if tracing.ACTIVE:
                tracing.op_begin(name, kind)
        self._wake.set()
        self.start()
        return fut

    def grouped_enqueue(self, kind: str, tensors, names=None, **kw
                        ) -> List[OpFuture]:
        """Enqueue a set that must execute together (parity:
        hvd.grouped_allreduce via group_table.cc).

        Names are validated up front: a duplicate (within the group or
        against a pending op) fails the WHOLE group immediately, since a
        partially-enqueued group could never reach its declared quorum.
        """
        eff_names = [
            (names[i] if names else None) or self._auto_name(kind)
            for i in range(len(tensors))
        ]
        with self._lock:
            dup = None
            seen = set()
            for n in eff_names:
                if n in seen or n in self._by_name:
                    dup = n
                    break
                seen.add(n)
            if dup is not None:
                futs = []
                for n in eff_names:
                    f = OpFuture(n)
                    f.set_error(HorovodInternalError(
                        f"duplicate tensor name in group: {dup!r} "
                        "(parity: TensorQueue DUPLICATE_NAME_ERROR)"))
                    futs.append(f)
                return futs
            gid = next(self._group_ids)
            self._ctrl.declare_group(gid, len(tensors))
            return [self.enqueue(kind, t, name=n, group_id=gid, **kw)
                    for t, n in zip(tensors, eff_names)]

    def register_process_set(self, psid: int, ranks: List[int]):
        """Mirror a newly-added process set into the negotiation core
        (parity: ProcessSetTable additions reaching the controller)."""
        self._ps_ranks[psid] = sorted(ranks)
        self._ctrl.register_process_set(psid, list(ranks))

    def join(self) -> OpFuture:
        """Parity: hvd.join / EnqueueJoin — resolves with the last rank
        to join once every rank has.  While joined, this rank keeps
        cycling and contributes ZEROS to collectives the remaining ranks
        run (JoinOp semantics)."""
        fut = OpFuture("join")
        with self._lock:
            self._join_futures.append(fut)
            self._joined_local = True
        self._ctrl.set_joined()
        # the join announcement must go out even with an empty queue
        self._post_needed = True
        self._wake.set()
        self.start()
        return fut

    # ---- the lockstep plane ----
    def _loop(self):
        # Parity: BackgroundThreadLoop — run RunLoopOnce every
        # cycle_time, stretching the cadence up to 4x while idle (each
        # cycle at P>1 is a store round trip on every rank); a local
        # enqueue snaps the loop awake via _wake.  This thread executes
        # an already negotiated, stall-inspected schedule: exempt from
        # the sync watchdog (comm/stall.py).
        sync_stall.bypass_thread()
        # run_cycle_once inspects stalls every 256 cycles; a cycle is a
        # store round trip whose time grows with the host's load, so the
        # loop also inspects on the streamed plane's time cadence, and a
        # stall warns and aborts near its configured time on a slow store
        stall_every = self._stall_cadence()
        next_stall = clock.monotonic() + stall_every
        idle_cycles = 0
        while not self._stop.is_set():
            t0 = clock.monotonic()
            try:
                active = self.run_cycle_once()
                if clock.monotonic() >= next_stall:
                    next_stall = clock.monotonic() + stall_every
                    self._inspect_stalls()
            except TransportClosed:
                break
            except BaseException as e:  # noqa: BLE001 — must fail futures
                self._fail_all(e, "eager controller cycle failed")
                return
            if self._shutdown_seen.is_set():
                return  # every rank announced shutdown: global quiesce
            idle_cycles = 0 if active else min(idle_cycles + 1, 3)
            if active:
                sleep = self.cycle_time_s - (clock.monotonic() - t0)
            else:
                # a floor, not a target minus elapsed: a slow exchange
                # must not turn idle cycles into a spin
                sleep = self.cycle_time_s * (1 + idle_cycles)
            if sleep > 0:
                self._wake.wait(sleep)
            self._wake.clear()

    def _exec_loop(self):
        """Pipelined execution: dequeue agreed ResponseLists in order
        and run them; errors fail every pending future and stop the
        controller, as the other threads' do."""
        sync_stall.bypass_thread()
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            item = self._exec_queue.get()
            if item is None:
                return
            try:
                self._execute(item)
            except BaseException as e:  # noqa: BLE001 — must fail futures
                self._fail_all(e, "eager executor failed")
                return

    def _fail_all(self, e: BaseException, what: str):
        """Control-plane death: record the error, fail every pending
        future, forget what the predictor learned, and unwedge the other
        threads."""
        self._thread_error = e
        logger.exception(what)
        with self._lock:
            payloads = list(self._payloads.values())
            self._payloads.clear()
            self._by_name.clear()
            self._pending_buf = []
            self._unsched.clear()
            self._predicted.clear()
            self._observe.clear()
            self._verified_bits.clear()
            self._mispredict_names.clear()
            self._release_open_packs()
            self._pack_plan = None
            self._pack_group_specs.clear()
        for p in payloads:
            p.future.set_error(HorovodInternalError(str(e)))
        self._stop.set()
        self._wake.set()
        self._local_resp_ev.set()

    # ---- prediction state and the zero-copy plane ----
    def _reset_predict_state(self):
        """Forget everything the schedule predictor learned (callers
        hold ``_lock``): on membership change, error responses, a
        coordinator-forced resync, a mispredict and a quiesce rollback.
        Resets the burst gate's steady size itself, not just its
        stability.  Outstanding predicted bursts are abandoned; their
        names move to the tolerate set so late real responses for them
        do not read as protocol corruption.  The pack plan was learned
        from the schedule being forgotten: it goes too, and the open
        exchange buffers go back to the pool (already packed payloads
        then miss their pack at drain and take the staged route)."""
        self._expected_burst = 0
        self._burst_stable = 0
        self._verified_bits.clear()
        self._observe.clear()
        for rec in self._predicted:
            self._mispredict_names.update(rec["names"])
        self._predicted.clear()
        self._release_open_packs()
        self._pack_plan = None
        self._pack_group_specs.clear()

    def _release_open_packs(self):
        """Return every open (partially filled) exchange buffer to the
        pool (callers hold ``_lock``)."""
        for (psid, _names), xb in self._open_packs.items():
            self._fusion_pool.release(psid, xb)
        self._open_packs.clear()

    def _maybe_prepack(self, p: _Payload):
        """Enqueue-time MemcpyInFusionBuffer (callers hold ``_lock``):
        when the learned pack plan has a slot for this op, copy its bytes
        into the group's pooled exchange buffer.  Every check that fails
        is a silent no-op: the staged route stays the source of truth.
        Without a plan (the non-steady state) the first line is the whole
        cost."""
        plan = self._pack_plan
        if plan is None:
            return
        slot = plan.get(p.name)
        if slot is None:
            return
        if (p.kind != "allreduce" or p.compressor is not NoneCompressor
                or p.prescale != 1.0 or p.rop != slot.rop
                or p.psid != slot.psid):
            return
        pack = self._open_packs.get(slot.gkey)
        if pack is None:
            specs = self._pack_group_specs.get(slot.gkey)
            if specs is None:
                return
            pack = self._fusion_pool.acquire(slot.psid, specs, self.device)
            self._open_packs[slot.gkey] = pack
        if pack.write(slot.index, p.tensor):
            p.prepacked = slot.gkey

    def _maybe_learn_pack_plan(self, rs: wire.Response,
                               payloads: List[_Payload]):
        """Record the fused grouping an executed staged group proves, so
        the NEXT burst's enqueues can pack at enqueue time.  Only steady
        schedules qualify (``_burst_stable``, the bar ``_try_predict``
        uses too) and only plain groups: no codec, no prescale, one dtype
        A1's unpack reads, on the controller's device."""
        if not self._zero_copy_on or self._burst_stable < 2:
            return
        t0 = payloads[0].tensor
        if not casts_to_wire(NoneCompressor, t0.dtype) or any(
                p.compressor is not NoneCompressor or p.prescale != 1.0
                or p.seq == -1 or p.tensor.dtype != t0.dtype
                or p.tensor.device != self.device for p in payloads):
            return
        psid = payloads[0].psid
        gkey = (psid, tuple(rs.tensor_names))
        specs = [(tuple(p.tensor.shape), p.tensor.dtype,
                  p.tensor.numel() * p.tensor.element_size())
                 for p in payloads]
        with self._lock:
            if self._pack_plan is None:
                self._pack_plan = {}
            for i, p in enumerate(payloads):
                self._pack_plan[p.name] = _PackSlot(
                    gkey=gkey, index=i, spec=specs[i], rop=p.rop,
                    psid=psid)
            self._pack_group_specs[gkey] = specs

    def _on_mispredict(self, why: str):
        """A predicted-and-executed schedule the coordinator did NOT
        confirm (callers hold ``_lock``): fail back to correct, never to
        fast.  Forces the next drain to be a full-entry resync and
        resets the predictor, so the pattern must verify again from
        scratch."""
        self.mispredicts += 1
        _M_MISPREDICT.inc()
        logger.error(
            "schedule mispredict (%s): forcing full negotiation + "
            "cache-resync re-anchor", why)
        if tracing.ACTIVE:
            tracing.instant("mispredict", why=why)
        if flight.ACTIVE:
            flight.note("mispredict", why=why)
        self._reset_predict_state()
        self._ctrl.force_resync()
        self._post_needed = True
        self._wake.set()

    # ---- the streamed plane ----
    # Three threads instead of one lockstep cycle: the DRAINER gates and
    # posts this rank's request blobs (and, on rank 0, ingests every
    # rank's stream and appends agreed ResponseLists to the response
    # stream); the FETCHER applies the response stream in order (the
    # same order on every rank keeps caches and fusion state identical)
    # and hands executions to the EXECUTOR.  No step is an all-rank
    # barrier.

    def _stall_cadence(self) -> float:
        """Seconds between time-based stall inspections: half the
        tighter of the warn and abort limits, within [0.05, 2]."""
        limits = [s for s in (self.stall_warn_s, self.stall_abort_s)
                  if s and s > 0 and s != float("inf")]
        return min([2.0] + [max(0.05, s / 2) for s in limits])

    def _drain_loop(self):
        sync_stall.bypass_thread()
        # stall inspection is time-based here; tight stall configs
        # tighten the cadence
        stall_every = self._stall_cadence()
        next_stall = clock.monotonic() + stall_every
        idle = 0
        while not self._stop.is_set():
            active = False
            try:
                if self._undrained or self._post_needed:
                    active = self._drain_once()
                if self.rank == 0:
                    active = self._service_once() or active
                if clock.monotonic() >= next_stall:
                    next_stall = clock.monotonic() + stall_every
                    self._inspect_stalls()
            except TransportClosed:
                break
            except BaseException as e:  # noqa: BLE001 — must fail futures
                self._fail_all(e, "eager controller drain loop failed")
                return
            if self._shutdown_seen.is_set():
                return
            idle = 0 if active else min(idle + 1, 6)
            if not active:
                # rank 0 keeps a polling cadence (remote ranks' blobs
                # arrive unannounced); workers park on _wake, their
                # responses arrive through the fetcher
                cap = (self.cycle_time_s * (1 + idle) if self.rank == 0
                       else 0.25)
                self._wake.wait(min(cap, stall_every))
                self._wake.clear()

    def _drain_once(self) -> bool:
        """Gate, drain and post ONE request blob (rank 0 ingests its own
        blob directly); in steady state the agreed schedule is predicted
        and executed before the blob leaves this host, and the blob goes
        out flagged as a confirmation."""
        t0 = clock.monotonic()
        self._gate_burst()
        # Atomic-burst drain cap: with an established steady burst,
        # drain exactly one burst per wire unit — enqueues of the NEXT
        # step that raced in during the gate stay for their own unit.
        limit = (self._expected_burst
                 if self._burst_cap_on and self._burst_stable >= 2
                 else 0)
        with self._lock:
            drained = self._undrained
            post_needed = self._post_needed
            if drained == 0 and not post_needed:
                return False
            take = min(drained, limit) if limit else drained
            self._undrained -= take
            self._post_needed = False
            names = self._pending_buf[:take]
            del self._pending_buf[:take]
            req = self._ctrl.drain_requests(limit)
        self._cycle += 1
        parsed = None
        if take:
            parsed = self._note_drained(take, req)
        if parsed is not None and self._try_predict(parsed, names):
            # executed locally already: the blob becomes a post-hoc
            # confirmation, which the coordinator matches against its
            # own release and answers with a confirm hash
            req = wire.mark_predicted(req)
            names = []
        if names:
            with self._lock:
                self._unsched.update(names)
        if self.rank == 0:
            self._ctrl.ingest(req)
            self._svc_dirty = True
        else:
            self._transport.post_request(self._req_idx, req)
            self._req_idx += 1
        if take < drained:
            self._wake.set()  # the capped remainder drains next pass
        _M_CYCLES.inc()
        _M_CYCLE_S.observe(clock.monotonic() - t0)
        return True

    def _try_predict(self, parsed: wire.RequestList,
                     names: List[str]) -> bool:
        """Steady-state fast path: a pure bypass drain whose agreed
        ResponseList is a function of state replicated on every rank —
        the response cache and the fusion threshold — executes NOW; the
        real response is verified and skipped when it streams in.  The
        gates (the reference's):

        - a bypass blob only (all cache hits, no join/shutdown flags);
        - no autotuner and no tuned value ever applied (a tuned
          threshold could reach ranks at different times and change
          the fusion split);
        - the burst size steady for >= 2 drains;
        - the cache below capacity (no eviction ever, so bit ids cannot
          have been reused while this rank's stream lags);
        - every predicted response an additive allreduce (Sum/Average,
          not int8), so joins we have not seen yet cannot change it;
        - nothing drained earlier still awaiting its response;
        - and this bit-set's exact schedule verified against the real
          response stream once before (a first occurrence is observed,
          not predicted).

        A peer that deviates from a pattern it just established without
        a cache miss is the only way to mispredict, and the
        coordinator's refusal to confirm then forces a full negotiation
        and a resync (``_apply_response_blob``)."""
        if not (self._stream and self._predict_on
                and parsed.cache_bypass):
            return False
        if preempt.pending():
            # A coordinated drain is in flight: no NEW speculation —
            # everything from here to the emergency commit runs fully
            # negotiated (quiesce handles predictions already made).
            return False
        if self._autotuner is not None or self._tuned_seen:
            return False
        if self._burst_stable < 2:
            return False
        if self._ctrl.cache_size >= self._cache_capacity:
            return False
        bits = wire.words_to_bits(parsed.cache_bits)
        blob = self._ctrl.predict_responses(bits)
        if blob is None:
            return False
        rl = wire.parse_response_list(blob)
        int8 = wire.DTYPE_IDS["int8"]
        for rs in rl.responses:
            if (rs.type != wire.ALLREDUCE
                    or rs.red_op not in (wire.RED_SUM, wire.RED_AVERAGE)
                    or rs.dtype == int8 or rs.error):
                return False
        got = [n for rs in rl.responses for n in rs.tensor_names]
        if sorted(got) != sorted(names):
            logger.debug("predict abort: schedule covers %r, drain holds "
                         "%r", sorted(got), sorted(names))
            return False
        key = frozenset(bits)
        with self._lock:
            if self._unsched:
                return False
            if key not in self._verified_bits:
                # first occurrence: observe the real stream instead
                # (bounded FIFO: stale observations age out)
                self._observe.append([key, list(rl.responses), 0])
                while len(self._observe) > 8:
                    self._observe.popleft()
                return False
            self._predicted.append({
                "hash": wire.fnv1a64(blob),
                "responses": list(rl.responses),
                "names": list(got),
            })
        if tracing.ACTIVE:
            for n in got:
                tracing.op_phase(n, tracing.PREDICT)
        # retire in-flight NOW: the futures resolve on execution, and the
        # next step re-enqueues the same names before the real response
        # streams in
        self._ctrl.finish(got)
        self._dispatch_execution(rl)
        self.predicted_bursts += 1
        _M_PREDICTED.inc()
        return True

    def _drain_arrival_skew(self):
        """Coordinator only: feed the per-op arrival spreads the core
        recorded into the straggler metrics, an ``arrival_skew`` trace
        instant and the anomaly plane (which names the offending rank);
        the latest 64 stay for ``debug_state``.  The C++ core does not
        record them (as in the reference): getattr-guarded, the metrics
        stay 0."""
        if self.rank != 0:
            return
        take = getattr(self._ctrl, "take_arrival_skew", None)
        if take is None:
            return
        for name, skew, last in take():
            self._arrival_skew.append((name, skew, last))
            _M_ARRIVAL_SKEW.observe(skew)
            _M_LAST_ARRIVER.inc(rank=str(last))
            if tracing.ACTIVE:
                tracing.instant("arrival_skew", tensor=name,
                                skew_s=skew, last_rank=last)
            if anomaly.ACTIVE:
                anomaly.on_arrival_skew(name, skew, last)

    def _service_once(self) -> bool:
        """Rank 0's coordination service: ingest newly streamed request
        blobs, compute responses, append non-trivial ResponseLists to
        the response stream (and feed our own fetcher in-process)."""
        got = self._transport.poll_requests(self._next_req_idx)
        for _r, _i, blob in got:
            self._ctrl.ingest(blob)
        if not got and not self._svc_dirty:
            return False
        self._svc_dirty = False
        resp = self._ctrl.compute_responses()
        self._drain_arrival_skew()
        rl = wire.parse_response_list(resp)
        tuned = (rl.tuned_fusion_threshold, rl.tuned_cycle_time_us)
        # confirm hashes are not trivial: every predictor's FIFO waits
        # on them
        trivial = (not rl.responses and not rl.confirm_hashes
                   and rl.join_last_rank < 0
                   and not rl.shutdown and not rl.cache_resync_needed
                   and tuned == self._last_tuned)
        if not trivial:
            self._last_tuned = tuned
            self._transport.post_response(self._resp_idx, resp)
            self._resp_idx += 1
            self._local_resp.append(resp)
            self._local_resp_ev.set()
            if self._resp_idx % 64 == 0:
                self._resp_gc = self._transport.gc_responses(self._resp_gc)
            # a compute releases only the front occurrence of each key: a
            # later burst already complete in the table (rank 0 drained
            # it before the earlier one released) waits for the next
            # compute, so compute again until one releases nothing.  The
            # reference computes only on new blobs, so such a burst waits
            # for the next one's enqueue.
            self._svc_dirty = True
        return bool(got) or not trivial

    def _fetch_loop(self):
        """Apply the response stream in order."""
        sync_stall.bypass_thread()
        while not self._stop.is_set():
            try:
                if not self._fetch_once():
                    continue
            except TransportClosed:
                break
            except BaseException as e:  # noqa: BLE001 — must fail futures
                self._fail_all(e, "eager controller fetch loop failed")
                return
            if self._shutdown_seen.is_set():
                return

    def _fetch_once(self, wait_s: float = 0.25) -> bool:
        """Take the next response blob (rank 0 from its in-process feed,
        other ranks from the store's response stream) and apply it; True
        when one was applied, False when none came within ``wait_s``."""
        if self.rank == 0:
            if not self._local_resp:
                self._local_resp_ev.wait(wait_s)
                self._local_resp_ev.clear()
                if not self._local_resp:
                    return False
            blob = self._local_resp.popleft()
        else:
            blob = self._transport.fetch_response(self._next_resp)
            if blob is None:
                return False
        self._apply_response_blob(blob)
        return True

    def _apply_response_blob(self, blob: bytes) -> None:
        self._ctrl.apply_responses(blob)
        rl = wire.parse_response_list(blob)
        if rl.cache_resync_needed:
            # re-announce in-flight ops next drain
            self._post_needed = True
            self._wake.set()
        with self._lock:
            # Confirmations first: the coordinator emits burst components
            # in every rank's drain order, so each hash must retire the
            # OLDEST outstanding prediction.  A hash matching nothing
            # belongs to a component this rank is not a member of (or is
            # stale after a reset): ignored; one matching a LATER record
            # means the head burst was released differently: mispredict.
            for h in rl.confirm_hashes:
                if self._predicted and h == self._predicted[0]["hash"]:
                    rec = self._predicted.popleft()
                    if tracing.ACTIVE:
                        # the predicted burst's PREDICT spans were real
                        tracing.instant("predict_confirm", how="hash",
                                        names=list(rec["names"]))
                elif any(h == rec["hash"] for rec in self._predicted):
                    self._on_mispredict(
                        "confirmation skipped the oldest outstanding "
                        f"prediction (hash {h:#018x} matched a later "
                        "burst)")
            # verify-and-skip responses already executed from a
            # predicted schedule (the response stream and the
            # predictions are both in drain order); every other response
            # marks its tensors as scheduled
            keep = []
            for rs in rl.responses:
                rec = self._predicted[0] if self._predicted else None
                if (rec is not None and rec["responses"]
                        and rs == rec["responses"][0]):
                    # a partially predicted burst (some member observed
                    # instead) streams real responses: byte-verified
                    # against the prediction, not executed again
                    rec["responses"].pop(0)
                    if not rec["responses"]:
                        self._predicted.popleft()
                        if tracing.ACTIVE:
                            tracing.instant("predict_confirm",
                                            how="byte-verify",
                                            names=list(rec["names"]))
                    continue
                if rec is not None and set(
                        rs.tensor_names) & set(rec["names"]):
                    # shares tensors with the oldest predicted burst but
                    # differs from its schedule
                    self._on_mispredict(
                        "released schedule diverged from the predicted "
                        f"one for {rs.tensor_names}")
                for n in rs.tensor_names:
                    self._unsched.discard(n)
                if self._observe:
                    # first-occurrence verification: the real stream
                    # must emit EXACTLY the predicted schedule before a
                    # bit-set may predict
                    ob = self._observe[0]
                    if rs in ob[1]:
                        ob[2] += 1
                        if ob[2] == len(ob[1]):
                            self._verified_bits.add(ob[0])
                            self._observe.popleft()
                    else:
                        ob_names = {n for pr in ob[1]
                                    for n in pr.tensor_names}
                        if ob_names.intersection(rs.tensor_names):
                            # shares tensors but differs: never verify
                            self._observe.popleft()
                keep.append(rs)
            rl.responses = keep
        self._dispatch_execution(rl)
        self._next_resp += 1
        if self.rank != 0 and self._next_resp % 64 == 0:
            try:
                self._transport.post_ack(self._next_resp - 1)
            except RuntimeError:
                pass  # GC input only: a lost ack delays the next GC pass

    # ---- shared negotiation plumbing ----
    def hint_burst(self, n: int):
        """Frontend burst declaration: the enqueue burst now streaming in
        will contain ``n`` ops, so the gate holds the drain for the
        whole burst instead of guessing its boundary from quiet gaps.
        Purely a latency gate: a wrong hint costs at most the gate
        deadline.  Consumed by the next drain that covers it."""
        with self._lock:
            self._burst_hint = max(0, int(n))

    def _gate_burst(self):
        """Fusion-coalescing gate (the reference gets this from
        cycle_time batching): while a burst of enqueues is still
        streaming in, wait for a quiet gap of one cycle before draining,
        so the whole burst negotiates as one fusion group.  With a
        stable burst size (repeated for >= 2 drains) or a hint, wait
        for the expected count instead; the deadline bounds the added
        latency of a genuinely continuous stream."""
        quiesce = self.cycle_time_s
        span = 8 * self.cycle_time_s
        if self._stream:
            # the lockstep plane's exchange paces the drain for free; the
            # streamed drainer would split a burst whose enqueues come
            # slower than one cycle: widen the quiet gap and the deadline
            quiesce = max(quiesce, 0.004)
            span = max(span, 0.024)
        with self._lock:
            hint = self._burst_hint
        expected = (self._expected_burst
                    if self._burst_stable >= 2 else hint)
        deadline = clock.monotonic() + (
            max(span, 0.25) if hint and expected
            else max(span, 0.05) if expected
            else span)
        while True:
            with self._lock:
                undrained = self._undrained
                last_t = self._last_enqueue_t
            now = clock.monotonic()
            # A pending drain (core/preempt.py) must not wait out the
            # burst gate: drain whatever is queued NOW so in-flight
            # collectives finish before the drain commit's grace
            # window burns down.
            if expected > 0:
                if (undrained == 0 or undrained >= expected
                        or now >= deadline or self._stop.is_set()
                        or preempt.pending()):
                    break
            elif (undrained == 0 or now - last_t >= quiesce
                    or now >= deadline or self._stop.is_set()
                    or preempt.pending()):
                break
            clock.sleep(min(quiesce / 2, max(deadline - now, 1e-4)))

    def _note_drained(self, drained: int, req: bytes) -> wire.RequestList:
        """Burst-stability bookkeeping for one drained request blob;
        returns the parsed blob for the prediction fast path."""
        if drained == self._expected_burst:
            self._burst_stable = min(self._burst_stable + 1, 8)
        else:
            self._expected_burst = drained
            self._burst_stable = 0
        with self._lock:
            if self._burst_hint and drained >= self._burst_hint:
                self._burst_hint = 0  # consumed; hooks re-arm per step
        parsed = wire.parse_request_list(req)
        if parsed.cache_bypass:
            _M_BYPASS.inc()
            _M_CACHE_HITS.inc(sum(
                bin(w).count("1") for w in parsed.cache_bits))
        else:
            if parsed.cache_resync:
                _M_RESYNC.inc()
                if flight.ACTIVE:
                    flight.note("resync", drained=drained)
            _M_CACHE_HITS.inc(len(parsed.cache_hits))
        return parsed

    def _dispatch_execution(self, rl: wire.ResponseList):
        """Hand one applied ResponseList to the pipelined executor (or
        run it inline in manual mode), then fold in the shutdown
        signal."""
        if (rl.cache_resync_needed or rl.join_last_rank >= 0
                or any(rs.error for rs in rl.responses)):
            # membership changes, forced resyncs and error responses
            # invalidate everything the predictor learned, the burst
            # gate's steady size included
            with self._lock:
                self._reset_predict_state()
        if tracing.ACTIVE and rl.responses:
            # negotiation is over for these tensors: they now wait for
            # the executor (op_phase skips names this rank does not hold)
            for rs in rl.responses:
                if not rs.error:
                    for n in rs.tensor_names:
                        tracing.op_phase(n, tracing.QUEUE)
        if rl.responses or rl.join_last_rank >= 0:
            if self._exec_queue is not None:
                # bounded queue: if the executor falls behind,
                # negotiation throttles instead of ballooning
                while True:
                    try:
                        self._exec_queue.put(rl, timeout=0.5)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            break
            else:
                self._execute(rl)
        if rl.responses and self._autotuner is not None and self.rank == 0:
            # Parity: ParameterManager.Update — the coordinator scores
            # each cycle by the bytes it moved and publishes the tuner's
            # current (fusion threshold, cycle time) in the next
            # ResponseList, so every rank applies the same values.
            self._autotuner.record_step(
                sum(rs.total_bytes for rs in rl.responses))
            thr, cyc_ms = self._autotuner.current
            self._ctrl.set_tuned(int(thr), int(cyc_ms * 1000.0))
        if rl.tuned_fusion_threshold >= 0:
            self._ctrl.set_fusion_threshold(int(rl.tuned_fusion_threshold))
            self._tuned_seen = True  # tuning in play: prediction off
        if rl.tuned_cycle_time_us >= 0:
            self.cycle_time_s = rl.tuned_cycle_time_us / 1e6
            self._tuned_seen = True
        if rl.shutdown:
            self._shutdown_seen.set()
        with self._lock:
            _M_QUEUE_DEPTH.set(len(self._payloads))
        _M_CACHE_SIZE.set(self._ctrl.cache_size)

    def run_cycle_once(self) -> bool:
        """One lockstep coordination cycle (parity: RunLoopOnce).
        Returns True when the cycle carried work (requests drained or
        responses executed) — the loop's idle-backoff signal."""
        t_cycle0 = clock.monotonic()
        self._gate_burst()
        cycle = self._cycle
        self._cycle += 1
        if self._timeline is not None and self._timeline.mark_cycles:
            self._timeline.mark_cycle(cycle)
        with self._lock:
            # counter reset and drain in ONE critical section: an
            # enqueue between them would be drained yet still counted
            drained = self._undrained
            self._undrained = 0
            self._pending_buf = []
            req = self._ctrl.drain_requests()
        if drained:
            self._note_drained(drained, req)
        resp_blob = self._transport.exchange(self._ctrl, cycle, req)
        self._drain_arrival_skew()
        self._ctrl.apply_responses(resp_blob)
        rl = wire.parse_response_list(resp_blob)
        self._dispatch_execution(rl)
        if cycle % 256 == 0:
            self._inspect_stalls()
        _M_CYCLES.inc()
        _M_CYCLE_S.observe(clock.monotonic() - t_cycle0)
        return bool(rl.responses) or drained > 0

    def _inspect_stalls(self):
        """Parity: stall_inspector.cc — name the ops and the missing
        ranks; warn once per op, abort past the shutdown deadline (the
        raise fails the controller and every pending op).  Rank 0 (the
        coordinator) sees per-rank presence in its message table; every
        OTHER rank watches its own pending ops by age, so a stalled
        collective surfaces everywhere."""
        if self.rank != 0:
            self._inspect_local_stalls()
            return
        for s in self._ctrl.check_stalls():
            key = s["name"]
            if key not in self._stall_logged:
                self._stall_logged.add(key)
                obs_metrics.counter("hvtpu_stall_warnings_total").inc()
                logger.warning(
                    "stalled collective %r: waited %.1fs; ranks ready %s, "
                    "ranks missing %s",
                    s["name"], s["waiting_s"], s["present"], s["missing"],
                )
                if tracing.ACTIVE:
                    tracing.instant(
                        "stall_warning", tensor=s["name"],
                        waited_s=s["waiting_s"],
                        ranks_present=s["present"],
                        ranks_missing=s["missing"])
            if (self.stall_abort_s > 0
                    and s["waiting_s"] > self.stall_abort_s):
                obs_metrics.counter("hvtpu_stall_aborts_total").inc()
                if flight.ACTIVE:
                    flight.note("stall_abort", tensor=s["name"],
                                waited_s=round(s["waiting_s"], 3),
                                ranks_missing=s["missing"])
                flight.dump_postmortem("stall_abort", tensor=s["name"])
                raise HorovodInternalError(
                    f"collective {s['name']!r} stalled for "
                    f"{s['waiting_s']:.0f}s; missing ranks {s['missing']}"
                )

    def _inspect_local_stalls(self):
        """Age-based watchdog for non-coordinator ranks: they cannot see
        which ranks are missing (only rank 0's message table can), but
        they can tell their own op has waited too long."""
        now = clock.monotonic()
        with self._lock:
            pending = [(p.name, now - p.t_enqueue)
                       for p in self._payloads.values()]
        for name, waited in pending:
            if waited < self.stall_warn_s:
                continue
            key = f"local:{name}"
            if key not in self._stall_logged:
                self._stall_logged.add(key)
                obs_metrics.counter("hvtpu_stall_warnings_total").inc()
                logger.warning(
                    "stalled collective %r: waited %.1fs on rank %d "
                    "(coordinator rank 0 logs which ranks are missing)",
                    name, waited, self.rank,
                )
                if tracing.ACTIVE:
                    tracing.instant(
                        "stall_warning", tensor=name,
                        waited_s=waited, rank=self.rank)
            if self.stall_abort_s > 0 and waited > self.stall_abort_s:
                obs_metrics.counter("hvtpu_stall_aborts_total").inc()
                if flight.ACTIVE:
                    flight.note("stall_abort", tensor=name,
                                waited_s=round(waited, 3),
                                rank=self.rank)
                flight.dump_postmortem("stall_abort", tensor=name)
                raise HorovodInternalError(
                    f"collective {name!r} stalled for {waited:.0f}s on "
                    f"rank {self.rank}"
                )

    # ---- live introspection ----
    def debug_state(self) -> dict:
        """A JSON-serializable snapshot of the controller, served as the
        ``controller`` provider at the metrics server's /debug."""
        with self._lock:
            out: Dict[str, Any] = {
                "rank": self.rank,
                "size": self.size,
                "plane": "streamed" if self._stream else "lockstep",
                "cycle": self._cycle,
                "stream_req_idx": self._req_idx,
                "stream_next_resp": self._next_resp,
                "queue_depth": len(self._payloads),
                "undrained": self._undrained,
                "unscheduled": len(self._unsched),
                "predicted_in_flight": len(self._predicted),
                "in_flight_ops": sorted(self._by_name)[:64],
                "pack_plan_ops": len(self._pack_plan or ()),
                "open_packs": len(self._open_packs),
            }
        out.update(
            thread_error=(repr(self._thread_error)
                          if self._thread_error else None),
            cache={"capacity": self._cache_capacity,
                   "size": self._ctrl.cache_size},
            pending_count=self._ctrl.pending_count,
            pending_bytes=self._ctrl.pending_bytes,
            zero_copy_ops=self.zero_copy_ops,
            staged_copies=self.staged_copies,
            mispredicts=self.mispredicts,
            predicted_bursts=self.predicted_bursts,
            fusion_pool=self._fusion_pool.stats(),
        )
        if self.rank == 0:
            # the Python core's alone, as in the reference
            ps = getattr(self._ctrl, "pending_summary", None)
            if callable(ps):
                out["pending_coordination"] = ps()
            out["arrival_skew"] = [list(s) for s in self._arrival_skew]
        return out

    # ---- execution (parity: PerformOperation dispatching to ops/*) ----
    def _stream_context(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._exec_stream is None:
            self._exec_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._exec_stream)

    def _execute(self, rl: wire.ResponseList):
        with eager_comm.controller_execution(), self._stream_context():
            self._execute_responses(rl)

    def _zero_payload(self, rs: wire.Response, i: int) -> _Payload:
        """Zero contribution for a tensor this (joined) rank never
        enqueued (parity: JoinOp substituting a zero tensor).  The
        response's dtype is the WIRE dtype, so the zeros line up with
        peers' compressed buffers; allgather/alltoall contribute zero
        rows."""
        name = rs.tensor_names[i]
        shape = tuple(rs.tensor_shapes[i]) if i < len(rs.tensor_shapes) \
            else ()
        dtype = getattr(torch, wire.DTYPE_NAMES.get(rs.dtype, "float32"))
        kind = _TYPE_TO_KIND.get(rs.type, "allreduce")
        splits = None
        if kind in ("allgather", "alltoall"):
            shape = (0,) + shape[1:]
        if kind == "alltoall":
            members = self._ps_ranks.get(rs.process_set_id)
            splits = [0] * (len(members) if members else self.size)
        fut = OpFuture(name)
        fut.set_result(None)  # nobody waits on a joined rank's result
        return _Payload(
            seq=-1, name=name, future=fut,
            tensor=torch.zeros(shape, dtype=dtype, device=self.device),
            rop=_WIRE_TO_RED.get(rs.red_op, ReduceOp.SUM),
            prescale=1.0, postscale=1.0, compressor=NoneCompressor,
            splits=splits, kind=kind, process_set=rs.process_set_id,
            psid=rs.process_set_id, root_rank=rs.root_rank,
            t_enqueue=clock.monotonic(),
        )

    def _take_payloads(self, rs: wire.Response,
                       strict: bool = True) -> List[_Payload]:
        """Pop this rank's payloads for a response (name + matching
        process-set id).  ``strict=True``: a missing payload is a name
        a predicted execution already resolved, or a joined rank's zero
        contribution; anything else is protocol corruption.
        ``strict=False`` (error responses): missing payloads are
        skipped."""
        out = []
        with self._lock:
            for i, n in enumerate(rs.tensor_names):
                seq = self._by_name.get(n)
                if (seq is not None
                        and self._payloads[seq].psid == rs.process_set_id):
                    del self._by_name[n]
                    out.append(self._payloads.pop(seq))
                elif not strict:
                    continue
                elif n in self._mispredict_names:
                    # executed (and resolved) from a predicted schedule
                    # whose confirmation was later abandoned: the late
                    # real response is bookkeeping only
                    self._mispredict_names.discard(n)
                    continue
                elif self._joined_local:
                    out.append(self._zero_payload(rs, i))
                else:
                    raise HorovodInternalError(
                        f"response names unknown tensor {n!r} "
                        f"(process set {rs.process_set_id})")
        return out

    def _member_of(self, psid: int) -> bool:
        ranks = self._ps_ranks.get(psid)
        return ranks is None or self.rank in ranks

    def _fail_error_response(self, rs: wire.Response):
        """Fail the futures of an ERROR response that this rank holds
        (error responses legitimately reach members that never enqueued
        the tensor).  Cross-rank mismatches raise
        :class:`HvtpuMismatchError`."""
        err_cls = HorovodInternalError
        if rs.error.startswith(_MISMATCH_MARKER):
            err_cls = HvtpuMismatchError
            _M_MISMATCH.inc()
            logger.error("coordinator mismatch diagnostics: %s", rs.error)
        for p in self._take_payloads(rs, strict=False):
            if self._timeline is not None:
                self._timeline.end(p.name)
            if tracing.ACTIVE:
                tracing.op_done(p.name, error=rs.error)
            p.future.set_error(err_cls(rs.error))

    def _execute_responses(self, rl: wire.ResponseList):
        for rs in rl.responses:
            # Responses reach every rank; only members of the response's
            # process set execute it.
            if not self._member_of(rs.process_set_id):
                continue
            if rs.error:
                self._fail_error_response(rs)
                continue
            payloads = self._take_payloads(rs)
            if not payloads:
                continue  # every name resolved by a predicted execution
            now = clock.monotonic()
            # one histogram lock for the whole fused group
            waits = [now - p.t_enqueue for p in payloads if p.seq != -1]
            if waits:
                _M_NEGOTIATION_S.observe_many(waits)
            if self._timeline is not None:
                for p in payloads:
                    if p.seq != -1:  # not a synthetic zero payload
                        self._timeline.end(p.name)
            try:
                self._await_inputs(payloads)
                self._resolve(payloads, self._execute_one(rs, payloads))
            except Exception as e:
                # Data-plane failure: fail exactly this response's
                # futures (parity: entry.callback(Status error)).
                for p in payloads:
                    if not p.future.done():
                        if tracing.ACTIVE:
                            tracing.op_done(p.name, error=str(e))
                        p.future.set_error(HorovodInternalError(str(e)))
        if rl.join_last_rank >= 0:
            with self._lock:
                futs, self._join_futures = self._join_futures, []
                self._joined_local = False
            for f in futs:
                f.set_result(rl.join_last_rank)

    def _await_inputs(self, payloads: List[_Payload]):
        """The executor's stream waits for each input's enqueue event,
        and the inputs are marked as used on it."""
        for p in payloads:
            if p.ready is not None:
                self._exec_stream.wait_event(p.ready)
                p.tensor.record_stream(self._exec_stream)

    def _resolve(self, payloads: List[_Payload], outs: list):
        done = None
        if self._exec_stream is not None:
            done = torch.cuda.Event()
            done.record(self._exec_stream)
        for p, out in zip(payloads, outs):
            p.future.set_result(out, done)

    def _execute_one(self, rs: wire.Response, payloads: List[_Payload]):
        """The results of one response, one a payload, each op over its
        process set (parity: PerformOperation looking up the Response's
        process_set_id communicator)."""
        if rs.type == wire.BARRIER:
            for p in payloads:
                if tracing.ACTIVE:
                    tracing.op_phase(p.name, tracing.EXEC)
                eager_comm.barrier(process_set=p.process_set)
                if tracing.ACTIVE:
                    tracing.op_done(p.name)
            return [None] * len(payloads)
        if rs.type == wire.ALLREDUCE:
            return self._execute_allreduce(rs, payloads)
        if tracing.ACTIVE:
            tracing.op_phase_many([p.name for p in payloads], tracing.EXEC)
        if rs.type == wire.ALLGATHER:
            outs = [eager_comm.allgather(p.tensor,
                                         process_set=p.process_set)
                    for p in payloads]
        elif rs.type == wire.BROADCAST:
            outs = [eager_comm.broadcast(p.tensor, root_rank=rs.root_rank,
                                         process_set=p.process_set)
                    for p in payloads]
        elif rs.type == wire.ALLTOALL:
            outs = [eager_comm.alltoall(p.tensor, p.splits,
                                        process_set=p.process_set)
                    for p in payloads]
        elif rs.type == wire.REDUCESCATTER:
            outs = [eager_comm.reducescatter(p.tensor, op=p.rop,
                                             process_set=p.process_set)
                    for p in payloads]
        else:
            raise HorovodInternalError(f"unknown response type {rs.type}")
        if tracing.ACTIVE:
            tracing.op_done_many([(p.name, {}) for p in payloads],
                                 bytes=rs.total_bytes)
        return outs

    def _execute_allreduce(self, rs: wire.Response,
                           payloads: List[_Payload]) -> list:
        rop = _WIRE_TO_RED[rs.red_op]
        unfusable = (
            rs.red_op == wire.RED_ADASUM
            # int8's per-chunk scales don't sum across ranks outside the
            # quantized allreduce; keep it on the per-tensor path
            # (subclass-aware: int8_stochastic too)
            or any(_is_int8(p.compressor) for p in payloads))
        if unfusable or len(payloads) == 1:
            # Adasum stays per tensor (its coefficients are per tensor);
            # single-tensor responses skip the pack entirely
            outs = []
            for p in payloads:
                if tracing.ACTIVE:
                    tracing.op_phase(p.name, tracing.EXEC)
                outs.append(eager_comm.allreduce(
                    p.tensor, op=p.rop, prescale_factor=p.prescale,
                    postscale_factor=p.postscale, compression=p.compressor,
                    name=p.name, process_set=p.process_set))
                if tracing.ACTIVE:
                    # wire bytes: what the collective moved
                    wd = p.compressor.wire_dtype(p.tensor.dtype)
                    tracing.op_done(p.name, bytes=p.tensor.numel() * (
                        torch.empty((), dtype=wd).element_size()))
            return outs
        # The fuser merges only responses of one process set, so the
        # group's set is payloads[0]'s.
        p0 = payloads[0]
        ps = eager_comm._resolve_process_set(p0.process_set, "allreduce")
        # The zero-copy route first: every payload of the group packed at
        # enqueue time into one complete exchange buffer (the learned
        # plan matched the agreed grouping).
        gkey = (p0.psid, tuple(rs.tensor_names))
        with self._lock:
            pack = self._open_packs.pop(gkey, None)
        if pack is not None:
            if (pack.complete() and len(payloads) == len(pack.specs)
                    and all(p.prepacked == gkey for p in payloads)):
                return self._execute_allreduce_zero_copy(payloads, pack,
                                                         rop, ps)
            # a stale or partial pack (another grouping, a payload that
            # failed its slot checks): return it and stage
            self._fusion_pool.release(p0.psid, pack)
        self.staged_copies += len(payloads)
        _M_FUSION_STAGED.inc(len(payloads))
        names = [p.name for p in payloads]
        if rop in (ReduceOp.SUM, ReduceOp.AVERAGE) and all(
                p.prescale == p0.prescale and p.postscale == p0.postscale
                and p.compressor is p0.compressor for p in payloads):
            # one scale a direction and one codec: the optimizer's group
            # reduction, which takes A1's grouped passes where it can
            # (and emits the FUSE, EXEC and DONE of the ops)
            outs = GroupReduction(rop, p0.prescale, p0.postscale,
                                  p0.compressor, ps).reduce(
                [p.tensor for p in payloads], names)
        else:
            outs = self._staged_by_payload(payloads, rop, ps, names)
        self._maybe_learn_pack_plan(rs, payloads)
        return outs

    @staticmethod
    def _staged_by_payload(payloads: List[_Payload], rop: ReduceOp, ps,
                           names: List[str]):
        """Scales or codecs that differ by payload, or Min/Max/Product:
        the reference's staged steps, payload by payload, around one flat
        collective (parity: MemcpyInFusionBuffer -> one allreduce ->
        MemcpyOutFusionBuffer)."""
        if tracing.ACTIVE:
            tracing.op_phase_many(names, tracing.FUSE)
        wires, ctxs = [], []
        for p in payloads:
            t = p.tensor
            if p.prescale != 1.0:
                t = apply_scale(t, p.prescale)
            t, ctx = p.compressor.compress(t)
            wires.append(t)
            ctxs.append(ctx)
        flat, specs = pack_flat(wires)
        if tracing.ACTIVE:
            tracing.op_phase_many(names, tracing.EXEC)
        flat = eager_comm.allreduce(
            flat, op=rop, process_set=ps,
            name=f"fused.{names[0]}.{len(names)}")
        outs = []
        for p, ctx, piece in zip(payloads, ctxs, unpack_flat(flat, specs)):
            out = p.compressor.decompress(piece, ctx)
            if p.postscale != 1.0:
                out = apply_scale(out, p.postscale)
            outs.append(out)
        if tracing.ACTIVE:
            tracing.op_done_many(
                [(n, {"bytes": int(spec[2]) * flat.element_size()})
                 for n, spec in zip(names, specs)],
                fused=len(names), zero_copy=False)
        return outs

    def _execute_allreduce_zero_copy(self, payloads: List[_Payload], pack,
                                     rop: ReduceOp, ps) -> list:
        """A fused allreduce over an enqueue-time packed exchange buffer:
        the collective reduces the buffer in place (no pack, no
        concatenate), and the futures resolve with lazy pieces whose
        first consumer unpacks the group (:class:`_GroupUnpack`)."""
        names = [p.name for p in payloads]
        if tracing.ACTIVE:
            tracing.op_phase_many(names, tracing.EXEC)
        if self._exec_stream is not None:
            pack.buf.record_stream(self._exec_stream)
        buf = pack.typed_view()
        eager_comm.count_collective("allreduce", buf, ps)
        # the executor's thread: no trace span (the ops' chains cover it)
        span = eager_comm.AllreduceSpan(
            core_state.global_state(), f"fused.{names[0]}.{len(names)}",
            buf.numel() * buf.element_size())
        try:
            red = eager_comm._reduce(buf, rop, NoneCompressor, ps)
        except BaseException:
            span.close()
            raise
        span.close(red, completed=True)
        group = _GroupUnpack(red, pack.element_specs(), pack,
                             self._fusion_pool, payloads[0].psid,
                             [p.postscale for p in payloads],
                             [p.out for p in payloads])
        self.zero_copy_ops += len(payloads)
        _M_FUSION_ZC.inc(len(payloads))
        if tracing.ACTIVE:
            tracing.op_done_many(
                [(n, {"bytes": int(pack.specs[i][2])})
                 for i, n in enumerate(names)],
                fused=len(names), zero_copy=True)
        return [_LazyPiece(group, i) for i in range(len(payloads))]

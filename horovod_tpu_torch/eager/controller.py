"""The async controller: negotiation cycles and the executor.

Counterpart of ``horovod_tpu/eager/controller.py``, its lockstep plane
(parity surface: ``horovod/common/operations.cc`` ``BackgroundThreadLoop``
/ ``RunLoopOnce`` / ``PerformOperation`` and the coordination cycle of
``horovod/common/controller.cc`` ``ComputeResponseList``).  Ranks
enqueue async collectives in any order; every cycle their controllers
agree on one fused schedule and every rank executes it in the same
order.

Division of labor, as in the reference:

- decisions (queueing, readiness, fusion, the response cache, burst
  units) live in the negotiation core, ``horovod_tpu_torch.native``
  (``PyController``);
- this module owns the cycle thread, the transport of the wire-v5 blobs
  between ranks, and the executor thread that runs the agreed responses
  through ``comm/eager.py`` and resolves each op's ``OpFuture``.

Transport: a world of one short-circuits it (``LocalTransport``);
otherwise the blobs ride the ``torch.distributed`` store under per-cycle
keys (``KVTransport``): every rank posts its request blob, rank 0
gathers them, computes the responses and posts them back.

CUDA streams: ``enqueue`` records an event on the caller's current
stream; the executor runs on a stream of its own that waits on it before
it touches the tensor, and records a done event that ``OpFuture.result``
makes the caller's current stream wait on.  Each tensor that crosses
streams is marked with ``record_stream``.  The executor's collectives
run over the process sets' controller groups
(``eager.controller_execution``), never over a communicator the caller's
thread uses.

The staged fused path (``_execute_allreduce``) reduces a group with one
prescale, one postscale and one codec through the optimizer's
``GroupReduction``, which runs kernel A1's grouped passes
(``ops/scale_cast.py``) where the group allows it: one
``scale_cast_pack`` launch in place of the per-tensor prescale,
compress and pack, and one ``unpack_cast_scale`` launch in place of the
per-tensor unpack, decompress and postscale.

Only the lockstep plane is ported.  Not yet ported, and left out where
the reference calls them: the streamed plane (the reference's
``HVTPU_EAGER_STREAM``, which the port does not read: every world size
takes the lockstep plane), schedule prediction, the zero-copy
fusion-buffer plane, Adasum, stall inspection, the tracing, flight,
metrics and timeline hooks, the autotuner, and faults, retry and
preemption.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import torch

from .. import native
from ..comm import eager as eager_comm
from ..comm.compression import NoneCompressor
from ..comm.eager import _is_int8
from ..comm.packing import pack_flat, unpack_flat
from ..comm.reduce_ops import ReduceOp
from ..core.exceptions import HorovodInternalError, HvtpuMismatchError
from ..native import wire
from ..torch.optimizer import GroupReduction, apply_scale

logger = logging.getLogger("horovod_tpu_torch.eager")

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

    def exchange(self, ctrl, cycle: int, request_blob: bytes) -> bytes:
        ctrl.ingest(request_blob)
        return ctrl.compute_responses()

    def close(self):
        pass


class KVTransport:
    """Coordination blobs over the ``torch.distributed`` store (replaces
    MPI_Gatherv/MPI_Bcast of mpi_controller.cc), under a ``PrefixStore``
    of the default group's store.

    The store has no directory get, so the coordinator reads one key a
    rank (the reference's per-key path).  A blocking get polls
    ``check`` with a backoff from 0.2 ms up to ``poll_s`` until its
    deadline: ``close()`` ends it at the next poll, and the store's
    client is never held inside a long ``wait`` (a ``FileStore`` waits a
    whole second whatever the timeout asked, and a ``TCPStore`` logs
    every ``wait`` that times out)."""

    def __init__(self, rank: int, size: int, timeout_s: float = 600.0,
                 poll_s: float = 0.05):
        import torch.distributed as dist

        self.ns = f"hvt_eager/g{next(_GENERATION)}"
        self._kv = dist.PrefixStore(
            self.ns, dist.distributed_c10d._get_default_store())
        self.rank = rank
        self.size = size
        self.timeout_ms = int(timeout_s * 1000)
        self.poll_s = poll_s
        self._closed = threading.Event()

    def _set(self, key: str, blob: bytes):
        self._kv.set(key, blob)

    def _get(self, key: str) -> bytes:
        wait = self.timeout_ms / 1000.0
        deadline = time.monotonic() + wait
        sleep = 0.0
        while True:
            if self._closed.is_set():
                raise TransportClosed(key)
            if self._kv.check([key]):
                return bytes(self._kv.get(key))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"coordination key {key!r} not posted within "
                    f"{wait:.0f}s")
            sleep = min(self.poll_s, sleep * 2 if sleep else 2e-4)
            time.sleep(sleep)

    def _delete(self, key: str):
        try:
            self._kv.delete_key(key)
        except Exception:  # noqa: BLE001 — GC only
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

    def close(self):
        self._closed.set()


# --------------------------------------------------------------------------
# controller
# --------------------------------------------------------------------------

class _Payload:
    __slots__ = ("seq", "name", "future", "tensor", "rop", "prescale",
                 "postscale", "compressor", "splits", "kind",
                 "process_set", "psid", "root_rank", "t_enqueue", "ready")

    def __init__(self, **kw):
        self.ready = None   # the caller's CUDA event at enqueue
        for k, v in kw.items():
            setattr(self, k, v)


class EagerController:
    """The cycle loop and the executor around the negotiation core.

    One instance per process; started lazily on first async enqueue
    (parity: InitializeHorovodOnce starting BackgroundThreadLoop).
    ``device`` is where zero contributions of a joined rank are made
    and, on the card, where the executor's stream lives.
    """

    def __init__(self, rank: int, size: int, *,
                 cycle_time_ms: float = 1.0,
                 fusion_threshold: int = 64 << 20,
                 cache_capacity: int = 1024,
                 transport=None,
                 process_sets: Optional[Dict[int, List[int]]] = None,
                 device: Optional[torch.device] = None,
                 manual: bool = False):
        self.rank, self.size = rank, size
        # manual=True: no background thread; tests drive run_cycle_once.
        self.manual = manual
        self.device = torch.device("cpu") if device is None else device
        self.cycle_time_s = cycle_time_ms / 1000.0
        self._ctrl = native.make_controller(
            rank, size, fusion_threshold, cache_capacity)
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

    # ---- lifecycle ----
    def start(self):
        if self.manual:
            return
        with self._lock:
            if self._thread is not None:
                return
            self._exec_queue = queue.Queue(maxsize=4)
            self._exec_thread = threading.Thread(
                target=self._exec_loop, name="hvt-eager-executor",
                daemon=True)
            self._exec_thread.start()
            self._thread = threading.Thread(
                target=self._loop, name="hvt-eager-controller", daemon=True)
            self._thread.start()

    def quiesce(self, timeout: float = 5.0) -> bool:
        """Wait until this rank has no queued or in-flight ops; True when
        the controller went idle within ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                busy = bool(self._payloads) or self._undrained != 0
            if not busy:
                return True
            if time.monotonic() >= deadline:
                return False
            self._wake.set()
            time.sleep(0.01)

    def request_shutdown(self):
        """Announce this rank's shutdown in subsequent cycles WITHOUT
        stopping the cycle loop (the non-blocking half of the
        coordinated shutdown: several controllers of one process call
        this on all of them before ``stop()`` so none lingers)."""
        self._ctrl.set_shutdown()
        self._wake.set()

    def stop(self):
        # Coordinated shutdown (parity: horovod_shutdown negotiating
        # DONE via the controller): announce, then KEEP CYCLING —
        # serving peers' coordination — until every rank announced.
        if (self.size > 1 and not self.manual
                and self._thread is not None and self._thread.is_alive()
                and self._thread_error is None):
            self._ctrl.set_shutdown()
            self._wake.set()
            linger = self.shutdown_linger_s
            t_ms = getattr(self._transport, "timeout_ms", None)
            if t_ms:
                linger = min(linger, t_ms / 1000.0)
            deadline = time.monotonic() + linger
            while time.monotonic() < deadline:
                if self._shutdown_seen.wait(timeout=0.1):
                    break
                if (self._thread is None or not self._thread.is_alive()
                        or self._thread_error is not None):
                    break
        self._stop.set()
        self._wake.set()
        # Close the transport so a cycle thread blocked in a store get
        # unblocks promptly (TransportClosed).
        self._transport.close()
        thread_exited = True
        if self._thread is not None:
            self._thread.join(timeout=30)
            thread_exited = not self._thread.is_alive()
            self._thread = None
        # Drain the executor AFTER the cycle thread stopped producing:
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
        if not thread_exited:
            logger.warning("controller threads did not exit within 30s")

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
                splits=None, group_id: int = -1) -> OpFuture:
        """Queue one collective; ``compression`` is an engine codec.  A
        rank outside ``process_set`` raises the reference's error here
        (the sync ops raise it too): it would never be answered."""
        if self._thread_error is not None:
            raise HorovodInternalError(
                f"controller thread died: {self._thread_error!r}")
        psid = self._psid(process_set)
        members = self._ps_ranks.get(psid)
        if members is not None and self.rank not in members:
            raise RuntimeError(
                "calling process is not a member of this process set")
        x = tensor.detach()
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
            t_enqueue=time.monotonic(),
        )
        if x.is_cuda:
            payload.ready = torch.cuda.Event()
            payload.ready.record(torch.cuda.current_stream(x.device))
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
            self._last_enqueue_t = time.monotonic()
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
        self._wake.set()
        self.start()
        return fut

    # ---- cycle loop ----
    def _loop(self):
        # Parity: BackgroundThreadLoop — run RunLoopOnce every
        # cycle_time, stretching the cadence up to 4x while idle (each
        # cycle at P>1 is a store round trip on every rank); a local
        # enqueue snaps the loop awake via _wake.
        idle_cycles = 0
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                active = self.run_cycle_once()
            except TransportClosed:
                break
            except BaseException as e:  # noqa: BLE001 — must fail futures
                self._fail_all(e, "eager controller cycle failed")
                return
            if self._shutdown_seen.is_set():
                return  # every rank announced shutdown: global quiesce
            idle_cycles = 0 if active else min(idle_cycles + 1, 3)
            if active:
                sleep = self.cycle_time_s - (time.monotonic() - t0)
            else:
                # a floor, not a target minus elapsed: a slow exchange
                # must not turn idle cycles into a spin
                sleep = self.cycle_time_s * (1 + idle_cycles)
            if sleep > 0:
                self._wake.wait(sleep)
            self._wake.clear()

    def _exec_loop(self):
        """Pipelined execution: dequeue agreed ResponseLists in cycle
        order and run them; errors fail every pending future and stop
        the controller, as the cycle loop's do."""
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
        future, and unwedge the other threads."""
        self._thread_error = e
        logger.exception(what)
        with self._lock:
            payloads = list(self._payloads.values())
            self._payloads.clear()
            self._by_name.clear()
        for p in payloads:
            p.future.set_error(HorovodInternalError(str(e)))
        self._stop.set()
        self._wake.set()

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
        with self._lock:
            hint = self._burst_hint
        expected = (self._expected_burst
                    if self._burst_stable >= 2 else hint)
        deadline = time.monotonic() + (
            max(span, 0.25) if hint and expected
            else max(span, 0.05) if expected
            else span)
        while True:
            with self._lock:
                undrained = self._undrained
                last_t = self._last_enqueue_t
            now = time.monotonic()
            if expected > 0:
                if (undrained == 0 or undrained >= expected
                        or now >= deadline or self._stop.is_set()):
                    break
            elif (undrained == 0 or now - last_t >= quiesce
                    or now >= deadline or self._stop.is_set()):
                break
            time.sleep(min(quiesce / 2, max(deadline - now, 1e-4)))

    def _note_drained(self, drained: int):
        """Burst-stability bookkeeping for one drain."""
        if drained == self._expected_burst:
            self._burst_stable = min(self._burst_stable + 1, 8)
        else:
            self._expected_burst = drained
            self._burst_stable = 0
        with self._lock:
            if self._burst_hint and drained >= self._burst_hint:
                self._burst_hint = 0  # consumed; hooks re-arm per step

    def _dispatch_execution(self, rl: wire.ResponseList):
        """Hand one applied ResponseList to the pipelined executor (or
        run it inline in manual mode), then fold in the shutdown
        signal."""
        if (rl.cache_resync_needed or rl.join_last_rank >= 0
                or any(rs.error for rs in rl.responses)):
            # membership changes, forced resyncs and error responses
            # invalidate the burst gate's steady size
            self._expected_burst = 0
            self._burst_stable = 0
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
        if rl.shutdown:
            self._shutdown_seen.set()

    def run_cycle_once(self) -> bool:
        """One lockstep coordination cycle (parity: RunLoopOnce).
        Returns True when the cycle carried work (requests drained or
        responses executed) — the loop's idle-backoff signal."""
        self._gate_burst()
        cycle = self._cycle
        self._cycle += 1
        with self._lock:
            # counter reset and drain in ONE critical section: an
            # enqueue between them would be drained yet still counted
            drained = self._undrained
            self._undrained = 0
            req = self._ctrl.drain_requests()
        if drained:
            self._note_drained(drained)
        resp_blob = self._transport.exchange(self._ctrl, cycle, req)
        self._ctrl.apply_responses(resp_blob)
        rl = wire.parse_response_list(resp_blob)
        self._dispatch_execution(rl)
        return bool(rl.responses) or drained > 0

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
            t_enqueue=time.monotonic(),
        )

    def _take_payloads(self, rs: wire.Response,
                       strict: bool = True) -> List[_Payload]:
        """Pop this rank's payloads for a response (name + matching
        process-set id).  ``strict=True``: a missing payload means a
        joined rank zero-substitutes, anything else is protocol
        corruption.  ``strict=False`` (error responses): missing
        payloads are skipped."""
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
            logger.error("coordinator mismatch diagnostics: %s", rs.error)
        for p in self._take_payloads(rs, strict=False):
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
            try:
                self._await_inputs(payloads)
                self._resolve(payloads, self._execute_one(rs, payloads))
            except Exception as e:
                # Data-plane failure: fail exactly this response's
                # futures (parity: entry.callback(Status error)).
                for p in payloads:
                    if not p.future.done():
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
                eager_comm.barrier(process_set=p.process_set)
            return [None] * len(payloads)
        if rs.type == wire.ALLREDUCE:
            return self._execute_allreduce(rs, payloads)
        if rs.type == wire.ALLGATHER:
            return [eager_comm.allgather(p.tensor,
                                         process_set=p.process_set)
                    for p in payloads]
        if rs.type == wire.BROADCAST:
            return [eager_comm.broadcast(p.tensor, root_rank=rs.root_rank,
                                         process_set=p.process_set)
                    for p in payloads]
        if rs.type == wire.ALLTOALL:
            return [eager_comm.alltoall(p.tensor, p.splits,
                                        process_set=p.process_set)
                    for p in payloads]
        if rs.type == wire.REDUCESCATTER:
            return [eager_comm.reducescatter(p.tensor, op=p.rop,
                                             process_set=p.process_set)
                    for p in payloads]
        raise HorovodInternalError(f"unknown response type {rs.type}")

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
            # single-tensor responses skip the pack entirely
            return [eager_comm.allreduce(
                p.tensor, op=p.rop, prescale_factor=p.prescale,
                postscale_factor=p.postscale, compression=p.compressor,
                name=p.name, process_set=p.process_set) for p in payloads]
        # Staged fused path: per-tensor prescale and wire compression
        # commute with elementwise reduction, so they run per tensor
        # around ONE flat collective (parity: MemcpyInFusionBuffer ->
        # single ncclAllReduce -> MemcpyOutFusionBuffer).  The fuser
        # merges only responses of one process set, so the group's set
        # is payloads[0]'s.
        p0 = payloads[0]
        ps = eager_comm._resolve_process_set(p0.process_set, "allreduce")
        if rop in (ReduceOp.SUM, ReduceOp.AVERAGE) and all(
                p.prescale == p0.prescale and p.postscale == p0.postscale
                and p.compressor is p0.compressor for p in payloads):
            # one scale a direction and one codec: the optimizer's group
            # reduction, which takes A1's grouped passes where it can
            return GroupReduction(rop, p0.prescale, p0.postscale,
                                  p0.compressor, ps).reduce(
                [p.tensor for p in payloads])
        # scales or codecs that differ by payload, or Min/Max/Product:
        # the reference's steps, payload by payload
        wires, ctxs = [], []
        for p in payloads:
            t = p.tensor
            if p.prescale != 1.0:
                t = apply_scale(t, p.prescale)
            t, ctx = p.compressor.compress(t)
            wires.append(t)
            ctxs.append(ctx)
        flat, specs = pack_flat(wires)
        flat = eager_comm.allreduce(flat, op=rop, process_set=ps)
        outs = []
        for p, ctx, piece in zip(payloads, ctxs, unpack_flat(flat, specs)):
            out = p.compressor.decompress(piece, ctx)
            if p.postscale != 1.0:
                out = apply_scale(out, p.postscale)
            outs.append(out)
        return outs

"""ElasticDataLoader: checkpointable, resize-aware input with prefetch.

Counterpart of ``horovod_tpu/data/loader.py``.

Delivery model
--------------
The loader owns a tiny :class:`LoaderState` — ``(epoch, cursor, seed)``,
the shuffle key and the **global** cursor of samples the world has
consumed this epoch.  Those three values plus the sharder's pure
functions (``data/sharder.py``) fully determine every future batch, so
registering the state with an elastic state
(``TorchState(model, optimizer, data=loader.state)``) makes the iterator
checkpointable: commits, rollbacks and the drain commit
(``core/preempt.py``) all capture it, and a relaunched incarnation,
possibly with another world size, resumes mid-epoch by re-splitting the
unconsumed remainder.  A sample is re-delivered only if the commit that
covered it was rolled back.

Prefetch
--------
A background thread plans ahead of the delivery cursor (across epoch
boundaries), fetches from the source and, unless
``HVTPU_DATA_DEVICE_PUT=0``, copies the batch onto the training device
(the state's device: ``cuda:{local_rank}``, or the CPU when ``init``
was asked for it), then parks it in a bounded queue
(``HVTPU_DATA_PREFETCH_DEPTH``, default 2).  On the card the copy starts
from pinned host memory on the prefetch thread's own CUDA stream; the
batch is handed over with an event that the consuming stream waits on
at delivery, so the copy overlaps the step and never races it.  A
failed copy raises at delivery: there is no fallback to host batches
(the reference's ``device_put`` fallback is deliberately not carried
over), because a silent fallback would hide the device.

Every batch is tagged with the state *version*; a restore bumps the
version, so stale prefetched batches are discarded at delivery and the
planner re-plans from the restored cursor.

Coordinated epoch boundary
--------------------------
The first use in each incarnation runs an allreduce-MIN over
``len(source)`` (``HVTPU_DATA_COORD_BOUNDARY``, default on) past one
rank, on a tensor on the state's device, and every rank trains on the
agreed prefix; a short shard therefore never deadlocks peers.

Observability: ``hvtpu_data_*`` metrics, a ``DATA_WAIT`` trace phase,
the step profiler's data-wait window, loader state in ``/debug``, and
the ``data.next`` fault site (delay/error/drop).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import faults
from ..obs import metrics as obs_metrics
from ..obs import stepprof
from ..obs import tracing
from .sharder import Sharder
from .sources import DataSource, map_structure

logger = logging.getLogger("horovod_tpu_torch")

_M_WAIT = obs_metrics.histogram(
    "hvtpu_data_wait_seconds",
    "Time the training loop blocked waiting on the input pipeline per "
    "batch (the data-stall half of the straggler decomposition).",
    buckets=obs_metrics.DEFAULT_TIME_BUCKETS)
_M_QDEPTH = obs_metrics.gauge(
    "hvtpu_data_queue_depth",
    "Prefetch queue depth sampled at each batch delivery (0 means the "
    "consumer is outrunning the producer — input-bound).")
_M_SAMPLES = obs_metrics.counter(
    "hvtpu_data_samples_delivered_total",
    "Samples delivered to this rank's training loop.")
_M_BATCHES = obs_metrics.counter(
    "hvtpu_data_batches_delivered_total",
    "Batches delivered to this rank's training loop.")
_M_RESHARDS = obs_metrics.counter(
    "hvtpu_data_reshards_total",
    "Iterator-state restores applied (elastic resync / rollback): each "
    "re-partitions the unconsumed epoch remainder across the world.")

def _default_device() -> torch.device:
    """The copy's target before ``init()``: the card, never the CPU by
    default (``init(device="cpu")`` for batches on the CPU,
    ``device_put=False`` for numpy batches)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ElasticDataLoader: CUDA is not available and the port is not "
            "initialized; init(device='cpu') for batches on the CPU, or "
            "device_put=False for numpy batches")
    return torch.device("cuda", torch.cuda.current_device())


# live loaders for the /debug endpoint and the pre-exit quiesce hook
_LIVE: Dict[str, "ElasticDataLoader"] = {}
_LIVE_LOCK = threading.Lock()


def _debug_state() -> dict:
    with _LIVE_LOCK:
        loaders = list(_LIVE.items())
    return {name: ld.debug_state() for name, ld in loaders}


def quiesce_all() -> None:
    """Stop every live loader's prefetch thread (state is untouched).
    Called by the graceful-preemption path right before a drain exit so
    no thread is mid-copy when the process leaves."""
    with _LIVE_LOCK:
        loaders = list(_LIVE.values())
    for ld in loaders:
        try:
            ld.quiesce()
        except Exception:  # pragma: no cover - shutdown must not raise
            logger.debug("data loader quiesce failed", exc_info=True)


class LoaderState:
    """The checkpointable iterator state: ``epoch``, the global
    ``cursor`` (samples the WORLD consumed this epoch — rank-agnostic,
    so the elastic sync broadcast cannot desync it), and the shuffle
    ``seed``.  Implements both the hvtpu elastic participant protocol
    (``hvtpu_state_dict``/``hvtpu_load_state_dict``, applied IN PLACE by
    ``ObjectState`` so the loader's reference stays live) and the
    torch-style ``state_dict``/``load_state_dict`` pair (``TorchState``
    captures it as a handle and also restores it in place)."""

    def __init__(self, seed: int = 0):
        self.epoch = 0
        self.cursor = 0
        self.seed = int(seed)
        # bumped on every restore so the prefetch planner re-plans and
        # stale prefetched batches are discarded at delivery
        self.version = 0

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": int(self.epoch), "cursor": int(self.cursor),
                "seed": int(self.seed)}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        self.epoch = int(sd["epoch"])
        self.cursor = int(sd["cursor"])
        self.seed = int(sd.get("seed", self.seed))
        self.version += 1
        _M_RESHARDS.inc()

    # elastic participant protocol (horovod_tpu/elastic/state.py)
    hvtpu_state_dict = state_dict
    hvtpu_load_state_dict = load_state_dict

    def __repr__(self):
        return (f"LoaderState(epoch={self.epoch}, cursor={self.cursor}, "
                f"seed={self.seed})")


class _Item:
    """One prefetched batch, tagged with the plan version and the
    cursor window it covers; ``ready`` is the CUDA event its copy
    recorded on the prefetch stream (None off the card)."""

    __slots__ = ("version", "epoch", "cursor_before", "cursor_after",
                 "indices", "batch", "ready")

    def __init__(self, version, epoch, cursor_before, cursor_after,
                 indices, batch, ready=None):
        self.version = version
        self.epoch = epoch
        self.cursor_before = cursor_before
        self.cursor_after = cursor_after
        self.indices = indices
        self.batch = batch
        self.ready = ready


def _env_flag(raw: Optional[str], default: bool) -> bool:
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off")


class ElasticDataLoader:
    """Elastic-aware sharded loader over a :class:`DataSource`.

    Usage::

        loader = ElasticDataLoader(ArraySource({"x": x, "y": y}),
                                   batch_size=64, seed=1234)
        state = hvd.elastic.TorchState(model, optimizer,
                                       data=loader.state)

        @hvd.elastic.run
        def train(state):
            while loader.state.epoch < EPOCHS:
                for batch in loader:      # resumes mid-epoch on resize
                    ...per-rank batch of batch_size samples, as tensors
                    on the training device...
                    state.commit()

    Per step every rank receives ``batch_size`` samples (the world
    consumes ``size * batch_size``), so per-rank batch shapes are
    invariant across resizes.  The copy's target is the state's device
    (``hvd.device()``) at first use.
    """

    def __init__(self, source: DataSource, batch_size: int, *,
                 seed: int = 0, shuffle: bool = True,
                 prefetch_depth: Optional[int] = None,
                 device_put: Optional[bool] = None,
                 transform: Optional[Callable[[Any], Any]] = None,
                 with_indices: bool = False,
                 name: str = "default"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.source = source
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.transform = transform
        self.with_indices = bool(with_indices)
        self.name = name
        self.state = LoaderState(seed=seed)
        if prefetch_depth is None:
            prefetch_depth = int(os.environ.get(
                "HVTPU_DATA_PREFETCH_DEPTH", "2"))
        self.prefetch_depth = max(1, int(prefetch_depth))
        if device_put is None:
            device_put = _env_flag(
                os.environ.get("HVTPU_DATA_DEVICE_PUT", "1"), True)
        self._device_put = bool(device_put)
        self._device: Optional[torch.device] = None
        self._stream = None  # the prefetch thread's CUDA stream
        self._coord_boundary = _env_flag(
            os.environ.get("HVTPU_DATA_COORD_BOUNDARY", "1"), True)
        self._queue: "queue.Queue[_Item]" = queue.Queue(
            maxsize=self.prefetch_depth)
        self._lock = threading.Lock()
        self._plan_epoch = 0  # hvtpulint: guarded-by(_lock)
        self._plan_cursor = 0  # hvtpulint: guarded-by(_lock)
        self._plan_version = -1  # hvtpulint: guarded-by(_lock)
        self._pending_error: Optional[BaseException] = None  # hvtpulint: guarded-by(_lock)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rank = 0
        self._size = 1
        self._n: Optional[int] = None
        self._sharder: Optional[Sharder] = None
        self._delivered_batches = 0
        self._delivered_samples = 0
        self._register()

    # -- world / length agreement ---------------------------------------
    def _agreed_length(self) -> int:
        """The sample count every rank trains on this incarnation.
        Resolved lazily at first use (after ``hvt.init`` and the
        elastic sync): an allreduce-MIN over the local ``len(source)``
        when the world has peers, so a short shard bounds the epoch for
        everyone instead of deadlocking them at its end."""
        if self._n is not None:
            return self._n
        n_local = len(self.source)
        n = n_local
        from ..core import state as core_state

        st = core_state.global_state()
        if st.initialized:
            self._rank, self._size = st.rank, st.size
        if st.initialized:
            self._device = st.device
        if st.initialized and st.size > 1 and self._coord_boundary:
            from ..comm.reduce_ops import Min
            from ..torch import mpi_ops

            agreed = int(mpi_ops.allreduce(
                torch.tensor([n_local], dtype=torch.int32,
                             device=st.device), op=Min,
                name=f"hvtpu.data.len.{self.name}")[0])
            if agreed != n_local:
                logger.warning(
                    "data loader %r: local source has %d samples but the "
                    "world agreed on %d (allreduce-min); the last %d are "
                    "ignored this incarnation", self.name, n_local,
                    agreed, n_local - agreed)
            n = agreed
        if n <= 0:
            raise ValueError(
                f"data loader {self.name!r}: agreed sample count is {n}")
        self._n = n
        self._sharder = Sharder(n, self.batch_size,
                                seed=self.state.seed, shuffle=self.shuffle)
        return n

    def steps_per_epoch(self) -> int:
        """Batches per full epoch — identical on every rank."""
        self._agreed_length()
        return self._sharder.steps_remaining(0, self._size)

    def __len__(self) -> int:
        return self.steps_per_epoch()

    # -- prefetch thread -------------------------------------------------
    def _ensure_started(self) -> None:
        self._agreed_length()
        if self._device_put and self._device is None:
            self._device = _default_device()
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._prefetch_loop,
            name=f"hvtpu-data-prefetch-{self.name}", daemon=True)
        self._thread.start()

    def _prefetch_loop(self) -> None:
        n = self._n
        sharder = self._sharder
        while not self._stop.is_set():
            with self._lock:
                if self._plan_version != self.state.version:
                    # restore/rollback: re-plan from the delivery state;
                    # stale queue items are discarded by version at
                    # delivery, so no draining is needed here
                    self._plan_version = self.state.version
                    self._plan_epoch = self.state.epoch
                    self._plan_cursor = self.state.cursor
                    sharder = Sharder(
                        n, self.batch_size, seed=self.state.seed,
                        shuffle=self.shuffle)
                if self._plan_cursor >= n:
                    self._plan_epoch += 1
                    self._plan_cursor = 0
                version = self._plan_version
                epoch = self._plan_epoch
                cursor = self._plan_cursor
            try:
                indices, new_cursor = sharder.next_indices(
                    epoch, cursor, self._rank, self._size)
                batch = self.source.fetch(indices)
                if self.transform is not None:
                    batch = self.transform(batch)
                ready = None
                if self._device_put:
                    batch, ready = self._to_device(batch)
            except BaseException as e:  # noqa: BLE001 - forwarded to consumer
                with self._lock:
                    self._pending_error = e
                return
            item = _Item(version, epoch, cursor, new_cursor, indices,
                         batch, ready)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            with self._lock:
                if self._plan_version == version:
                    self._plan_cursor = new_cursor

    def _to_device(self, batch):
        """``(batch on the training device, ready event or None)``.  On
        the card each array leaf is pinned and copied on this thread's
        own stream, and the event recorded after the last copy is what
        the consumer waits on.  A failure raises (the consumer sees it
        at delivery): there is no host fallback."""
        dev = self._device
        if dev.type != "cuda":
            return map_structure(
                lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                batch), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._stream):
            out = map_structure(
                lambda a: torch.from_numpy(np.ascontiguousarray(a))
                .pin_memory().to(dev, non_blocking=True), batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _hand_over(self, item: "_Item") -> None:
        """Make the consuming stream wait for the item's copy, and tell
        the allocator that stream now uses the batch's memory."""
        if item.ready is None:
            return
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(item.ready)
        map_structure(lambda t: t.record_stream(consumer), item.batch)

    # -- delivery ---------------------------------------------------------
    def _next_item(self) -> _Item:
        """Take the next in-plan batch, discarding stale (pre-restore)
        prefetches and surfacing producer errors."""
        while True:
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                with self._lock:
                    err = self._pending_error
                    self._pending_error = None
                if err is not None:
                    raise RuntimeError(
                        f"data loader {self.name!r}: prefetch failed"
                    ) from err
                if self._stop.is_set() or self._thread is None \
                        or not self._thread.is_alive():
                    raise RuntimeError(
                        f"data loader {self.name!r}: prefetch thread is "
                        "not running (closed mid-iteration?)")
                continue
            if item.version != self.state.version:
                continue  # prefetched before a restore: never deliver
            return item

    def _deliver(self) -> Tuple[np.ndarray, Any]:
        t0 = time.perf_counter()
        t_wall0 = time.time()
        if tracing.ACTIVE:
            tracing.op_begin(f"data/{self.name}", kind="data",
                             phase=tracing.DATA_WAIT,
                             epoch=self.state.epoch,
                             cursor=self.state.cursor)
        try:
            dropped = False
            if faults.ACTIVE:
                # delay stalls inside the DATA_WAIT span (an injected
                # input straggler); error raises; drop loses one batch
                dropped = faults.inject(
                    "data.next",
                    detail=f"{self.name}@{self.state.epoch}:"
                           f"{self.state.cursor}")
            item = self._next_item()
            if dropped:
                logger.warning(
                    "data loader %r: injected drop lost batch "
                    "epoch=%d cursor=%d (%d samples)", self.name,
                    item.epoch, item.cursor_before, len(item.indices))
                self.state.cursor = item.cursor_after
                item = self._next_item()
        finally:
            if tracing.ACTIVE:
                tracing.op_done(f"data/{self.name}")
            if stepprof.ACTIVE:
                # Wall-clock window for the overlap profiler's
                # per-step data-wait bucket (obs/stepprof).
                stepprof.note_data_wait(t_wall0, time.time())
        _M_WAIT.observe(time.perf_counter() - t0)
        if item.cursor_before != self.state.cursor \
                or item.epoch != self.state.epoch:
            raise RuntimeError(
                f"data loader {self.name!r}: prefetch plan diverged "
                f"from delivery state (planned {item.epoch}:"
                f"{item.cursor_before}, expected {self.state.epoch}:"
                f"{self.state.cursor})")
        self._hand_over(item)
        self.state.cursor = item.cursor_after
        self._delivered_batches += 1
        self._delivered_samples += len(item.indices)
        _M_BATCHES.inc()
        _M_SAMPLES.inc(len(item.indices))
        _M_QDEPTH.set(self._queue.qsize())
        return item.indices, item.batch

    def __iter__(self):
        """Yield the CURRENT epoch's remaining batches (mid-epoch
        resume after a restore is automatic: the cursor says where to
        pick up), then advance ``state.epoch`` so a per-epoch
        ``state.commit()`` captures the rollover."""
        self._ensure_started()
        n = self._agreed_length()
        epoch = self.state.epoch
        while self.state.epoch == epoch and self.state.cursor < n:
            indices, batch = self._deliver()
            yield (indices, batch) if self.with_indices else batch
        if self.state.epoch == epoch and self.state.cursor >= n:
            self.state.epoch += 1
            self.state.cursor = 0

    def stream(self):
        """Infinite batch iterator across epoch boundaries (the bench
        shape: the prefetcher keeps the queue full through rollovers)."""
        while True:
            yield from self

    # -- lifecycle ---------------------------------------------------------
    def _register(self) -> None:
        with _LIVE_LOCK:
            base, k = self.name, 1
            while self.name in _LIVE:
                self.name = f"{base}-{k}"
                k += 1
            first = not _LIVE
            _LIVE[self.name] = self
        if first:
            obs_metrics.register_debug_provider("data", _debug_state)

    def quiesce(self) -> None:
        """Stop the prefetch thread; state and the registration stay
        (iteration restarts the thread)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            # unblock a producer parked on a full queue
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
        self._thread = None

    def close(self) -> None:
        """Quiesce and deregister (no dangling thread — unit-tested)."""
        self.quiesce()
        with _LIVE_LOCK:
            _LIVE.pop(self.name, None)
            empty = not _LIVE
        if empty:
            obs_metrics.unregister_debug_provider("data")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection ------------------------------------------------------
    def debug_state(self) -> dict:
        t = self._thread
        return {
            "epoch": self.state.epoch,
            "cursor": self.state.cursor,
            "seed": self.state.seed,
            "samples": self._n,
            "batch_size": self.batch_size,
            "rank": self._rank,
            "size": self._size,
            "queue_depth": self._queue.qsize(),
            "prefetch_depth": self.prefetch_depth,
            "prefetch_alive": bool(t is not None and t.is_alive()),
            "device_put": self._device_put,
            "device": None if self._device is None else str(self._device),
            "delivered_batches": self._delivered_batches,
            "delivered_samples": self._delivered_samples,
        }

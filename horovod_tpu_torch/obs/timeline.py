"""Per-tensor lifecycle tracing to Chrome trace-event JSON.

Counterpart of ``horovod_tpu/obs/timeline.py`` (parity surface:
``horovod/common/timeline.cc`` ``Timeline`` / ``TimelineController``) —
enabled by ``HVTPU_TIMELINE=/path.json`` (or the reference spelling
``HOROVOD_TIMELINE``) or ``hvd.start_timeline``, loadable in
``chrome://tracing`` / Perfetto.  Phases mirror the reference's
per-tensor states (NEGOTIATE_* → QUEUE → MEMCPY_IN_FUSION_BUFFER →
<collective> → MEMCPY_OUT_FUSION_BUFFER).  The collective phase of an
allreduce is ``NCCL_ALLREDUCE``, upstream Horovod's name for it on GPUs
(the JAX package's ``ICI_ALLREDUCE``); every other name is the JAX
package's.

For on-device detail (per-kernel timing) ``start_torch_profiler`` wraps
``torch.profiler`` — the counterpart of the JAX package's
``start_jax_profiler`` and of the reference's NVTX ranges
(horovod/common/nvtx_op_range.cc).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

# Reference-parity phase names (timeline.cc writes these as event names).
NEGOTIATE = "NEGOTIATE"
QUEUE = "QUEUE"
MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
NCCL_ALLREDUCE = "NCCL_ALLREDUCE"
MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"
COMPILE = "COMPILE"
CYCLE = "CYCLE"


class Timeline:
    """Thread-safe incremental Chrome-trace writer.

    Events: ``begin(name, phase)`` / ``end(name)`` duration pairs on a
    per-tensor track, plus ``instant`` marks and ``mark_cycle`` (the
    reference's HOROVOD_TIMELINE_MARK_CYCLES).
    """

    def __init__(self, filename: str, rank: int = 0, mark_cycles: bool = False):
        self._filename = filename
        self._rank = rank
        self._mark_cycles = mark_cycles
        self._lock = threading.Lock()
        self._file = open(filename, "w")
        self._file.write("[\n")
        self._first = True
        # Monotonic epoch for event timestamps plus the wall-clock
        # reading taken at the same instant: merge tooling
        # (tools/hvtputrace) rebases per-rank relative timestamps onto
        # a shared wall clock via this anchor and the clock offsets.
        self._t0 = time.monotonic()
        self._wall_t0 = time.time()
        self._open_spans = {}
        self._closed = False
        self._emit(
            {
                "name": "process_name",
                "ph": "M",
                "pid": rank,
                "args": {"name": f"hvtpu rank {rank}"},
            }
        )

    @property
    def wall_t0(self) -> float:
        """time.time() captured at the trace's ts=0 instant."""
        return self._wall_t0

    @property
    def mark_cycles(self) -> bool:
        """Whether CYCLE instants are enabled (the controller consults
        this before paying for a mark_cycle call each cycle)."""
        return self._mark_cycles

    def _now_us(self) -> float:
        return (time.monotonic() - self._t0) * 1e6

    def _emit(self, event: dict):
        with self._lock:
            if self._closed:
                return
            if not self._first:
                self._file.write(",\n")
            self._first = False
            json.dump(event, self._file)
            self._file.flush()

    def begin(self, tensor_name: str, phase: str, **args):
        # A tensor entering its next phase before end() closes the
        # previous one (NEGOTIATE -> QUEUE -> NCCL_ALLREDUCE) must end
        # that span first — silently overwriting the open-span entry
        # leaves an unmatched 'B' event in the trace.
        if tensor_name in self._open_spans:
            self.end(tensor_name)
        self._open_spans[tensor_name] = phase
        self._emit(
            {
                "name": phase,
                "cat": "tensor",
                "ph": "B",
                "ts": self._now_us(),
                "pid": self._rank,
                "tid": hash(tensor_name) % (1 << 31),
                "args": {"tensor": tensor_name, **args},
            }
        )

    def end(self, tensor_name: str):
        phase = self._open_spans.pop(tensor_name, None)
        if phase is None:
            return
        self._emit(
            {
                "name": phase,
                "cat": "tensor",
                "ph": "E",
                "ts": self._now_us(),
                "pid": self._rank,
                "tid": hash(tensor_name) % (1 << 31),
            }
        )

    def instant(self, name: str, **args):
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "p",
                "ts": self._now_us(),
                "pid": self._rank,
                "tid": 0,
                "args": args,
            }
        )

    def mark_cycle(self, cycle_index: int):
        """Mark a controller cycle; no-op unless mark_cycles was enabled
        (parity: HOROVOD_TIMELINE_MARK_CYCLES)."""
        if self._mark_cycles:
            self.instant(CYCLE, index=cycle_index)

    def close(self):
        # End dangling spans first so the trace has no unmatched 'B'
        # events (e.g. ops still negotiating when the file is swapped
        # by start_timeline).
        for name in list(self._open_spans):
            self.end(name)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._file.write("\n]\n")
            self._file.close()


# --- torch.profiler integration (NVTX analog) ---------------------------

_profiler = None
_profiler_dir: Optional[str] = None


def start_torch_profiler(log_dir: str):
    """Start a ``torch.profiler`` trace of the host and, when CUDA is
    available, the card; ``stop_torch_profiler`` writes it into
    ``log_dir`` as a Chrome trace (``obs/profile.py`` reads it)."""
    global _profiler, _profiler_dir
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _profiler is not None:
        raise RuntimeError("a torch profiler trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _profiler, _profiler_dir = prof, log_dir


def stop_torch_profiler():
    """Stop the trace ``start_torch_profiler`` began and write it into
    its directory; returns the file written (None when none ran)."""
    global _profiler, _profiler_dir
    prof, log_dir = _profiler, _profiler_dir
    _profiler = _profiler_dir = None
    if prof is None:
        return None
    prof.stop()
    from . import profile as _profile

    return _profile.export(prof, log_dir)

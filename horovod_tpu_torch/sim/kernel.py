"""Deterministic virtual-time kernel for the fabric simulator (the
port's copy of ``horovod_tpu/sim/kernel.py``; the same logic, so the
same seed schedules the same events in both packages).

The simulator's job is to run the REAL control
plane — eager negotiation, drain coordination, rendezvous audits,
heartbeats — at 256–4096 virtual ranks inside one process, under
chaos, deterministically.  The kernel provides the substrate:

- **Virtual time.**  :class:`VirtualClock` implements the
  ``core/clock.py`` seam; every ``clock.monotonic()`` /
  ``clock.sleep()`` / ``clock.call_later()`` issued by framework code
  on a simulated thread reads or advances the kernel's discrete-event
  clock instead of the host's.  A scenario covering ten minutes of
  drain grace runs in wall-clock milliseconds, and two runs with the
  same seed produce byte-identical event logs.

- **Cooperative rank tasks on real threads.**  Framework code is full
  of genuine blocking calls (KV blocking gets, retry backoff sleeps,
  burst-gate waits), so each virtual rank runs on a real OS thread —
  but the kernel holds a single *run token*: exactly one task thread
  executes at any instant, and control passes task → scheduler →
  task only at virtual-time events.  That serialisation is what makes
  the simulation deterministic without rewriting the framework into
  coroutines.

- **Events.**  A heap of ``(virtual_time, seq, callback)`` entries.
  ``seq`` (a monotonically increasing tie-breaker) makes simultaneous
  events fire in scheduling order, which is itself deterministic.

- **Wait tokens.**  The primitive the in-memory KV fabric builds
  blocking-get-with-timeout from: a task parks on a token
  (:meth:`SimKernel.block`), any other task or timer resolves it
  (:meth:`SimKernel.notify`), and an armed timeout event resolves it
  the other way.  Each park uses a FRESH token, so a stale timeout
  event can never wake a later wait.

- **Deadlock detection.**  When the event heap drains while tasks are
  still parked, no future event can ever wake them: the kernel raises
  :class:`DeadlockError` listing every parked task and what it is
  blocked on — turning a hung protocol into a diagnosis.

- **Virtual process exit.**  ``exit_fn`` seams in core/faults.py and
  core/preempt.py raise :class:`VirtualExit` (a BaseException, so it
  cannot be swallowed by ``except Exception`` recovery paths) to make
  one virtual rank "die" with an exit code — kill faults and planned
  drain departures — without taking the host process down.

Purity contract: nothing in this package reads the host clock or the
module-level ``random`` functions, nor torch's ambient RNG (enforced by
the port's sim-purity test); all randomness flows from
:meth:`SimKernel.rng` streams keyed by ``(seed, name)``.
"""

from __future__ import annotations

import heapq
import json
import os
import random
import threading
from typing import Any, Callable, Dict, List, Optional

from ..core import clock as core_clock

__all__ = [
    "DeadlockError",
    "SimKernel",
    "SimTimeBudgetExceeded",
    "VirtualClock",
    "VirtualExit",
    "WaitToken",
]

#: Exit code used when the kernel force-unwinds still-parked tasks at
#: teardown (distinct from any real exit code the protocols use).
ABORTED_EXIT = -1


class VirtualExit(BaseException):
    """One virtual rank leaving with an exit code (kill fault, planned
    drain departure, kernel teardown).  BaseException so framework
    ``except Exception`` recovery paths cannot swallow a death."""

    def __init__(self, code: int):
        super().__init__(f"virtual exit {code}")
        self.code = code


class DeadlockError(RuntimeError):
    """Event heap drained while tasks are still parked — no future
    event can wake them.  The message lists each parked task and its
    blocked reason."""


class SimTimeBudgetExceeded(RuntimeError):
    """Virtual time passed the scenario's budget — the protocol under
    test is livelocked or pathologically slow, not merely busy."""


class WaitToken:
    """One park of one task.  States: waiting → notified | timeout.
    Created fresh per wait so stale timeout events are inert."""

    __slots__ = ("state", "task", "value", "timer")

    def __init__(self):
        self.state = "waiting"
        self.task: Optional["_Task"] = None
        self.value: Any = None
        self.timer: Optional["_VTimer"] = None


class _VTimer:
    """Virtual ``clock.Timer``: a cancellable one-shot callback on the
    event heap (fires on the scheduler thread)."""

    __slots__ = ("_fn", "_cancelled")

    def __init__(self, fn: Callable[[], None]):
        self._fn = fn
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    def _fire(self) -> None:
        if not self._cancelled:
            self._fn()


class VirtualClock(core_clock.Clock):
    """The ``core/clock.py`` seam over the kernel: monotonic == virtual
    seconds since run start, wall == a fixed epoch plus virtual time
    (so wall-clock deltas are virtual too and logs stay reproducible),
    sleep parks the calling task, call_later lands on the event heap."""

    #: Fixed virtual wall epoch (2020-01-01T00:00:00Z).  Arbitrary but
    #: constant: wall() must never leak host time into event logs.
    EPOCH = 1577836800.0

    def __init__(self, kernel: "SimKernel"):
        self._kernel = kernel

    def monotonic(self) -> float:
        return self._kernel.now

    def wall(self) -> float:
        return self.EPOCH + self._kernel.now

    def sleep(self, seconds: float) -> None:
        self._kernel.sleep(seconds)

    def call_later(self, delay_s: float,
                   fn: Callable[[], None]) -> _VTimer:
        return self._kernel.call_later(delay_s, fn)


class _Task:
    """One virtual rank (or auxiliary actor): a real daemon thread that
    only ever runs while it holds the kernel's run token."""

    def __init__(self, kernel: "SimKernel", name: str,
                 fn: Callable[[], Any]):
        self.kernel = kernel
        self.name = name
        self.fn = fn
        self.go = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.done = False
        self.exit_code: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.result: Any = None
        self.blocked_reason = "never started"
        self._abort = False

    # -- scheduler side -------------------------------------------------
    def _resume(self) -> None:
        """Hand the run token to this task until it parks or finishes.
        Runs on the scheduler thread as an event callback."""
        if self.done:
            return
        kernel = self.kernel
        if self.thread is None:
            self.thread = kernel._start_thread(self)
        else:
            self.go.set()
        kernel._control.wait()
        kernel._control.clear()

    # -- task side ------------------------------------------------------
    def _run(self) -> None:
        kernel = self.kernel
        kernel._tls.task = self
        core_clock.install(kernel.clock)
        try:
            self.result = self.fn()
        except VirtualExit as e:
            self.exit_code = e.code
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised by run()
            self.error = e
            kernel._failed.append(self)
        finally:
            self.done = True
            core_clock.install(None)
            kernel._control.set()

    def _park(self, reason: str) -> None:
        """Give the run token back and wait to be resumed.  Must be
        called on this task's own thread."""
        self.blocked_reason = reason
        kernel = self.kernel
        kernel._control.set()
        self.go.wait()
        self.go.clear()
        self.blocked_reason = "running"
        if self._abort:
            raise VirtualExit(ABORTED_EXIT)


class SimKernel:
    """The discrete-event scheduler: owns virtual time, the event heap,
    the task set, seeded RNG streams, and the event log."""

    def __init__(self, seed: int = 0, *, stack_kb: Optional[int] = None):
        self.seed = int(seed)
        self.now = 0.0
        self.clock = VirtualClock(self)
        self._heap: List[tuple] = []  # (time, seq, fn)
        self._seq = 0
        self._control = threading.Event()
        self._tls = threading.local()
        self._tasks: List[_Task] = []
        # tasks that died with an error, appended task-side: run()'s
        # dispatch loop checks this O(1) per event instead of scanning
        # the whole task list (O(ranks) per event is a 10x slowdown at
        # 1024 vranks)
        self._failed: List[_Task] = []
        self._rngs: Dict[str, random.Random] = {}
        self.events: List[dict] = []
        self._running = False
        # 4096 rank threads at the default (often 8 MB) stack would
        # reserve absurd address space; framework control-plane frames
        # are shallow, so a small fixed stack is plenty.
        if stack_kb is None:
            stack_kb = int(os.environ.get("HVTPU_SIM_STACK_KB", "1024"))
        self._stack_bytes = max(64, int(stack_kb)) * 1024

    # -- rng / log ------------------------------------------------------
    def rng(self, name: str) -> random.Random:
        """A named deterministic RNG stream: same (seed, name) ⇒ same
        sequence, independent across names."""
        r = self._rngs.get(name)
        if r is None:
            r = random.Random(f"{self.seed}/{name}")
            self._rngs[name] = r
        return r

    def log(self, kind: str, **fields: Any) -> None:
        """Append one event-log record stamped with virtual time.
        Records must hold only virtual-time/deterministic values — the
        log is the byte-identical replay artifact."""
        rec = {"t": round(self.now, 9), "kind": kind}
        rec.update(fields)
        self.events.append(rec)

    def dump_events(self) -> str:
        """The canonical JSONL serialisation (sorted keys: dict order
        can never leak into the replay artifact)."""
        return "".join(
            json.dumps(rec, sort_keys=True) + "\n" for rec in self.events)

    # -- tasks / events -------------------------------------------------
    def spawn(self, name: str, fn: Callable[[], Any],
              delay_s: float = 0.0) -> _Task:
        """Create a task and schedule its first run ``delay_s`` of
        virtual time from now."""
        task = _Task(self, name, fn)
        self._tasks.append(task)
        self.schedule(delay_s, task._resume)
        return task

    def schedule(self, delay_s: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the scheduler thread at ``now + delay_s``."""
        self._seq += 1
        heapq.heappush(
            self._heap, (self.now + max(0.0, delay_s), self._seq, fn))

    def call_later(self, delay_s: float,
                   fn: Callable[[], None]) -> _VTimer:
        timer = _VTimer(fn)
        self.schedule(delay_s, timer._fire)
        return timer

    def current_task(self) -> Optional[_Task]:
        return getattr(self._tls, "task", None)

    # -- task-side blocking primitives ---------------------------------
    def sleep(self, seconds: float) -> None:
        """Park the calling task for ``seconds`` of virtual time."""
        task = self.current_task()
        if task is None:
            # A scheduler-thread callback (timer) tried to sleep: that
            # would deadlock the whole kernel.  Framework timer
            # callbacks are flag-writes by design; refuse loudly.
            raise RuntimeError(
                "virtual sleep outside a sim task (timer callbacks "
                "must not block)")
        self.schedule(seconds, task._resume)
        task._park(f"sleep({seconds:.6g}s)")

    def block(self, token: WaitToken, timeout_s: Optional[float],
              reason: str) -> bool:
        """Park the calling task on ``token`` until :meth:`notify`
        resolves it (True) or ``timeout_s`` virtual seconds pass
        (False).  ``token`` must be fresh for this wait."""
        task = self.current_task()
        if task is None:
            raise RuntimeError(f"block({reason}) outside a sim task")
        token.task = task
        if timeout_s is not None:
            def _timeout(token=token, task=task):
                if token.state == "waiting":
                    token.state = "timeout"
                    task._resume()

            # kept on the token so notify() can cancel it: a stale
            # timeout must neither fire nor advance virtual time (a
            # 600s timeout on a get that resolves in 1ms would
            # otherwise drag the final scenario clock to 600s)
            token.timer = self.call_later(timeout_s, _timeout)
        task._park(reason)
        return token.state == "notified"

    def notify(self, token: WaitToken, value: Any = None,
               delay_s: float = 0.0) -> bool:
        """Resolve a parked token (from any task or timer context);
        the parked task resumes ``delay_s`` virtual seconds from now.
        Returns False when the token already timed out / was notified."""
        if token.state != "waiting":
            return False
        token.state = "notified"
        token.value = value
        if token.timer is not None:
            token.timer.cancel()
            token.timer = None
        self.schedule(delay_s, token.task._resume)
        return True

    # -- scheduler ------------------------------------------------------
    def _start_thread(self, task: _Task) -> threading.Thread:
        prev = threading.stack_size(self._stack_bytes)
        try:
            thread = threading.Thread(
                target=task._run, name=f"sim:{task.name}", daemon=True)
            thread.start()
        finally:
            threading.stack_size(prev)
        return thread

    def run(self, max_virtual_s: Optional[float] = None) -> None:
        """Dispatch events until the heap drains.  Raises the first
        task error (protocol bug), :class:`DeadlockError` when parked
        tasks can never wake, or :class:`SimTimeBudgetExceeded` past
        ``max_virtual_s``.  Installs the virtual clock on the calling
        (scheduler) thread too, so timer callbacks reading the clock
        see virtual time."""
        if self._running:
            raise RuntimeError("SimKernel.run is not reentrant")
        self._running = True
        prev_clock = core_clock.installed()
        core_clock.install(self.clock)
        try:
            while self._heap:
                when, _seq, fn = heapq.heappop(self._heap)
                owner = getattr(fn, "__self__", None)
                if isinstance(owner, _VTimer) and owner._cancelled:
                    # cancelled timers are inert AND must not advance
                    # virtual time — the scenario clock would otherwise
                    # read "timeout horizon", not "work done"
                    continue
                if max_virtual_s is not None and when > max_virtual_s:
                    self._abort_parked()
                    raise SimTimeBudgetExceeded(
                        f"virtual time {when:.3f}s exceeds the "
                        f"{max_virtual_s:.3f}s budget "
                        f"({self._parked_summary()})")
                if when > self.now:
                    self.now = when
                fn()
                if self._failed:
                    self._abort_parked()
                    raise self._failed[0].error
            parked = [t for t in self._tasks if not t.done]
            if parked:
                summary = self._parked_summary()
                self._abort_parked()
                raise DeadlockError(
                    f"event heap drained with {len(parked)} task(s) "
                    f"still parked: {summary}")
        finally:
            self._running = False
            core_clock.install(prev_clock)

    def _parked_summary(self) -> str:
        parked = [t for t in self._tasks if not t.done]
        shown = ", ".join(
            f"{t.name}: {t.blocked_reason}" for t in parked[:8])
        more = f" (+{len(parked) - 8} more)" if len(parked) > 8 else ""
        return shown + more

    def _abort_parked(self) -> None:
        """Force-unwind every still-parked task with VirtualExit so no
        thread outlives the kernel (tests run many kernels)."""
        for task in self._tasks:
            if task.done or task.thread is None:
                continue
            task._abort = True
            task.go.set()
            # Bounded wait: a task parked in _park always unwinds, but
            # if one is wedged in a REAL blocking call (a scenario bug)
            # we leak the daemon thread instead of hanging teardown.
            if self._control.wait(timeout=10.0):
                self._control.clear()
        for task in self._tasks:
            if task.thread is not None:
                task.thread.join(timeout=5.0)

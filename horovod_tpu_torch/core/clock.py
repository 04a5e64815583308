"""Injectable clock seam for every control-plane timing decision.

Counterpart of ``horovod_tpu/core/clock.py``, copied so that the port
imports nothing of the JAX package.  The control plane reads time in
four ways — ``monotonic()`` for durations and deadlines, ``wall()`` for
human-facing timestamps, ``sleep()`` for backoff/poll loops, and
``call_later()`` for one-shot timers.  The watchdog, the fault harness
and the retry policies route all four through this module instead of
calling :mod:`time` / :class:`threading.Timer` directly, so a test can
substitute a virtual clock.

Installation is **thread-local**: a clock installed on one thread
applies to that thread only; unregistered threads fall through to the
process-wide default, which is the real :class:`SystemClock` unless
overridden with :func:`set_default`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Clock:
    """Interface: the four timing primitives the control plane uses."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def wall(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> "Timer":
        raise NotImplementedError


class Timer:
    """Handle returned by :meth:`Clock.call_later`; ``cancel()`` is
    best-effort (the callback may already be running)."""

    def cancel(self) -> None:  # pragma: no cover - interface default
        pass


class _ThreadingTimer(Timer):
    def __init__(self, t: threading.Timer):
        self._t = t

    def cancel(self) -> None:
        self._t.cancel()


class SystemClock(Clock):
    """The real thing: time.monotonic / time.time / time.sleep /
    threading.Timer."""

    def monotonic(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> Timer:
        t = threading.Timer(max(0.0, delay_s), fn)
        t.daemon = True
        t.start()
        return _ThreadingTimer(t)


_SYSTEM = SystemClock()
_default: Clock = _SYSTEM
_tls = threading.local()


def get() -> Clock:
    """The clock for the *calling thread*: its thread-local override if
    one is installed, else the process default."""
    c = getattr(_tls, "clock", None)
    return c if c is not None else _default


def install(clock: Optional[Clock]) -> None:
    """Install ``clock`` as this thread's clock (None to uninstall)."""
    _tls.clock = clock


def installed() -> Optional[Clock]:
    """This thread's override, or None when running on the default."""
    return getattr(_tls, "clock", None)


def set_default(clock: Optional[Clock]) -> None:
    """Replace the process-wide default (None restores SystemClock).
    Tests only; production leaves the SystemClock in place."""
    global _default
    _default = clock if clock is not None else _SYSTEM


# Convenience free functions — call sites read as ``clock.monotonic()``
# which keeps diffs against the old ``time.monotonic()`` spelling small.

def monotonic() -> float:
    return get().monotonic()


def wall() -> float:
    return get().wall()


def sleep(seconds: float) -> None:
    get().sleep(seconds)


def call_later(delay_s: float, fn: Callable[[], None]) -> Timer:
    return get().call_later(delay_s, fn)

"""Async handles for the collectives of the async controller.

Counterpart of ``horovod_tpu/api/handles.py`` (parity: the handle table
of the reference torch binding, ``horovod/torch/handle_manager.cc`` with
``synchronize``/``poll`` in horovod/torch/mpi_ops.py).

A handle is an integer naming an ``OpFuture`` of the controller (or any
object with ``result()`` and ``done()``), a callable, or a finished
value.  ``synchronize`` blocks the host until the future resolves, then
makes the caller's current CUDA stream wait on the executor's done event
(``OpFuture.result``): a tensor it returns is ready on the caller's
stream, as ``jax.block_until_ready`` makes the reference's ready.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class HandleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._results: Dict[int, Any] = {}

    def allocate(self, value) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = value
            return h

    def synchronize(self, handle: int):
        with self._lock:
            if handle not in self._results:
                raise ValueError(
                    f"unknown or already-synchronized handle {handle}")
            value = self._results.pop(handle)
        if hasattr(value, "result") and hasattr(value, "done"):
            return value.result()
        if callable(value):
            return value()
        return value

    def poll(self, handle: int) -> bool:
        with self._lock:
            value = self._results.get(handle)
        if value is None:
            return True  # unknown / already-synchronized handles are done
        if hasattr(value, "result") and hasattr(value, "done"):
            return bool(value.done())
        return not callable(value)


_manager = HandleManager()


def manager() -> HandleManager:
    return _manager

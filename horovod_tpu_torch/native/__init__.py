"""The negotiation core of the PyTorch port (counterpart of
``horovod_tpu/native``).

- ``src/``        the C++17 core, the port's own copy, built by
                  ``_build.py`` with g++ at first use into
                  ``build/horovod_tpu_torch/``
- ``core.py``     its ctypes bindings (``NativeController``,
                  ``NativeTimeline``, the thread pool's gather/scatter,
                  the GP)
- ``wire.py``     the coordination wire format, version 5
- ``fallback.py`` the negotiation core in Python (``PyController``)

Both cores speak the same wire, so mixed fleets coordinate.
``make_controller`` returns the C++ core unless
``HVTPU_FORCE_PY_CONTROLLER`` is set; unlike the JAX package it does not
fall back quietly to Python when the C++ core fails to build or load, it
raises.
"""

from __future__ import annotations

import os

from . import core, fallback, wire


def native_available() -> bool:
    return core.available()


def make_controller(rank: int, size: int, fusion_threshold: int,
                    cache_capacity: int = 1024, stall_warn_s: float = 60.0,
                    stall_abort_s: float = 0.0, resync_every: int = None):
    """The negotiation core of one rank: the C++ core, or the Python one
    when ``HVTPU_FORCE_PY_CONTROLLER`` is set (a failed build or load of
    the C++ core raises and names that variable).  ``resync_every`` is
    the steady-state bypass cadence (every Nth all-cache-hit cycle sends
    a full resync blob; 0 disables bypass); it defaults to
    ``HVTPU_CACHE_RESYNC_EVERY`` or 64.  Every rank must agree on the
    value: it shapes the wire traffic, not the decisions."""
    if resync_every is None:
        resync_every = int(os.environ.get("HVTPU_CACHE_RESYNC_EVERY", "64"))
    cls = (fallback.PyController
           if os.environ.get("HVTPU_FORCE_PY_CONTROLLER")
           else core.NativeController)
    return cls(rank, size, fusion_threshold, cache_capacity,
               stall_warn_s, stall_abort_s, resync_every=resync_every)


__all__ = [
    "core", "fallback", "wire", "native_available", "make_controller",
]

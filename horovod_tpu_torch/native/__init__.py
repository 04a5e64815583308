"""The negotiation core of the PyTorch port (counterpart of
``horovod_tpu/native``).

- ``wire.py``     the coordination wire format, version 5
- ``fallback.py`` the negotiation core in Python (``PyController``)

The JAX package also builds a C++ core (``horovod_tpu/native/src``,
``core.py``) that speaks the same wire; the port has only the Python
core so far, so ``make_controller`` always returns it.
"""

from __future__ import annotations

import os

from . import fallback, wire


def make_controller(rank: int, size: int, fusion_threshold: int,
                    cache_capacity: int = 1024, stall_warn_s: float = 60.0,
                    stall_abort_s: float = 0.0, resync_every: int = None):
    """The negotiation core of one rank.  ``resync_every`` is the
    steady-state bypass cadence (every Nth all-cache-hit cycle sends a
    full resync blob; 0 disables bypass); it defaults to
    ``HVTPU_CACHE_RESYNC_EVERY`` or 64.  Every rank must agree on the
    value: it shapes the wire traffic, not the decisions."""
    if resync_every is None:
        resync_every = int(os.environ.get("HVTPU_CACHE_RESYNC_EVERY", "64"))
    return fallback.PyController(
        rank, size, fusion_threshold, cache_capacity,
        stall_warn_s, stall_abort_s, resync_every=resync_every,
    )


__all__ = ["fallback", "wire", "make_controller"]

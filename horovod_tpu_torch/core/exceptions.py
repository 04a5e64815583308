"""Exception types of the PyTorch port.

Counterpart of ``horovod_tpu/core/exceptions.py``: the same seven
classes in the same hierarchy, copied so that the port imports nothing
of the JAX package.  ``HorovodInternalError`` and
``HostsUpdatedInterrupt`` are the two the elastic run wrapper catches
(``elastic/worker.py``); ``DrainInterrupt`` is the latter raised on the
ranks that stay when a peer drains (``core/preempt.py``).
"""


class HorovodTpuError(Exception):
    """Base class for all errors of the port."""


class NotInitializedError(HorovodTpuError):
    """An API requiring ``init()`` was called before init."""

    def __init__(self, name: str = "operation"):
        super().__init__(
            f"horovod_tpu_torch has not been initialized; call "
            f"horovod_tpu_torch.init() before using {name}."
        )


class StallError(HorovodTpuError):
    """The stall inspector declared a rank permanently missing."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed (comm failure, desync, a peer that
    shut down, a controller that stopped with the op in flight)."""


class HvtpuMismatchError(HorovodInternalError):
    """Ranks submitted conflicting metadata for the same tensor name.

    The coordinator found that member ranks announced different (op
    type, reduction op, dtype, shape, root rank) for one tensor name;
    the error text names each offending rank and what it submitted, and
    every member rank raises it instead of stalling (parity: the
    reference controller's "Mismatched ..." error responses).
    """


class HvtpuDivergenceError(HorovodInternalError):
    """The parameter divergence audit found replicas that differ.

    Raised by ``core/audit.py`` under ``HVTPU_AUDIT_ACTION=abort``.
    Subclasses :class:`HorovodInternalError` so an elastic training
    loop rolls back to the last commit and the world is relaunched from
    verified-identical state.
    """


class HostsUpdatedInterrupt(HorovodTpuError):
    """The set of participating hosts changed (elastic membership).

    Raised at a commit boundary after the host-update notification
    (SIGUSR1) arrived; the training loop re-initializes with the new
    world without rolling back state.
    """

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class DrainInterrupt(HostsUpdatedInterrupt):
    """A member rank is draining after a preemption notice
    (``core/preempt.py``); raised on the REMAINING ranks at the agreed
    drain-commit boundary.

    The drain commit already persisted this step, so the committed
    state stands: no rollback.  Subclasses
    :class:`HostsUpdatedInterrupt` so training loops that catch the
    parent keep working; the elastic run wrapper catches this first to
    count the reset as ``peer_drain``.
    """

    def __init__(self, rank: int = -1):
        super().__init__(skip_sync=False)
        #: rank that announced the departure (-1 if unknown)
        self.rank = rank

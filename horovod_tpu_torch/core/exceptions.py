"""Exception types of the PyTorch port.

Counterpart of ``horovod_tpu/core/exceptions.py``: the classes this part
of the port raises, copied so that the port imports nothing of the JAX
package.
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

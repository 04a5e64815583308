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

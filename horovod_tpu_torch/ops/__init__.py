"""Hand-written CUDA kernels of the PyTorch port and their plain PyTorch
versions (counterpart of ``horovod_tpu/ops``)."""

from .scale_cast import fused_scale_cast, fused_scale_cast_plain

__all__ = ["fused_scale_cast", "fused_scale_cast_plain"]

"""Hand-written CUDA kernels of the PyTorch port and their plain PyTorch
versions (counterpart of ``horovod_tpu/ops``)."""

from .norm import batch_norm_plain, fused_norm
from .quantize import (
    QBLOCK,
    dequantize_int8_blocks,
    dequantize_int8_blocks_plain,
    quantize_int8_blocks,
    quantize_int8_blocks_plain,
)
from .ring import (
    ring_allgather_2d,
    ring_allgather_2d_plain,
    ring_allreduce,
    ring_allreduce_plain,
)
from .scale_cast import (
    fused_scale_cast,
    fused_scale_cast_plain,
    scale_cast_pack,
    scale_cast_pack_plain,
    unpack_cast_scale,
    unpack_cast_scale_plain,
)

__all__ = [
    "fused_scale_cast", "fused_scale_cast_plain",
    "scale_cast_pack", "scale_cast_pack_plain",
    "unpack_cast_scale", "unpack_cast_scale_plain",
    "QBLOCK", "quantize_int8_blocks", "quantize_int8_blocks_plain",
    "dequantize_int8_blocks", "dequantize_int8_blocks_plain",
    "ring_allreduce", "ring_allreduce_plain",
    "ring_allgather_2d", "ring_allgather_2d_plain",
    "fused_norm", "batch_norm_plain",
]

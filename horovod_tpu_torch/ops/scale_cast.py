"""``fused_scale_cast``: ``cast(x.float() * scale)`` in one pass.

Counterpart of ``horovod_tpu/ops/pallas_ops.py`` ``fused_scale_cast``
(its Pallas body ``_scale_cast_kernel``): the pre/postscale around a
fused allreduce.  On a CUDA tensor the wrapper launches the hand-written
kernel of ``csrc/scale_cast.cu`` on the current stream and counts the
launch in ``fused_scale_cast.launches``; on a CPU tensor it computes the
plain version, ``fused_scale_cast_plain``.  There is no other path: a
CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _f32(scale: float) -> float:
    """``scale`` rounded to float32, the precision both versions use."""
    return ctypes.c_float(float(scale)).value


def fused_scale_cast_plain(x: torch.Tensor, scale: float,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``(x.float() * f32(scale)).to(out_dtype)``."""
    return (x.float() * _f32(scale)).to(out_dtype or x.dtype)


def _kernel_fn():
    fn = _build.load("scale_cast").hvtpu_scale_cast
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_scale_cast(x: torch.Tensor, scale: float,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """``cast(x.float() * scale)`` over a contiguous 1-D tensor.

    ``x`` and ``out_dtype`` (default ``x.dtype``) are float32, bfloat16
    or float16; ``scale`` is rounded to float32.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return fused_scale_cast_plain(x, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_scale_cast: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(
            f"fused_scale_cast: {x.dtype} -> {out_dtype} is not supported "
            "(float32, bfloat16, float16)")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(
            "fused_scale_cast: expects a contiguous 1-D tensor, got "
            f"shape {tuple(x.shape)} strides {x.stride()}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(x.data_ptr(), out.data_ptr(), n,
                           _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
                           _f32(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_scale_cast: kernel launch failed with cudaError {err}")
    fused_scale_cast.launches += 1
    return out


fused_scale_cast.launches = 0

"""Gradient wire compression (parity: horovod/torch/compression.py
``Compression.none`` / ``fp16``; counterpart of
``horovod_tpu/torch/compression.py``).

``compress`` casts a float32/float64 gradient to the wire dtype before
the collective and returns the original dtype as its context;
``decompress`` casts back.  Other dtypes ride the wire unchanged.
"""

from __future__ import annotations

import torch


class Compressor:
    """Interface: compress(tensor) -> (tensor, ctx); decompress(tensor, ctx)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class NoneCompressor(Compressor):
    pass


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor: torch.Tensor):
        if tensor.dtype in (torch.float32, torch.float64):
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class FP16Compressor(_CastCompressor):
    """Cast fp32/fp64 gradients to fp16 on the wire, cast back after."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 wire format (same exponent range as fp32, so no overflow
    risk on un-normalized gradient sums)."""

    wire_dtype = torch.bfloat16


class Compression:
    """Namespace matching ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

"""The engine's wire codecs (counterpart of
``horovod_tpu/comm/compression.py``).

``compress(tensor) -> (wire, ctx)`` before the collective,
``decompress(wire, ctx)`` after; ``wire_dtype(dtype)`` is the dtype that
crosses the wire.  ``fp16`` / ``bf16`` cast every floating tensor;
``int8`` quantizes it in 1024-element blocks with one float32 absmax
scale each (kernels A2/A3, ``ops/quantize.py``), and ``int8_stochastic``
rounds stochastically, keyed by :func:`_stochastic_seed`.  Other dtypes
ride the wire unchanged.

This is the engine's namespace, reached as
``horovod_tpu_torch.comm.compression.Compression``; the torch surface's
``hvd.Compression`` (``torch/compression.py``) maps onto it.
"""

from __future__ import annotations

import itertools

import torch

from ..ops.quantize import (
    LANES,
    QBLOCK,
    dequantize_int8_blocks,
    quantize_int8_blocks,
)

_STOCH_CALL_COUNTER = itertools.count()
_M32 = 0xFFFFFFFF


def _rank_salt() -> int:
    from ..core import state as core_state

    st = core_state.global_state()
    rank = st.rank if st.initialized else 0
    return (rank * 1_000_003) & 0x7FFFFFFF


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2**32 into int32, two's complement."""
    return (((x + 2 ** 31) & _M32) - 2 ** 31).to(torch.int32)


def _payload_fold(flat: torch.Tensor) -> torch.Tensor:
    """int32 wrapping sum of the payload's bits in its own width (2-byte
    dtypes sign-extended from int16), on the payload's device."""
    if flat.element_size() == 2:
        bits = flat.view(torch.int16)
    elif flat.dtype == torch.float32:
        bits = flat.view(torch.int32)
    else:
        bits = flat.to(torch.float32).view(torch.int32)
    return wrap_int32(bits.sum(dtype=torch.int64))


def _stochastic_seed(flat: torch.Tensor) -> torch.Tensor:
    """Seed of stochastic rounding: a device int32, the fold of the
    payload's bits XOR a salt of the process rank and a per-process call
    counter.  Computed on the device: no host sync."""
    salt = (_rank_salt() ^ (next(_STOCH_CALL_COUNTER) * 0x9E3779B1)) \
        & 0x7FFFFFFF
    return _payload_fold(flat) ^ salt


class Compressor:
    """Interface: compress before the collective, decompress after."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @staticmethod
    def wire_dtype(dtype):
        return dtype


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire: torch.dtype

    @classmethod
    def compress(cls, tensor):
        ctx = tensor.dtype
        if tensor.is_floating_point():
            tensor = tensor.to(cls.wire)
        return tensor, ctx

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None and tensor.dtype != ctx:
            tensor = tensor.to(ctx)
        return tensor

    @classmethod
    def wire_dtype(cls, dtype):
        return cls.wire if dtype.is_floating_point else dtype


class FP16Compressor(_CastCompressor):
    """Cast floating tensors to fp16 on the wire, back after."""

    wire = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 wire format."""

    wire = torch.bfloat16


class Int8Compressor(Compressor):
    """Block-scaled int8: codes ``(nblocks, 1024) int8`` on the wire, the
    float32 per-block scales in the context."""

    BLOCK = QBLOCK
    STOCHASTIC = False

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        flat = tensor.reshape(-1)
        q, scale, n = quantize_int8_blocks(
            flat.contiguous(), stochastic=cls.STOCHASTIC,
            seed=_stochastic_seed(flat) if cls.STOCHASTIC else 0)
        return (q.reshape(-1, cls.BLOCK),
                (tensor.dtype, tuple(tensor.shape), n, scale))

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None:
            return tensor
        dtype, shape, n, scale = ctx
        # the kernel writes f32/bf16/f16 directly (one rounding, as the
        # reference's f32 dequantize then cast); wider dtypes widen f32
        out_dtype = dtype if dtype in (torch.float32, torch.bfloat16,
                                       torch.float16) else torch.float32
        deq = dequantize_int8_blocks(tensor.reshape(-1, LANES), scale, n,
                                     dtype=out_dtype)
        return deq.reshape(shape).to(dtype)

    @staticmethod
    def wire_dtype(dtype):
        return torch.int8 if dtype.is_floating_point else dtype


class Int8StochasticCompressor(Int8Compressor):
    """Int8 with stochastic rounding: unbiased quantisation noise, so
    the rounding error does not add up over ranks in a summation."""

    STOCHASTIC = True


class Compression:
    """Namespace matching the reference API: ``Compression.none`` etc."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int8_stochastic = Int8StochasticCompressor

    @staticmethod
    def from_name(name: str):
        try:
            return {
                "none": NoneCompressor,
                "fp16": FP16Compressor,
                "bf16": BF16Compressor,
                "int8": Int8Compressor,
                "int8_stochastic": Int8StochasticCompressor,
            }[name]
        except KeyError:
            raise ValueError(f"unknown compression {name!r}") from None


"""Gradient compression intents of the TensorFlow frontend (counterpart
of ``horovod_tpu/tensorflow/compression.py``; parity:
horovod/tensorflow/compression.py).  As in the torch frontend, the wire
codec runs inside the engine: these classes say what the user asks for
and are mapped onto the engine's codec at the op boundary
(``mpi_ops._engine_compression``)."""

from __future__ import annotations


class Compressor:
    """Interface parity: compress/decompress are the identity at the TF
    layer; the engine compresses on the wire."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class NoneCompressor(Compressor):
    pass


class FP16Compressor(Compressor):
    pass


class BF16Compressor(Compressor):
    """bfloat16 wire format."""


class Compression:
    """Parity: hvd.Compression.{none,fp16} (and bf16)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor

"""Block-absmax int8 quantize (A2) and dequantize (A3).

Counterpart of ``horovod_tpu/ops/pallas_ops.py`` ``quantize_int8_blocks``
/ ``dequantize_int8_blocks`` (Pallas bodies ``_quantize_kernel`` and
``_dequantize_kernel``), the codec of the engine's ``Compression.int8``
and ``Compression.int8_stochastic``.  On a CUDA tensor each wrapper
launches its hand-written kernel of ``csrc/quantize_int8.cu`` on the
current stream and counts the launch (``quantize_int8_blocks.launches``,
``dequantize_int8_blocks.launches``); on a CPU tensor it computes the
plain version beside it.  There is no other path: a CUDA tensor the
kernel cannot take raises.  The codec's callers launch one tensor at a
time, so a call's host cost counts as much as its kernel: the
prototypes are set once, the stream is the raw current one, and a
device context is entered only for a tensor off the current device.
``csrc/quantize_int8.cu`` notes the kernels' design and bound.

Both versions compute what the TPU kernel computes, including the TPU's
float32 semantics that PyTorch does not share:

* a float32 input, scale or product whose magnitude is below
  ``FLT_MIN`` counts as 0 (the TPU, and XLA on the CPU, flush
  subnormals);
* the absmax propagates NaN, so a block holding NaN gets scale NaN, and
  a NaN code is clipped to 0 (a block holding inf gets scale inf and
  codes 0).

Stochastic rounding draws ``u`` from a counter-based hash of (seed,
element index), ``u = (bits >> 9) * 2**-23``; the plain version
reproduces the hash with int64 torch ops, so the two agree bitwise.  The
TPU's own random stream cannot be matched.  The seed is a device int32
tensor: computing it never syncs the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

LANES = 128
QROWS = 8
QBLOCK = QROWS * LANES        # elements per block; one f32 scale each
FLT_MIN = 2.0 ** -126
INV_127 = 1.0 / 127.0         # rounds to f32 0x1.020408p-7 in a tensor
_M32 = 0xFFFFFFFF

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# -- layout ---------------------------------------------------------------

def num_blocks(n: int) -> int:
    return -(-n // QBLOCK)


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` as float32 ``(nblocks, QBLOCK)``, zero-padded at the end."""
    x = flat.to(torch.float32)
    pad = num_blocks(x.numel()) * QBLOCK - x.numel()
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(-1, QBLOCK)


# -- the shared formula -----------------------------------------------------

def flush(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals as 0, as the TPU computes (NaN stays)."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def block_scale_inv(xg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, inv) of float32 blocks ``xg (g, B)`` already flushed:
    ``scale = absmax * f32(1/127)`` (a scale below FLT_MIN is 0),
    ``inv = 1/scale`` or 0 where the scale is not positive."""
    absmax = xg.abs().amax(dim=1, keepdim=True)     # amax keeps NaN
    scale = flush(absmax * INV_127)
    pos = scale > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, 1.0),
                      torch.zeros_like(scale))
    return scale, inv


def fma_f32(q: torch.Tensor, s: torch.Tensor, x: torch.Tensor
            ) -> torch.Tensor:
    """float32 ``q * s + x`` rounded once, as one fused multiply-add (the
    card's ``__fmaf_rn``, XLA's fused dequantize-and-add) computes it;
    ``q * s`` must be exact in float64 (an int8 code times a float32).
    The float64 sum is rounded to odd (its error, from TwoSum, moves an
    inexact even result one step toward the exact value), so rounding it
    to float32 cannot round twice."""
    p = q.to(torch.float64) * s.to(torch.float64)
    c = x.to(torch.float64)
    t = p + c
    back = t - p
    err = (p - (t - back)) + (c - back)
    bits = t.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0) & torch.isfinite(t)
    step = torch.where((err > 0) == (t > 0), 1, -1)
    return torch.where(odd, bits + step, bits).view(torch.float64).to(
        torch.float32)


def round_codes(t: torch.Tensor, u: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """int8 codes: ``rint(t)``, or ``floor(t + u)`` when ``u`` is given;
    NaN to 0, then clipped to [-127, 127]."""
    r = torch.round(t) if u is None else torch.floor(t + u)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return r.clamp(-127.0, 127.0).to(torch.int8)


# -- the counter-based generator --------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32), with no
    intermediate past 2**49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 tensors holding uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dither_bits(key: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """32 random bits of (key, counter), as the kernel's
    ``dither_bits``; int64 tensors holding uint32, broadcast."""
    key = key.to(torch.int64) & _M32
    ctr = ctr.to(torch.int64) & _M32
    return _mix32(_mix32((_mul32(ctr, 0x9E3779B1) + key) & _M32) ^ key)


def uniform(key: torch.Tensor, numel: int) -> torch.Tensor:
    """float32 ``u`` in [0, 1) of elements 0..numel-1 under ``key``:
    23 random bits over 2**23."""
    ctr = torch.arange(numel, dtype=torch.int64, device=key.device)
    bits = dither_bits(key.reshape(()), ctr)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


# -- plain versions ---------------------------------------------------------

def _seed_tensor(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(seed), dtype=torch.int64,
                        device=device).to(torch.int32)


def quantize_int8_blocks_plain(flat: torch.Tensor, *,
                               stochastic: bool = False, seed=0):
    """Plain PyTorch version of :func:`quantize_int8_blocks`."""
    xg = flush(_blocks(flat))
    scale, inv = block_scale_inv(xg)
    t = flush(xg * inv)
    u = None
    if stochastic:
        u = uniform(_seed_tensor(seed, flat.device), t.numel())
        u = u.reshape(t.shape)
    q = round_codes(t, u)
    return q.reshape(-1, LANES), scale, flat.numel()


def dequantize_int8_blocks_plain(q: torch.Tensor, scale: torch.Tensor,
                                 n: int, dtype=torch.float32
                                 ) -> torch.Tensor:
    """Plain PyTorch version of :func:`dequantize_int8_blocks`."""
    g = q.shape[0] // QROWS
    s = flush(scale.to(torch.float32)).reshape(g, 1)
    out = q.to(torch.float32).reshape(g, QBLOCK) * s
    return out.reshape(-1)[:n].to(dtype)


# -- the kernels ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("quantize_int8")
    q, d = lib.hvtpu_quantize_int8, lib.hvtpu_dequantize_int8
    q.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p]
    q.restype = ctypes.c_int
    d.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    d.restype = ctypes.c_int
    return q, d


def _call(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` on the current stream of device ``index``,
    entering a device context only when ``index`` is not the current
    device (the usual case costs no context)."""
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def quantize_int8_blocks(flat: torch.Tensor, *, stochastic: bool = False,
                         seed=0):
    """Block-absmax int8 quantisation of a 1-D float tensor.

    Returns ``(codes, scales, n)``: codes ``(rows, 128) int8`` (rows a
    multiple of 8, zero-padded), scales ``(rows/8, 1) f32``, one per
    1024-element block, and the element count ``n``.  ``seed`` (a device
    int32 tensor, or an int) keys the stochastic rounding.
    """
    if not flat.is_cuda:
        if flat.device.type == "cpu":
            return quantize_int8_blocks_plain(flat, stochastic=stochastic,
                                              seed=seed)
        raise ValueError(
            f"quantize_int8_blocks: unsupported device {flat.device}")
    if flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError(
            "quantize_int8_blocks: expects a contiguous 1-D tensor, got "
            f"shape {tuple(flat.shape)} strides {flat.stride()}")
    code = _DTYPE_CODE.get(flat.dtype)
    if code is None:
        if not flat.is_floating_point():
            raise TypeError(f"quantize_int8_blocks: {flat.dtype} is not a "
                            "floating dtype")
        flat = flat.to(torch.float32)    # as the reference pre-casts f64
        code = 0
    n = flat.numel()
    g = num_blocks(n)
    codes = flat.new_empty((g * QROWS, LANES), dtype=torch.int8)
    scales = flat.new_empty((g, 1), dtype=torch.float32)
    if n == 0:
        return codes, scales, n
    seed_t = _seed_tensor(seed, flat.device) if stochastic else None
    err = _call(_library()[0], flat.get_device(), flat.data_ptr(), code, n,
                codes.data_ptr(), scales.data_ptr(),
                None if seed_t is None else seed_t.data_ptr(),
                int(stochastic))
    if err != 0:
        raise RuntimeError(
            f"quantize_int8_blocks: kernel launch failed with cudaError {err}")
    quantize_int8_blocks.launches += 1
    return codes, scales, n


def dequantize_int8_blocks(q: torch.Tensor, scale: torch.Tensor, n: int,
                           dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_blocks`: a 1-D tensor of ``n``
    elements of ``dtype`` (float32, bfloat16 or float16 on the card)."""
    shape = q.shape
    if len(shape) != 2 or shape[1] != LANES or shape[0] % QROWS:
        raise ValueError(
            f"dequantize_int8_blocks: codes must be (rows, {LANES}) with "
            f"rows a multiple of {QROWS}, got {tuple(shape)}")
    if not 0 <= n <= q.numel():
        raise ValueError(f"dequantize_int8_blocks: n={n} out of range")
    if not q.is_cuda:
        if q.device.type == "cpu":
            return dequantize_int8_blocks_plain(q, scale, n, dtype)
        raise ValueError(
            f"dequantize_int8_blocks: unsupported device {q.device}")
    code = _DTYPE_CODE.get(dtype)
    if code is None:
        raise TypeError(f"dequantize_int8_blocks: output {dtype} is not "
                        "supported (float32, bfloat16, float16)")
    index = q.get_device()
    if (q.dtype != torch.int8 or scale.dtype != torch.float32
            or scale.numel() != shape[0] // QROWS
            or scale.get_device() != index):
        raise TypeError(
            "dequantize_int8_blocks: expects int8 codes and one float32 "
            f"scale a block on {q.device}, got {q.dtype} codes and "
            f"{scale.numel()} {scale.dtype} scales on {scale.device}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequantize_int8_blocks: codes and scales must "
                         "be contiguous")
    out = q.new_empty(n, dtype=dtype)
    if n == 0:
        return out
    err = _call(_library()[1], index, q.data_ptr(), scale.data_ptr(), n,
                out.data_ptr(), code)
    if err != 0:
        raise RuntimeError(
            "dequantize_int8_blocks: kernel launch failed with cudaError "
            f"{err}")
    dequantize_int8_blocks.launches += 1
    return out


quantize_int8_blocks.launches = 0
dequantize_int8_blocks.launches = 0

"""Ring collectives over the virtual ranks of one card: the all-gather
(A4), the allreduce (A5) and the per-hop requantizing int8 allreduce
(A6).

Counterpart of ``horovod_tpu/ops/ring.py`` (Pallas bodies
``_allgather_kernel``, ``_allreduce_kernel`` and
``_quantized_allreduce_kernel``).  The JAX functions run once per rank
inside ``shard_map``; these take one tensor per rank and return one
output per rank, the counterpart of a ``shard_map`` body over an
``n``-rank axis.  On CUDA tensors every rank's buffers sit in one card's
memory and one cooperative launch of ``csrc/ring.cu`` runs every rank,
through the reference's protocol: double-buffered slots per phase,
per-slot receive flags and ACK backpressure.  Each wrapper counts its
launches (``ring_allgather_2d.launches``, ``ring_allreduce.launches``
for A5, ``ring_allreduce.quantized_launches`` for A6).  CPU tensors
take the plain versions beside them, which walk the same ring hop by
hop with the same arithmetic.  There is no other path: CUDA tensors the
kernel cannot take raise, and ranks on more than one card raise
``NotImplementedError`` (peer-mapped memory across cards is later
work).

Arithmetic, as the reference computes it on the CPU (float32 subnormals
count as 0):

* A5 sums chunk ``c`` in ring order, ``((x_c + x_{c+1}) + ...) +
  x_{c+n-1}`` (ranks mod n), one rounding an addition; every rank gets
  the same bits, which are not those of ``x.sum(0)``.
* A6 sends int8 codes and one float32 scale per 1024 elements on every
  hop.  A reduce-scatter hop requantizes the running sum (the scale
  formula of A2, ``ops/quantize.py``) and accumulates with one fused
  multiply-add, ``fma(float(q), s, x_local)``; the owner of a reduced
  chunk quantizes it once, keeps ``q0 * s0`` and the all-gather relays
  those codes verbatim, so every rank dequantizes the same bytes.
* Average multiplies by ``f32(1/n)``; integers take the exact sum in
  their dtype and Average floor-divides; ``n == 1`` is a float32 round
  trip with no kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build
from .quantize import QBLOCK, block_scale_inv, flush, fma_f32, round_codes

LANES = 128
ROW_QUANTUM = 8               # a rank's chunk is a multiple of 8 rows
SLICE = 8 * QBLOCK            # elements a CUDA block carries a hop


# -- shapes and checks --------------------------------------------------------

def chunk_elems(size: int, n: int) -> int:
    """Elements of each rank's chunk: ``size`` zero-padded to a multiple
    of ``n * 8 * 128``, over ``n``."""
    quantum = n * ROW_QUANTUM * LANES
    return -(-size // quantum) * quantum // n


def _ranks(tensors: Sequence[torch.Tensor], what: str
           ) -> Tuple[List[torch.Tensor], torch.device]:
    tensors = list(tensors)
    if not tensors:
        raise ValueError(f"{what}: needs one tensor per rank, got none")
    first = tensors[0]
    for r, t in enumerate(tensors):
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(
                f"{what}: rank {r} holds {t.dtype} {tuple(t.shape)}, rank 0 "
                f"{first.dtype} {tuple(first.shape)}")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        if all(d.type == "cuda" for d in devices):
            raise NotImplementedError(
                f"{what}: ranks on more than one card need peer-mapped "
                "memory, not ported yet (ROADMAP Queue A item 4)")
        raise ValueError(
            f"{what}: ranks on mixed devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    return tensors, device


# -- plain versions -----------------------------------------------------------

def _stacked_chunks(flats: Sequence[torch.Tensor], e: int) -> torch.Tensor:
    """``(n, n, e)`` float32: ``[r, c]`` is rank r's chunk c, flushed,
    zero-padded past the end."""
    n, size = len(flats), flats[0].numel()
    x = flats[0].new_zeros((n, n * e))
    x[:, :size] = torch.stack(list(flats))
    return flush(x).reshape(n, n, e)


def _quantize_chunks(acc: torch.Tensor):
    """``(n, e)`` float32 -> int8 codes ``(n, e)`` and scales
    ``(n, e/1024, 1)``: A2's deterministic formula."""
    n, e = acc.shape
    xg = flush(acc).reshape(n * (e // QBLOCK), QBLOCK)
    scale, inv = block_scale_inv(xg)
    q = round_codes(flush(xg * inv))
    return q.reshape(n, e), scale.reshape(n, e // QBLOCK, 1)


def _dequantize_chunks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    n, e = q.shape
    return (q.to(torch.float32).reshape(n, e // QBLOCK, QBLOCK)
            * scale).reshape(n, e)


def _ring_sum_plain(flats: Sequence[torch.Tensor], quantized: bool
                    ) -> List[torch.Tensor]:
    """The reduce-scatter and all-gather of A5 (A6 when ``quantized``)
    over float32 1-D tensors, hop by hop: at hop k the running sum of
    chunk c sits on rank c+k-1 and rank c+k adds its own chunk c."""
    n, size = len(flats), flats[0].numel()
    e = chunk_elems(size, n)
    x = _stacked_chunks(flats, e)
    c = torch.arange(n, device=x.device)
    acc = x[c, c]                                   # (n, e): chunk c at rank c
    for k in range(1, n):
        local = x[(c + k) % n, c]
        if quantized:
            q, s = _quantize_chunks(acc)
            acc = flush(fma_f32(q.reshape(n, -1, QBLOCK), s,
                                local.reshape(n, -1, QBLOCK)).reshape(n, e))
        else:
            acc = flush(acc + local)
    if quantized:
        acc = _dequantize_chunks(*_quantize_chunks(acc))
    out = acc.reshape(-1)[:size]
    return [out] + [out.clone() for _ in range(n - 1)]


def _allreduce(tensors, average: bool, quantized: bool, plain: bool,
               what: str) -> List[torch.Tensor]:
    """The wrapper's semantics around the ring; ``plain`` forces the
    plain version, else CPU tensors take it and CUDA tensors the kernel."""
    tensors, device = _ranks(tensors, what)
    n, shape, dtype = len(tensors), tensors[0].shape, tensors[0].dtype
    if not dtype.is_floating_point:
        # integers: the exact sum in their own dtype (the reference's
        # psum), Average floor-divides
        out = torch.stack(tensors).sum(0, dtype=dtype)
        if average:
            out = out.floor_divide(n)
        return [out] + [out.clone() for _ in range(n - 1)]
    if n == 1:
        return [tensors[0].to(torch.float32).to(dtype).clone()]
    flats = [t.reshape(-1).to(torch.float32) for t in tensors]
    reduce_fn = (_ring_sum_plain if plain or device.type == "cpu"
                 else _ring_sum_kernel)
    outs = (reduce_fn(flats, quantized) if flats[0].numel()
            else [f.clone() for f in flats])
    if average:
        recip = torch.tensor(1.0 / n, dtype=torch.float32, device=device)
        outs = [flush(o.mul_(recip)) for o in outs]
    return [o.reshape(shape).to(dtype) for o in outs]


def ring_allreduce_plain(tensors: Sequence[torch.Tensor], *,
                         average: bool = False, quantized: bool = False
                         ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`ring_allreduce`."""
    return _allreduce(tensors, average, quantized, True,
                      "ring_allreduce_plain")


def _check_blocks(blocks, what: str):
    blocks, device = _ranks(blocks, what)
    b = blocks[0]
    if b.dim() != 2 or b.shape[1] != LANES or b.dtype != torch.float32:
        raise ValueError(f"{what}: expects float32 (CH, {LANES}) blocks, got "
                         f"{b.dtype} {tuple(b.shape)}")
    return blocks, device


def ring_allgather_2d_plain(blocks: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`ring_allgather_2d`: at hop i rank
    r receives from rank r-1 the block of rank r-i-1."""
    blocks, _ = _check_blocks(blocks, "ring_allgather_2d_plain")
    n, ch = len(blocks), blocks[0].shape[0]
    outs = [blocks[0].new_empty((n * ch, LANES)) for _ in range(n)]
    held = list(blocks)
    for r in range(n):
        outs[r][r * ch:(r + 1) * ch] = held[r]
    for i in range(n - 1):
        held = [held[(r - 1) % n] for r in range(n)]
        for r in range(n):
            src = (r - i - 1) % n
            outs[r][src * ch:(src + 1) * ch] = held[r]
    return outs


# -- the kernels --------------------------------------------------------------

def _kernels():
    lib = _build.load("ring")
    fns = (lib.hvtpu_ring_allgather, lib.hvtpu_ring_allreduce)
    if fns[0].argtypes is None:
        for fn in fns:
            # table, n, size, chunk, slice, quantized, stream
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fns


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel loads
    16 bytes a thread); a copy only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, what: str, xs, outs, slot_bytes: int, scale_slot_bytes: int,
            size: int, e: int, quantized: bool) -> None:
    """One cooperative launch over every rank.  Per rank the pointer table
    holds (input, output, 4 slots, 4 scale slots, flags); slots and
    flags of all ranks come from one allocation each.  The flags start
    at 0 on the launch stream: on one card stream order then rules out a
    stale flag from the previous call (ranks in separate processes will
    need epochs instead)."""
    n, device = len(xs), xs[0].device
    nslices = -(-e // SLICE)
    slots = torch.empty((n, 4 * slot_bytes + 4 * scale_slot_bytes + 16),
                        dtype=torch.uint8, device=device)
    flags = torch.zeros((n, nslices * 8), dtype=torch.int32, device=device)
    rows = []
    for r in range(n):
        base = (slots[r].data_ptr() + 15) // 16 * 16
        rows.append([xs[r].data_ptr(), outs[r].data_ptr(), base,
                     base + 4 * slot_bytes, flags[r].data_ptr()])
    table = torch.tensor(rows, dtype=torch.int64).to(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(table.data_ptr(), n, size, e, SLICE, int(quantized), stream)
    if err != 0:
        raise RuntimeError(
            f"{what}: cooperative launch over {n} ranks failed with "
            f"cudaError {err} (82: the ranks' blocks cannot all be "
            "resident on the card)")


def _ring_sum_kernel(flats: Sequence[torch.Tensor], quantized: bool
                     ) -> List[torch.Tensor]:
    n, size = len(flats), flats[0].numel()
    e = chunk_elems(size, n)
    xs = [_aligned(f) for f in flats]
    outs = [torch.empty(size, dtype=torch.float32, device=f.device)
            for f in flats]
    slot = e if quantized else 4 * e             # int8 codes or float32
    scale_slot = 4 * (e // QBLOCK) if quantized else 0
    _launch(_kernels()[1], "ring_allreduce", xs, outs, slot, scale_slot,
            size, e, quantized)
    if quantized:
        ring_allreduce.quantized_launches += 1
    else:
        ring_allreduce.launches += 1
    return outs


def ring_allreduce(tensors: Sequence[torch.Tensor], *, average: bool = False,
                   quantized: bool = False) -> List[torch.Tensor]:
    """Ring allreduce of one tensor per rank; returns one output per rank
    (the same values on every rank), each of the input's shape and dtype.

    ``quantized=True`` sends int8 codes and per-1024-element scales on
    every hop (A6); otherwise float32 travels (A5).  Floating inputs are
    reduced in float32.
    """
    return _allreduce(tensors, average, quantized, False, "ring_allreduce")


def ring_allgather_2d(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather rank r's float32 ``(CH, 128)`` block: every rank gets
    the ``(n*CH, 128)`` concatenation in rank order (A4)."""
    blocks, device = _check_blocks(blocks, "ring_allgather_2d")
    if device.type == "cpu":
        return ring_allgather_2d_plain(blocks)
    n, ch = len(blocks), blocks[0].shape[0]
    outs = [torch.empty((n * ch, LANES), dtype=torch.float32, device=device)
            for _ in range(n)]
    if ch == 0:
        return outs
    e = ch * LANES
    _launch(_kernels()[0], "ring_allgather_2d", [_aligned(b) for b in blocks],
            outs, 4 * e, 0, e, e, False)
    ring_allgather_2d.launches += 1
    return outs


ring_allgather_2d.launches = 0
ring_allreduce.launches = 0
ring_allreduce.quantized_launches = 0

"""Ring collectives over the virtual ranks of one card: the all-gather
(A4), the allreduce (A5) and the per-hop requantizing int8 allreduce
(A6).

Counterpart of ``horovod_tpu/ops/ring.py`` (Pallas bodies
``_allgather_kernel``, ``_allreduce_kernel`` and
``_quantized_allreduce_kernel``).  The JAX functions run once per rank
inside ``shard_map``; these take one tensor per rank and return one
output per rank, the counterpart of a ``shard_map`` body over an
``n``-rank axis.  CPU tensors take the plain versions beside them, which
walk the same ring hop by hop with the same arithmetic.  On CUDA tensors
every rank's buffers sit in one card's memory and one launch runs every
rank; :func:`kernel_route` picks the kernel from ``n`` alone:

* ``"cluster"`` (A4, A5 and A6 at ``2 <= n <= 8``):
  ``csrc/ring_cluster.cu``, one thread block cluster of ``n`` CTAs a
  ring, the slots in shared memory, each hop's payload (float32, or A6's
  int8 codes and scales) stored into the neighbour's slot through
  distributed shared memory and one cluster barrier a hop.  HBM sees
  each input read once and each output written once, the bound; the
  wrapper allocates only the outputs.  Counted in
  ``ring_allgather_2d.cluster_launches``,
  ``ring_allreduce.cluster_launches`` (A5) and
  ``ring_allreduce.quantized_cluster_launches`` (A6).
* ``"global"`` (A4, A5 and A6 at ``n > 8``): ``csrc/ring.cu``, one
  cooperative launch through the reference's protocol: double-buffered
  slots per phase in device memory, per-slot receive flags and ACK
  backpressure.  Counted in ``ring_allgather_2d.launches``,
  ``ring_allreduce.launches`` (A5) and
  ``ring_allreduce.quantized_launches`` (A6).  These are the kernels to
  extend across cards.

There is no other path: CUDA tensors a kernel cannot take raise, a
launch that fails raises, and ranks on more than one card raise
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
CLUSTER_MAX_RANKS = 8         # CTAs of a portable thread block cluster
CLUSTER_KINDS = ("A4", "A5", "A6")   # ring_cluster.cu's kernels, by index


def kernel_route(n: int, quantized: bool = False) -> str:
    """The CUDA kernel that serves a ring of ``n >= 2`` ranks on one
    card, A4, A5 and A6 (``quantized``) alike: ``"cluster"``
    (``csrc/ring_cluster.cu``) at ``n <= 8``, ``"global"``
    (``csrc/ring.cu``) past 8."""
    if n < 2:
        raise ValueError(f"a ring needs 2 or more ranks, got {n}")
    return "cluster" if n <= CLUSTER_MAX_RANKS else "global"


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


def bind_cluster(lib: ctypes.CDLL):
    """The all-gather (A4), allreduce (A5), info and quantized allreduce
    (A6) functions of a loaded ``ring_cluster`` library, their C
    signatures set."""
    fns = (lib.hvtpu_ring_cluster_allgather, lib.hvtpu_ring_cluster_allreduce,
           lib.hvtpu_ring_cluster_info,
           lib.hvtpu_ring_cluster_quantized_allreduce)
    if fns[0].argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_int64)
        # xs, outs, n, chunk, stream
        fns[0].argtypes = [ptrs, ptrs, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_void_p]
        # xs, outs, n, size, chunk, stream
        fns[1].argtypes = fns[3].argtypes = [
            ptrs, ptrs, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        # kind (index in CLUSTER_KINDS), n, info[6]
        fns[2].argtypes = [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
        for fn in fns:
            fn.restype = ctypes.c_int
    return fns


def _cluster_kernels():
    return bind_cluster(_build.load("ring_cluster"))


def _cluster_table(what: str, xs, outs, x_numel: int, out_numel: int):
    """The per-rank pointer arrays of a cluster launch, after the checks
    of what the kernel takes: 2 to 8 ranks, one output a rank, every
    tensor float32, contiguous, of its length, on one device and at a
    16-byte aligned address."""
    n = len(xs)
    if not 2 <= n <= CLUSTER_MAX_RANKS:
        raise ValueError(f"{what}: a cluster ring takes 2 to "
                         f"{CLUSTER_MAX_RANKS} ranks, got {n}")
    if len(outs) != n:
        raise ValueError(f"{what}: {n} inputs but {len(outs)} outputs")
    devices = {t.device for t in (*xs, *outs)}
    if len(devices) != 1:
        raise ValueError(f"{what}: ranks on mixed devices "
                         f"{sorted(map(str, devices))}")
    for kind, ts, numel in (("input", xs, x_numel), ("output", outs,
                                                      out_numel)):
        for r, t in enumerate(ts):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.numel() != numel):
                raise ValueError(
                    f"{what}: rank {r}'s {kind} must be {numel} contiguous "
                    f"float32, got {t.dtype} {tuple(t.shape)}")
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: rank {r}'s {kind} is not 16-byte "
                                 "aligned")
    table = ctypes.c_int64 * n
    return (table(*(t.data_ptr() for t in xs)),
            table(*(t.data_ptr() for t in outs)))


def _cluster_call(what: str, fn, n: int, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: cluster launch over {n} ranks failed "
                           f"with cudaError {err}")


def _cluster_allreduce(flats: Sequence[torch.Tensor], fn
                       ) -> List[torch.Tensor]:
    n, size = len(flats), flats[0].numel()
    e = chunk_elems(size, n)
    outs = [torch.empty(size, dtype=torch.float32, device=f.device)
            for f in flats]
    xs, os_ = _cluster_table("ring_allreduce", flats, outs, size, size)
    _cluster_call("ring_allreduce", fn, n, flats[0].device, xs, os_, n,
                  size, e)
    return outs


def cluster_allreduce_sum(flats: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
    """A5's Sum by one cluster launch over 1-D float32 CUDA tensors, one
    a rank."""
    outs = _cluster_allreduce(flats, _cluster_kernels()[1])
    ring_allreduce.cluster_launches += 1
    return outs


def cluster_quantized_allreduce(flats: Sequence[torch.Tensor]
                                ) -> List[torch.Tensor]:
    """A6's Sum by one cluster launch over 1-D float32 CUDA tensors, one
    a rank."""
    outs = _cluster_allreduce(flats, _cluster_kernels()[3])
    ring_allreduce.quantized_cluster_launches += 1
    return outs


def cluster_allgather(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A4 by one cluster launch over float32 ``(CH, 128)`` CUDA blocks,
    one a rank."""
    n, ch = len(blocks), blocks[0].shape[0]
    e = ch * LANES
    outs = [torch.empty((n * ch, LANES), dtype=torch.float32,
                        device=blocks[0].device) for _ in range(n)]
    xs, os_ = _cluster_table("ring_allgather_2d", blocks, outs, e, n * e)
    _cluster_call("ring_allgather_2d", _cluster_kernels()[0], n,
                  blocks[0].device, xs, os_, n, e)
    ring_allgather_2d.cluster_launches += 1
    return outs


def cluster_info(kind: str, n: int) -> dict:
    """What the current card gives the cluster kernel ``kind`` (one of
    :data:`CLUSTER_KINDS`): registers and spill bytes a thread, shared
    memory a CTA, CTAs an SM, clusters of ``n`` resident at once, and
    the kernel's slice in elements."""
    info = (ctypes.c_int * 6)()
    err = _cluster_kernels()[2](CLUSTER_KINDS.index(kind), n, info)
    if err != 0:
        raise RuntimeError(f"cluster_info: cudaError {err}")
    return dict(zip(("registers", "spill_bytes", "shared_bytes",
                     "ctas_per_sm", "clusters", "slice"), info))


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


def global_allreduce(xs: Sequence[torch.Tensor], quantized: bool
                     ) -> List[torch.Tensor]:
    """A5's Sum (A6's when ``quantized``) by one cooperative launch of
    the global-slot kernel over 1-D float32 CUDA tensors, one a rank, at
    16-byte aligned addresses.  It takes any ``n >= 2``; the wrapper
    sends it the rings past 8 ranks."""
    n, size = len(xs), xs[0].numel()
    e = chunk_elems(size, n)
    outs = [torch.empty(size, dtype=torch.float32, device=x.device)
            for x in xs]
    slot = e if quantized else 4 * e             # int8 codes or float32
    scale_slot = 4 * (e // QBLOCK) if quantized else 0
    _launch(_kernels()[1], "ring_allreduce", xs, outs, slot, scale_slot,
            size, e, quantized)
    if quantized:
        ring_allreduce.quantized_launches += 1
    else:
        ring_allreduce.launches += 1
    return outs


def _ring_sum_kernel(flats: Sequence[torch.Tensor], quantized: bool
                     ) -> List[torch.Tensor]:
    xs = [_aligned(f) for f in flats]
    if kernel_route(len(xs), quantized) == "cluster":
        return (cluster_quantized_allreduce(xs) if quantized
                else cluster_allreduce_sum(xs))
    return global_allreduce(xs, quantized)


def ring_allreduce(tensors: Sequence[torch.Tensor], *, average: bool = False,
                   quantized: bool = False) -> List[torch.Tensor]:
    """Ring allreduce of one tensor per rank; returns one output per rank
    (the same values on every rank), each of the input's shape and dtype.

    ``quantized=True`` sends int8 codes and per-1024-element scales on
    every hop (A6); otherwise float32 travels (A5).  Floating inputs are
    reduced in float32.
    """
    return _allreduce(tensors, average, quantized, False, "ring_allreduce")


def _allgather_kernel(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    n, ch = len(blocks), blocks[0].shape[0]
    xs = [_aligned(b) for b in blocks]
    if kernel_route(n) == "cluster":
        return cluster_allgather(xs)
    outs = [torch.empty((n * ch, LANES), dtype=torch.float32,
                        device=xs[0].device) for _ in range(n)]
    e = ch * LANES
    _launch(_kernels()[0], "ring_allgather_2d", xs, outs, 4 * e, 0, e, e,
            False)
    ring_allgather_2d.launches += 1
    return outs


def ring_allgather_2d(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather rank r's float32 ``(CH, 128)`` block: every rank gets
    the ``(n*CH, 128)`` concatenation in rank order (A4)."""
    blocks, device = _check_blocks(blocks, "ring_allgather_2d")
    if device.type == "cpu":
        return ring_allgather_2d_plain(blocks)
    if len(blocks) == 1 or blocks[0].shape[0] == 0:
        return [torch.cat(blocks) for _ in blocks]     # nothing to send
    return _allgather_kernel(blocks)


ring_allgather_2d.launches = 0            # csrc/ring.cu, n > 8
ring_allgather_2d.cluster_launches = 0    # csrc/ring_cluster.cu, n <= 8
ring_allreduce.launches = 0               # A5, csrc/ring.cu, n > 8
ring_allreduce.cluster_launches = 0       # A5, csrc/ring_cluster.cu
ring_allreduce.quantized_launches = 0     # A6, csrc/ring.cu, n > 8
ring_allreduce.quantized_cluster_launches = 0   # A6, csrc/ring_cluster.cu

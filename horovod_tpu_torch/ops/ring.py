"""Ring collectives: the all-gather (A4), the allreduce (A5) and the
per-hop requantizing int8 allreduce (A6), over the virtual ranks of one
card or over one rank a process.

Counterpart of ``horovod_tpu/ops/ring.py`` (Pallas bodies
``_allgather_kernel``, ``_allreduce_kernel`` and
``_quantized_allreduce_kernel``).  The JAX functions run once per rank
inside ``shard_map``, each device one rank.  The port has two
counterparts:

* :func:`ring_allreduce` / :func:`ring_allgather_2d` take one tensor per
  rank, every rank in this process, and return one output per rank;
* :class:`ProcessRing` is a communicator of one rank a process over a
  ``torch.distributed`` group: each process passes its own tensor and
  gets its own output, as a ``shard_map`` body does.

CPU tensors take the plain versions, which walk the same ring hop by hop
with the same arithmetic (:class:`ProcessRing`'s over the group's
point-to-point ops).  CUDA tensors take a kernel; :func:`kernel_route`
picks it for the ranks of one process from ``n`` alone:

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
  cooperative launch of every rank through the reference's protocol:
  double-buffered slots per phase in device memory, per-slot receive
  flags and ACK backpressure, on fresh flags every call.  Counted in
  ``ring_allgather_2d.launches``, ``ring_allreduce.launches`` (A5) and
  ``ring_allreduce.quantized_launches`` (A6).

:class:`ProcessRing` on a card runs the same ``csrc/ring.cu`` kernels
with one rank a launch: each process's slots and flags are its own
``cudaMalloc``, mapped by its neighbours through CUDA IPC handles, the
flags carry an epoch in place of zeroing, at system scope, so a peer may
be another process on the same card or another card.  Counted in
``ring_allgather_2d.ipc_launches``, ``ring_allreduce.ipc_launches`` (A5)
and ``ring_allreduce.quantized_ipc_launches`` (A6).

There is no other path: CUDA tensors a kernel cannot take raise, a
launch or an IPC call that fails raises with the CUDA error, and a list
of ranks on more than one card raises ``NotImplementedError``: such
ranks run one a process, through :class:`ProcessRing`.

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
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

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
                f"{what}: ranks on more than one card run one a process, "
                "through ProcessRing(group); a process drives one card "
                "until ROADMAP Queue A item 9")
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

def bind_global(lib: ctypes.CDLL):
    """The one-launch all-gather (A4) and allreduce (A5/A6) functions of
    a loaded ``ring`` library, their C signatures set."""
    fns = (lib.hvtpu_ring_allgather, lib.hvtpu_ring_allreduce)
    if fns[0].argtypes is None:
        for fn in fns:
            # table, n, size, chunk, slice, quantized, stream
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fns


def _kernels():
    return bind_global(_build.load("ring"))


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


# what csrc/ring.cu keeps for each slice of a chunk: 4 slots of SLICE
# float32 (A6's codes in the first quarter), 4 scale slots of SLICE/1024
# float32 (A6), 8 flag words of 64 bits; and one 64-bit word a block
SLOT_BYTES = 4 * SLICE
SCALE_SLOT_BYTES = 4 * (SLICE // QBLOCK)
FLAG_BYTES = 8 * 8
DONE_BYTES = 8


def _launch(fn, what: str, xs, outs, size: int, e: int,
            quantized: bool) -> None:
    """One cooperative launch over every rank.  Per rank the pointer table
    holds (input, output, slots, scale slots, flags, done words); slots
    and flags of all ranks come from one allocation each.  The flags and
    done words start at 0 on the launch stream, and the kernel runs at
    epoch 1: stream order rules out a flag of an earlier call."""
    n, device = len(xs), xs[0].device
    nslices = -(-e // SLICE)
    slot_bytes = nslices * 4 * SLOT_BYTES
    scale_bytes = nslices * 4 * SCALE_SLOT_BYTES if quantized else 0
    slots = torch.empty((n, slot_bytes + scale_bytes + 16),
                        dtype=torch.uint8, device=device)
    # per slice 8 flag words, then a done word a block (B <= nslices)
    flags = torch.zeros((n, nslices * 9), dtype=torch.int64, device=device)
    rows = []
    for r in range(n):
        base = (slots[r].data_ptr() + 15) // 16 * 16
        f = flags[r].data_ptr()
        rows.append([xs[r].data_ptr(), outs[r].data_ptr(), base,
                     base + slot_bytes, f, f + nslices * FLAG_BYTES])
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
    _launch(_kernels()[1], "ring_allreduce", xs, outs, size, e, quantized)
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
    _launch(_kernels()[0], "ring_allgather_2d", xs, outs, e, e, False)
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


# -- one rank a process -------------------------------------------------------

def _ipc_lib():
    """The ``ring`` library with the C signatures of its per-process
    entry points set."""
    lib = _build.load("ring")
    if lib.hvtpu_ring_allreduce_rank.argtypes is None:
        # rows, n, rank, blocks, epoch, size, chunk, slice, quantized,
        # stream
        rank_args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
                     ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                     ctypes.c_void_p]
        ptr_out = ctypes.POINTER(ctypes.c_void_p)
        for fn, args in (
                (lib.hvtpu_ring_allreduce_rank, rank_args),
                (lib.hvtpu_ring_allgather_rank, rank_args),
                (lib.hvtpu_ring_ipc_blocks, [ctypes.POINTER(ctypes.c_int)]),
                (lib.hvtpu_ring_ipc_alloc,
                 [ctypes.c_int64, ptr_out, ctypes.c_void_p]),
                (lib.hvtpu_ring_ipc_open, [ctypes.c_void_p, ptr_out]),
                (lib.hvtpu_ring_ipc_close, [ctypes.c_void_p]),
                (lib.hvtpu_ring_ipc_free, [ctypes.c_void_p])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.hvtpu_ring_error_name.argtypes = [ctypes.c_int]
        lib.hvtpu_ring_error_name.restype = ctypes.c_char_p
    return lib


IPC_HANDLE_BYTES = 64     # cudaIpcMemHandle_t


class ProcessRing:
    """A4, A5 and A6 with one rank a process, over the ``torch.distributed``
    group ``group`` (None: the default group), in its rank order: the
    counterpart of the reference's rings inside ``shard_map``.

    Every member calls each method with the same arguments (shape,
    dtype, flags), as with any collective.  CPU tensors take the plain
    versions: the same ring hop by hop over the group's point-to-point
    ops, sending per hop what the kernel sends (float32 for A4/A5, int8
    codes and a float32 scale a 1024 elements for A6); their results are
    bitwise those of :func:`ring_allreduce_plain` /
    :func:`ring_allgather_2d_plain` over the stacked ranks.  CUDA tensors
    launch this rank's blocks of ``csrc/ring.cu``.

    On the card the ring holds, from the first call on, one ``cudaMalloc``
    of its own (slots, scale slots, flags and done words for
    ``nslices`` slices of the largest chunk so far; :attr:`nbytes`),
    zeroed once; its left and right neighbours' allocations are mapped
    through CUDA IPC handles (:attr:`mapped_bytes`).  The handles and the
    blocks a rank (B, the least over the ranks, agreed once) travel as
    CPU objects through the group's ``all_gather_object``, so a gloo
    group serves as well as NCCL.  The epoch grows by one a call; a call
    that needs more slices grows the buffers on every rank in the same
    call (every rank passes the same size), after a device sync and a
    barrier, and starts the epochs again on fresh flags.  :meth:`close`
    (collective, no call in flight) unmaps the neighbours' memory, then
    frees its own.
    """

    def __init__(self, group=None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD)
        self._left_peer = ranks[(self.rank - 1) % self.n]
        self._right_peer = ranks[(self.rank + 1) % self.n]
        self.device = None
        self.blocks = None        # B, agreed at the first card call
        self.epoch = 0            # of the last call on the buffers
        self.nslices = 0          # the buffers' capacity, in slices
        self.nbytes = 0
        self._own = None          # this rank's allocation
        self._peers: Dict[int, Tuple[int, int]] = {}   # rank: (ptr, bytes)

    # -- the collectives ------------------------------------------------------

    def allreduce(self, x: torch.Tensor, *, average: bool = False,
                  quantized: bool = False) -> torch.Tensor:
        """This rank's share of the ring allreduce: the reduction over the
        group, of ``x``'s shape and dtype (A5; A6 when ``quantized``)."""
        device = x.device
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"ProcessRing.allreduce: unsupported device "
                             f"{device}")
        n, shape, dtype = self.n, x.shape, x.dtype
        if not dtype.is_floating_point:
            # integers: the exact sum in their own dtype (the reference's
            # psum), never the float32 ring; Average floor-divides
            out = x.clone()
            dist.all_reduce(out, group=self.group)
            return out.floor_divide(n) if average else out
        if n == 1:
            return x.to(torch.float32).to(dtype).clone()
        flat = x.reshape(-1).to(torch.float32)
        if flat.numel() == 0:
            out = flat.clone()
        elif device.type == "cpu":
            out = self._sum_plain(flat, quantized)
        else:
            out = self._sum_kernel(flat, quantized)
        if average:
            recip = torch.tensor(1.0 / n, dtype=torch.float32, device=device)
            out = flush(out.mul_(recip))
        return out.reshape(shape).to(dtype)

    def allgather_2d(self, block: torch.Tensor) -> torch.Tensor:
        """The ``(n*CH, 128)`` concatenation of every rank's float32
        ``(CH, 128)`` block in rank order (A4)."""
        (block,), device = _check_blocks([block], "ProcessRing.allgather_2d")
        n, ch = self.n, block.shape[0]
        if device.type == "cpu":
            return self._gather_plain(block)
        if n == 1 or ch == 0:
            return block.repeat(n, 1)                  # nothing to send
        return self._gather_kernel(block)

    @property
    def mapped_bytes(self) -> int:
        """Bytes of the neighbours' allocations mapped into this process."""
        return sum(b for _, b in self._peers.values())

    # -- plain versions -------------------------------------------------------

    def _exchange(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        """One hop: send ``tensors`` to the right neighbour, receive the
        same shapes from the left one (one tag a tensor)."""
        recvs = [torch.empty_like(t) for t in tensors]
        ops = []
        for tag, (t, r) in enumerate(zip(tensors, recvs)):
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self._right_peer, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, r, self._left_peer,
                                  self.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recvs

    def _sum_plain(self, flat: torch.Tensor, quantized: bool
                   ) -> torch.Tensor:
        """The kernel's walk from this rank: at reduce-scatter step i it
        receives the running sum of chunk ``me-i-1`` and adds its own; it
        then owns chunk ``me+1`` and relays the reduced chunks."""
        n, me, size = self.n, self.rank, flat.numel()
        e = chunk_elems(size, n)
        x = flat.new_zeros(n * e)
        x[:size] = flat
        x = flush(x).reshape(n, e)
        acc = x[me]
        for i in range(n - 1):
            c = (me - i - 1) % n
            if quantized:
                q, s = _quantize_chunks(acc[None])
                q, s = self._exchange(q[0], s[0])
                acc = flush(fma_f32(q.reshape(-1, QBLOCK), s,
                                    x[c].reshape(-1, QBLOCK)).reshape(e))
            else:
                (r,) = self._exchange(acc)
                acc = flush(r + x[c])
        out = x.new_empty((n, e))
        held = _quantize_chunks(acc[None]) if quantized else (acc,)
        for i in range(n):
            c = (me + 1 - i) % n                      # owned by rank me-i
            if i:
                held = self._exchange(*held)
            out[c] = (_dequantize_chunks(*held)[0] if quantized
                      else held[0])
        return out.reshape(-1)[:size]

    def _gather_plain(self, block: torch.Tensor) -> torch.Tensor:
        n, me, ch = self.n, self.rank, block.shape[0]
        out = block.new_empty((n * ch, LANES))
        out[me * ch:(me + 1) * ch] = block
        held = block
        for i in range(n - 1):
            (held,) = self._exchange(held)
            src = (me - i - 1) % n
            out[src * ch:(src + 1) * ch] = held
        return out

    # -- the card -------------------------------------------------------------

    def _sum_kernel(self, flat: torch.Tensor, quantized: bool
                    ) -> torch.Tensor:
        size = flat.numel()
        e = chunk_elems(size, self.n)
        x = _aligned(flat)
        out = torch.empty(size, dtype=torch.float32, device=flat.device)
        self._launch(_ipc_lib().hvtpu_ring_allreduce_rank,
                     "ProcessRing.allreduce", x, out, size, e, quantized)
        if quantized:
            ring_allreduce.quantized_ipc_launches += 1
        else:
            ring_allreduce.ipc_launches += 1
        return out

    def _gather_kernel(self, block: torch.Tensor) -> torch.Tensor:
        ch = block.shape[0]
        x = _aligned(block)
        out = torch.empty((self.n * ch, LANES), dtype=torch.float32,
                          device=block.device)
        e = ch * LANES
        self._launch(_ipc_lib().hvtpu_ring_allgather_rank,
                     "ProcessRing.allgather_2d", x, out, e, e, False)
        ring_allgather_2d.ipc_launches += 1
        return out

    def _fail(self, what: str, err: int):
        name = _ipc_lib().hvtpu_ring_error_name(err)
        raise RuntimeError(
            f"{what}: rank {self.rank} of {self.n} failed with cudaError "
            f"{err} ({name.decode() if name else 'unknown'})")

    def _call(self, what: str, fn, *args) -> None:
        err = fn(*args)
        if err != 0:
            self._fail(what, err)

    @staticmethod
    def _layout(nslices: int) -> Tuple[int, int, int]:
        """Byte offsets of the scale slots, flags and done words in an
        allocation of ``nslices`` slices (the same on every rank)."""
        scale = nslices * 4 * SLOT_BYTES
        flags = scale + nslices * 4 * SCALE_SLOT_BYTES
        return scale, flags, flags + nslices * FLAG_BYTES

    def _reserve(self, device: torch.device, nslices: int) -> None:
        """Buffers for ``nslices`` slices on every rank: allocate (the
        first call, or a call that needs more), exchange the handles,
        map the neighbours'."""
        lib = _ipc_lib()
        if self.device is None:
            self.device = device
        elif device != self.device:
            raise ValueError(f"ProcessRing: rank {self.rank} holds buffers "
                             f"on {self.device}, got a tensor on {device}")
        if nslices <= self.nslices:
            return
        self._release()
        b = ctypes.c_int(0)
        self._call("ProcessRing: blocks", lib.hvtpu_ring_ipc_blocks,
                   ctypes.byref(b))
        nbytes = self._layout(nslices)[2] + b.value * DONE_BYTES
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
        self._call("ProcessRing: cudaMalloc of the ring's buffers",
                   lib.hvtpu_ring_ipc_alloc, nbytes, ctypes.byref(ptr),
                   handle)
        self._own, self.nbytes, self.nslices = ptr.value, nbytes, nslices
        shared = [None] * self.n
        dist.all_gather_object(shared, (b.value, nbytes, handle.raw),
                               group=self.group)
        if self.blocks is None:
            self.blocks = min(s[0] for s in shared)
        for r in {(self.rank - 1) % self.n, (self.rank + 1) % self.n}:
            peer = ctypes.c_void_p()
            self._call(f"ProcessRing: opening rank {r}'s IPC handle",
                       lib.hvtpu_ring_ipc_open,
                       ctypes.create_string_buffer(shared[r][2],
                                                   IPC_HANDLE_BYTES),
                       ctypes.byref(peer))
            self._peers[r] = (peer.value, shared[r][1])
        self.epoch = 0

    def _release(self) -> None:
        """Unmap the neighbours' memory, then free this rank's, once no
        rank has a call in flight (a device sync, then a barrier)."""
        if self._own is None:
            return
        lib = _ipc_lib()
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)
        for r, (ptr, _) in sorted(self._peers.items()):
            self._call(f"ProcessRing: closing rank {r}'s IPC mapping",
                       lib.hvtpu_ring_ipc_close, ptr)
        self._peers = {}
        own, self._own, self.nslices, self.nbytes = self._own, None, 0, 0
        self._call("ProcessRing: cudaFree of the ring's buffers",
                   lib.hvtpu_ring_ipc_free, own)

    def _rows(self, x: torch.Tensor, out: torch.Tensor) -> List[int]:
        """The kernel's left, self and right rows (input, output, slots,
        scale slots, flags, done words; a neighbour's input and output 0)."""
        scale, flags, done = self._layout(self.nslices)

        def row(base, xp=0, op=0):
            return [xp, op, base, base + scale, base + flags, base + done]

        left = self._peers[(self.rank - 1) % self.n][0]
        right = self._peers[(self.rank + 1) % self.n][0]
        return (row(left) + row(self._own, x.data_ptr(), out.data_ptr())
                + row(right))

    def _launch(self, fn, what: str, x: torch.Tensor, out: torch.Tensor,
                size: int, e: int, quantized: bool) -> None:
        device = x.device
        with torch.cuda.device(device):
            self._reserve(device, -(-e // SLICE))
            self.epoch += 1
            rows = (ctypes.c_int64 * 18)(*self._rows(x, out))
            stream = torch.cuda.current_stream(device).cuda_stream
            self._call(what, fn, rows, self.n, self.rank, self.blocks,
                       self.epoch, size, e, SLICE, int(quantized), stream)

    def close(self) -> None:
        """Collective: every rank closes, with no call in flight.  Unmaps
        the neighbours' memory, then frees this rank's; the ring can be
        used again (it allocates anew)."""
        if self._own is not None:
            with torch.cuda.device(self.device):
                self._release()
        self.device = None
        self.epoch = 0


ring_allgather_2d.launches = 0            # csrc/ring.cu, n > 8
ring_allgather_2d.cluster_launches = 0    # csrc/ring_cluster.cu, n <= 8
ring_allreduce.launches = 0               # A5, csrc/ring.cu, n > 8
ring_allreduce.cluster_launches = 0       # A5, csrc/ring_cluster.cu
ring_allreduce.quantized_launches = 0     # A6, csrc/ring.cu, n > 8
ring_allreduce.quantized_cluster_launches = 0   # A6, csrc/ring_cluster.cu
ring_allgather_2d.ipc_launches = 0        # ProcessRing, csrc/ring.cu
ring_allreduce.ipc_launches = 0           # A5, ProcessRing
ring_allreduce.quantized_ipc_launches = 0   # A6, ProcessRing

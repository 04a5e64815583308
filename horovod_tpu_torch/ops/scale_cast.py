"""Kernel A1, ``fused_scale_cast``, and the two grouped passes built on it.

Counterpart of ``horovod_tpu/ops/pallas_ops.py`` ``fused_scale_cast``
(its Pallas body ``_scale_cast_kernel``), the pre/postscale that
``horovod_tpu/eager/controller.py`` ``_apply_scale`` runs around the
staged fused allreduce.  One CUDA kernel, ``csrc/scale_cast.cu``, takes
a table of tensors; three entry points launch it:

* ``fused_scale_cast(x, scale, out_dtype)``: ``cast(x.float() * scale)``
  of one tensor, a table of one entry;
* ``scale_cast_pack(tensors, scale, codec)``: the prescale, the wire
  codec's cast and ``pack_flat`` of a group of tensors;
* ``unpack_cast_scale(flat, specs, ctxs, scale, outs)``: ``unpack_flat``,
  the codec's cast back and the postscale, written into ``outs``.

On a CUDA tensor each launches the kernel on the current stream, one
launch for up to ``max_entries()`` tensors, and counts every launch in
``fused_scale_cast.launches``; on a CPU tensor it computes its plain
version (``*_plain``), the reference's per-tensor composition.  There is
no other path: a CUDA tensor the kernel cannot take raises.

The grouped passes cache, per group layout (dtypes, shapes, device),
the part of the kernel's table that does not change from step to step:
sizes, offsets and dtype codes.  Each call writes only the pointers,
since ``zero_grad(set_to_none=True)`` gives the gradients new storage.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm.packing import pack_flat, unpack_flat
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# one entry of the kernel's table (struct Entry of csrc/scale_cast.cu)
_ENTRY = np.dtype({
    "names": ["src", "dst", "n", "start", "src_dt", "spec_dt", "own_dt",
              "dst_dt"],
    "formats": ["<u8", "<u8", "<i8", "<i8", "u1", "u1", "u1", "u1"],
    "offsets": [0, 8, 16, 24, 32, 33, 34, 35],
    "itemsize": 40,
})


def _f32(scale: float) -> float:
    """``scale`` rounded to float32, the precision both versions use."""
    return ctypes.c_float(float(scale)).value


def _check_dtype(dtype, what: str) -> None:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: {dtype} is not supported (float32, "
                        "bfloat16, float16)")


# -- plain versions -----------------------------------------------------------

def fused_scale_cast_plain(x: torch.Tensor, scale: float,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version: ``(x.float() * f32(scale)).to(out_dtype)``."""
    return (x.float() * _f32(scale)).to(out_dtype or x.dtype)


def casts_to_wire(codec, dtype: torch.dtype) -> bool:
    """Whether the grouped passes take a tensor of ``dtype`` under the
    engine codec ``codec``: the kernel reads ``dtype`` and writes the
    codec's wire dtype for it.  Of the engine's codecs that holds for
    ``none`` and the cast codecs ``fp16`` / ``bf16``, whose compress is
    that cast; ``int8``'s wire (int8 codes) is not a cast."""
    return (dtype in _DTYPE_CODE
            and codec.wire_dtype(dtype) in _DTYPE_CODE)


def _check_codec(codec, dtype: torch.dtype) -> torch.dtype:
    """The wire dtype of ``dtype`` under ``codec``; raises where the
    grouped passes do not take it."""
    _check_dtype(dtype, "scale_cast_pack")
    if not casts_to_wire(codec, dtype):
        name = getattr(codec, "__name__", codec)
        raise TypeError(f"scale_cast_pack: {name} sends {dtype} as "
                        f"{codec.wire_dtype(dtype)}, not as float32, "
                        "bfloat16 or float16")
    return codec.wire_dtype(dtype)


def scale_cast_pack_plain(tensors: Sequence[torch.Tensor], scale: float,
                          codec):
    """Plain PyTorch version of :func:`scale_cast_pack`: per tensor the
    prescale (``fused_scale_cast_plain``) and the codec's compress, then
    ``pack_flat``."""
    wires = []
    for t in tensors:
        _check_codec(codec, t.dtype)
        t = fused_scale_cast_plain(t.reshape(-1), scale).reshape(t.shape)
        wires.append(codec.compress(t)[0])
    return pack_flat(wires)


def unpack_cast_scale_plain(flat: torch.Tensor, specs, ctxs, scale: float,
                            outs: Optional[Sequence[torch.Tensor]] = None
                            ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`unpack_cast_scale`: ``unpack_flat``,
    per piece the cast codecs' decompress (back to the context's dtype; a
    context of None, ``none``'s, leaves the piece as it is) and the
    postscale (``fused_scale_cast_plain``), copied into ``outs`` when
    given."""
    from ..comm.compression import Compression

    results = []
    for i, (piece, ctx) in enumerate(zip(unpack_flat(flat, specs), ctxs)):
        _check_dtype(piece.dtype, "unpack_cast_scale")
        g = Compression.fp16.decompress(piece, ctx)
        _check_dtype(g.dtype, "unpack_cast_scale")
        g = fused_scale_cast_plain(g.reshape(-1), scale).reshape(g.shape)
        results.append(g if outs is None else outs[i].copy_(g))
    return results


# -- the kernel's tables -----------------------------------------------------

def launch_tables(sizes: Sequence[int], codes: Sequence[Tuple[int, ...]],
                  max_entries: int):
    """The launches of a group: ``[(lo, hi, table, total), ...]``, entries
    ``lo:hi`` of the group in each, at most ``max_entries`` a launch.
    Each table holds its entries' sizes, prefix offsets (from 0 in every
    launch) and dtype codes (src, spec, own, dst); the pointers travel
    beside it, one array a side (``_launch``)."""
    out = []
    for lo in range(0, len(sizes), max_entries):
        hi = min(lo + max_entries, len(sizes))
        table = np.zeros(hi - lo, dtype=_ENTRY)
        n = np.asarray(sizes[lo:hi], dtype=np.int64)
        table["n"] = n
        table["start"] = np.cumsum(n) - n
        c = np.asarray(codes[lo:hi], dtype=np.uint8).reshape(-1, 4)
        for k, name in enumerate(("src_dt", "spec_dt", "own_dt", "dst_dt")):
            table[name] = c[:, k]
        out.append((lo, hi, table, int(n.sum())))
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("scale_cast")
    fn = lib.hvtpu_scale_cast_table
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for query in (lib.hvtpu_scale_cast_entry_bytes,
                  lib.hvtpu_scale_cast_max_entries):
        query.argtypes, query.restype = [], ctypes.c_int
    if lib.hvtpu_scale_cast_entry_bytes() != _ENTRY.itemsize:
        raise RuntimeError("scale_cast: the library's table entry is not "
                           f"{_ENTRY.itemsize} bytes")
    return fn, lib.hvtpu_scale_cast_max_entries()


def max_entries() -> int:
    """Tensors one launch takes (CUDA's kernel-parameter limit)."""
    return _library()[1]


def _launch(launches, srcs: np.ndarray, dsts: np.ndarray, scale: float,
            device: torch.device, what: str) -> None:
    """Launch each table of ``launches`` on ``device``'s current stream,
    with the group's source and destination addresses (uint64 arrays,
    one a tensor)."""
    fn = _library()[0]
    scale = _f32(scale)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    sp, dp = srcs.ctypes.data, dsts.ctypes.data
    with (contextlib.nullcontext()
          if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        for lo, hi, table, total in launches:
            if total == 0:
                continue
            err = fn(table.ctypes.data, sp + 8 * lo, dp + 8 * lo, hi - lo,
                     total, scale, stream)
            if err != 0:
                raise RuntimeError(
                    f"{what}: kernel launch failed with cudaError {err}")
            fused_scale_cast.launches += 1


def _addresses(tensors: Sequence[torch.Tensor]) -> np.ndarray:
    return np.fromiter(map(torch.Tensor.data_ptr, tensors), dtype=np.uint64,
                       count=len(tensors))


def _byte_offsets(sizes: Sequence[int], dtype: torch.dtype) -> np.ndarray:
    """Each piece's byte offset in a flat buffer of ``dtype``."""
    n = np.asarray(sizes, dtype=np.uint64)
    return (np.cumsum(n, dtype=np.uint64) - n) * np.uint64(dtype.itemsize)


def _layout(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple([(t.dtype, t.shape, t.is_contiguous(), t.get_device())
                  for t in tensors])


def _device_of(layout: tuple, what: str) -> int:
    devices = {d for _, _, _, d in layout}
    if len(devices) != 1 or min(devices) < 0:
        raise ValueError(f"{what}: expects tensors on one CUDA device, got "
                         f"devices {sorted(devices)}")
    if not all(c for _, _, c, _ in layout):
        raise ValueError(f"{what}: expects contiguous tensors")
    return devices.pop()


# -- one tensor --------------------------------------------------------------

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
    # no rounding between load and multiply: spec = own = float32
    launches = _single_table(x.numel(), _DTYPE_CODE[x.dtype],
                             _DTYPE_CODE[out_dtype])
    _launch(launches, _addresses([x]), _addresses([out]), scale, x.device,
            "fused_scale_cast")
    return out


@functools.lru_cache(maxsize=256)
def _single_table(n: int, in_code: int, out_code: int):
    return launch_tables([n], [(in_code, 0, 0, out_code)], 1)


fused_scale_cast.launches = 0


# -- the grouped passes ------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _pack_plan(layout: tuple, codec):
    device = _device_of(layout, "scale_cast_pack")
    wires = [_check_codec(codec, dtype) for dtype, _, _, _ in layout]
    flat_dtype = wires[0]
    for w in wires[1:]:
        flat_dtype = torch.promote_types(flat_dtype, w)
    sizes = [shape.numel() for _, shape, _, _ in layout]
    fc = _DTYPE_CODE[flat_dtype]
    codes = [(_DTYPE_CODE[d],) * 3 + (fc,) for d, _, _, _ in layout]
    specs = tuple((tuple(shape), w, n)
                  for (_, shape, _, _), w, n in zip(layout, wires, sizes))
    return (launch_tables(sizes, codes, max_entries()), flat_dtype,
            sum(sizes), specs, _byte_offsets(sizes, flat_dtype), device)


def scale_cast_pack(tensors: Sequence[torch.Tensor], scale: float, codec):
    """The prescale, the wire cast and the pack of a group, as one pass.

    Returns ``(flat, specs)`` as ``pack_flat`` of the wires would: each
    tensor, scaled by ``scale`` in its own dtype (``fused_scale_cast``),
    compressed by the engine codec ``codec`` (``none`` keeps each
    tensor's dtype, ``fp16`` / ``bf16`` cast to theirs; see
    :func:`casts_to_wire`) and written at its offset into one flat
    buffer of the wires' promoted dtype.  Tensors are contiguous,
    float32, bfloat16 or float16.  At scale 1 the multiply is exact, so
    the pass is the codec's compress and ``pack_flat``.
    """
    if not tensors:
        raise ValueError("scale_cast_pack requires at least one tensor")
    if tensors[0].device.type == "cpu":
        return scale_cast_pack_plain(tensors, scale, codec)
    launches, flat_dtype, total, specs, offsets, device = _pack_plan(
        _layout(tensors), codec)
    flat = torch.empty(total, dtype=flat_dtype, device=f"cuda:{device}")
    _launch(launches, _addresses(tensors),
            offsets + np.uint64(flat.data_ptr()), scale, flat.device,
            "scale_cast_pack")
    return flat, list(specs)


@functools.lru_cache(maxsize=256)
def _unpack_plan(flat_dtype, device: int, specs: tuple, ctxs: tuple):
    _check_dtype(flat_dtype, "unpack_cast_scale")
    fc = _DTYPE_CODE[flat_dtype]
    codes, outs = [], []
    for (shape, spec, n), ctx in zip(specs, ctxs):
        if ctx is not None and not isinstance(ctx, torch.dtype):
            raise TypeError(f"unpack_cast_scale: context {ctx!r} is not a "
                            "dtype (the cast codecs') or None")
        own = spec if ctx is None else ctx
        _check_dtype(spec, "unpack_cast_scale")
        _check_dtype(own, "unpack_cast_scale")
        oc = _DTYPE_CODE[own]
        codes.append((fc, _DTYPE_CODE[spec], oc, oc))
        outs.append((own, tuple(shape), True, device))
    sizes = [n for _, _, n in specs]
    return (launch_tables(sizes, codes, max_entries()), sum(sizes),
            tuple(outs), _byte_offsets(sizes, flat_dtype))


def unpack_cast_scale(flat: torch.Tensor, specs, ctxs, scale: float,
                      outs: Optional[Sequence[torch.Tensor]] = None
                      ) -> List[torch.Tensor]:
    """The unpack, the cast back and the postscale of a group, as one pass.

    Piece ``i`` of ``flat`` (``specs[i] = (shape, S, n)`` as
    ``scale_cast_pack`` or ``pack_flat`` return them) becomes
    ``G(f32(G(S(piece))) * scale)``, ``G`` the gradient's dtype: the
    context ``ctxs[i]`` of a cast codec, or ``S`` where it is None.  The
    results are written into ``outs`` (contiguous, of dtype ``G`` and the
    piece's shape) when given, else into new tensors; returns them.  The
    kernel writes ``outs`` through their addresses, so their version
    counters are bumped after the launch, as an in-place op's would be.
    """
    if flat.device.type == "cpu":
        return unpack_cast_scale_plain(flat, specs, ctxs, scale, outs)
    if flat.device.type != "cuda":
        raise ValueError(f"unpack_cast_scale: unsupported device "
                         f"{flat.device}")
    if flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError("unpack_cast_scale: expects a contiguous 1-D flat "
                         "buffer")
    if len(specs) != len(ctxs) or not specs:
        raise ValueError("unpack_cast_scale: one context a spec, at least "
                         "one spec")
    launches, total, want, offsets = _unpack_plan(
        flat.dtype, flat.get_device(), tuple(specs), tuple(ctxs))
    if total != flat.numel():
        raise ValueError(f"unpack_cast_scale: specs cover {total} elements, "
                         f"the flat buffer holds {flat.numel()}")
    if outs is None:
        outs = [torch.empty(shape, dtype=dtype, device=flat.device)
                for dtype, shape, _, _ in want]
    elif _layout(outs) != want:
        raise ValueError("unpack_cast_scale: outs must be contiguous, on "
                         f"the flat buffer's device, of {want}")
    _launch(launches, offsets + np.uint64(flat.data_ptr()),
            _addresses(outs), scale, flat.device, "unpack_cast_scale")
    torch.autograd.graph.increment_version(outs)
    return list(outs)

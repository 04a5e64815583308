"""Flat-buffer pack/unpack around one fused collective (the memcpy-in/out
of the reference's fusion buffer, horovod/common/ops/
collective_operations.cc MemcpyInFusionBuffer / MemcpyOutFusionBuffer).

Counterpart of ``horovod_tpu/comm/packing.py`` ``pack_flat`` /
``unpack_flat``: the flat buffer takes the promoted dtype of its pieces
(``torch.promote_types`` folded over the pieces, as
``jnp.result_type`` there), and unpack slices,
reshapes and casts each piece back.

The zero-copy fusion-buffer plane (``comm/packing.py:115-302`` there):
:class:`ExchangeBuffer` is one byte tensor on the device holding a fused
group at dtype-aligned offsets (:func:`assign_offsets`), pooled per
(process set, layout, device) by :class:`FusionBufferPool`.  The async
controller fills it at enqueue time once a steady schedule has fixed
each op's slot; the group's unpack is then one launch of kernel A1's
``unpack_cast_scale`` over the reduced buffer (the reference's
``group_unpack_program``, one cached jitted program).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import torch

Spec = Tuple[Tuple[int, ...], torch.dtype, int]


def _promoted_dtype(tensors: Sequence[torch.Tensor]) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def pack_flat(tensors: Sequence[torch.Tensor]):
    """Concatenate tensors into one flat buffer in the promoted dtype.

    Returns (flat, specs) where specs = [(shape, dtype, size), ...] in
    input order.
    """
    if not tensors:
        raise ValueError("pack_flat requires at least one tensor")
    dtype = _promoted_dtype(tensors)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    specs = [(tuple(t.shape), t.dtype, t.numel()) for t in tensors]
    return flat, specs


def unpack_flat(flat: torch.Tensor, specs: Sequence[Spec]
                ) -> List[torch.Tensor]:
    """Inverse of pack_flat: slice, reshape, and cast back."""
    outs, off = [], 0
    for shape, dtype, size in specs:
        outs.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return outs


# ---------------------------------------------------------------------------
# the zero-copy fusion-buffer plane
# ---------------------------------------------------------------------------

#: Pool-capacity knob: how many idle exchange buffers FusionBufferPool
#: keeps across all layouts before evicting the least recently used.
POOL_KNOB = "HVTPU_FUSION_BUFFER_POOL"

ByteSpec = Tuple[Tuple[int, ...], torch.dtype, int]


def _byte_specs(specs) -> List[ByteSpec]:
    return [(tuple(int(d) for d in shape), dtype, int(nbytes))
            for shape, dtype, nbytes in specs]


def assign_offsets(specs, align: Optional[int] = None
                   ) -> Tuple[List[int], int]:
    """Byte offsets for packing ``specs`` = [(shape, dtype, nbytes), ...]
    into one buffer, each offset padded up to the group's largest
    itemsize (or ``align``) so every piece is a view of its dtype.
    Returns ``(offsets, total_bytes)``; a uniform-dtype group has no
    padding, so its layout is the contiguous one of ``pack_flat``."""
    specs = _byte_specs(specs)
    if align is None:
        align = max((d.itemsize for _s, d, _n in specs), default=1)
    align = max(1, int(align))
    offsets, off = [], 0
    for _shape, _dtype, nbytes in specs:
        off = -(-off // align) * align
        offsets.append(off)
        off += nbytes
    return offsets, -(-off // align) * align


class ExchangeBuffer:
    """One exchange buffer of a fused group (parity: the reference's
    FusionBufferManager buffer): a byte tensor on ``device``, each op's
    slot at a dtype-aligned offset fixed at construction, so the async
    controller can pack an op's bytes at enqueue time, before the burst
    drains.

    ``write(i, t)`` is one ``copy_`` of op ``i``'s tensor into its slot
    on the caller's current stream.  A buffer back from the pool may
    still be read by the work of its last use: ``retire`` records where
    that work ends (events), and every later ``write`` makes its stream
    wait for them first."""

    __slots__ = ("specs", "offsets", "nbytes", "device", "buf", "_views",
                 "_filled", "_writers", "_reuse_after")

    def __init__(self, specs, device=None):
        self.specs = _byte_specs(specs)
        self.offsets, self.nbytes = assign_offsets(self.specs)
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.buf = torch.empty(self.nbytes, dtype=torch.uint8,
                               device=self.device)
        # each slot as a view of its dtype and shape, made once
        self._views = [self.buf[off:off + nbytes].view(dtype).view(shape)
                       for off, (shape, dtype, nbytes)
                       in zip(self.offsets, self.specs)]
        self._filled: set = set()
        self._writers: set = set()
        self._reuse_after: list = []

    def layout_key(self):
        return tuple(self.specs)

    def reset(self):
        self._filled.clear()

    def write(self, i: int, t: torch.Tensor) -> bool:
        """Pack op ``i``'s tensor into its slot; False when the slot was
        already filled (a stale plan) or the tensor is not the slot's
        dtype, byte count and device — the caller falls back."""
        if i in self._filled:
            return False
        shape, dtype, nbytes = self.specs[i]
        if (t.dtype != dtype or t.numel() * dtype.itemsize != nbytes
                or t.device != self.device):
            return False
        if t.is_cuda:
            stream = torch.cuda.current_stream(t.device)
            if stream not in self._writers:
                # the stream's first write since the buffer came back
                for ev in self._reuse_after:
                    stream.wait_event(ev)
                self._writers.add(stream)
        view = self._views[i]
        (view if t.shape == shape else view.view(t.shape)).copy_(t)
        self._filled.add(i)
        return True

    def retire(self, after=None):
        """The buffer goes back to the pool: later writes wait for the
        events ``after`` (the end of the work that read it) or, when
        None, for the streams that wrote into it since its last use."""
        if after is None:
            after = []
            for stream in self._writers:
                ev = torch.cuda.Event()
                ev.record(stream)
                after.append(ev)
        self._reuse_after = list(after)
        self._writers = set()
        self.reset()

    def complete(self) -> bool:
        return len(self._filled) == len(self.specs)

    def typed_view(self) -> torch.Tensor:
        """The whole payload as one 1-D tensor of the group's dtype
        (requires the uniform-dtype layout the controller's fuser
        guarantees)."""
        dtype = self.specs[0][1]
        if any(d != dtype for _s, d, _n in self.specs):
            raise ValueError("typed_view requires a uniform-dtype group")
        return self.buf.view(dtype)

    def element_specs(self) -> List[Spec]:
        """(shape, dtype, element count) triples in ``pack_flat``'s spec
        form."""
        return [(shape, dtype, nbytes // dtype.itemsize)
                for shape, dtype, nbytes in self.specs]

    def views(self) -> List[torch.Tensor]:
        """Each op's slot as a view of its shape and dtype."""
        return list(self._views)


class FusionBufferPool:
    """LRU pool of :class:`ExchangeBuffer`\\ s keyed by (process-set id,
    layout, device), bounded by the ``HVTPU_FUSION_BUFFER_POOL`` knob.
    Thread-safe: the controller's enqueue thread acquires while the
    executor and the consumers release."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(os.environ.get(POOL_KNOB, "16"))
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        # key -> stack of idle buffers; the OrderedDict's order is the
        # LRU order across keys
        self._idle: "OrderedDict[tuple, list]" = OrderedDict()
        self._pooled = 0

    def acquire(self, psid: int, specs, device=None) -> ExchangeBuffer:
        device = torch.device("cpu") if device is None \
            else torch.device(device)
        key = (psid, tuple(_byte_specs(specs)), device)
        with self._lock:
            stack = self._idle.get(key)
            if stack:
                self._idle.move_to_end(key)
                self._pooled -= 1
                buf = stack.pop()
                if not stack:
                    del self._idle[key]
                buf.reset()
                return buf
        return ExchangeBuffer(specs, device)

    def release(self, psid: int, xb: ExchangeBuffer, after=None):
        """Return ``xb``; ``after`` as in :meth:`ExchangeBuffer.retire`."""
        xb.retire(after)
        key = (psid, xb.layout_key(), xb.device)
        with self._lock:
            self._idle.setdefault(key, []).append(xb)
            self._idle.move_to_end(key)
            self._pooled += 1
            while self._pooled > self.capacity:
                k, stack = next(iter(self._idle.items()))
                stack.pop(0)
                self._pooled -= 1
                if not stack:
                    del self._idle[k]

    def stats(self) -> dict:
        with self._lock:
            return {"pooled": self._pooled, "capacity": self.capacity,
                    "layouts": len(self._idle)}

"""Flat-buffer pack/unpack around one fused collective (the memcpy-in/out
of the reference's fusion buffer, horovod/common/ops/
collective_operations.cc MemcpyInFusionBuffer / MemcpyOutFusionBuffer).

Counterpart of ``horovod_tpu/comm/packing.py`` ``pack_flat`` /
``unpack_flat``: the flat buffer takes the promoted dtype of its pieces
(``torch.promote_types`` folded over the pieces, as
``jnp.result_type`` there), and unpack slices,
reshapes and casts each piece back.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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

"""Adasum: scale-invariant gradient combination.

Counterpart of ``horovod_tpu/comm/adasum.py`` (parity surface:
``horovod/common/ops/adasum/adasum.h`` and the ``op=hvd.Adasum``
argument).  The pairwise rule for two gradients a, b is

    adasum(a, b) = (1 - a·b / (2 a·a)) a + (1 - a·b / (2 b·b)) b

which is symmetric, so both partners of an exchange compute the same
result.  :func:`adasum_reduce` runs recursive distance doubling over a
process set, as the reference does: log2(n) hops, each one exchange with
the partner at ``rank ^ dist`` (``torch.distributed`` point-to-point),
then the pairwise rule.  It requires a power-of-two set size, as the
reference does.

The reference is XLA code, not a Pallas kernel; here it is PyTorch ops.
The dot products run in float32 one segment at a time (``torch.dot``,
whose order of summation is fixed, so the two partners' coefficients
agree bit for bit), and the combination is one elementwise pass.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Segments = Optional[Sequence[Tuple[int, int]]]


def pairwise_adasum(a: torch.Tensor, b: torch.Tensor,
                    segments: Segments = None) -> torch.Tensor:
    """Combine two gradients of one shape.

    ``segments`` — (offset, size) pairs over the flattened tensors —
    computes the coefficients per segment, as the reference applies
    Adasum inside a fused buffer (each tensor its own correction).  The
    dot products and the combination run in float32; the result takes
    ``a``'s dtype and shape."""
    af = a.reshape(-1).float()
    bf = b.reshape(-1).float()
    if segments is None:
        segments = [(0, af.numel())]
    dots = []
    for off, size in segments:
        sa, sb = af[off:off + size], bf[off:off + size]
        dots.append(torch.stack([torch.dot(sa, sb), torch.dot(sa, sa),
                                 torch.dot(sb, sb)]))
    ab, aa, bb = torch.stack(dots).unbind(1)
    zero = torch.zeros((), dtype=torch.float32, device=af.device)
    ca = torch.where(aa > 0, ab / (2.0 * aa), zero)
    cb = torch.where(bb > 0, ab / (2.0 * bb), zero)
    offs = [off for off, _size in segments]
    sizes = [size for _off, size in segments]
    if offs != [sum(sizes[:i]) for i in range(len(sizes))] \
            or sum(sizes) != af.numel():
        raise ValueError("segments must tile the flattened tensor in order")
    sizes = torch.tensor(sizes, device=af.device)
    n = af.numel()
    out = (torch.repeat_interleave(1.0 - ca, sizes, output_size=n) * af
           + torch.repeat_interleave(1.0 - cb, sizes, output_size=n) * bf)
    return out.reshape(a.shape).to(a.dtype)


def adasum_reduce(x: torch.Tensor, process_set,
                  segments: Segments = None) -> torch.Tensor:
    """Adasum-combine ``x`` across ``process_set``'s ranks (every member
    calls it with a tensor of one shape and dtype); returns the combined
    tensor, the same on every member.  ``segments`` as in
    :func:`pairwise_adasum`."""
    from .eager import _group

    n = int(process_set.size)
    if n & (n - 1):
        raise ValueError(
            f"Adasum requires a power-of-two world size, got {n}")
    me = process_set.rank_in_set(dist.get_rank())
    group = _group(process_set)
    v = x.contiguous()
    step = 1
    while step < n:
        peer = process_set.ranks[me ^ step]
        other = torch.empty_like(v)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, v, peer, group),
                dist.P2POp(dist.irecv, other, peer, group)]):
            req.wait()
        v = pairwise_adasum(v, other, segments)
        step *= 2
    return v


def adasum_reduce_reference(tensors):
    """Plain numpy reference in float64 for tests: recursive distance
    doubling over a list of per-rank tensors; returns the combined
    tensor."""
    import numpy as np

    n = len(tensors)
    assert n & (n - 1) == 0
    vals = [np.asarray(t, dtype=np.float64) for t in tensors]
    step = 1
    while step < n:
        new = list(vals)
        for j in range(n):
            a, b = vals[j], vals[j ^ step]
            ab = float((a * b).sum())
            aa = float((a * a).sum())
            bb = float((b * b).sum())
            ca = ab / (2 * aa) if aa > 0 else 0.0
            cb = ab / (2 * bb) if bb > 0 else 0.0
            new[j] = (1 - ca) * a + (1 - cb) * b
        vals = new
        step *= 2
    return vals[0]

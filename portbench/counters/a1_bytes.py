"""The bytes kernel A1 moves in a step, worked out from the optimizer's
bucket plan: every bucket of several gradients takes one pass before the
wire (read each gradient, write its wire copy) and one after it (read
the wire copy, write the gradient); a bucket of one gradient does not go
through A1.  Each input byte read once, each output byte written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# (elements, bytes of an element of the gradient)
Grad = Tuple[int, int]


def a1_step(buckets: Sequence[Sequence[Grad]], wire_bytes: int
            ) -> Tuple[int, int]:
    """``(bytes, passes)`` of one step over ``buckets``."""
    nbytes = passes = 0
    for bucket in buckets:
        if len(bucket) < 2:
            continue
        for n, g in bucket:
            nbytes += 2 * n * (g + wire_bytes)
        passes += 2
    return nbytes, passes

"""The operations and bytes of a transformer's matrix products and
attention, worked out from the published shapes (not counted from what
an implementation runs, which a fused or recomputing change would move).

The terms of a step are listed by ``counters/<arch>_layers.py``'s
``terms(config, batch, seq_len)``, found by the configuration's
``arch``:

* :class:`Gemm`: the product of an ``[m, k]`` activation A and a
  ``[k, n]`` operand B, a weight or a second activation.  Three passes a
  training step, as ``conv_flops.py``'s layers: the forward pass, B's
  gradient and A's gradient; each ``2 m k n`` operations, and each reads
  its two inputs once and writes its output once, ``(m k + k n + m n)``
  elements.
* :class:`Attention`: causal ``Q K^T`` and ``P V`` over ``heads`` heads
  of ``batch`` rows of ``seq_len`` positions: ``T (T + 1) / 2`` (query,
  key) pairs a head, each position seeing itself and those before it.
  The forward pass's two products and the backward pass's four (``dV =
  P^T dO``, ``dP = dO V^T``, ``dQ = dS K``, ``dK = dS^T Q``), each ``2
  pairs d`` operations with ``d`` its head size; the forward reads Q, K
  and V and writes O, the backward reads Q, K, V, O and dO and writes
  dQ, dK and dV.

A pass's least time on the card is the larger of its operations over the
peak of its dtype and its bytes over the HBM bandwidth (``kernels.py``).
``min_s`` sums the GEMM terms' (``conv_roofline`` holds them against the
``conv_gemm`` kernels), ``attention_min_s`` the attention terms' (the
``attention`` kernels'); ``flops`` counts both.

Routed experts: :func:`expert_tokens`, the tokens the experts held here
see in a step on average under an even router, ``tokens x
experts_per_token x held / routed``: the ``m`` of their products.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List, Union

from .. import kernels
from .conv_flops import DTYPE_BYTES


@dataclasses.dataclass(frozen=True)
class Gemm:
    name: str
    m: float
    k: int
    n: int
    dtype: str

    passes = 3

    def pass_flops(self) -> float:
        return 2.0 * self.m * self.k * self.n

    def pass_bytes(self) -> float:
        return (DTYPE_BYTES[self.dtype]
                * (self.m * self.k + self.k * self.n + self.m * self.n))


@dataclasses.dataclass(frozen=True)
class Attention:
    name: str
    batch: int
    heads: int
    seq_len: int
    qk_dim: int
    v_dim: int
    dtype: str

    @property
    def pairs(self) -> int:
        return self.seq_len * (self.seq_len + 1) // 2

    def forward_flops(self) -> float:
        return (2.0 * self.batch * self.heads * self.pairs
                * (self.qk_dim + self.v_dim))

    def backward_flops(self) -> float:
        return 2.0 * self.forward_flops()

    def _bytes(self, qk: int, v: int) -> float:
        return (DTYPE_BYTES[self.dtype] * self.batch * self.heads
                * self.seq_len * (qk * self.qk_dim + v * self.v_dim))

    def forward_bytes(self) -> float:
        return self._bytes(2, 2)          # Q, K, V in; O out

    def backward_bytes(self) -> float:
        return self._bytes(4, 4)          # Q, K, V, O, dO in; dQ, dK, dV


Term = Union[Gemm, Attention]


def expert_tokens(tokens: int, experts_per_token: int, held: int,
                  routed: int) -> float:
    """The tokens the ``held`` of ``routed`` experts see a step on
    average when each of ``tokens`` picks ``experts_per_token``."""
    return tokens * experts_per_token * held / routed


def terms(config: dict, batch: int, seq_len: int) -> List[Term]:
    """The terms of ``config``, from the ``terms`` function of
    ``counters/<arch>_layers.py``."""
    module = importlib.import_module(f"{__package__}.{config['arch']}_layers")
    return module.terms(config, batch, seq_len)


def _least(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / kernels.PEAK_FLOPS[dtype],
               nbytes / kernels.PEAK_BYTES_PER_S)


def step_work(config: dict, batch: int, seq_len: int) -> dict:
    """``flops``: the operations of one training step of ``batch`` rows
    of ``seq_len`` tokens; ``min_s`` and ``attention_min_s``: the sums of
    the GEMM and of the attention passes' least times."""
    flops = min_s = attention_min_s = 0.0
    for t in terms(config, batch, seq_len):
        if isinstance(t, Gemm):
            f, b = t.pass_flops(), t.pass_bytes()
            flops += t.passes * f
            min_s += t.passes * _least(f, b, t.dtype)
        else:
            flops += t.forward_flops() + t.backward_flops()
            attention_min_s += (
                _least(t.forward_flops(), t.forward_bytes(), t.dtype)
                + _least(t.backward_flops(), t.backward_bytes(), t.dtype))
    return {"flops": flops, "min_s": min_s,
            "attention_min_s": attention_min_s}

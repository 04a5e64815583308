"""The terms of a ``decoder`` configuration for ``transformer_flops.py``:
each block's q, k, v and o projections, its causal attention and its
SwiGLU MLP (gate, up, down), then the untied head; all in the compute
dtype.  The embedding is a lookup, no product."""

from __future__ import annotations

from typing import List

from .transformer_flops import Attention, Gemm, Term


def terms(config: dict, batch: int, seq_len: int) -> List[Term]:
    dt = config["compute_dtype"]
    d, f = config["hidden_size"], config["intermediate_size"]
    h = config["num_attention_heads"]
    m = batch * seq_len
    out: List[Term] = []
    for i in range(config["num_hidden_layers"]):
        b = f"blocks.{i}"
        out += [Gemm(f"{b}.{w}", m, d, d, dt) for w in ("wq", "wk", "wv")]
        out.append(Attention(f"{b}.attention", batch, h, seq_len, d // h,
                             d // h, dt))
        out.append(Gemm(f"{b}.wo", m, d, d, dt))
        out += [Gemm(f"{b}.{w}", m, d, f, dt) for w in ("w_gate", "w_up")]
        out.append(Gemm(f"{b}.w_down", m, f, d, dt))
    out.append(Gemm("head", m, d, config["vocab_size"], dt))
    return out

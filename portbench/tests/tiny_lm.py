"""The program side of the tests' tiny causal language model: a 2-layer
pre-norm decoder, written apart from ``reference/decoder.py`` as a
program would be (``F.scaled_dot_product_attention``, a rotary table
held as buffers that it recomputes itself after ``to_empty``).  The tests'
configuration names it by ``port_module`` (``tiny_lm.json``); no
configuration of ``BENCHMARK.json`` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _weight(cout: int, cin: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, device=device))


class _Norm(nn.Module):
    def __init__(self, d: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(d, device=device))

    def forward(self, x):
        f = x.float()
        var = f.pow(2).mean(-1, keepdim=True)
        return (f * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.weight = _weight(cout, cin, device)

    def forward(self, x):
        return x @ self.weight.to(x.dtype).t()


class Rotary(nn.Module):
    """cos and sin of every position's angles, float32, recomputed by
    :meth:`reset_buffers` (after ``to_empty`` leaves them empty)."""

    def __init__(self, head_dim: int, positions: int, theta: float, device):
        super().__init__()
        self.head_dim, self.theta = head_dim, theta
        shape = (positions, head_dim)
        self.register_buffer("cos", torch.empty(shape, device=device),
                             persistent=False)
        self.register_buffer("sin", torch.empty(shape, device=device),
                             persistent=False)
        self.reset_buffers()

    def reset_buffers(self):
        d = self.head_dim
        dev = self.cos.device
        freq = 1.0 / self.theta ** (
            torch.arange(0, d, 2, dtype=torch.float64, device=dev) / d)
        pos = torch.arange(self.cos.shape[0], dtype=torch.float64,
                           device=dev)
        ang = torch.outer(pos, freq).repeat(1, 2)
        with torch.no_grad():
            self.cos.copy_(ang.cos())
            self.sin.copy_(ang.sin())

    def forward(self, x):
        t, half = x.shape[-2], self.head_dim // 2
        f = x.float()
        rot = torch.cat((-f[..., half:], f[..., :half]), dim=-1)
        return (f * self.cos[:t] + rot * self.sin[:t]).to(x.dtype)


class _Block(nn.Module):
    def __init__(self, d, heads, ffn, eps, device):
        super().__init__()
        self.heads = heads
        self.attn_norm = _Norm(d, eps, device)
        self.wq, self.wk, self.wv, self.wo = (
            _Proj(d, d, device) for _ in range(4))
        self.mlp_norm = _Norm(d, eps, device)
        self.w_gate = _Proj(d, ffn, device)
        self.w_up = _Proj(d, ffn, device)
        self.w_down = _Proj(ffn, d, device)

    def forward(self, x, rope):
        b, t, d = x.shape
        a = self.attn_norm(x)
        q, k, v = (w(a).view(b, t, self.heads, -1).transpose(1, 2)
                   for w in (self.wq, self.wk, self.wv))
        o = F.scaled_dot_product_attention(rope(q), rope(k), v,
                                           is_causal=True)
        x = x + self.wo(o.transpose(1, 2).reshape(b, t, d))
        m = self.mlp_norm(x)
        return x + self.w_down(F.silu(self.w_gate(m)) * self.w_up(m))


class TinyDecoder(nn.Module):
    def __init__(self, dtype=torch.float32, device=None, hidden_size=64,
                 num_attention_heads=4, num_hidden_layers=2,
                 intermediate_size=176, vocab_size=256, rms_norm_eps=1e-6,
                 rope_theta=10000.0, max_positions=32):
        super().__init__()
        d = hidden_size
        self.dtype = dtype
        self.embed = nn.Module()
        self.embed.weight = _weight(vocab_size, d, device)
        self.rope = Rotary(d // num_attention_heads, max_positions,
                           rope_theta, device)
        self.blocks = nn.ModuleList(
            _Block(d, num_attention_heads, intermediate_size, rms_norm_eps,
                   device) for _ in range(num_hidden_layers))
        self.norm = _Norm(d, rms_norm_eps, device)
        self.head = _Proj(d, vocab_size, device)

    def forward(self, ids):
        x = self.embed.weight[ids].to(self.dtype)
        for block in self.blocks:
            x = block(x, self.rope)
        return self.head(self.norm(x)).float()

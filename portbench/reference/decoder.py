"""A pre-norm decoder-only transformer in plain PyTorch, the frozen
reference of the ``decoder`` configurations (the harness's own tests
run one; no published model is of this plain form).

Ids -> a float32 embedding row cast to the compute dtype -> blocks of
``x + attn(rms(x))`` then ``x + mlp(rms(x))`` -> a final RMSNorm -> an
untied head whose logits are cast to float32.  RMSNorm: ``x *
rsqrt(mean(x^2) + eps) * scale`` in float32, back in the compute dtype.
Attention: ``num_attention_heads`` heads of ``hidden_size / heads``,
rotary positions (rotate-half, base ``rope_theta``) on q and k in
float32, causal softmax of the float32 scores over ``sqrt(head size)``.
The MLP: SwiGLU, ``down(silu(gate(x)) * up(x))``, ``intermediate_size``
wide.  No biases.  Every matrix product's inputs go through
``layers.operand``, so that the fp8 control reaches them all, the
attention's products too.  Parameter names are the program's
(``embed.weight``, ``blocks.{i}.wq.weight``, ``blocks.{i}.attn_norm.scale``,
``norm.scale``, ``head.weight``...).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import operand


class Linear(nn.Module):
    """A float32 ``(out, in)`` weight; the product in ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))

    def forward(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        w = operand(self.weight.to(self.dtype), precision)
        return F.linear(operand(x.to(self.dtype), precision), w)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = x.float()
        r = torch.rsqrt(f.square().mean(dim=-1, keepdim=True) + self.eps)
        return (f * r * self.scale).to(x.dtype)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary positions on ``x`` ``[B, H, T, D]``, in float32
    (positions 0..T-1, frequencies ``theta ** (-2i / D)``)."""
    t, d = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1).float()
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1).float()
    f = x.float()
    half = d // 2
    rot = torch.cat([-f[..., half:], f[..., :half]], dim=-1)
    return (f * cos + rot * sin).to(x.dtype)


class Block(nn.Module):
    def __init__(self, config: dict, dtype: torch.dtype, device=None):
        super().__init__()
        d, f = config["hidden_size"], config["intermediate_size"]
        eps = config["rms_norm_eps"]
        self.heads = config["num_attention_heads"]
        self.theta = float(config["rope_theta"])
        self.attn_norm = RMSNorm(d, eps, device)
        self.wq = Linear(d, d, dtype, device)
        self.wk = Linear(d, d, dtype, device)
        self.wv = Linear(d, d, dtype, device)
        self.wo = Linear(d, d, dtype, device)
        self.mlp_norm = RMSNorm(d, eps, device)
        self.w_gate = Linear(d, f, dtype, device)
        self.w_up = Linear(d, f, dtype, device)
        self.w_down = Linear(f, d, dtype, device)

    def attention(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads

        def heads(y):
            return y.view(b, t, h, d // h).transpose(1, 2)

        q = rotary(heads(self.wq(x, precision)), self.theta)
        k = rotary(heads(self.wk(x, precision)), self.theta)
        v = heads(self.wv(x, precision))
        s = torch.matmul(operand(q, precision),
                         operand(k, precision).transpose(-1, -2)).float()
        s = s / math.sqrt(d // h)
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        o = torch.matmul(operand(p.to(v.dtype), precision),
                         operand(v, precision))
        return self.wo(o.transpose(1, 2).reshape(b, t, d), precision)

    def forward(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        x = x + self.attention(self.attn_norm(x), precision)
        y = self.mlp_norm(x)
        g = F.silu(self.w_gate(y, precision)) * self.w_up(y, precision)
        return x + self.w_down(g, precision)


class Decoder(nn.Module):
    def __init__(self, config: dict, dtype: torch.dtype, device=None):
        super().__init__()
        d, v = config["hidden_size"], config["vocab_size"]
        self.dtype = dtype
        self.embed = nn.Module()
        self.embed.weight = nn.Parameter(torch.empty(v, d, device=device))
        self.blocks = nn.ModuleList(
            Block(config, dtype, device)
            for _ in range(config["num_hidden_layers"]))
        self.norm = RMSNorm(d, config["rms_norm_eps"], device)
        self.head = Linear(d, v, dtype, device)

    def forward(self, ids: torch.Tensor, precision: str = "bf16"
                ) -> torch.Tensor:
        x = F.embedding(ids, self.embed.weight).to(self.dtype)
        for block in self.blocks:
            x = block(x, precision)
        return self.head(self.norm(x), precision).float()


def build(config: dict, device=None) -> Decoder:
    return Decoder(config, getattr(torch, config["compute_dtype"]), device)

"""Flagship model: GPT-style transformer with hybrid dp/tp/pp/sp/ep
sharding.

Counterpart of ``horovod_tpu/models/transformer.py``: the same config,
parameter tree, partition specs and arithmetic order (a decoder-only
transformer whose one training step runs over a :class:`MeshLayout`
exercising every parallelism axis at once), as eager PyTorch on this
rank's shards:

* **dp** -- the batch sharded: each rank passes its dp shard of the
  tokens (the reference's ``in_specs=P(dp, None)``).
* **tp** -- Megatron column->row sharded attention/MLP projections.
* **sp** -- the sequence sharded between blocks: ``megatron_sp`` (sp
  shares the tp group: all_gather in, psum_scatter out) or ``ring`` /
  ``ulysses`` (a dedicated sp axis, ``parallel/{ring,ulysses}.py``).
* **pp** -- blocks stacked a stage, the GPipe schedule
  (``parallel/pipeline.py``) over the pp axis.
* **ep** -- optional Switch-MoE MLPs with experts sharded over ep
  (``parallel/moe.py``; ep shares dp by default).

The matmuls, attention and softmax are plain torch ops, as they are XLA
code (no Pallas kernel) in the reference; no fused attention replaces
the float32-softmax one, whose rounding the reference fixes.

**Gradients.**  The reference gets its gradient reductions from
``shard_map``'s transpose rules.  Here the convention is:

1. the loss :func:`forward_local` returns is the same on every rank, and
   each rank back-propagates ``loss / world_size``, so the ranks'
   objectives sum to the loss;
2. every collective's backward is its exact adjoint
   (``parallel/_collectives.py``), so rank r's ``.grad`` is the
   derivative of that sum with respect to rank r's own copy of each
   parameter element;
3. the gradient of the loss with respect to a parameter element is the
   sum of those derivatives over every copy of it: each gradient is
   summed over every mesh axis of size above 1 that its
   :func:`param_specs` entry does not shard (:func:`reduce_gradients`,
   ``allreduce_gradients`` along each axis, so the fusion buckets serve
   the hybrid path).  ``embed``, ``pos`` and ``ln_f`` are summed over
   every axis; ``wqkv`` over dp and a dedicated sp, not tp or pp; the
   experts' weights over every axis but ep and pp.

:func:`make_train_step` does the three.  One helper slices a global
tree by the specs (:func:`shard_params`): the model's initialisation,
``weights.transformer_params_from_jax`` and the tests use it.
:func:`global_params` wraps this rank's shards as ``DTensor``s of the
global arrays by the same specs (the tree that the sharded checkpoint
commits, every process its own shards), and :func:`local_params` takes
the blocks back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel._collectives import (
    all_gather,
    axis_index,
    axis_size,
    pmean,
    psum,
    psum_scatter,
)
from ..parallel.mesh import MeshLayout
from ..parallel.moe import expert_parallel_moe
from ..parallel.pipeline import pipeline_apply
from ..parallel.ring import ring_attention
from ..parallel.ulysses import ulysses_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: Any = torch.bfloat16
    attn_mode: str = "megatron_sp"  # "megatron_sp" | "ring" | "ulysses"
    n_experts: int = 0  # 0 -> dense MLP in every block
    capacity_factor: float = 2.0
    aux_loss_weight: float = 0.01
    num_microbatches: int = 0  # 0 -> 2 * pp

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# init and sharding
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Tree:
    """Global (unsharded) parameter tree with the reference's shapes,
    dtypes and distributions; blocks stacked on a leading layer dim so
    they can be pp-sharded.  Draws from ``generator`` (on ``device``,
    default the CPU)."""
    d, h, dh, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.n_layers)

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    def norm(shape, fan_in):
        return (normal(shape) / math.sqrt(fan_in)).to(cfg.dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    blocks: Tree = {
        "ln1": const((L, d), 1.0),
        # [L, D, 3, H*Dh]: q/k/v on their own dim so tp-sharding the
        # last dim splits heads, never mixes q/k/v columns
        "wqkv": norm((L, d, 3, h * dh), d),
        "wo": norm((L, h * dh, d), h * dh),
        "ln2": const((L, d), 1.0),
    }
    if cfg.n_experts:
        e = cfg.n_experts
        blocks["gate"] = normal((L, d, e)) * 0.02        # float32
        blocks["we1"] = norm((L, e, d, f), d)
        blocks["we2"] = norm((L, e, f, d), f)
    else:
        blocks["w1"] = norm((L, d, f), d)
        blocks["b1"] = const((L, f), 0.0)
        blocks["w2"] = norm((L, f, d), f)
        blocks["b2"] = const((L, d), 0.0)
    return {
        "embed": (normal((cfg.vocab_size, d)) * 0.02).to(cfg.dtype),
        "pos": (normal((cfg.max_seq, d)) * 0.02).to(cfg.dtype),
        "blocks": blocks,
        "ln_f": const((d,), 1.0),
    }


def param_specs(cfg: TransformerConfig, layout: MeshLayout) -> Tree:
    """The reference's PartitionSpecs, as tuples of physical axis names
    (``None`` an unsharded dim, trailing dims unsharded): blocks
    pp-sharded on the layer dim, projections tp-sharded Megatron-style,
    experts ep-sharded."""
    tp, pp, ep = layout.tp, layout.pp, layout.ep
    blocks: Tree = {
        "ln1": (pp, None),
        "wqkv": (pp, None, None, tp),
        "wo": (pp, tp, None),
        "ln2": (pp, None),
    }
    if cfg.n_experts:
        blocks["gate"] = (pp, None, None)
        blocks["we1"] = (pp, ep, None, None)
        blocks["we2"] = (pp, ep, None, None)
    else:
        blocks["w1"] = (pp, None, tp)
        blocks["b1"] = (pp, tp)
        blocks["w2"] = (pp, tp, None)
        blocks["b2"] = (pp, None)
    return {"embed": (), "pos": (), "blocks": blocks, "ln_f": ()}


def flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """``{"blocks.wqkv": ..., "embed": ...}``: the module's names."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _local_slice(x, spec, layout: MeshLayout):
    """This rank's block of ``x`` (a tensor or a numpy array) under
    ``spec``: dim i split evenly over axis ``spec[i]``, the block at this
    rank's index along it."""
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = layout.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} not "
                             f"divisible by axis {axis!r} size {n}")
        size = x.shape[dim] // n
        i = axis_index(axis, mesh=layout.mesh)
        index.append(slice(i * size, (i + 1) * size))
    return x[tuple(index)]


def shard_params(params: Tree, cfg: TransformerConfig,
                 layout: MeshLayout) -> Dict[str, Any]:
    """This rank's shard of every parameter of a global tree, by flat
    name (``"blocks.wqkv"``)."""
    specs = flatten(param_specs(cfg, layout))
    return {name: _local_slice(x, specs[name], layout)
            for name, x in flatten(params).items()}


def _placements(spec, layout: MeshLayout):
    """``spec`` as DTensor placements, one a mesh dim: ``Shard(d)`` where
    dim ``d`` names the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in layout.shape:
        dims = [d for d, a in enumerate(spec)
                if a == axis or (isinstance(a, tuple) and axis in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def global_params(local: Dict[str, Any], cfg: TransformerConfig,
                  layout: MeshLayout) -> Tree:
    """This rank's shards (flat names, as :func:`shard_params` and the
    module's ``state_dict`` give them) as ``DTensor``s of the global
    arrays, by :func:`param_specs`: the tree a
    ``ShardedCheckpointer`` / ``ShardedTorchState`` commits.  Any flat
    dict of tensors shaped like the shards wraps the same way (Adam's
    ``exp_avg`` and ``exp_avg_sq`` by parameter name).  The blocks are
    shared, not copied."""
    from torch.distributed.tensor import DTensor

    specs = flatten(param_specs(cfg, layout))
    out = {}
    for name, x in local.items():
        spec = specs[name]
        shape = list(x.shape)
        for d, axis in enumerate(spec):
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    shape[d] *= layout.shape[a]
        out[name] = DTensor.from_local(
            x.detach(), layout.mesh, _placements(spec, layout),
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return unflatten(out)


def local_params(tree: Tree) -> Dict[str, Any]:
    """The inverse of :func:`global_params`: each ``DTensor``'s block of
    this rank, by flat name (a ``load_state_dict`` argument)."""
    return {name: x.to_local() for name, x in flatten(tree).items()}


def reduction_axes(spec, layout: MeshLayout) -> Tuple[str, ...]:
    """The mesh axes of size above 1 that ``spec`` does not shard, in the
    mesh's order: the axes a gradient under it is summed over."""
    return tuple(a for a, n in layout.shape.items()
                 if n > 1 and a not in spec)


# ---------------------------------------------------------------------------
# the local forward
# ---------------------------------------------------------------------------

def _rms_norm(x, w):
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    return (x32 * scale).to(x.dtype) * w


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def _dense_causal_attention(q, k, v):
    # q,k,v: [B, T, h, Dh] -- full sequence, local head subset
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _split_heads(qkv, h_local, dh):
    b, t = qkv.shape[:2]
    return tuple(qkv[:, :, i].reshape(b, t, h_local, dh) for i in range(3))


def _attention(cfg: TransformerConfig, p, x, layout: MeshLayout):
    """One attention sublayer on a seq-sharded activation
    ``[B_mb, T_local, D]``; returns the same shape."""
    mesh = layout.mesh
    sp_ax, tp_ax = layout.sp, layout.tp
    h_local = cfg.n_heads // axis_size(tp_ax, mesh=mesh)
    dh = cfg.head_dim
    xn = _rms_norm(x, p["ln1"])

    if cfg.attn_mode == "megatron_sp":
        # sp == tp group: gather the sequence in, scatter it back out
        xg = all_gather(xn, tp_ax, dim=1, tiled=True, mesh=mesh)
        qkv = torch.einsum("btd,dcf->btcf", xg, p["wqkv"])
        q, k, v = _split_heads(qkv, h_local, dh)
        o = _dense_causal_attention(q, k, v)
        o = o.reshape(*o.shape[:2], h_local * dh)
        y = torch.einsum("btf,fd->btd", o, p["wo"])      # partial over tp
        y = psum_scatter(y, tp_ax, scatter_dimension=1, tiled=True,
                         mesh=mesh)
    else:
        # dedicated sp axis: projections tp-parallel, attention sp-parallel
        qkv = torch.einsum("btd,dcf->btcf", xn, p["wqkv"])
        q, k, v = _split_heads(qkv, h_local, dh)
        if cfg.attn_mode == "ring":
            o = ring_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                sp_ax, causal=True, mesh=mesh,
            ).transpose(1, 2)
        elif cfg.attn_mode == "ulysses":
            o = ulysses_attention(q, k, v, sp_ax, causal=True, mesh=mesh)
        else:
            raise ValueError(f"unknown attn_mode {cfg.attn_mode!r}")
        o = o.reshape(*o.shape[:2], h_local * dh)
        y = torch.einsum("btf,fd->btd", o, p["wo"])
        y = psum(y, tp_ax, mesh=mesh)
    return x + y.to(x.dtype)


def _expert_fn(ep_params, tok):
    w1, w2 = ep_params
    return torch.einsum("cf,fd->cd",
                        _gelu(torch.einsum("cd,df->cf", tok, w1)), w2)


def _mlp(cfg: TransformerConfig, p, x, layout: MeshLayout):
    """Dense (tp column->row) or Switch-MoE (ep all_to_all) MLP sublayer
    on ``[B_mb, T_local, D]``; returns (out, aux_loss)."""
    mesh = layout.mesh
    tp_ax, ep_ax = layout.tp, layout.ep
    xn = _rms_norm(x, p["ln2"])

    if cfg.n_experts:
        b, t, d = xn.shape
        y, aux = expert_parallel_moe(
            xn.reshape(b * t, d), p["gate"], (p["we1"], p["we2"]),
            _expert_fn, ep_ax, num_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor, mesh=mesh,
        )
        return x + y.reshape(b, t, d).to(x.dtype), aux

    if cfg.attn_mode == "megatron_sp":
        xg = all_gather(xn, tp_ax, dim=1, tiled=True, mesh=mesh)
        hmid = _gelu(torch.einsum("btd,df->btf", xg, p["w1"]) + p["b1"])
        y = torch.einsum("btf,fd->btd", hmid, p["w2"])
        y = psum_scatter(y, tp_ax, scatter_dimension=1, tiled=True,
                         mesh=mesh)
        y = y + p["b2"]
    else:
        hmid = _gelu(torch.einsum("btd,df->btf", xn, p["w1"]) + p["b1"])
        y = torch.einsum("btf,fd->btd", hmid, p["w2"])
        y = psum(y, tp_ax, mesh=mesh) + p["b2"]
    return x + y.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def _block(cfg, layer_params, x, layout):
    """One transformer block; x: [B_mb, T_local, D] -> (same, aux)."""
    x = _attention(cfg, layer_params, x, layout)
    return _mlp(cfg, layer_params, x, layout)


def forward_local(
    cfg: TransformerConfig,
    params: Tree,
    tokens: torch.Tensor,
    layout: MeshLayout,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full decoder forward on this rank.

    Args:
      params: this rank's shards, as a tree (the blocks' leading layer
        dim is this pp stage's slice; tp/ep dims are local slices).
      tokens: ``[B_local, T]``, this rank's dp shard of the batch, the
        sequence full.
      layout: the mesh and the logical->physical axis names.

    Returns:
      (loss, aux_loss): float32 scalars, the same on every rank.
    """
    mesh = layout.mesh
    sp_ax, pp_ax, dp_ax, tp_ax = layout.sp, layout.pp, layout.dp, layout.tp
    sp_size = axis_size(sp_ax, mesh=mesh)
    sp_idx = axis_index(sp_ax, mesh=mesh)
    pp_size = axis_size(pp_ax, mesh=mesh)

    b_local, t_full = tokens.shape
    t_in = t_full - 1
    if t_in % sp_size:
        raise ValueError(f"seq len {t_in} not divisible by sp={sp_size}")
    t_local = t_in // sp_size

    inp, labels = tokens[:, :-1], tokens[:, 1:]

    # embed, then take this sp member's sequence slice
    x = F.embedding(inp, params["embed"]) + params["pos"][:t_in][None]
    lo, hi = sp_idx * t_local, (sp_idx + 1) * t_local
    x = x[:, lo:hi]
    labels_loc = labels[:, lo:hi]

    # microbatch for the pipeline
    n_micro = cfg.num_microbatches or max(1, 2 * pp_size)
    if b_local % n_micro:
        raise ValueError(
            f"local batch {b_local} not divisible by {n_micro} microbatches"
        )
    mb = x.reshape(n_micro, b_local // n_micro, t_local, cfg.d_model)

    def stage_fn(stage_params, xmb):
        # this stage's layers, one after the other (the reference's scan)
        auxs = []
        for i in range(stage_params["ln1"].shape[0]):
            xmb, aux = _block(cfg, {k: v[i] for k, v in stage_params.items()},
                              xmb, layout)
            auxs.append(aux)
        return xmb, torch.stack(auxs).sum()

    # GPipe over pp (a pp of 1 too); aux accumulates across stages and
    # microbatches inside the schedule (bubble ticks masked)
    out, aux_total = pipeline_apply(stage_fn, params["blocks"], mb, pp_ax,
                                    with_aux=True, mesh=mesh)
    x = out.reshape(b_local, t_local, cfg.d_model)
    # the MoE aux's mean over microbatches and routing groups (dp x sp);
    # the pmean over tp is the identity, kept as the reference keeps it
    aux_acc = pmean(aux_total / n_micro, (dp_ax, sp_ax), mesh=mesh)
    aux_acc = pmean(aux_acc, tp_ax, mesh=mesh)

    x = _rms_norm(x, params["ln_f"])
    logits = torch.einsum("btd,vd->btv", x, params["embed"])  # tied head

    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels_loc[..., None])[..., 0]
    total = psum(nll.sum(), (dp_ax, sp_ax), mesh=mesh)
    loss = total / (b_local * t_in * axis_size(dp_ax, mesh=mesh))
    loss = pmean(loss, tp_ax, mesh=mesh)       # the identity, as aux's
    return loss, aux_acc


# ---------------------------------------------------------------------------
# the module, the loss, the gradient reduction and the train step
# ---------------------------------------------------------------------------

def unflatten(flat: Dict[str, Any]) -> Tree:
    """The inverse of :func:`flatten`."""
    tree: Tree = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


class Transformer(nn.Module):
    """This rank's shard of the transformer: each parameter of the global
    tree sliced by :func:`param_specs` (names as :func:`flatten` gives
    them: ``embed``, ``pos``, ``ln_f``, ``blocks.wqkv``, ...).

    ``params`` is a global tree (e.g. ``init_params``); without it the
    model draws its own from ``generator`` (on the CPU, so a seed gives
    the same weights on any device).  ``device`` defaults to the port's
    device (``hvd.device()``).  ``forward(tokens)`` is the loss of this
    rank's dp shard of the batch (``loss + aux_loss_weight * aux``).
    """

    def __init__(self, cfg: TransformerConfig, layout: MeshLayout, *,
                 params: Optional[Tree] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        if device is None:
            from ..core.state import device as port_device

            device = port_device()
        self.cfg, self.layout = cfg, layout
        self._loss = make_loss_fn(cfg, layout)
        if params is None:
            params = init_params(cfg, generator)
        self.blocks = nn.ParameterDict()
        for name, x in shard_params(params, cfg, layout).items():
            p = nn.Parameter(x.detach().to(device).clone())
            if name.startswith("blocks."):
                self.blocks[name[len("blocks."):]] = p
            else:
                self.register_parameter(name, p)

    def tree(self) -> Tree:
        """The parameters as the reference's tree."""
        return unflatten(dict(self.named_parameters()))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._loss(self.tree(), tokens)


def make_loss_fn(cfg: TransformerConfig, layout: MeshLayout):
    """Returns ``loss(params, tokens) -> scalar`` on this rank's shards
    (a tree) and its dp shard of the batch: ``loss + aux_loss_weight *
    aux``, the same on every rank.  Back-propagate ``loss / world_size``
    and :func:`reduce_gradients` for the reference's gradients (module
    docstring)."""
    if cfg.attn_mode == "megatron_sp" and layout.sp != layout.tp:
        raise ValueError(
            "attn_mode='megatron_sp' requires sp to share the tp group "
            "(make_layout without a dedicated sp axis); with a dedicated "
            "sp axis use attn_mode='ring' or 'ulysses'"
        )

    def loss_fn(params: Tree, tokens: torch.Tensor) -> torch.Tensor:
        loss, aux = forward_local(cfg, params, tokens, layout)
        return loss + cfg.aux_loss_weight * aux

    return loss_fn


def reduce_gradients(model: Transformer) -> None:
    """Sum each parameter's ``.grad`` over the axes its spec does not
    shard (:func:`reduction_axes`), one ``allreduce_gradients`` (fused
    buckets, Sum) along each axis; a missing gradient counts as zeros."""
    from ..api.optimizer import allreduce_gradients
    from ..comm.reduce_ops import ReduceOp

    layout = model.layout
    specs = flatten(param_specs(model.cfg, layout))
    params = dict(model.named_parameters())
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for axis in layout.shape:
        names = [n for n in params
                 if axis in reduction_axes(specs[n], layout)]
        if not names:
            continue
        out = allreduce_gradients({n: params[n].grad for n in names},
                                  axis_name=axis, op=ReduceOp.SUM,
                                  mesh=layout.mesh)
        for n in names:
            params[n].grad = out[n]


def make_train_step(cfg: TransformerConfig, layout: MeshLayout, optimizer):
    """The full hybrid-parallel train step: ``step(model, tokens) ->
    loss`` for a :class:`Transformer` whose parameters ``optimizer`` (a
    ``torch.optim`` optimizer) holds, ``tokens`` this rank's dp shard.
    Back-propagates ``loss / world_size``, reduces the gradients, steps
    the optimizer; returns the loss (detached)."""
    loss_fn = make_loss_fn(cfg, layout)
    world = math.prod(layout.shape.values())

    def step(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model.tree(), tokens)
        (loss / world).backward()
        reduce_gradients(model)
        optimizer.step()
        return loss.detach()

    return step

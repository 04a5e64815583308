"""Helpers of the CNN models' tests: the rank function of the 2-rank
synchronized ``TpuBatchNorm`` check.  Imports torch and the port only, so
a spawned rank starts without JAX."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from torch_port_util import _write_result

SBN_LOCAL = (3, 4, 5, 6)      # a rank's batch, NHWC
SBN_MOMENTUM, SBN_EPSILON = 0.9, 1e-5


def sbn_arrays(world: int = 2) -> dict:
    """The global batch (ranks' batches stacked on N), the weights of the
    weighted sum that drives the backward pass, and the norm's
    parameters and running stats."""
    rng = np.random.RandomState(21)
    n, h, w, c = SBN_LOCAL
    return {
        "x": (rng.randn(world * n, h, w, c) * 2 + 0.7).astype(np.float32),
        "w": rng.randn(world * n, h, w, c).astype(np.float32),
        "scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
        "bias": (0.1 * rng.randn(c)).astype(np.float32),
        "mean": (0.1 * rng.randn(c)).astype(np.float32),
        "var": (1 + 0.2 * rng.rand(c)).astype(np.float32),
    }


def sync_bn_worker(rank: int, world: int, store_path: str,
                   out_dir: str) -> None:
    """One rank of the synchronized norm: ``TpuBatchNorm(axis_name=
    "world")`` on this rank's block of the batch, train mode, the
    weighted sum back-propagated: the output, the input's gradient, this
    rank's parameter gradients and the running stats."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TpuBatchNorm

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    a = sbn_arrays(world)
    n = SBN_LOCAL[0]
    nchw = lambda k: torch.from_numpy(  # noqa: E731
        a[k][rank * n:(rank + 1) * n].transpose(0, 3, 1, 2).copy())
    bn = TpuBatchNorm(SBN_LOCAL[3], dtype=torch.float32,
                      momentum=SBN_MOMENTUM, epsilon=SBN_EPSILON,
                      axis_name="world", mesh=hvd.world_mesh())
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(a[k]))
    bn.train()
    x = nchw("x").requires_grad_(True)
    y = bn(x)
    (y * nchw("w")).sum().backward()
    res = {"y": y.detach().permute(0, 2, 3, 1), "dx": x.grad.permute(
        0, 2, 3, 1), "dscale": bn.scale.grad, "dbias": bn.bias.grad,
        "mean": bn.mean, "var": bn.var}
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"sbn{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})
    _write_result(out_dir, rank, {"ok": True})


def sync_bn_epilogue_worker(rank: int, world: int, store_path: str,
                            out_dir: str) -> None:
    """One rank of the synchronized norm with its epilogue:
    ``bn(x, residual=r, relu=True)``, ``r`` the weights of the global
    batch reversed along N, train mode, the weighted sum back-propagated:
    the output, the input's and the residual's gradients, this rank's
    parameter gradients and the running stats."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TpuBatchNorm

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    a = sbn_arrays(world)
    a["r"] = a["w"][::-1]
    n = SBN_LOCAL[0]
    nchw = lambda k: torch.from_numpy(  # noqa: E731
        a[k][rank * n:(rank + 1) * n].transpose(0, 3, 1, 2).copy())
    bn = TpuBatchNorm(SBN_LOCAL[3], dtype=torch.float32,
                      momentum=SBN_MOMENTUM, epsilon=SBN_EPSILON,
                      axis_name="world", mesh=hvd.world_mesh())
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(a[k]))
    bn.train()
    x = nchw("x").requires_grad_(True)
    r = nchw("r").requires_grad_(True)
    y = bn(x, residual=r, relu=True)
    (y * nchw("w")).sum().backward()
    res = {"y": y.detach(), "dx": x.grad, "dr": r.grad,
           "dscale": bn.scale.grad, "dbias": bn.bias.grad,
           "mean": bn.mean, "var": bn.var}
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"sbn_epi{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})
    _write_result(out_dir, rank, {"ok": True})

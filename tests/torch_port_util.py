"""Helpers of the PyTorch port's tests: the narrow ResNet, synthetic
batches, a training loop and the rank function of the 2-process gloo
test.  Imports torch and the port only, so a spawned rank starts
without JAX."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F


def narrow_resnet(seed: int = 0):
    from horovod_tpu_torch.models import ResNet

    return ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                  dtype=torch.float32,
                  generator=torch.Generator().manual_seed(seed))


def synthetic_batches(n_steps: int, size: int = 32, batch: int = 8,
                      seed: int = 7):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, size, size, 3).astype(np.float32),
             rng.randint(0, 10, size=(batch,))) for _ in range(n_steps)]


def train_steps(model, opt, batches):
    """One optimizer step per batch; returns the losses."""
    losses = []
    model.train()
    for x, y in batches:
        opt.zero_grad()
        loss = F.cross_entropy(model(torch.from_numpy(x)),
                               torch.from_numpy(y))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def two_rank_worker(rank: int, world: int, store_path: str, out_dir: str,
                    predivide: float, threshold: int) -> None:
    os.environ["HVTPU_FUSION_THRESHOLD"] = str(threshold)
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        hvd.init(device="cpu")
        assert (hvd.rank(), hvd.size()) == (rank, world)
        # every rank starts from its own init; broadcast makes them equal
        model = narrow_resnet(seed=100 + rank)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            gradient_predivide_factor=predivide)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        rng = np.random.RandomState(rank)   # different data per rank
        x = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 10, size=(4,)))
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        local = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        opt.synchronize()
        reduced = {n: p.grad.detach().clone()
                   for n, p in model.named_parameters()}
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        summed = hvd.allreduce(torch.full((3,), float(rank + 1)),
                               op=hvd.Sum)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 summed=summed.numpy(),
                 **{f"local/{n}": t.numpy() for n, t in local.items()},
                 **{f"reduced/{n}": t.numpy() for n, t in reduced.items()},
                 **{f"param/{n}": t.numpy() for n, t in params.items()})
        hvd.shutdown()
    finally:
        dist.destroy_process_group()

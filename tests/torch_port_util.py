"""Helpers of the PyTorch port's tests: the narrow ResNet, synthetic
batches, a training loop and the rank function of the 2-process gloo
test.  Imports torch and the port only, so a spawned rank starts
without JAX."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F


@pytest.fixture(scope="module", autouse=True)
def no_leaked_reference():
    """Shut down the JAX reference when an earlier test file of this
    worker left it initialized (``tests/test_integrity.py``'s
    ``TestNonfiniteGuard`` inits it and never shuts it down).  A leaked
    reference answers the rank and size of a world of one to the code
    that reads them, and its ``init()`` returns at once, so a test that
    compares with it, or a later test that inits it, would see the
    leaked state.  Each port test module imports this autouse fixture."""
    ref_state = sys.modules.get("horovod_tpu.core.state")
    if ref_state is not None and ref_state.global_state().initialized:
        sys.modules["horovod_tpu"].shutdown()
    yield


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
        two_rank_step(hvd, rank, out_dir, predivide)
        hvd.shutdown()
    finally:
        dist.destroy_process_group()


def two_rank_step(hvd, rank: int, out_dir: str, predivide: float) -> None:
    """One optimizer step of the narrow ResNet from a broadcast init on
    per-rank data, then an allreduce of ``rank + 1``; this rank's local
    and reduced gradients, parameters and sum in
    ``out_dir/rank<rank>.npz`` (with ``master_addr``: whether the env
    named ``MASTER_ADDR``).  ``two_rank_worker`` and the launched
    ``torch_port_launch_script.py resnet`` both run it."""
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
    summed = hvd.allreduce(torch.full((3,), float(rank + 1)), op=hvd.Sum)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             summed=summed.numpy(),
             master_addr=np.array("MASTER_ADDR" in os.environ),
             **{f"local/{n}": t.numpy() for n, t in local.items()},
             **{f"reduced/{n}": t.numpy() for n, t in reduced.items()},
             **{f"param/{n}": t.numpy() for n, t in params.items()})


def launched_rank_info(scale: float = 1.0) -> dict:
    """A ``runner.run`` payload: init through the launcher's env, this
    rank's placement and device, a Sum of ``scale * (rank + 1)``."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        out = hvd.allreduce(torch.full((2,), scale * (hvd.rank() + 1)),
                            op=hvd.Sum)
        return {"rank": hvd.rank(), "size": hvd.size(),
                "local_rank": hvd.local_rank(),
                "device": str(hvd.device()), "sum": out.tolist(),
                "master_addr": "MASTER_ADDR" in os.environ}
    finally:
        hvd.shutdown()


# -- the collectives of the second slice, 2 ranks over gloo -------------------

INT8_N = 1500          # not a multiple of 2 * 512


def collective_inputs(rank: int) -> dict:
    """Per-rank inputs of ``collectives_worker``, made with numpy from a
    seed; the test makes the same arrays for its references."""
    rng = np.random.RandomState(40 + rank)
    return dict(
        int8=(rng.randn(INT8_N) * (1 + rank)).astype(np.float32),
        int8_bf16=(rng.randn(7, 300) * 3).astype(np.float32),
        group_a=rng.randn(5, 3).astype(np.float32),
        group_b=rng.randint(-50, 50, size=(9,)).astype(np.int32),
        group_c=rng.randn(4).astype(np.float32),
        gather=rng.randn(3 + 2 * rank, 2).astype(np.float32),
        a2a=rng.randn(6, 3).astype(np.float32),
        rs_even=rng.randn(6, 2).astype(np.float32),
        rs_odd=rng.randn(5, 2).astype(np.float32),
        rs_int=rng.randint(-9, 9, size=(4,)).astype(np.int32),
        minmax=rng.randn(11).astype(np.float32),
        prod=(rng.rand(11) + 0.5).astype(np.float32),
    )


A2A_SPLITS = {0: [2, 4], 1: [5, 1]}


def collectives_worker(rank: int, world: int, store_path: str,
                       out_dir: str) -> None:
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.compression import Compression

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        hvd.init(device="cpu")
        x = {k: torch.from_numpy(v) for k, v in collective_inputs(rank).items()}
        res = {}
        # the engine's codecs ride the engine's allreduce: the torch
        # surface maps them to none, as the reference does
        for name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
            res[f"int8_{name}"] = eager.allreduce(
                x["int8"], op=op, compression=Compression.int8)
        res["int8_scaled"] = eager.allreduce(
            x["int8"], op=hvd.Sum, compression=Compression.int8,
            prescale_factor=0.5, postscale_factor=3.0)
        res["int8_bf16"] = eager.allreduce(
            x["int8_bf16"].to(torch.bfloat16), op=hvd.Average,
            compression=Compression.int8).float()
        res["int8_stoch"] = eager.allreduce(
            x["int8"], op=hvd.Sum, compression=Compression.int8_stochastic)
        res["fp16_avg"] = eager.allreduce(
            x["int8"], op=hvd.Average, compression=Compression.fp16)
        outs = hvd.grouped_allreduce(
            [x["group_a"], x["group_b"], x["group_c"]], op=hvd.Sum)
        res.update(group_a=outs[0], group_b=outs[1], group_c=outs[2])
        res["group_max"] = torch.cat([t.reshape(-1).float() for t in
                                      hvd.grouped_allreduce(
                                          [x["group_a"], x["group_c"]],
                                          op=hvd.Max)])
        res["gather"] = hvd.allgather(x["gather"])
        a2a, splits = hvd.alltoall(x["a2a"], A2A_SPLITS[rank])
        res.update(a2a=a2a, a2a_splits=splits)
        res["a2a_equal"] = hvd.alltoall(x["a2a"])
        res["rs_even_sum"] = hvd.reducescatter(x["rs_even"], op=hvd.Sum)
        res["rs_even_avg"] = hvd.reducescatter(x["rs_even"], op=hvd.Average)
        res["rs_odd_sum"] = hvd.reducescatter(x["rs_odd"], op=hvd.Sum)
        res["rs_int_avg"] = hvd.reducescatter(x["rs_int"], op=hvd.Average)
        res["min"] = hvd.allreduce(x["minmax"], op=hvd.Min)
        res["max"] = hvd.allreduce(x["minmax"], op=hvd.Max)
        res["prod"] = hvd.allreduce(x["prod"], op=hvd.Product)
        np.savez(os.path.join(out_dir, f"coll{rank}.npz"),
                 **{k: v.numpy() for k, v in res.items()})
        hvd.shutdown()
    finally:
        dist.destroy_process_group()


# -- Average over a rank count that is not a power of two, 3 ranks over gloo --

AVG_N = 3000


def average_inputs(rank: int) -> dict:
    """Per-rank inputs of ``average_worker``.  The plain allreduce inputs
    are quarters of small integers, so every partial sum is exact in
    float32, bfloat16 and float16 and the backends' summation orders
    agree: what differs is only how Average scales the sum."""
    rng = np.random.RandomState(60 + rank)
    quarters = (rng.randint(-64, 65, size=AVG_N) * 0.25).astype(np.float32)
    return dict(
        exact=quarters,
        int8=(rng.randn(AVG_N) * (1 + rank)).astype(np.float32),
        ints=rng.randint(-100, 100, size=(AVG_N,)).astype(np.int32),
        rs=quarters[:6 * 50].reshape(6, 50),
    )


def average_worker(rank: int, world: int, store_path: str,
                   out_dir: str) -> None:
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.quantized import quantized_allreduce

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        hvd.init(device="cpu")
        x = {k: torch.from_numpy(v) for k, v in average_inputs(rank).items()}
        res = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                         ("f16", torch.float16)):
            res[f"avg_{name}"] = hvd.allreduce(x["exact"].to(dt),
                                               op=hvd.Average).float()
        res["avg_int"] = hvd.allreduce(x["ints"], op=hvd.Average)
        res["avg_int8"] = eager.allreduce(x["int8"], op=hvd.Average,
                                          compression=Compression.int8)
        res["quantized_avg"] = quantized_allreduce(x["int8"], average=True)
        res["rs_avg"] = hvd.reducescatter(x["rs"], op=hvd.Average)
        np.savez(os.path.join(out_dir, f"avg{rank}.npz"),
                 **{k: v.numpy() for k, v in res.items()})
        hvd.shutdown()
    finally:
        dist.destroy_process_group()


# -- the torch surface's autograd and codec mapping, 2 ranks over gloo --------

MPI_ROOT = 1           # broadcast's root: rank 0's gradient must be zeros


def mpi_ops_inputs(rank: int) -> dict:
    """Per-rank inputs of ``mpi_ops_worker``: each collective's input and
    the weights ``w`` of the weighted sum whose backward it runs."""
    rng = np.random.RandomState(80 + rank)
    rs_rows = 3 - rank                  # 5 rows over 2 ranks: 3 and 2
    a2a_rows = sum(A2A_SPLITS[s][rank] for s in range(2))
    mag = 10.0 ** rng.uniform(-8, 4, size=600)
    f32 = np.float32
    return dict(
        x=rng.randn(6, 5).astype(f32),
        w_sum=rng.randn(6, 5).astype(f32),
        w_avg=rng.randn(6, 5).astype(f32),
        gather=rng.randn(3 + 2 * rank, 4).astype(f32),
        w_gather=rng.randn(8, 4).astype(f32),
        bcast=rng.randn(7).astype(f32),
        w_bcast=rng.randn(7).astype(f32),
        rs=rng.randn(5, 3).astype(f32),
        w_rs_sum=rng.randn(rs_rows, 3).astype(f32),
        w_rs_avg=rng.randn(rs_rows, 3).astype(f32),
        a2a=rng.randn(6, 3).astype(f32),
        w_a2a=rng.randn(a2a_rows, 3).astype(f32),
        # over 12 decades: an fp16 wire flushes, rounds and overflows
        # values that a bfloat16 wire keeps
        wire=(rng.randn(600) * mag).astype(f32),
    )


def mpi_ops_worker(rank: int, world: int, store_path: str,
                   out_dir: str) -> None:
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm.compression import Compression as Engine

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        hvd.init(device="cpu")
        a = {k: torch.from_numpy(v) for k, v in mpi_ops_inputs(rank).items()}
        res = {}

        def run(name, fn, x, w):
            """Forward and the input's grad after backward of sum(y * w)."""
            x = x.clone().requires_grad_()
            y = fn(x)
            (y * w).sum().backward()
            res[name], res[f"grad_{name}"] = y.detach(), x.grad

        for name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
            run(f"allreduce_{name}", lambda x: hvd.allreduce(x, op=op),
                a["x"], a[f"w_{name}"])
            run(f"rs_{name}", lambda x: hvd.reducescatter(x, op),
                a["rs"], a[f"w_rs_{name}"])
        run("allgather", hvd.allgather, a["gather"], a["w_gather"])
        run("bcast", lambda x: hvd.broadcast(x, MPI_ROOT, "bcast"),
            a["bcast"], a["w_bcast"])
        run("a2a", lambda x: hvd.alltoall(x, A2A_SPLITS[rank])[0],
            a["a2a"], a["w_a2a"])
        bf16 = a["wire"].to(torch.bfloat16)
        for name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
            res[f"fp16_wire_{name}"] = hvd.allreduce(
                bf16, op=op, compression=hvd.Compression.fp16).float()
        res["bf16_wire_sum"] = hvd.allreduce(bf16, op=hvd.Sum).float()
        res["engine_int8_sum"] = hvd.allreduce(a["x"], op=hvd.Sum,
                                               compression=Engine.int8)
        np.savez(os.path.join(out_dir, f"mpi{rank}.npz"),
                 **{k: v.numpy() for k, v in res.items()})
        hvd.shutdown()
    finally:
        dist.destroy_process_group()


# -- the async controller, 2 and 3 ranks over gloo ----------------------------

ASYNC_NAMES = ["a", "b", "c", "d"]


def async_inputs(rank: int, world: int) -> dict:
    """Per-rank inputs of ``async_worker``: small integers and halves, so
    every sum over 2 or 3 ranks is exact in any order."""
    rng = np.random.RandomState(90 + rank)
    ints = lambda *s: rng.randint(-40, 41, size=s)  # noqa: E731
    f32 = np.float32
    return dict(
        **{n: (ints(3 + i, 2) * 0.5).astype(f32)
           for i, n in enumerate(ASYNC_NAMES)},
        ps=(ints(6) * 0.25).astype(f32),
        grouped=(ints(10) * 0.5).astype(f32),
        grouped_b=(ints(4) * 0.5).astype(f32),
        gather=ints(2 + rank, 3).astype(np.int32),
        bcast=ints(5).astype(f32),
        rs=(ints(2 * world, 3) * 0.5).astype(f32),
        a2a=ints(2 * world, 2).astype(f32),
        sparse_rows=rng.choice(8, size=3 + rank).astype(np.int64),
        sparse_vals=(ints(3 + rank, 4) * 0.5).astype(f32),
    )


def async_weights(shape) -> torch.Tensor:
    """The weights of the process-set allgather's backward, the same on
    every rank."""
    n = int(np.prod(shape))
    return torch.arange(n, dtype=torch.float32).reshape(shape) * 0.5


def async_process_set(world: int):
    return [0, 2] if world == 3 else [1]


def async_worker(rank: int, world: int, store_path: str,
                 out_dir: str, python_core: bool = False) -> None:
    """The async plane at ``world`` ranks: out-of-order enqueue, a
    partial submission, the grouped fused path, the other async ops, a
    process set (members and a non-member), its removal, and shutdown
    with an op in flight.  Rank 0 records every call its negotiation
    core's coordinator side takes, for a replay through the JAX
    package's core.  ``python_core``: ``PyController`` instead of the
    default C++ core."""
    import pickle
    import threading
    import time

    torch.set_num_threads(1)
    if python_core:
        os.environ["HVTPU_FORCE_PY_CONTROLLER"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native import core, fallback

    cls = fallback.PyController if python_core else core.NativeController
    log = []
    if rank == 0:
        # the streamed plane calls the core from two threads: a call and
        # its log entry are one step, so the log keeps the core's order
        log_lock = threading.Lock()
        for method in ("ingest", "compute_responses", "apply_responses",
                       "declare_group", "register_process_set"):
            orig = getattr(cls, method)

            def wrapped(self, *args, _orig=orig, _m=method):
                with log_lock:
                    out = _orig(self, *args)
                    log.append((_m, args, out))
                return out
            setattr(cls, method, wrapped)

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    x = {k: torch.from_numpy(v) for k, v in async_inputs(rank, world).items()}
    res, errors = {}, {}
    try:
        hvd.init(device="cpu")
        # every rank enqueues the named ops in its own order
        order = list(np.random.RandomState(rank).permutation(ASYNC_NAMES))
        handles = {n: hvd.allreduce_async(x[n], name=n, op=hvd.Sum)
                   for n in order}
        for n in ASYNC_NAMES:
            res[f"ooo_{n}"] = hvd.synchronize(handles[n])
        from horovod_tpu_torch.eager import get_controller

        core_name = type(get_controller()._ctrl).__name__
        # a partial submission waits for the last rank, which enqueues
        # only once rank 0 has polled its handle after some cycles
        store = dist.PrefixStore(
            "test", dist.distributed_c10d._get_default_store())
        if rank == world - 1:
            store.wait(["polled"])
        h = hvd.allreduce_async(x["a"], name="partial", op=hvd.Average)
        if rank == 0:
            time.sleep(0.2)
            res["partial_polled"] = np.asarray(hvd.poll(h))
            store.set("polled", b"1")
        res["partial"] = hvd.synchronize(h)
        res["partial_polled_after"] = np.asarray(hvd.poll(h))
        # the fused path: fp16 wire, the predivide scales
        hs = hvd.grouped_allreduce_async(
            [x["grouped"], x["grouped_b"].to(torch.bfloat16)], op=hvd.Sum,
            names=["g0", "g1"], compression=hvd.Compression.fp16,
            prescale_factor=0.5, postscale_factor=2.0)
        res["grouped0"], g1 = [hvd.synchronize(h) for h in hs]
        res["grouped1"] = g1.float()
        res["gather"] = hvd.synchronize(hvd.allgather_async(x["gather"]))
        res["bcast"] = hvd.synchronize(
            hvd.broadcast_async(x["bcast"], world - 1, "bc"))
        res["rs"] = hvd.synchronize(hvd.reducescatter_async(x["rs"],
                                                            op=hvd.Sum))
        res["a2a"] = hvd.synchronize(hvd.alltoall_async(x["a2a"]))
        res["ggather"], = [hvd.synchronize(h) for h in
                           hvd.grouped_allgather_async([x["gather"]])]
        sp = torch.sparse_coo_tensor(x["sparse_rows"][None], x["sparse_vals"],
                                     (8, 4))
        res["sparse"] = hvd.synchronize(
            hvd.sparse_allreduce_async(sp, op=hvd.Sum)).to_dense()
        # a process set: members reduce over it, a non-member is refused
        ps = hvd.add_process_set(async_process_set(world))
        res["ps_id"] = np.asarray(ps.process_set_id)
        if ps.included():
            res["ps_sum"] = hvd.synchronize(hvd.allreduce_async(
                x["ps"], name="ps_sum", op=hvd.Sum, process_set=ps))
            res["ps_avg"] = hvd.synchronize(hvd.allreduce_async(
                x["ps"], name="ps_avg", op=hvd.Average, process_set=ps))
            res["ps_sync_avg"] = hvd.allreduce(x["ps"], op=hvd.Average,
                                               process_set=ps)
            # allgather's adjoint slices this rank's rows of the set
            xg = x["gather"].float().requires_grad_()
            y = hvd.allgather(xg, process_set=ps)
            (y * async_weights(y.shape)).sum().backward()
            res["ps_gather"], res["ps_gather_grad"] = y.detach(), xg.grad
            # the optimizer over the set: predivide 2, postscale 2 / 2
            w = torch.nn.Parameter(torch.zeros(6))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD([w], lr=1.0), named_parameters=[("w", w)],
                gradient_predivide_factor=2.0, process_set=ps)
            w.grad = x["ps"].clone()
            opt.synchronize()
            res["ps_opt_grad"] = w.grad.detach().clone()
        else:
            for what, fn in (
                    ("sync", lambda: hvd.allreduce(x["ps"], process_set=ps)),
                    ("async", lambda: hvd.allreduce_async(
                        x["ps"], name="ps_sum", process_set=ps))):
                try:
                    fn()
                except RuntimeError as e:
                    errors[f"ps_{what}"] = str(e)
        res["ps_removed"] = np.asarray([hvd.remove_process_set(ps),
                                        hvd.remove_process_set(ps)])
        ps2 = hvd.add_process_set([world - 1])
        res["ps2_id"] = np.asarray(ps2.process_set_id)
        if ps2.included():
            res["ps2"] = hvd.synchronize(hvd.allreduce_async(
                x["ps"], name="ps2", op=hvd.Sum, process_set=ps2))
        hvd.remove_process_set(ps2)
        res["after_ps"] = hvd.synchronize(hvd.allreduce_async(
            x["b"], name="after", op=hvd.Sum))
        # a shape that differs on one rank: every rank gets the
        # coordinator's mismatch error, naming that rank
        try:
            hvd.synchronize(hvd.allreduce_async(
                torch.zeros(3 + (rank == 1)), name="mismatch", op=hvd.Sum))
        except hvd.HvtpuMismatchError as e:
            errors["mismatch"] = str(e)
        # shutdown with an op in flight: the last rank never enqueues it,
        # and shuts down once the others have (else a late rank's op
        # could meet another rank's shutdown first, on the streamed
        # plane, and fail naming that rank)
        if rank != world - 1:
            h = hvd.allreduce_async(x["a"], name="never", op=hvd.Sum)
            store.set(f"never{rank}", b"1")
        t0 = time.time()
        if rank == world - 1:
            store.wait([f"never{r}" for r in range(world - 1)])
            hvd.shutdown()
        else:
            try:
                hvd.synchronize(h)
            except hvd.HorovodInternalError as e:
                errors["in_flight"] = str(e)
            hvd.shutdown()
        res["shutdown_s"] = np.asarray(time.time() - t0)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"async{rank}.pkl"), "wb") as f:
        pickle.dump({"res": {k: np.asarray(v) for k, v in res.items()},
                     "errors": errors, "log": log, "core": core_name}, f)


# -- the streamed plane, 2 ranks over gloo ------------------------------------

STREAM_STEPS = 16
STREAM_SHAPES = [(5, 3), (17,), (2, 2, 2)]


def stream_inputs(rank: int, step: int) -> list:
    """One burst of ``stream_worker``: small integers and halves, so the
    sum of 2 ranks and its half are exact."""
    rng = np.random.RandomState(1000 * step + rank)
    return [(rng.randint(-40, 41, size=s) * 0.5).astype(np.float32)
            for s in STREAM_SHAPES]


def _stream_run(hvd, rank: int) -> dict:
    """``STREAM_STEPS`` bursts of ``allreduce_async_`` (the optimizer's
    default: Average, no codec, scales 1), then one fp16 grouped burst
    with the predivide scales; the controller's plane and counters."""
    res = {}
    for step in range(STREAM_STEPS):
        ts = [torch.from_numpy(x) for x in stream_inputs(rank, step)]
        hs = [hvd.allreduce_async_(t, name=f"s/{i}")
              for i, t in enumerate(ts)]
        for i, h in enumerate(hs):
            out = hvd.synchronize(h)
            assert out is ts[i]
            res[f"s{step}/{i}"] = out.clone()
    g = [torch.from_numpy(x) for x in stream_inputs(rank, 99)]
    hs = hvd.grouped_allreduce_async(g, names=["g/0", "g/1", "g/2"],
                                     op=hvd.Sum,
                                     compression=hvd.Compression.fp16,
                                     prescale_factor=0.5,
                                     postscale_factor=2.0)
    for i, h in enumerate(hs):
        res[f"g/{i}"] = hvd.synchronize(h)
    from horovod_tpu_torch.eager import get_controller

    state = get_controller().debug_state()
    res["state"] = {k: state[k] for k in (
        "plane", "predicted_bursts", "mispredicts", "zero_copy_ops",
        "staged_copies")}
    return res


def stream_worker(rank: int, world: int, store_path: str,
                  out_dir: str) -> None:
    """The same traffic on the default plane (streamed, at 2 ranks) and,
    after a shutdown and an init, on the lockstep plane
    (``HVTPU_EAGER_STREAM=0``)."""
    import pickle

    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    out = {}
    try:
        for plane, env in (("default", None), ("lockstep", "0")):
            if env is not None:
                os.environ["HVTPU_EAGER_STREAM"] = env
            hvd.init(device="cpu")
            try:
                out[plane] = _stream_run(hvd, rank)
            finally:
                hvd.shutdown()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"stream{rank}.pkl"), "wb") as f:
        pickle.dump({p: {k: (v if k == "state" else v.numpy())
                         for k, v in r.items()} for p, r in out.items()}, f)


# -- Adasum, 4 ranks over gloo ------------------------------------------------

ADASUM_SHAPES = [(33,), (4, 5), (7, 3, 2)]
ADASUM_SETS = {"world": None, "pair": [1, 3], "three": [0, 1, 2]}


def adasum_inputs(rank: int) -> list:
    rng = np.random.RandomState(500 + rank)
    return [rng.randn(*s).astype(np.float32) for s in ADASUM_SHAPES]


def adasum_worker(rank: int, world: int, store_path: str,
                  out_dir: str, python_core: bool = False) -> None:
    """``adasum_reduce`` and ``allreduce(op=Adasum)`` (sync, async and
    the optimizer) over the world of 4, over a set of 2 ({1, 3}), and the
    refusal over a set of 3 ({0, 1, 2}).  ``python_core``: the async
    ops negotiate on ``PyController`` instead of the default C++ core."""
    import pickle

    torch.set_num_threads(1)
    if python_core:
        os.environ["HVTPU_FORCE_PY_CONTROLLER"] = "1"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.comm.adasum import adasum_reduce

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    res, errors = {}, {}
    try:
        hvd.init(device="cpu")
        xs = [torch.from_numpy(x) for x in adasum_inputs(rank)]
        sets = {k: (v if v is None else hvd.add_process_set(v))
                for k, v in ADASUM_SETS.items()}
        for key, ps in sets.items():
            if ps is not None and not ps.included():
                continue
            if key == "three":
                for what, fn in (
                        ("sync", lambda: hvd.allreduce(
                            xs[0], op=hvd.Adasum, process_set=ps)),
                        ("async", lambda: hvd.synchronize(
                            hvd.allreduce_async(xs[0], op=hvd.Adasum,
                                                name="three",
                                                process_set=ps)))):
                    try:
                        fn()
                    except Exception as e:  # noqa: BLE001 — recorded
                        errors[f"three_{what}"] = (type(e).__name__, str(e))
                continue
            the_set = ps if ps is not None else hvd.global_process_set
            flat = torch.cat([x.reshape(-1) for x in xs])
            sizes = [x.numel() for x in xs]
            offs = [sum(sizes[:i]) for i in range(len(sizes))]
            res[f"{key}/reduce"] = adasum_reduce(flat, the_set)
            res[f"{key}/segments"] = adasum_reduce(
                flat, the_set, list(zip(offs, sizes)))
            for i, x in enumerate(xs):
                res[f"{key}/sync{i}"] = hvd.allreduce(x, op=hvd.Adasum,
                                                      process_set=ps)
            hs = [hvd.allreduce_async(x, op=hvd.Adasum, name=f"{key}.a{i}",
                                      process_set=ps)
                  for i, x in enumerate(xs)]
            for i, h in enumerate(hs):
                res[f"{key}/async{i}"] = hvd.synchronize(h)
            # the optimizer: each gradient its own Adasum, SGD lr 1 from 0
            ws = [torch.nn.Parameter(torch.zeros_like(x)) for x in xs]
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(ws, lr=1.0),
                named_parameters=[(f"w{i}", w) for i, w in enumerate(ws)],
                op=hvd.Adasum, process_set=ps)
            for w, x in zip(ws, xs):
                w.grad = x.clone()
            opt.step()
            for i, w in enumerate(ws):
                res[f"{key}/opt{i}"] = -w.detach()
            # fp16 wire: compressed before the combine
            res[f"{key}/fp16"] = hvd.allreduce(
                xs[0], op=hvd.Adasum, compression=hvd.Compression.fp16,
                process_set=ps)
        # identical inputs combine to the input, inputs with disjoint
        # supports (orthogonal) to their sum
        same = torch.from_numpy(adasum_inputs(0)[0])
        res["world/ident"] = hvd.allreduce(same, op=hvd.Adasum)
        orth = torch.zeros(4 * 8)
        orth[8 * rank:8 * rank + 8] = same[:8]
        res["world/orth"] = hvd.allreduce(orth, op=hvd.Adasum)
        for ps in sets.values():
            if ps is not None:
                hvd.remove_process_set(ps)
        core_name = type(get_controller()._ctrl).__name__
        hvd.shutdown()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"adasum{rank}.pkl"), "wb") as f:
        pickle.dump({"res": {k: v.numpy() for k, v in res.items()},
                     "errors": errors, "core": core_name}, f)


# -- the ring collectives one rank a process, 2 and 3 ranks over gloo ---------

RING_IPC_CASES = {2: (1024, 3001), 3: (4000,)}
RING_IPC_MODES = {"sum": {}, "average": {"average": True},
                  "quantized": {"quantized": True}}


def ring_ipc_inputs(n: int, per_rank: int) -> np.ndarray:
    """``(n, per_rank)`` float32, rank r's input in row r: the inputs of
    ``tests/test_torch_port_ring.py`` ``_inputs`` (subnormals and a sum
    that cancels below FLT_MIN included)."""
    rng = np.random.RandomState(per_rank + n)
    x = rng.randn(n, per_rank).astype(np.float32)
    if per_rank >= 100:
        x[:, :10] = 3e-39
        x[:, 20] = 0.0
        x[0, 20], x[1, 20] = 1.5e-38, -1.4e-38
    return x


def ring_ipc_blocks(n: int) -> np.ndarray:
    """``(n*16, 128)`` float32: rank r's A4 block is rows 16r..16r+15."""
    return np.random.RandomState(30 + n).randn(n * 16, 128).astype(
        np.float32)


def ring_ipc_ints(n: int) -> np.ndarray:
    return (np.arange(n * 64, dtype=np.int32).reshape(n, 64) * 7919
            - 2000)


def ring_ipc_route_input(rank: int) -> np.ndarray:
    """Rank r's input of the ``HVTPU_QUANTIZED_RING`` route: (3, 700),
    not a multiple of a chunk."""
    return (np.random.RandomState(50 + rank).randn(3, 700)
            * (1 + rank)).astype(np.float32)


def ring_ipc_worker(rank: int, world: int, store_path: str,
                    out_dir: str) -> None:
    """``ProcessRing``'s plain versions at every case of
    ``RING_IPC_CASES[world]``, A4 and int32; at 2 ranks also the
    ``HVTPU_QUANTIZED_RING`` route through the engine's allreduce, with
    a spy on the ring's plain reduction."""
    torch.set_num_threads(1)
    os.environ.pop("HVTPU_QUANTIZED_RING", None)
    from horovod_tpu_torch.ops import ring as ring_mod
    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        ring = ring_mod.ProcessRing()
        res = {}
        for per_rank in RING_IPC_CASES[world]:
            x = torch.from_numpy(ring_ipc_inputs(world, per_rank)[rank])
            for mode, kw in RING_IPC_MODES.items():
                res[f"{mode}_{per_rank}"] = ring.allreduce(x, **kw)
            # the input is not written
            assert torch.equal(x, torch.from_numpy(
                ring_ipc_inputs(world, per_rank)[rank]))
        res["gather"] = ring.allgather_2d(torch.from_numpy(
            ring_ipc_blocks(world)[16 * rank:16 * (rank + 1)].copy()))
        ints = torch.from_numpy(ring_ipc_ints(world)[rank].copy())
        res["int_sum"] = ring.allreduce(ints)
        res["int_avg"] = ring.allreduce(ints, average=True)
        res["launches"] = np.array([
            ring_allgather_2d.ipc_launches, ring_allreduce.ipc_launches,
            ring_allreduce.quantized_ipc_launches])
        if world == 2:
            res.update(_ring_route(rank, world, ring_mod))
        np.savez(os.path.join(out_dir, f"ring_ipc{rank}.npz"),
                 **{k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _ring_route(rank: int, world: int, ring_mod) -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.quantized import quantized_allreduce

    calls = []
    plain = ring_mod.ProcessRing._sum_plain

    def spy(self, flat, quantized):
        calls.append(quantized)
        return plain(self, flat, quantized)

    ring_mod.ProcessRing._sum_plain = spy
    hvd.init(device="cpu")
    solo = [dist.new_group([r]) for r in range(world)][rank]
    x = torch.from_numpy(ring_ipc_route_input(rank))
    res = {}

    def run(tag):
        start = len(calls)
        for name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
            res[f"{tag}_{name}"] = eager.allreduce(
                x, op=op, compression=Compression.int8)
        after_ring = len(calls)
        res[f"{tag}_stoch"] = eager.allreduce(
            x, op=hvd.Sum, compression=Compression.int8_stochastic)
        res[f"{tag}_solo"] = quantized_allreduce(x, group=solo)
        return [after_ring - start, len(calls) - after_ring]

    os.environ["HVTPU_QUANTIZED_RING"] = "1"
    try:
        on = run("on")
    finally:
        del os.environ["HVTPU_QUANTIZED_RING"]
    off = run("off")
    res["ring_calls"] = np.array(on + off)
    res["ring_quantized"] = np.array(calls, dtype=bool)
    hvd.shutdown()
    return res


# -- the stall watchdog, faults and retry, 2 ranks over gloo ------------------

def spawn_world(target, world: int, tmp_path, *args, timeout: float = 60.0):
    """Run ``target(rank, world, store_path, out_dir, *args)`` in ``world``
    spawned processes (``HVTPU_FLIGHT_DIR`` set to ``tmp_path``), join
    them under ``timeout`` (killing any still alive) and return
    ``(exit codes, [rank r's JSON result or None])``."""
    return join_world(start_world(target, world, tmp_path, *args),
                      timeout=timeout)


def start_world(target, world: int, tmp_path, *args):
    """Start the processes of :func:`spawn_world` and return the handle
    :func:`join_world` takes, so the caller works while they run."""
    import multiprocessing
    import time

    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target,
                         args=(r, world, store, str(tmp_path)) + args)
             for r in range(world)]
    # the ranks' postmortems go to the test's directory, not the cwd
    saved = os.environ.get("HVTPU_FLIGHT_DIR")
    os.environ["HVTPU_FLIGHT_DIR"] = str(tmp_path)
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("HVTPU_FLIGHT_DIR", None)
        else:
            os.environ["HVTPU_FLIGHT_DIR"] = saved
    return procs, world, tmp_path, time.monotonic()


def join_world(handle, timeout: float = 60.0):
    """Join the processes of :func:`start_world` under ``timeout`` (from
    their start; killing any still alive) and return ``(exit codes,
    [rank r's JSON result or None])``."""
    import json
    import time

    procs, world, tmp_path, started = handle
    deadline = started + timeout
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(world):
        path = tmp_path / f"rank{r}.json"
        results.append(json.loads(path.read_text()) if path.exists()
                       else None)
    return [p.exitcode for p in procs], results


def _write_result(out_dir: str, rank: int, result: dict) -> None:
    import json

    tmp = os.path.join(out_dir, f".rank{rank}.json")
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.json"))


def _await_results(out_dir: str, world: int, timeout: float = 20.0) -> None:
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(os.path.exists(os.path.join(out_dir, f"rank{r}.json"))
               for r in range(world)):
            return
        time.sleep(0.02)


def _stall_healthy(hvd, rank: int, out_dir: str) -> dict:
    """The sync op matrix with the watchdog on and off (bitwise), two
    guarded optimizer steps, and one allreduce whose wire send is dropped
    on rank 0 (``HVTPU_WIRE_RETRIES=1``) against the clean one."""
    from horovod_tpu_torch.comm import eager, wirefault
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.core import faults
    from horovod_tpu_torch.core import state as core_state

    st = core_state.global_state()
    rng = np.random.RandomState(40 + rank)
    x = torch.from_numpy(rng.randn(37).astype(np.float32))
    ragged = torch.from_numpy(rng.randn(rank + 2, 3).astype(np.float32))

    def matrix():
        out = {
            "allreduce": hvd.allreduce(x, op=hvd.Sum),
            "average": hvd.allreduce(x, op=hvd.Average),
            "max": hvd.allreduce(x, op=hvd.Max),
            "int8": eager.allreduce(x, op=hvd.Sum,
                                    compression=Compression.int8),
            "adasum": hvd.allreduce(x, op=hvd.Adasum),
            "grouped": torch.cat(hvd.grouped_allreduce(
                [x, x[:5] * 2], op=hvd.Sum)),
            "allgather": hvd.allgather(ragged).reshape(-1),
            "broadcast": hvd.broadcast(x, root_rank=1),
            "alltoall": hvd.alltoall(x[:36]),
            "reducescatter": hvd.reducescatter(x[:36], op=hvd.Sum),
        }
        hvd.barrier()
        return {k: v.numpy().tolist() for k, v in out.items()}

    guarded = matrix()
    guarded_seq = dict(st.sync_stall.debug_state()["counters"])
    mode = st.sync_stall.debug_state()["mode"]
    st.config.stall_check_disable = True
    plain = matrix()
    st.config.stall_check_disable = False

    model = narrow_resnet(seed=3)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    step = hvd.stall_guard(
        lambda xb, yb: train_steps(model, opt, [(xb, yb)]), name="train")
    losses = [step(*b)[0] for b in synthetic_batches(2, batch=4,
                                                     seed=9 + rank)]
    params = torch.cat([p.detach().reshape(-1)
                        for p in model.parameters()]).numpy().tolist()

    y = torch.arange(8, dtype=torch.float32) * (rank + 1) + 0.125
    clean = hvd.allreduce(y, op=hvd.Sum, name="retry").numpy().tolist()
    before = wirefault._M_RETRIES.value()
    faults.install("wire.send:drop@rank=0,times=1", rank=rank)
    try:
        faulted = hvd.allreduce(y, op=hvd.Sum, name="retry").numpy().tolist()
    finally:
        faults.uninstall()
    retries = wirefault._M_RETRIES.value() - before
    ok = float(hvd.allreduce(torch.ones(()), op=hvd.Sum))
    return {"guarded": guarded, "plain": plain, "mode": mode,
            "counters": guarded_seq, "losses": losses, "params": params,
            "clean": clean, "faulted": faulted, "retries": retries,
            "ok": ok}


def _stall_skipped(hvd, rank: int, out_dir: str) -> dict:
    """Rank 1 skips a collective rank 0 enters."""
    import time

    from horovod_tpu_torch.core import state as core_state

    assert float(hvd.allreduce(torch.ones(()), op=hvd.Sum)) == 2.0
    if rank == 1:
        return {"status": "skipped"}
    insp = core_state.global_state().sync_stall
    try:
        hvd.allreduce(torch.ones(4), op=hvd.Sum)
    except hvd.HorovodInternalError as e:
        return {"status": "aborted", "msg": str(e),
                "age": time.monotonic() - insp._tracks["0"].t0,
                **_obs_record(rank, out_dir)}
    return {"status": "completed"}


def _obs_record(rank: int, out_dir: str) -> dict:
    """The watchdog's metric families and this rank's postmortem (the
    flight recorder dumps it into ``HVTPU_FLIGHT_DIR``)."""
    import json
    import time

    from horovod_tpu_torch.comm import stall

    # the heartbeat thread that latched the failure writes the file; the
    # error can surface on this thread first
    path = os.path.join(out_dir, f"postmortem-{rank}-0.json")
    deadline = time.monotonic() + 5.0
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    postmortem = None
    if os.path.exists(path):
        with open(path) as f:
            postmortem = json.load(f)
    return {"counters": stall.counters(), "postmortem": postmortem}


def _stall_diverged(hvd, rank: int, out_dir: str) -> dict:
    """Rank 0 enters an allreduce where rank 1 enters a broadcast; both
    then keep stepping until the watchdog stops them."""
    import time

    t0 = time.monotonic()
    try:
        if rank == 0:
            hvd.allreduce(torch.ones(2), op=hvd.Sum, name="grads")
        else:
            hvd.broadcast(torch.ones(2), root_rank=0)
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            hvd.allreduce(torch.ones(()), op=hvd.Sum)
            time.sleep(0.05)
    except hvd.HorovodInternalError as e:
        return {"status": "mismatch", "msg": str(e),
                "waited": time.monotonic() - t0,
                **_obs_record(rank, out_dir)}
    return {"status": "no-error"}


def _stall_optimizer(hvd, rank: int, out_dir: str) -> dict:
    """Rank 1 stops stepping after 2 steps of ``DistributedOptimizer``;
    rank 0's bucket reduction must name it."""
    import time

    from horovod_tpu_torch.core import state as core_state

    model = narrow_resnet(seed=5)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    batches = synthetic_batches(4, batch=4, seed=20 + rank)
    train_steps(model, opt, batches[:2])
    hierarchical = core_state.global_state().topology is not None
    if rank == 1:
        return {"status": "stopped", "buckets": len(opt.buckets),
                "hierarchical": hierarchical}
    insp = core_state.global_state().sync_stall
    try:
        train_steps(model, opt, batches[2:])
    except hvd.HorovodInternalError as e:
        return {"status": "aborted", "msg": str(e),
                "age": time.monotonic() - insp._tracks["0"].t0,
                "buckets": len(opt.buckets), "hierarchical": hierarchical}
    return {"status": "completed"}


def _stall_controller(hvd, rank: int, out_dir: str) -> dict:
    """Rank 0 enqueues an async op rank 1 never enqueues; the
    controller's stall inspection warns, then aborts naming rank 1."""
    import logging
    import time

    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            warnings.append((time.monotonic(), record.getMessage()))

    logging.getLogger("horovod_tpu_torch.eager").addHandler(Keep())
    warm = hvd.synchronize(hvd.allreduce_async(torch.ones(3), op=hvd.Sum,
                                               name="warm"))
    assert warm.tolist() == [2.0, 2.0, 2.0]
    from horovod_tpu_torch.core import state as core_state

    plane = core_state.global_state().controller.debug_state()["plane"]
    if rank == 1:
        return {"status": "skipped", "plane": plane}
    t0 = time.monotonic()
    handle = hvd.allreduce_async(torch.ones(3), op=hvd.Sum, name="lonely")
    try:
        hvd.synchronize(handle)
    except hvd.HorovodInternalError as e:
        t1 = time.monotonic()
        return {"status": "aborted", "msg": str(e), "waited": t1 - t0,
                "plane": plane,
                "warnings": [(t - t0, m) for t, m in warnings
                             if "lonely" in m]}
    return {"status": "completed", "plane": plane}


STALL_SCENARIOS = {
    "healthy": _stall_healthy,
    "skipped": _stall_skipped,
    "diverged": _stall_diverged,
    "optimizer": _stall_optimizer,
    "controller": _stall_controller,
}


def stall_worker(rank: int, world: int, store_path: str, out_dir: str,
                 scenario: str, env: dict) -> None:
    """One rank of a watchdog scenario: the env first (with
    ``HVTPU_UNIFORM_LOCAL_SIZE`` set, also this rank's place in the
    launcher's layout of that many ranks a host), then gloo and
    ``init(device="cpu")``, the scenario, its result as JSON.  The
    healthy scenario shuts down; the others leave a collective wedged on
    purpose, so every rank waits for the others' results and then
    rank 0 exits through ``shutdown()`` and the exit hook (a poisoned
    rank hard-exits with status 1) and the others with ``os._exit(0)``."""
    os.environ.update(env)
    local = int(env.get("HVTPU_UNIFORM_LOCAL_SIZE", 0))
    if local:
        # the launcher's host-major layout of ``local`` ranks a host
        os.environ.update(
            HVTPU_LOCAL_RANK=str(rank % local), HVTPU_LOCAL_SIZE=str(local),
            HVTPU_CROSS_RANK=str(rank // local),
            HVTPU_CROSS_SIZE=str(world // local))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    result = STALL_SCENARIOS[scenario](hvd, rank, out_dir)
    if scenario == "healthy":
        hvd.shutdown()
        dist.destroy_process_group()
        _write_result(out_dir, rank, result)
        return
    from horovod_tpu_torch.comm import stall

    result["poisoned"] = stall.poisoned()
    _write_result(out_dir, rank, result)
    _await_results(out_dir, world)
    if rank != 0 or not stall.poisoned():
        os._exit(0)
    hvd.shutdown()      # bounded; the exit hook then hard-exits


# -- the observability slice (test_torch_port_obs_slice.py) -----------------

OBS_KINDS = ("allreduce", "allgather", "broadcast", "alltoall",
             "reducescatter")


def _named_op(hvd, kind: str, name: str):
    x = torch.ones(4, 2)
    if kind == "allreduce":
        return hvd.allreduce(x, op=hvd.Sum, name=name)
    if kind == "allgather":
        return hvd.allgather(x, name=name)
    if kind == "broadcast":
        return hvd.broadcast(x, 0, name)
    if kind == "alltoall":
        return hvd.alltoall(x, name=name)
    return hvd.reducescatter(x, hvd.Sum, name)


def trace_span_names(path: str) -> list:
    """Per step window (cut at the ``step_boundary`` instants), the set
    of op names whose trace spans open in it."""
    import json

    with open(path) as f:
        events = json.load(f)
    steps, cur = [], set()
    for e in events:
        if e.get("name") == "step_boundary":
            steps.append(sorted(cur))
            cur = set()
        elif e.get("ph") == "B":
            cur.add(e["args"]["tensor"])
    return steps[1:] + ([sorted(cur)] if cur else [])


def timeline_span_names(path: str) -> list:
    """The (phase, name) pairs of a timeline's spans."""
    import json

    with open(path) as f:
        events = json.load(f)
    return sorted({(e["name"], e["args"]["tensor"]) for e in events
                   if e.get("ph") == "B"})


def obs_worker(rank: int, world: int, store_path: str, out_dir: str,
               steps: int) -> None:
    """One rank of the slice: planes on (timeline, trace, the defaults),
    ``steps`` steps of the narrow ResNet with ``metrics.note_step``, a
    ``metrics.aggregate``, a traced async burst; then the same steps
    with every plane off; then five differently named ops a mode, each
    diagnosed as diverged.  Its result as JSON."""
    import json
    import time

    torch.set_num_threads(1)
    os.environ.update({
        "HVTPU_TIMELINE": os.path.join(out_dir, f"timeline{rank}.json"),
        "HVTPU_TRACE": os.path.join(out_dir, "trace"),
        "HVTPU_FLIGHT_DIR": out_dir})
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.obs import flight, metrics, stepprof, tracing

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    batches = synthetic_batches(steps, batch=4, seed=7 + rank)

    def train():
        model = narrow_resnet(seed=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        before = metrics.op_counter("allreduce").value()
        metrics.note_step()
        for b in batches:
            train_steps(model, opt, [b])
            metrics.note_step()
        params = torch.cat([p.detach().reshape(-1)
                            for p in model.parameters()])
        return (params.numpy().tolist(),
                metrics.op_counter("allreduce").value() - before)

    hvd.init(device="cpu")
    tracer = tracing.get_tracer()
    res = {"planes_on": [tracing.ACTIVE, flight.ACTIVE, stepprof.ACTIVE,
                         core_state.global_state().timeline is not None],
           "offset_us": tracer.offset_us}
    res["params_on"], res["allreduces"] = train()
    agg = metrics.aggregate()
    res["aggregate_ranks"] = sorted(agg["per_rank"])
    res["aggregate_ok"] = agg["merged"] == metrics.merge_snapshots(
        [agg["per_rank"][r] for r in sorted(agg["per_rank"])])
    names = [f"burst.{i}" for i in range(6)]
    handles = hvd.grouped_allreduce_async(
        [torch.full((3,), float(i + rank)) for i in range(6)], names=names,
        op=hvd.Sum)
    res["burst"] = [hvd.synchronize(h).tolist() for h in handles]
    res["debug"] = sorted(metrics.debug_snapshot())
    hvd.shutdown()

    for key in ("HVTPU_TIMELINE", "HVTPU_TRACE"):
        os.environ.pop(key)
    os.environ.update(HVTPU_FLIGHT="0", HVTPU_ANOMALY="0")
    stepprof.ACTIVE = False
    hvd.init(device="cpu")
    res["planes_off"] = [tracing.ACTIVE, flight.ACTIVE]
    res["params_off"], _ = train()
    hvd.shutdown()

    os.environ.pop("HVTPU_FLIGHT")
    os.environ.update(HVTPU_STALL_CHECK_TIME_SECONDS="5",
                      HVTPU_STALL_SHUTDOWN_TIME_SECONDS="30",
                      HVTPU_STALL_HEARTBEAT_SECONDS="0.1")
    diverged = {}
    for mode in ("amortized", "strict"):
        os.environ["HVTPU_STALL_CHECK_MODE"] = mode
        for kind in OBS_KINDS:
            hvd.init(device="cpu")
            aborts = stall.counters()["stall_aborts"]
            msg = None
            try:
                _named_op(hvd, kind, f"{kind}.r{rank}")
                insp = core_state.global_state().sync_stall
                deadline = time.monotonic() + 5.0
                while insp.failure is None and time.monotonic() < deadline:
                    time.sleep(0.02)
                msg = insp.failure
            except hvd.HorovodInternalError as e:
                msg = str(e)
            pm_path = os.path.join(out_dir, f"postmortem-{rank}-0.json")
            deadline = time.monotonic() + 5.0
            while not os.path.exists(pm_path) and time.monotonic() < deadline:
                time.sleep(0.02)
            with open(pm_path) as f:
                pm = f.read()
            os.remove(pm_path)
            diverged[f"{mode}:{kind}"] = {
                "msg": msg, "postmortem": pm,
                "aborts": stall.counters()["stall_aborts"] - aborts}
            hvd.shutdown()
    res["diverged"] = diverged
    dist.destroy_process_group()
    _write_result(out_dir, rank, json.loads(json.dumps(res)))



# -- the elastic slice (test_torch_port_elastic.py and _data.py) -------------

ELASTIC_BATCH = 4      # samples a rank a step
ELASTIC_IMAGES = 32    # 8 steps an epoch at one rank
ELASTIC_EPOCHS = 2


def elastic_arrays(n: int = ELASTIC_IMAGES, size: int = 32, seed: int = 0):
    """The images and labels of the elastic runs, made from a seed."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, size, size, 3), dtype=np.float32),
            "y": rng.integers(0, 10, size=(n,))}


def numpy_resnet_trees(model, seed: int = 0):
    """flax-layout ``params`` / ``batch_stats`` trees of numpy arrays for
    ``model``'s state_dict (conv kernels HWIO, the Dense kernel (in,
    out)), from a seed: what ``weights.resnet_params_from_jax`` carries
    into either package's torch model, so both start from the same
    bytes."""
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        *mods, leaf = key.split(".")
        shape = tuple(t.shape)
        if leaf in ("mean", "var"):
            node, value = stats, (rng.uniform(0.5, 1.5, shape) if leaf == "var"
                                  else rng.normal(0.0, 0.1, shape))
        elif leaf == "weight" and len(shape) == 4:
            o, i, h, w = shape
            node, leaf = params, "kernel"
            value = rng.normal(0.0, (i * h * w) ** -0.5, (h, w, i, o))
        elif leaf == "weight" and len(shape) == 2:
            node, leaf = params, "kernel"
            value = rng.normal(0.0, shape[1] ** -0.5, shape[::-1])
        elif leaf == "scale":
            node, value = params, rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias":
            node, value = params, rng.normal(0.0, 0.1, shape)
        else:
            raise ValueError(f"unexpected state_dict entry {key}")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value.astype(np.float32)
    return params, stats


def elastic_model(seed: int = 0):
    """The narrow ResNet with its weights from :func:`numpy_resnet_trees`
    through ``horovod_tpu_torch/weights.py``."""
    from horovod_tpu_torch.weights import resnet_params_from_jax

    model = narrow_resnet(seed)
    model.load_state_dict(resnet_params_from_jax(*numpy_resnet_trees(model,
                                                                     seed)))
    return model


def _log(path: str, rec: dict) -> None:
    import json

    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def elastic_incarnation() -> None:
    """One incarnation of the elastic slice in this process, configured
    by the env: ``HVT_PKG`` (``port``: horovod_tpu_torch on the CPU;
    ``ref``: the JAX package's torch frontend and data loader),
    ``HVT_LOG`` (one JSON line a step), ``HVT_OUT`` (the final
    state_dicts), ``HVT_USR1_AFTER`` / ``HVT_TERM_AFTER`` (send itself
    SIGUSR1, a host update, or SIGTERM, a preemption notice, after this
    many commits of this incarnation).  ``HVTPU_ELASTIC*`` and
    ``HVTPU_FAULT_SPEC`` drive the elastic plane as in a job."""
    import signal

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    pkg = os.environ["HVT_PKG"]
    if pkg == "port":
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.data import ArraySource, ElasticDataLoader

        hvd.init(device="cpu")
        loader_kw = {}
    elif pkg == "ref":
        import horovod_tpu.torch as hvd
        from horovod_tpu.data import ArraySource, ElasticDataLoader

        hvd.init()
        loader_kw = {"device_put": False}
    else:
        raise ValueError(f"HVT_PKG={pkg!r}: port or ref")
    model = elastic_model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    loader = ElasticDataLoader(ArraySource(elastic_arrays()), ELASTIC_BATCH,
                               seed=0, with_indices=True, **loader_kw)
    state = hvd.elastic.TorchState(model, opt, data=loader.state)
    gen = int(os.environ.get("HVTPU_ELASTIC_GENERATION", "0"))
    signals = {int(os.environ.get(f"HVT_{name}_AFTER", "0")): sig
               for name, sig in (("USR1", signal.SIGUSR1),
                                 ("TERM", signal.SIGTERM))}
    log = os.environ["HVT_LOG"]
    spe = ELASTIC_IMAGES // ELASTIC_BATCH
    commits = [0]

    @hvd.elastic.run
    def train(state):
        while loader.state.epoch < ELASTIC_EPOCHS:
            start = loader.state.state_dict()
            for idx, batch in loader:
                x, y = batch["x"], batch["y"]
                if not torch.is_tensor(x):
                    x, y = torch.from_numpy(x), torch.from_numpy(y)
                opt.zero_grad()
                F.cross_entropy(model(x), y).backward()
                opt.step()
                step = (loader.state.epoch * spe
                        + loader.state.cursor // ELASTIC_BATCH)
                _log(log, {"gen": gen, "step": step,
                           "epoch": loader.state.epoch,
                           "idx": [int(i) for i in idx], "start": start,
                           "device": str(x.device)})
                start = None
                state.commit()
                commits[0] += 1
                if commits[0] in signals:
                    os.kill(os.getpid(), signals[commits[0]])

    train(state)
    torch.save({"model": model.state_dict(),
                "momentum": [opt.state[p]["momentum_buffer"]
                             for p in model.parameters()]},
               os.environ["HVT_OUT"])
    hvd.shutdown()


def run_incarnation(tmp_path, pkg: str, state_dir, gen: int, log, out,
                    extra_env=None, timeout: float = 240.0):
    """Run :func:`elastic_incarnation` in a child process; its exit
    code."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    for k in ("HVTPU_FAULT_SPEC", "HVT_USR1_AFTER", "HVT_TERM_AFTER"):
        env.pop(k, None)
    env.update({
        "PYTHONPATH": os.pathsep.join(
            [repo, os.path.join(repo, "tests"), env.get("PYTHONPATH", "")]),
        "JAX_PLATFORMS": "cpu", "HVT_PKG": pkg, "HVT_LOG": str(log),
        "HVT_OUT": str(out), "HVTPU_ELASTIC": "1",
        "HVTPU_ELASTIC_STATE_DIR": str(state_dir),
        "HVTPU_ELASTIC_GENERATION": str(gen), "HVTPU_CKPT_FSYNC": "0",
        "HVTPU_FLIGHT_DIR": str(tmp_path)})
    env.update(extra_env or {})
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch_port_util as u; u.elastic_incarnation()"],
        env=env, cwd=str(tmp_path), timeout=timeout, capture_output=True,
        text=True)
    return proc.returncode, proc.stderr


def committed_step(state_dir, pkg: str) -> int:
    """The step of the last verified commit under ``state_dir`` (0 when
    none), from the loader state it holds: a commit's seq is not its
    step once a kill has torn a commit and left its seq behind."""
    import io
    import pickle

    from horovod_tpu_torch.core import durable

    seq = durable.latest_verified(str(state_dir))
    if seq is None:
        return 0
    files = durable.read_snapshot(str(state_dir), seq)
    if pkg == "ref":
        payload = pickle.loads(files["state.pkl"])
    else:
        payload = torch.load(io.BytesIO(files["state.pt"]),
                             weights_only=False)
    data = payload["__sd__data"]
    return data["epoch"] * (ELASTIC_IMAGES // ELASTIC_BATCH) \
        + data["cursor"] // ELASTIC_BATCH


def read_steps(log) -> list:
    import json

    with open(log) as f:
        return [json.loads(line) for line in f]


def committed_steps(records: list, resumes: list) -> dict:
    """step -> the record of the run that committed it: incarnation k's
    steps up to where incarnation k+1 resumed (``resumes[k]``, the
    step it restarted from), the last incarnation's all."""
    out = {}
    for rec in records:
        g = rec["gen"]
        if g < len(resumes) and rec["step"] > resumes[g]:
            continue
        out.setdefault(rec["step"], []).append(rec)
    return out


# -- 2-rank elastic worlds over gloo ------------------------------------------

DRAIN_SAMPLES = 48     # 6 steps an epoch at 2 ranks of 4


def elastic_rank(rank: int, world: int, store_path: str, out_dir: str,
                 state_dir: str, gen: int, fault_spec: str) -> None:
    """One rank of a 2-rank elastic incarnation of a small linear model
    over gloo, 0.5 s a step (the preemption watcher's 0.2 s poll fits
    inside a step twice, under load too; the reference's drain tests
    sleep 0.3 s), a JSON line a step in
    ``out_dir/steps<rank>.jsonl`` and its final parameters in
    ``final<rank>.pt``."""
    os.environ.update({"HVTPU_ELASTIC": "1",
                       "HVTPU_ELASTIC_STATE_DIR": state_dir,
                       "HVTPU_ELASTIC_GENERATION": str(gen),
                       "HVTPU_CKPT_FSYNC": "0"})
    if fault_spec:
        os.environ["HVTPU_FAULT_SPEC"] = fault_spec
    torch.set_num_threads(1)
    import time

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import ArraySource, ElasticDataLoader

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    model = torch.nn.Linear(6, 3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(5)
        model.weight.copy_(torch.randn(3, 6, generator=g))
        model.bias.zero_()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    rng = np.random.default_rng(3)
    src = ArraySource({"x": rng.standard_normal((DRAIN_SAMPLES, 6),
                                                dtype=np.float32),
                       "y": rng.integers(0, 3, size=(DRAIN_SAMPLES,))})
    loader = ElasticDataLoader(src, 4, seed=1, with_indices=True)
    state = hvd.elastic.TorchState(model, opt, data=loader.state)
    spe = DRAIN_SAMPLES // (4 * world)
    log = os.path.join(out_dir, f"steps{rank}.jsonl")

    @hvd.elastic.run
    def train(state):
        while loader.state.epoch < 2:
            for idx, b in loader:
                opt.zero_grad()
                F.cross_entropy(model(b["x"]), b["y"]).backward()
                opt.step()
                time.sleep(0.5)
                _log(log, {"gen": gen, "rank": rank,
                           "step": loader.state.epoch * spe
                           + loader.state.cursor // (4 * world),
                           "epoch": loader.state.epoch,
                           "idx": [int(i) for i in idx]})
                state.commit()

    train(state)
    torch.save({k: v.clone() for k, v in model.state_dict().items()},
               os.path.join(out_dir, f"final{rank}.pt"))
    hvd.shutdown()
    dist.destroy_process_group()
    _write_result(out_dir, rank, {"ok": True})


def data_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One rank of the 2-rank loader checks over gloo: a source of 20
    samples on rank 0 and 17 on rank 1 (the world agrees on 17 by
    allreduce-Min), delivered once plainly and once under
    ``data.next:drop@count=2,times=1``."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import faults
    from horovod_tpu_torch.data import ElasticDataLoader, SyntheticSource

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    n_local = 20 if rank == 0 else 17
    result = {}
    for mode in ("plain", "drop"):
        if mode == "drop":
            faults.install("data.next:drop@count=2,times=1", rank=rank)
        loader = ElasticDataLoader(SyntheticSource(n_local, (2,), seed=3),
                                   2, seed=9, with_indices=True,
                                   name=f"rank{rank}-{mode}")
        batches = [(idx.tolist(), b["x"][:, 0].tolist(), str(b["x"].device))
                   for idx, b in loader]
        result[mode] = {"n": loader._n, "steps": loader.steps_per_epoch(),
                        "batches": batches, "state": loader.state.state_dict()}
        loader.close()
        faults.uninstall()
    hvd.shutdown()
    dist.destroy_process_group()
    _write_result(out_dir, rank, result)


def audit_rank(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One rank of the 2-rank divergence audit over gloo: a clean audit
    of the same tree, then rank 1's ``['model']['Dense_0.bias']``
    perturbed, under ``abort`` and ``warn``."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import audit

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    model = elastic_model()
    tree = {"model": model.state_dict(), "step": 3,
            "half": torch.arange(8, dtype=torch.bfloat16)}
    result = {"clean": audit.verify(tree, "clean", action="abort")}
    if rank == 1:
        with torch.no_grad():
            model.Dense_0.bias[2] += 1.0
    try:
        audit.verify(tree, "params", action="abort")
        result["abort"] = None
    except hvd.HvtpuDivergenceError as e:
        result["abort"] = str(e)
    result["warn"] = audit.verify(tree, "params", action="warn")
    hvd.shutdown()
    dist.destroy_process_group()
    _write_result(out_dir, rank, result)


# -- broadcast_parameters (F7), 2 ranks over gloo ------------------------------

def bp_state(rank: int) -> dict:
    """A state dict of rank ``rank``'s own values: contiguous CPU tensors
    of several dtypes (one 0-d), and a non-contiguous one."""
    rng = np.random.RandomState(70 + rank)
    return {
        "conv.weight": torch.from_numpy(rng.randn(4, 3, 3, 3).astype(
            np.float32)),
        "conv.bias": torch.from_numpy(rng.randn(4).astype(np.float32)),
        "bn.running_mean": torch.from_numpy(rng.randn(7).astype(
            np.float32)).to(torch.bfloat16),
        "bn.num_batches_tracked": torch.tensor(int(rng.randint(1000))),
        "fc.weight_t": torch.from_numpy(rng.randn(5, 6).astype(
            np.float32)).t(),
    }


def bp_worker(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """``broadcast_parameters`` from rank 0: the stall descriptors of the
    broadcasts it issues and every tensor's bytes after it, as JSON."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import stall

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    descs = []
    check = stall.check

    def recorded(st, ps, desc, *args, **kw):
        descs.append(desc)
        return check(st, ps, desc, *args, **kw)

    stall.check = recorded
    hvd.init(device="cpu")
    state = bp_state(rank)
    hvd.broadcast_parameters(state, root_rank=0)
    res = {"descs": descs,
           "bytes": {n: t.contiguous().view(-1).view(torch.uint8)
                     .numpy().tobytes().hex() for n, t in state.items()}}
    hvd.shutdown()
    dist.destroy_process_group()
    _write_result(out_dir, rank, res)


# -- the collectives over a mesh axis (comm/spmd.py), 2 and 3 ranks ------------

SPMD_N = 1300          # the int8 and Adasum payload: not a multiple of 512
SPMD_THRESHOLD = 40    # fused_tree_allreduce's buckets: a few tensors each
SPMD_SEGMENTS = [(0, 700), (700, SPMD_N - 700)]


def spmd_inputs(rank: int, world: int) -> dict:
    """Per-rank inputs of ``spmd_worker``.  The float inputs of the plain
    reductions are eighths of small integers, so every partial sum is
    exact in float32, bfloat16 and float16, and gloo's summation order
    at 3 ranks gives XLA's bits; ``pos`` holds powers of two, whose
    products are exact."""
    rng = np.random.RandomState(90 + rank)
    f32 = np.float32

    def eighths(*shape):
        return (rng.randint(-64, 65, size=shape) * 0.125).astype(f32)

    return dict(
        exact=eighths(5, 7),
        small=eighths(3),
        ints=rng.randint(-100, 100, size=(5, 7)).astype(np.int32),
        pos=(2.0 ** rng.randint(-3, 4, size=(5, 7))).astype(f32),
        wide=(rng.randn(SPMD_N) * (1 + rank)).astype(f32),
        bools=rng.rand(9) < 0.5,
        a2a=eighths(2 * world, 3),
        rs=eighths(4 * world, 5),
        tree_a=eighths(4, 3),
        tree_b=eighths(7),
        tree_c=eighths(11),
    )


def spmd_tree(x: dict) -> dict:
    """The dict of ``fused_tree_allreduce``: keys out of sorted order,
    one bfloat16 tensor among float32 ones."""
    return {"b": x["tree_b"].to(torch.bfloat16), "a": x["tree_a"],
            "c": x["tree_c"]}


def spmd_layout(rank: int, world: int) -> dict:
    """The host layout of the spmd worlds: 2 ranks on 2 hosts of one
    rank; 3 ranks on a host of 2 and a host of 1 (unequal)."""
    hosts = [[0], [1]] if world == 2 else [[0, 1], [2]]
    host = next(h for h, rs in enumerate(hosts) if rank in rs)
    return {"HVTPU_LOCAL_RANK": str(hosts[host].index(rank)),
            "HVTPU_LOCAL_SIZE": str(len(hosts[host])),
            "HVTPU_CROSS_RANK": str(host),
            "HVTPU_CROSS_SIZE": str(len(hosts))}


def _error(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def spmd_worker(rank: int, world: int, store_path: str,
                out_dir: str) -> None:
    """One rank of the spmd checks over gloo: every function of
    ``comm/spmd.py`` on this rank's inputs, over the world mesh, a mesh
    axis, partitions of the axis and a process set's device groups; the
    meshes; ``fused_tree_allreduce``; at 2 ranks Adasum and the int8
    route through the ring A6.  Tensors to ``spmd{rank}.npz``, the rest
    (sizes, error messages, ring calls) to ``rank{rank}.json``."""
    torch.set_num_threads(1)
    os.environ.update(spmd_layout(rank, world))
    os.environ.pop("HVTPU_QUANTIZED_RING", None)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import spmd
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.fusion import fused_tree_allreduce
    from horovod_tpu_torch.ops import ring as ring_mod

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    x = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in spmd_inputs(rank, world).items()}
    R = hvd.ReduceOp
    W = dict(axis_name="world")
    res, info = {}, {}
    res["sum_f32"] = spmd.allreduce(x["exact"], op=R.SUM, **W)
    res["avg_f32"] = spmd.allreduce(x["exact"], op=R.AVERAGE, **W)
    res["avg_bf16"] = spmd.allreduce(x["exact"].to(torch.bfloat16),
                                     op=R.AVERAGE, **W)
    res["sum_f16"] = spmd.allreduce(x["exact"].half(), op=R.SUM, **W)
    res["sum_i32"] = spmd.allreduce(x["ints"], op=R.SUM, **W)
    res["avg_i32"] = spmd.allreduce(x["ints"], op=R.AVERAGE, **W)
    res["min"] = spmd.allreduce(x["exact"], op=R.MIN, **W)
    res["max"] = spmd.allreduce(x["exact"], op=R.MAX, **W)
    res["prod"] = spmd.allreduce(x["pos"], op=R.PRODUCT, **W)
    res["scaled"] = spmd.allreduce(x["exact"], op=R.SUM, prescale_factor=0.5,
                                   postscale_factor=3.0, **W)
    res["scaled_i32"] = spmd.allreduce(x["ints"], average=False,
                                       prescale_factor=2.0,
                                       postscale_factor=0.5, **W)
    res["fp16_wire"] = spmd.allreduce(x["exact"], op=R.SUM,
                                      compression=Compression.fp16, **W)
    res["bf16_wire"] = spmd.allreduce(x["exact"], op=R.AVERAGE,
                                      compression=Compression.bf16, **W)
    res["int8_sum"] = spmd.allreduce(x["wide"], op=R.SUM,
                                     compression=Compression.int8, **W)
    res["int8_avg"] = spmd.allreduce(x["wide"], op=R.AVERAGE,
                                     compression=Compression.int8, **W)
    res["stoch"] = spmd.allreduce(x["wide"], op=R.SUM,
                                  compression=Compression.int8_stochastic,
                                  **W)
    outs = spmd.grouped_allreduce([x["exact"], x["small"].to(torch.bfloat16)],
                                  op=R.AVERAGE, **W)
    res["grouped_avg_0"], res["grouped_avg_1"] = outs
    outs = spmd.grouped_allreduce([x["exact"], x["ints"]], op=R.MAX, **W)
    res["grouped_max_0"], res["grouped_max_1"] = outs
    res["gather_f32"] = spmd.allgather(x["exact"], **W)
    res["gather_i32"] = spmd.allgather(x["ints"], **W)
    res["bcast_f32"] = spmd.broadcast(x["exact"], root_rank=1, **W)
    res["bcast_bool"] = spmd.broadcast(x["bools"], root_rank=world - 1, **W)
    res["a2a"] = spmd.alltoall(x["a2a"], **W)
    res["rs_sum"] = spmd.reducescatter(x["rs"], op=R.SUM, **W)
    res["rs_avg"] = spmd.reducescatter(x["rs"], op=R.AVERAGE, **W)
    res["barrier"] = spmd.barrier("world")
    info["axis"] = [spmd.axis_size("world"), spmd.rank("world")]
    info["a2a_indivisible"] = _error(
        lambda: spmd.alltoall(x["a2a"][:-1], **W))
    info["rs_min"] = _error(
        lambda: spmd.reducescatter(x["rs"], op=R.MIN, **W))

    # partitions of the axis: [[0], [1]] at 2 ranks; at 3 a process set's
    # device groups, the members [0, 2] and the singleton [1]
    if world == 2:
        groups = [[0], [1]]
    else:
        groups = hvd.add_process_set([0, 2]).device_groups()
    info["groups"] = groups
    res["g_sum"] = spmd.allreduce(x["exact"], op=R.SUM, groups=groups, **W)
    res["g_avg"] = spmd.allreduce(x["exact"], op=R.AVERAGE, groups=groups,
                                  **W)
    res["g_min"] = spmd.allreduce(x["exact"], op=R.MIN, groups=groups, **W)
    info["g_gather"] = _error(
        lambda: res.__setitem__("g_gather", spmd.allgather(
            x["exact"], groups=groups, **W)))
    info["g_int8"] = _error(lambda: spmd.allreduce(
        x["wide"], compression=Compression.int8, groups=groups, **W))
    info["g_adasum"] = _error(lambda: spmd.allreduce(
        x["wide"], op=R.ADASUM, groups=groups, **W))

    tree = spmd_tree(x)
    for name, op in (("sum", R.SUM), ("avg", R.AVERAGE)):
        out = fused_tree_allreduce(tree, threshold_bytes=SPMD_THRESHOLD,
                                   op=op, **W)
        info[f"tree_{name}_keys"] = list(out)
        res.update({f"tree_{name}_{k}": v for k, v in out.items()})
    if world == 2:
        res["adasum"] = spmd.allreduce(x["wide"], op=R.ADASUM, **W)
        res["adasum_seg"] = spmd.allreduce(
            x["wide"], op=R.ADASUM, adasum_segments=SPMD_SEGMENTS, **W)
        out = fused_tree_allreduce(tree, threshold_bytes=SPMD_THRESHOLD,
                                   op=R.ADASUM, **W)
        res.update({f"tree_adasum_{k}": v for k, v in out.items()})
    else:
        info["adasum"] = _error(
            lambda: spmd.allreduce(x["wide"], op=R.ADASUM, **W))

    # the meshes
    wm = hvd.world_mesh()
    info["world_mesh"] = [list(wm.mesh_dim_names), wm.mesh.tolist(),
                          wm is hvd.world_mesh()]
    info["num_devices"] = hvd.num_devices()
    info["local_devices"] = [str(d) for d in hvd.local_devices()]
    nd = hvd.mesh(("dp", "tp"), (1, world))
    res["nd_tp_sum"] = spmd.allreduce(x["exact"], op=R.SUM, axis_name="tp",
                                      mesh=nd)
    nd2 = hvd.mesh(("dp", "tp"), (world, 1))
    res["nd_tp_solo"] = spmd.allreduce(x["exact"], op=R.SUM, axis_name="tp",
                                       mesh=nd2)
    info["nd"] = [nd.mesh.tolist(), nd2.mesh.tolist(),
                  spmd.axis_size("tp", mesh=nd), spmd.rank("tp", mesh=nd),
                  spmd.axis_size("dp", mesh=nd2), spmd.rank("dp", mesh=nd2)]
    info["nd_bad"] = _error(lambda: hvd.mesh(("a", "b"), (2, 2)))
    if world == 2:
        hm = hvd.hierarchical_mesh()
        info["hier"] = [list(hm.mesh_dim_names), hm.mesh.tolist(),
                        spmd.axis_size("dcn", mesh=hm),
                        spmd.axis_size("ici", mesh=hm),
                        spmd.rank("dcn", mesh=hm), spmd.rank("ici", mesh=hm)]
        res["hier_dcn_sum"] = spmd.allreduce(x["exact"], op=R.SUM,
                                             axis_name="dcn", mesh=hm)
        # stochastic rounding's key folds the axis index, not the global
        # rank: over the one-rank "ici" axis both ranks are index 0, so
        # the same payload rounds alike on both
        same = torch.from_numpy(spmd_inputs(0, world)["wide"])
        res["stoch_ici"] = spmd.allreduce(
            same, op=R.SUM, compression=Compression.int8_stochastic,
            axis_name="ici", mesh=hm)
        # the int8 route through the ring A6 (its plain version on CPU
        # tensors), and without the variable the two-phase codec
        calls = []
        real = ring_mod.ProcessRing.allreduce

        def spy(self, *a, **kw):
            calls.append(bool(kw.get("quantized")))
            return real(self, *a, **kw)

        ring_mod.ProcessRing.allreduce = spy
        os.environ["HVTPU_QUANTIZED_RING"] = "1"
        try:
            res["ring_sum"] = spmd.allreduce(
                x["wide"], op=R.SUM, compression=Compression.int8, **W)
            res["ring_avg"] = spmd.allreduce(
                x["wide"], op=R.AVERAGE, compression=Compression.int8, **W)
            res["ring_stoch"] = spmd.allreduce(
                x["wide"], op=R.SUM,
                compression=Compression.int8_stochastic, **W)
        finally:
            del os.environ["HVTPU_QUANTIZED_RING"]
            ring_mod.ProcessRing.allreduce = real
        info["ring_calls"] = calls
    else:
        info["hier"] = _error(hvd.hierarchical_mesh)
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"spmd{rank}.npz"),
             **{k: (v.float() if v.dtype in (torch.bfloat16, torch.float16)
                    else v).numpy() for k, v in res.items()})
    _write_result(out_dir, rank, info)


# -- allreduce_gradients and ShardedDistributedOptimizer, 2 and 3 ranks -------

OPT_LR = 0.1
OPT_STEPS = 3
OPT_THRESHOLD = 64     # allreduce_gradients' buckets: a few tensors each


def opt_grads(rank: int, step: int = 0) -> dict:
    """A rank's gradients at ``step``: eighths of small integers (exact
    sums), keys out of sorted order, one bfloat16 tensor."""
    rng = np.random.RandomState(110 + 10 * step + rank)

    def eighths(*shape):
        return (rng.randint(-64, 65, size=shape) * 0.125).astype(np.float32)

    return {"w": eighths(6, 5), "b": eighths(5), "e": eighths(4),
            "k": eighths(3, 3)}


def opt_params() -> dict:
    """The parameters of the sharded optimizer, the same on every rank
    (the gradients' shapes, float32), in sorted-key order so the port's
    packing order is the reference's tree order."""
    rng = np.random.RandomState(7)
    shapes = {k: v.shape for k, v in opt_grads(0).items()}
    return {k: rng.randn(*shapes[k]).astype(np.float32)
            for k in sorted(shapes)}


def _torch_grads(rank: int, step: int = 0) -> dict:
    g = {k: torch.from_numpy(v) for k, v in opt_grads(rank, step).items()}
    g["e"] = g["e"].to(torch.bfloat16)
    return g


def opt_worker(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One rank of the optimizer checks over gloo: ``allreduce_gradients``
    along the world axis (whole, and scoped by a process set's device
    groups at 3 ranks) and on the eager plan, and 3 steps of
    ``ShardedDistributedOptimizer(SGD, momentum 0.9)`` with this rank's
    gradients (the parameters and this rank's momentum shard after each
    step).  Tensors to ``opt{rank}.npz``."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    res = {}

    def keep(prefix, tree):
        res.update({f"{prefix}_{k}": v.float() if v.dtype == torch.bfloat16
                    else v for k, v in tree.items()})

    g = _torch_grads(rank)
    for name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
        keep(f"axis_{name}", hvd.allreduce_gradients(
            g, axis_name="world", op=op, prescale_factor=0.5,
            fusion_threshold_bytes=OPT_THRESHOLD))
        keep(f"eager_{name}", hvd.allreduce_gradients(
            g, op=op, prescale_factor=0.5,
            fusion_threshold_bytes=OPT_THRESHOLD))
    if world == 3:
        ps = hvd.add_process_set([0, 2])
        keep("set_avg", hvd.allreduce_gradients(
            g, axis_name="world", op=hvd.Average, process_set=ps,
            fusion_threshold_bytes=OPT_THRESHOLD))

    params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
              for v in opt_params().values()]
    opt = hvd.ShardedDistributedOptimizer(
        torch.optim.SGD, params, axis_name="world", lr=OPT_LR,
        momentum=0.9)
    for step in range(OPT_STEPS):
        grads = opt_grads(rank, step)
        for p, k in zip(params, opt_params()):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        res[f"params_{step}"] = torch.cat([p.detach().reshape(-1)
                                           for p in params])
        res[f"momentum_{step}"] = opt.inner.state[opt.shard][
            "momentum_buffer"].clone()
    opt.zero_grad()
    res["zeroed"] = torch.tensor([p.grad is None or not p.grad.any()
                                  for p in params])
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"opt{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    _write_result(out_dir, rank, {"ok": True})


# -- SyncBatchNorm, 2 ranks ------------------------------------------------------

SBN_SHAPE = (3, 4, 5, 6)   # a rank's batch: N, C, H, W
SBN_STEPS = 2


def sbn_inputs(rank: int, step: int) -> dict:
    """A rank's batch at ``step`` and the weights of the weighted sum
    whose backward drives the gradients."""
    rng = np.random.RandomState(130 + 10 * step + rank)
    return {"x": (rng.randn(*SBN_SHAPE) * 2 + 0.5).astype(np.float32),
            "w": rng.randn(*SBN_SHAPE).astype(np.float32)}


SBN_VARIANTS = {"default": {}, "no_affine": {"affine": False},
                "cumulative": {"momentum": None}}


def sbn_worker(rank: int, world: int, store_path: str, out_dir: str) -> None:
    """One rank of the SyncBatchNorm checks over gloo: for each variant,
    ``SBN_STEPS`` training steps (output and input gradient each step),
    then the summed weight and bias gradients of the last step and the
    running statistics; and an eval-mode forward."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    res = {}
    for name, kw in SBN_VARIANTS.items():
        torch.manual_seed(0)
        bn = hvd.SyncBatchNorm(SBN_SHAPE[1], **kw)
        if bn.weight is not None:
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.uniform_(-0.5, 0.5)
        for step in range(SBN_STEPS):
            inp = {k: torch.from_numpy(v)
                   for k, v in sbn_inputs(rank, step).items()}
            x = inp["x"].clone().requires_grad_(True)
            bn.zero_grad()
            out = bn(x)
            (out * inp["w"]).sum().backward()
            res[f"{name}_out_{step}"] = out.detach()
            res[f"{name}_dx_{step}"] = x.grad
        if bn.weight is not None:
            res[f"{name}_dw"] = hvd.allreduce(bn.weight.grad, op=hvd.Sum)
            res[f"{name}_db"] = hvd.allreduce(bn.bias.grad, op=hvd.Sum)
        res[f"{name}_mean"] = bn.running_mean.clone()
        res[f"{name}_var"] = bn.running_var.clone()
        bn.eval()
        res[f"{name}_eval"] = bn(torch.from_numpy(
            sbn_inputs(rank, 0)["x"])).detach()
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"sbn{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    _write_result(out_dir, rank, {"ok": True})


# -- the parallel layers, 2 and 3 ranks ----------------------------------------

PAR_MICRO = (1, 2, 4)      # pipeline_apply's microbatch counts
PAR_D = 8                  # feature width of the layer inputs


def par_inputs(rank: int, world: int) -> dict:
    """A rank's inputs and cotangents of ``parallel_worker``.  The
    collectives' inputs are eighths of small integers (exact sums in any
    order); the layers' are normal draws.  Replicated inputs (``rep_*``)
    are the same on every rank."""
    rng = np.random.RandomState(150 + rank)
    rep = np.random.RandomState(149)
    f32 = np.float32

    def eighths(*shape):
        return (rng.randint(-64, 65, size=shape) * 0.125).astype(f32)

    def normal(*shape, r=rng):
        return np.asarray(r.randn(*shape), dtype=f32)

    n, d = world, PAR_D
    e = 2 * n
    out = dict(
        psum=eighths(5, 7), psum_ct=eighths(5, 7),
        ag=eighths(3, 4), ag_ct=eighths(3, 4 * n), ag_u_ct=eighths(3, n, 4),
        rs=eighths(3, 2 * n), rs_ct=eighths(3, 2),
        rs_u=eighths(n, 5), rs_u_ct=eighths(5),
        a2a=eighths(2 * n, 3), a2a_ct=eighths(2, 3 * n),
        a2a_u=eighths(n, 4), a2a_u_ct=eighths(4, n),
        perm=eighths(4, 3), perm_ct=eighths(4, 3),
        # column -> row: x and b2 replicated, w1/b1/w2 this rank's shards
        tp_x=normal(4, d, r=rep), tp_w1=normal(d, 6), tp_b1=normal(6),
        tp_w2=normal(6, 5), tp_b2=normal(5, r=rep), tp_ct=normal(4, 5),
        # attention: [B, T_local, H, D] (ulysses), [B, H, T_local, D] (ring)
        uly_q=normal(2, 4, 2 * n, d), uly_k=normal(2, 4, 2 * n, d),
        uly_v=normal(2, 4, 2 * n, d), uly_ct=normal(2, 4, 2 * n, d),
        ring_q=normal(2, 2, 4, d), ring_k=normal(2, 2, 4, d),
        ring_v=normal(2, 2, 4, d), ring_ct=normal(2, 2, 4, d),
        # pipeline: this stage's (w, b), microbatches replicated
        pp_w=(normal(d, d) / np.sqrt(d)).astype(f32), pp_b=normal(d),
        pp_aux_ct=normal(),
        # MoE: E = 2 * world experts, 2 a rank; capacity factor 0.5 makes
        # tokens overflow
        moe_x=normal(16, d), moe_gate=normal(d, e, r=rep),
        moe_w1=(normal(2, d, 6) / np.sqrt(d)).astype(f32),
        moe_w2=(normal(2, 6, d) / np.sqrt(6)).astype(f32),
        moe_ct=normal(16, d), moe_aux_ct=normal(),
    )
    for m in PAR_MICRO:
        out[f"pp_mb{m}"] = normal(m, 3, d, r=np.random.RandomState(148 + m))
        out[f"pp_ct{m}"] = normal(m, 3, d)
    return out


def par_ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def par_partial_perm(n: int):
    """One pair and a rank that receives nothing: zeros."""
    return [(0, n - 1), (n - 1, 1 % n)] if n > 2 else [(0, 1)]


def _par_stage(params, x, with_aux):
    w, b = params
    y = torch.tanh(x @ w + b)
    return (y, (y * y).mean()) if with_aux else y


def _par_expert(params, tok):
    w1, w2 = params
    return torch.tanh(tok @ w1) @ w2


def parallel_worker(rank: int, world: int, store_path: str,
                    out_dir: str) -> None:
    """One rank of the parallel-layer checks over gloo, on a 1-D mesh
    (axis ``i``) over the world: each collective of
    ``parallel/_collectives.py`` and each layer on this rank's inputs,
    forward and the gradients of ``<output, cotangent>``; the layouts
    and the refusals of ``parallel/mesh.py``.  Tensors to
    ``par{rank}.npz``, the rest to ``rank{rank}.json``."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.parallel import _collectives as C

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    mesh = hvd.mesh(("i",), (world,))
    x = {k: torch.from_numpy(np.array(v))
         for k, v in par_inputs(rank, world).items()}
    res, info = {}, {}

    def run(name, fn, inputs, cts):
        ins = [x[k].clone().requires_grad_(True) for k in inputs]
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for i, o in enumerate(outs):
            res[f"{name}/out{i}"] = o.detach()
        torch.autograd.backward(list(outs), [x[k] for k in cts])
        for k, t in zip(inputs, ins):
            res[f"{name}/d_{k}"] = t.grad

    I = dict(mesh=mesh)
    run("psum", lambda a: C.psum(a, "i", **I), ["psum"], ["psum_ct"])
    run("all_gather", lambda a: C.all_gather(a, "i", dim=1, tiled=True, **I),
        ["ag"], ["ag_ct"])
    run("all_gather_untiled",
        lambda a: C.all_gather(a, "i", dim=1, tiled=False, **I),
        ["ag"], ["ag_u_ct"])
    run("psum_scatter", lambda a: C.psum_scatter(
        a, "i", scatter_dimension=1, tiled=True, **I), ["rs"], ["rs_ct"])
    run("psum_scatter_untiled", lambda a: C.psum_scatter(
        a, "i", scatter_dimension=0, tiled=False, **I), ["rs_u"],
        ["rs_u_ct"])
    run("all_to_all", lambda a: C.all_to_all(a, "i", 0, 1, tiled=True, **I),
        ["a2a"], ["a2a_ct"])
    run("all_to_all_untiled",
        lambda a: C.all_to_all(a, "i", 0, 1, tiled=False, **I),
        ["a2a_u"], ["a2a_u_ct"])
    run("ppermute_ring",
        lambda a: C.ppermute(a, "i", par_ring_perm(world), **I),
        ["perm"], ["perm_ct"])
    run("ppermute_partial",
        lambda a: C.ppermute(a, "i", par_partial_perm(world), **I),
        ["perm"], ["perm_ct"])
    info["axis"] = [C.axis_index("i", **I), C.axis_size("i", **I)]

    run("tp", lambda a, w1, b1, w2, b2: par.row_parallel(
        par.column_parallel(a, w1, b1), w2, "i", b2, **I),
        ["tp_x", "tp_w1", "tp_b1", "tp_w2", "tp_b2"], ["tp_ct"])
    for causal in (False, True):
        tag = "causal" if causal else "full"
        run(f"ulysses_{tag}", lambda q, k, v: par.ulysses_attention(
            q, k, v, "i", causal=causal, **I),
            ["uly_q", "uly_k", "uly_v"], ["uly_ct"])
        run(f"ring_{tag}", lambda q, k, v: par.ring_attention(
            q, k, v, "i", causal=causal, **I),
            ["ring_q", "ring_k", "ring_v"], ["ring_ct"])
    for m in PAR_MICRO:
        run(f"pipeline_m{m}", lambda w, b, mb: par.pipeline_apply(
            lambda p, h: _par_stage(p, h, False), (w, b), mb, "i", **I),
            ["pp_w", "pp_b", f"pp_mb{m}"], [f"pp_ct{m}"])
        run(f"pipeline_aux_m{m}", lambda w, b, mb: par.pipeline_apply(
            lambda p, h: _par_stage(p, h, True), (w, b), mb, "i",
            with_aux=True, **I),
            ["pp_w", "pp_b", f"pp_mb{m}"], [f"pp_ct{m}", "pp_aux_ct"])
    run("moe", lambda a, g, w1, w2: par.expert_parallel_moe(
        a, g, (w1, w2), _par_expert, "i", num_experts=2 * world,
        capacity_factor=0.5, **I),
        ["moe_x", "moe_gate", "moe_w1", "moe_w2"], ["moe_ct", "moe_aux_ct"])
    dispatch, combine, aux = par.switch_route(
        x["moe_x"], x["moe_gate"], 2 * world, 3)
    res["route/dispatch"], res["route/combine"] = dispatch, combine
    res["route/aux"] = aux

    info["errors"] = {
        "ulysses_heads": _error(lambda: par.ulysses_attention(
            x["uly_q"][:, :, :1], x["uly_k"][:, :, :1], x["uly_v"][:, :, :1],
            "i", **I)),
        "moe_experts": _error(lambda: par.expert_parallel_moe(
            x["moe_x"], x["moe_gate"][:, :world + 1], (), _par_expert, "i",
            num_experts=world + 1, **I)),
    }
    info["errors"]["subset"] = _error(lambda: par.make_layout(devices=[0]))
    info["layouts"] = {name: _par_layout(par, kw)
                       for name, kw in par_layout_cases(world).items()}
    info["auto"] = _par_layout(par, None)
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"par{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    _write_result(out_dir, rank, info)


def par_layout_cases(world: int) -> dict:
    """``make_layout`` keywords at ``world`` ranks: layouts and refusals."""
    cases = {"default": {}, "tp": {"tp": world}, "pp": {"pp": world},
             "sp": {"sp": world}, "ep": {"ep": world},
             "not_divisible": {"tp": world + 1},
             "wrong_size": {"dp": 2, "tp": world}}
    if world == 2:
        cases["mixed"] = {"dp": 1, "pp": 1, "tp": 1, "sp": 2}
    else:
        cases["mixed"] = {"dp": 1, "pp": 3, "sp": 1, "ep": 1}
    return cases


def _par_layout(par, kw) -> dict:
    """A layout's mesh shape (in order), logical -> physical map and this
    rank's coordinates; or the error it raises."""
    try:
        lay = par.auto_layout() if kw is None else par.make_layout(**kw)
    except ValueError as e:
        return {"error": str(e)}
    m = lay.mesh
    return {"shape": [[a, n] for a, n in lay.shape.items()],
            "map": lay.logical_to_physical,
            "sizes": {a: lay.axis_size(a) for a in ("dp", "tp", "pp",
                                                    "sp", "ep")},
            "coords": [m.get_local_rank(a) for a in m.mesh_dim_names]}


# -- the hybrid-parallel transformer, 1, 2 and 8 ranks -------------------------

TFM_BATCH = 16             # divisible by dp x microbatches of every layout
TFM_TOKENS = 17
TFM_TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                max_seq=32, num_microbatches=2)
# name -> (world, config keywords, make_layout keywords)
TFM_CASES = {
    "megatron_1x1x1": (1, {}, dict(dp=1, tp=1, pp=1)),
    "megatron_2x1x1": (2, {}, dict(dp=2, tp=1, pp=1)),
    "megatron_1x2x1": (2, {}, dict(dp=1, tp=2, pp=1)),
    "megatron_1x1x2": (2, {}, dict(dp=1, tp=1, pp=2)),
    "megatron_2x2x2": (8, {}, dict(dp=2, tp=2, pp=2)),
    "ring_sp2": (8, {"attn_mode": "ring"}, dict(dp=2, tp=2, pp=1, sp=2)),
    "ulysses_sp2": (8, {"attn_mode": "ulysses"},
                    dict(dp=2, tp=2, pp=1, sp=2)),
    "moe_dp2": (2, {"n_experts": 4, "n_layers": 2}, dict(dp=2, tp=1, pp=1)),
}
TFM_TRAIN = (8, {}, dict(dp=2, tp=2, pp=2))
TFM_TRAIN_STEPS = 3
TFM_LR = 1e-2
TFM_WORLDS = (1, 2, 8)


def tfm_params_key(cfg_kw: dict) -> str:
    """The file of the reference's global parameters for a config."""
    return "moe" if cfg_kw.get("n_experts") else "dense"


def tfm_tokens() -> np.ndarray:
    return np.random.RandomState(0).randint(
        0, TFM_TINY["vocab_size"], size=(TFM_BATCH, TFM_TOKENS)
    ).astype(np.int32)


def _tfm_model(tfm, par, weights, cfg_kw, lay_kw, out_dir):
    cfg = tfm.TransformerConfig(**{**TFM_TINY, **cfg_kw}, dtype=torch.float32)
    lay = par.make_layout(**lay_kw)
    flat = np.load(os.path.join(out_dir,
                                f"params_{tfm_params_key(cfg_kw)}.npz"))
    model = tfm.Transformer(cfg, lay, device="cpu")
    model.load_state_dict(weights.transformer_params_from_jax(
        tfm.unflatten(dict(flat)), cfg, lay))
    dp = lay.shape[lay.dp]
    i = lay.mesh.get_local_rank(lay.dp)
    b = TFM_BATCH // dp
    toks = torch.from_numpy(tfm_tokens()[i * b:(i + 1) * b]).long()
    return cfg, lay, model, toks


def transformer_worker(rank: int, world: int, store_path: str,
                       out_dir: str) -> None:
    """One rank of the transformer checks over gloo: for each case of
    ``TFM_CASES`` at this world size, the reference's parameters carried
    across by ``transformer_params_from_jax``, the loss and this rank's
    reduced gradients (``loss / world`` back-propagated, then
    ``reduce_gradients``); at ``TFM_TRAIN``'s world, ``make_train_step``
    with ``torch.optim.Adam`` for ``TFM_TRAIN_STEPS`` steps; in a world
    of one, the model's own seeded init.  Tensors to ``tfm{rank}.npz``,
    the rest to ``rank{rank}.json``."""
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch import weights
    from horovod_tpu_torch.models import transformer as tfm

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    hvd.init(device="cpu")
    res, info = {}, {}
    for name, (w, cfg_kw, lay_kw) in TFM_CASES.items():
        if w != world:
            continue
        cfg, lay, model, toks = _tfm_model(tfm, par, weights, cfg_kw,
                                           lay_kw, out_dir)
        loss = model(toks)
        (loss / world).backward()
        tfm.reduce_gradients(model)
        res[f"{name}/loss"] = loss.detach()
        for n, p in model.named_parameters():
            res[f"{name}/{n}"] = p.grad
    if TFM_TRAIN[0] == world:
        cfg, lay, model, toks = _tfm_model(tfm, par, weights, *TFM_TRAIN[1:],
                                           out_dir)
        opt = torch.optim.Adam(model.parameters(), lr=TFM_LR)
        step = tfm.make_train_step(cfg, lay, opt)
        res["train/losses"] = torch.stack(
            [step(model, toks) for _ in range(TFM_TRAIN_STEPS)])
        for n, p in model.named_parameters():
            res[f"train/{n}"] = p.detach()
    if world == 1:
        info["init"] = {}
        for key, cfg_kw in (("dense", {}), ("moe", {"n_experts": 4})):
            cfg = tfm.TransformerConfig(**{**TFM_TINY, **cfg_kw})   # bfloat16
            tree = tfm.init_params(cfg, torch.Generator().manual_seed(0))
            model = tfm.Transformer(cfg, par.make_layout(),
                                    generator=torch.Generator().manual_seed(0),
                                    device="cpu")
            same = all(torch.equal(p, tfm.flatten(tree)[n])
                       for n, p in model.named_parameters())
            loss = model(torch.from_numpy(tfm_tokens()).long())
            info["init"][key] = {
                "tree": {n: [list(t.shape), str(t.dtype).split(".")[-1]]
                         for n, t in tfm.flatten(tree).items()},
                "module_is_the_tree": same,
                "loss": float(loss)}
    hvd.shutdown()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"tfm{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    _write_result(out_dir, rank, info)

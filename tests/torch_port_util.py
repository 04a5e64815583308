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
                 out_dir: str) -> None:
    """The async plane at ``world`` ranks: out-of-order enqueue, a
    partial submission, the grouped fused path, the other async ops, a
    process set (members and a non-member), its removal, and shutdown
    with an op in flight.  Rank 0 records every call its negotiation
    core's coordinator side takes, for a replay through the JAX
    package's core."""
    import pickle
    import threading
    import time

    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.native import fallback

    log = []
    if rank == 0:
        # the streamed plane calls the core from two threads: a call and
        # its log entry are one step, so the log keeps the core's order
        log_lock = threading.Lock()
        for method in ("ingest", "compute_responses", "apply_responses",
                       "declare_group", "register_process_set"):
            orig = getattr(fallback.PyController, method)

            def wrapped(self, *args, _orig=orig, _m=method):
                with log_lock:
                    out = _orig(self, *args)
                    log.append((_m, args, out))
                return out
            setattr(fallback.PyController, method, wrapped)

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
                     "errors": errors, "log": log}, f)


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
                  out_dir: str) -> None:
    """``adasum_reduce`` and ``allreduce(op=Adasum)`` (sync, async and
    the optimizer) over the world of 4, over a set of 2 ({1, 3}), and the
    refusal over a set of 3 ({0, 1, 2})."""
    import pickle

    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
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
        hvd.shutdown()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"adasum{rank}.pkl"), "wb") as f:
        pickle.dump({"res": {k: v.numpy() for k, v in res.items()},
                     "errors": errors}, f)

"""One rank of one run of a cell: the set-up, the checked first steps,
the measured (or traced) window, and, on rank 0, the reference.

The path driven is the user's: ``hvd.init`` -> the model ->
``hvd.DistributedOptimizer(SGD or AdamW)`` -> ``hvd.broadcast_parameters``
-> back-to-back steps (``zero_grad``, forward, the task's loss,
``backward`` with the optimizer's hooks launching the buckets,
``opt.step()``).  The benchmark makes the weights (``data.py``) and the
batches (the configuration's task, ``tasks/``) and puts a
``record_function`` range around the forward pass, the backward pass and
``opt.step()``.

The first ``check_steps`` steps run in set-up, each on a batch of its
own, through the same step function the window calls; their losses, the
first gradient as the optimizer got it, its momentum after the last and
the parameters' change are read for the check.  The same model and
optimizer then warm up and run the window.  Once it has closed and the peak memory is read, the
program's state is freed and rank 0 runs the reference over the same
weights and batches (``reference/``).
"""

from __future__ import annotations

import gc
import importlib.util
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import check, data, reference, tasks, trace
from .counters import a1_bytes
from .reference import train as ref_train

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
ROOT = Path(__file__).resolve().parent.parent
PORT_MODULE = "horovod_tpu_torch.models"
# where each optimizer keeps what the check reads: the first gradient as
# the update got it (None: the reduced ``.grad`` itself) and the momentum
STATE_KEYS = {"sgd": ("momentum_buffer", "momentum_buffer"),
              "adamw": (None, "exp_avg")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run must not load,
    compared whole (``horovod_tpu_torch`` is not ``horovod_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_optimizer(params, spec: dict):
    """The wrapped optimizer the configuration's ``optimizer`` states:
    ``sgd`` (``lr``, ``momentum``) or ``adamw`` (``lr``, ``betas``,
    ``eps``, ``weight_decay``)."""
    import torch

    kind = spec["kind"]
    if kind == "sgd":
        return torch.optim.SGD(params, lr=spec["lr"],
                               momentum=spec["momentum"])
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=spec["lr"],
                                 betas=tuple(spec["betas"]), eps=spec["eps"],
                                 weight_decay=spec["weight_decay"])
    raise ValueError(f"optimizer {kind!r}: one of {sorted(STATE_KEYS)}")


def build_program(hvd, config: dict, traffic: dict, seed: int, dev,
                  rank: int, fault: Optional[str] = None):
    """The program's model and optimizer on the seed's weights, this
    rank's batches, and the step function.  The model is
    ``port_model`` of the port's models (of ``port_module`` for the
    tests' configuration, which ``run.make_spec`` refuses in a cell).
    Returns ``(model, opt, step, feed,
    weights)``."""
    import torch
    from torch.profiler import record_function

    task = tasks.of(config)
    dtype = getattr(torch, config["compute_dtype"])
    specs = [(n, p.shape) for n, p in
             reference.build(config, "meta").named_parameters()]
    weights = data.make_weights(specs, seed, dev,
                               config["init"])
    models = importlib.import_module(config.get("port_module", PORT_MODULE))
    model = getattr(models, config["port_model"])(
        dtype=dtype, device="meta", **config["port_kwargs"])
    model = model.to_empty(device=dev)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    want = {n: tuple(s) for n, s in specs}
    if got != want:
        raise RuntimeError("the program's parameters are not the "
                           f"reference's: {sorted(set(got) ^ set(want))}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    data.fill_buffers(model, config["init"])
    model.train()
    batches = task.make_batches(traffic, config, seed, rank, dev)
    opt = hvd.DistributedOptimizer(
        make_optimizer(model.parameters(), config["optimizer"]),
        named_parameters=model.named_parameters(),
        compression=getattr(hvd.Compression, config["compression"]),
        gradient_predivide_factor=config["gradient_predivide_factor"])
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    if fault == "no_update":
        opt.step = lambda closure=None: opt.synchronize()
    elif fault == "no_exchange":
        import torch.distributed as dist

        real = dist.all_reduce

        def all_reduce(tensor, *args, **kwargs):
            return real(torch.zeros_like(tensor), *args, **kwargs)

        dist.all_reduce = all_reduce
    elif fault not in (None, "half_batch"):
        raise ValueError(f"fault {fault!r}")

    def feed(k: int):
        x, y = batches[k % len(batches)]
        if fault == "half_batch":
            return x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        return x, y

    def step(x, y):
        opt.zero_grad()
        with record_function(trace.FORWARD):
            loss = task.loss(model(x), y)
        with record_function(trace.BACKWARD):
            loss.backward()
        with record_function(trace.OPT_STEP):
            opt.step()
        return loss

    return model, opt, step, feed, weights


def program_readings(model, opt, step, feed, weights, steps: int,
                     world: int, config: dict) -> dict:
    """Run the checked steps and read them: each step's loss, the
    task's reading of the first and the last step's logits (a hook on
    the model's output), each leaf's first gradient as step 1's update
    got it (SGD's momentum buffer after step 1; the reduced ``.grad``
    under AdamW) and its momentum after the last step (the buffer;
    AdamW's ``exp_avg``), each leaf's change after the last, and (past
    one rank) its bit digest.  ``buffers`` holds the first gradients
    themselves, on the host, for the reference to judge."""
    import torch

    read = tasks.of(config).reading
    first_key, moment_key = STATE_KEYS[config["optimizer"]["kind"]]
    losses, logits = [], []
    params = list(model.named_parameters())
    hook = model.register_forward_hook(
        lambda m, i, out: logits.append(read(out)))

    def state(key):
        return {n: p.grad if key is None else opt.state.get(p, {}).get(key)
                for n, p in params}

    def on_host():
        return {n: (torch.zeros_like(p, device="cpu") if b is None
                    else b.detach().to("cpu", copy=True))
                for (n, p), b in zip(params, state(first_key).values())}

    for s in range(steps):
        losses.append(step(*feed(s)).detach())
        if s == 0:
            first = on_host()
    hook.remove()
    last = state(moment_key)
    change = {n: ref_train.leaf_norm(p.detach() - weights[n])
              for n, p in params}
    digests = ([ref_train.bit_digest(p) for _, p in params]
               if world > 1 else None)
    return {"losses": [float(v) for v in losses],
            "grad_norms": {n: ref_train.leaf_norm(b)
                           for n, b in first.items()},
            "momentum_norms": {n: 0.0 if b is None else ref_train.leaf_norm(b)
                               for n, b in last.items()},
            "change_norms": change, "digest": digests,
            "logits": logits[0].tolist(), "logits_last": logits[-1].tolist(),
            "buffers": first}


def reference_readings(config: dict, traffic: dict, seed: int, world: int,
                       dev, precision: str = "bf16",
                       fault: Optional[str] = None,
                       channels_last: bool = False,
                       against: Optional[dict] = None,
                       keep_buffers: bool = False) -> dict:
    """The reference's readings of the checked steps, all ranks' batches
    made again from the seed; ``against``, the program's first
    gradients, to judge them.  Its own stay in the readings only with
    ``keep_buffers``."""
    import torch

    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference.build(config, dev, channels_last)
    specs = [(n, p.shape) for n, p in model.named_parameters()]
    weights = data.make_weights(specs, seed, dev,
                               config["init"])
    per_rank = [tasks.of(config).make_batches(traffic, config, seed, r, dev)
                for r in range(world)]
    steps = traffic["check_steps"]
    batches = [[per_rank[r][s] for r in range(world)] for s in range(steps)]
    out = ref_train.run_steps(model, weights, batches, config, traffic,
                              precision, fault, against)
    if not keep_buffers:
        del out["buffers"]
    del model, weights, per_rank, batches
    return out


def _free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _window_work(config: dict, traffic: dict, opt) -> dict:
    work = tasks.of(config).step_work(config, traffic)
    wire_bytes = {"fp16": 2, "bf16": 2}[config["compression"]]
    nbytes, passes = a1_bytes.a1_step(
        [[(p.numel(), p.element_size()) for p in b] for b in opt.buckets],
        wire_bytes)
    return {"flops_per_step": work["flops"],
            "conv_min_s_per_step": work["min_s"],
            "attention_min_s_per_step": work["attention_min_s"],
            "a1_bytes_per_step": nbytes, "a1_passes_per_step": passes}


def execute(spec: dict) -> dict:
    """One rank's run of ``spec`` (``run.make_spec``); returns what the
    rank measured and read, as plain data."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fused_scale_cast

    config, traffic = spec["config"], spec["traffic"]
    seed, fault = spec["seed"], spec.get("fault")
    hvd.init(device="cpu" if spec["device"] == "cpu" else None)
    dev, rank, world = hvd.device(), hvd.rank(), hvd.size()
    if world != traffic["ranks"]:
        raise RuntimeError(f"{world} ranks, the traffic asks for "
                           f"{traffic['ranks']}")
    if dev.type == "cuda":
        # as users' training scripts do (NVIDIA's ResNet-50 recipe among
        # them): cuDNN times its algorithms for the cell's shapes in set-up
        torch.backends.cudnn.benchmark = True
    model, opt, step, feed, weights = build_program(
        hvd, config, traffic, seed, dev, rank, fault)
    checked = traffic["check_steps"]
    prog = program_readings(model, opt, step, feed, weights, checked, world,
                            config)
    buffers = prog.pop("buffers")
    del weights
    _free(dev)

    # warm-up, the rest of the set-up: its second half times a step, and
    # rank 0's time fixes the window's steps for every rank
    warm = traffic["warmup_steps"]
    t_half = None
    for i in range(warm):
        if i == warm // 2:
            _sync(dev)
            t_half = time.perf_counter()
        step(*feed(checked + i))
    _sync(dev)
    est = (time.perf_counter() - t_half) / (warm - warm // 2)
    n = torch.tensor([max(3, round(spec["seconds"] / est))], device=dev)
    if world > 1:
        dist.broadcast(n, 0)
    n_steps = traffic["trace_steps"] if spec["trace"] else int(n.item())
    first = checked + warm
    work = _window_work(config, traffic, opt)
    out = {"rank": rank, "world": world, "device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "program": prog}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if spec["trace"]:
        # the same steps untraced first: the step's time with no profiler
        # on the host, which mfu and idle_share read
        _sync(dev)
        t = time.perf_counter()
        for k in range(n_steps):
            step(*feed(first + k))
        _sync(dev)
        work["untraced_step_s"] = (time.perf_counter() - t) / n_steps
        first += n_steps
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        launches0 = fused_scale_cast.launches
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                for k in range(n_steps):
                    step(*feed(first + k))
                _sync(dev)
        launches = fused_scale_cast.launches - launches0
        path = Path(spec["trace_dir"]) / (
            f"{spec['cell']}.seed{seed}.rank{rank}.json.gz")
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof
        w = trace.window_of(trace.load_events(str(path)), steps=n_steps,
                            a1_launches=launches, **work)
        out["trace"] = {"path": str(path), "steps": n_steps}
        if w is not None:
            out["trace"].update(
                busy_s=w.busy_s(), window_s=w.window_s,
                breakdown=trace.breakdown(w),
                metrics={m: load_reader(m)(w) for m in spec["per_layer"]})
        losses = []
    else:
        _sync(dev)
        out["setup_s"] = time.time() - spec["t0"]
        marks, losses = [], []
        t0 = time.perf_counter()
        if dev.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        host = [t0]
        for k in range(n_steps):
            losses.append(step(*feed(first + k)).detach())
            if dev.type == "cuda":
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                host.append(time.perf_counter())
        _sync(dev)
        wall = time.perf_counter() - t0
        if dev.type == "cuda":
            step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            step_ms = [(b - a) * 1e3 for a, b in zip(host, host[1:])]
        out.update(wall_s=wall, steps=n_steps, step_ms=step_ms,
                   estimate_ms=est * 1e3)
    finite = (torch.stack(losses).isfinite() if losses
              else torch.ones(0, dtype=torch.bool))
    out["failed"] = int((~finite).sum())
    out["last_loss"] = float(losses[-1]) if losses else None
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    out["forbidden"] = forbidden_modules()
    out["images_per_step"] = traffic["batch_per_rank"]
    del losses, model, opt, step, feed
    hvd.shutdown()
    _free(dev)
    if rank == 0:
        t = time.perf_counter()
        out["reference"] = reference_readings(config, traffic, seed, world,
                                              dev, against=buffers)
        out["reference_s"] = time.perf_counter() - t
        _free(dev)
    del buffers
    return out


def p90(values: List[float]) -> float:
    """The 90th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def write_json(path: str, obj) -> None:
    import json

    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def rank_main(spec_path: str) -> int:
    """A rank started by the program's launcher: run the spec, write the
    rank's result beside it."""
    import json

    with open(spec_path) as f:
        spec = json.load(f)
    out = execute(spec)
    write_json(str(Path(spec["out_dir"]) / f"rank{out['rank']}.json"), out)
    return 0


def judge_ranks(ranks: List[dict], limits: Dict[str, dict]):
    """``(correct, rows)`` of a run from its ranks' results."""
    r0 = next(r for r in ranks if r["rank"] == 0)
    digests = None
    if len(ranks) > 1:
        digests = [r["program"]["digest"]
                   for r in sorted(ranks, key=lambda r: r["rank"])]
    values = check.readings(r0["program"], r0["reference"], digests)
    return check.judge(values, limits)

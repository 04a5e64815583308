#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` and then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds kernel A1, ``fused_scale_cast``, bitwise against its plain
   PyTorch version over all 9 dtype pairs, lengths 1..2^20+3, aligned and
   unaligned buffers and every ResNet-50 gradient shape, and times it;
3. trains full-width ResNet-50 (bf16, NHWC 224x224, batch 64, synthetic
   data from a seed) through ``hvd.DistributedOptimizer`` (SGD momentum
   0.9, ``Compression.fp16``, ``gradient_predivide_factor=2.0``) in a
   one-rank NCCL world: 2 warm-up and 5 timed steps, finite loss, and
   exactly 2 x 161 kernel launches per step;
4. reduces one batch's gradients through the optimizer's group reduction
   with the kernel and with the plain version: bitwise equal;
5. checks a narrow float32 ResNet trained 2 steps on the card against the
   same steps computed on the CPU with plain PyTorch.

Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no result, when CUDA is
absent, when the package is not beside this script, or when any phase
fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
# tensor cores (the kernel multiplies in float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

SEED = 0
BATCH = 64
IMAGE = 224
WARMUP_STEPS = 2
TIMED_STEPS = 5
PREDIVIDE = 2.0
RESNET50_GRADS = 161
LENGTHS = [1, 127, 1024, 1025, 2 ** 20 + 3]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def _bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def spread_values(n: int, dtype, device, gen):
    """float32 values over 12 decades, cast to ``dtype``: the narrow
    outputs see overflow, subnormals and ties."""
    import torch

    mag = 10.0 ** (torch.rand(n, generator=gen, device=device) * 12 - 8)
    return (torch.randn(n, generator=gen, device=device) * mag).to(dtype)


def resnet50_grad_shapes():
    from horovod_tpu_torch.models import ResNet50

    model = ResNet50(device="meta")
    return [tuple(p.shape) for p in model.parameters()]


# -- phase 2: kernel A1 against its plain version -----------------------------

def kernel_phase(device, grad_shapes, big_n: int, reps: int):
    import torch

    from horovod_tpu_torch.ops import fused_scale_cast, fused_scale_cast_plain

    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    scales = [0.5, 2.0, 1.0 / 3.0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    compared = 0

    def compare(x, scale, out_dtype, what):
        nonlocal max_err, compared
        got = fused_scale_cast(x, scale, out_dtype)
        want = fused_scale_cast_plain(x, scale, out_dtype)
        check(got.dtype == out_dtype and got.shape == x.shape,
              f"fused_scale_cast {what}: dtype/shape")
        check(torch.equal(got, want), f"fused_scale_cast {what}: differs "
              "from the plain version")
        both = torch.isfinite(got) & torch.isfinite(want)
        if both.any():
            err = (got[both].double() - want[both].double()).abs().max()
            max_err = max(max_err, float(err))
        compared += 1

    for in_dt in dtypes:
        for out_dt in dtypes:
            for n in LENGTHS:
                x = spread_values(n + 1, in_dt, device, gen)
                for scale in scales:
                    # offset 0: 16-byte aligned, vector loop; offset 1:
                    # unaligned view, scalar loop
                    compare(x[:n], scale, out_dt, f"{in_dt}->{out_dt} n={n}")
                    compare(x[1:], scale, out_dt,
                            f"{in_dt}->{out_dt} n={n} unaligned")
            for shape in grad_shapes:
                n = math.prod(shape)
                x = spread_values(n, in_dt, device, gen)
                for scale in scales:
                    compare(x, scale, out_dt, f"{in_dt}->{out_dt} {shape}")
    torch.cuda.synchronize()
    log(f"kernel: fused_scale_cast bitwise equal to the plain version in "
        f"{compared} comparisons (9 dtype pairs, lengths {LENGTHS}, "
        f"{len(grad_shapes)} ResNet-50 gradient shapes, scales {scales})")

    # Timing 1: one pass over the main path's shapes (161 float32
    # gradients, the prescale 1/2), as the optimizer issues it.
    grads = [torch.randn(s, generator=gen, device=device) for s in grad_shapes]
    flats = [g.reshape(-1) for g in grads]
    total = sum(f.numel() for f in flats)
    pre = 1.0 / PREDIVIDE

    def kernel_pass():
        for f in flats:
            fused_scale_cast(f, pre)

    def plain_pass():
        for f in flats:
            fused_scale_cast_plain(f, pre)

    def library_pass():
        torch._foreach_mul(flats, pre)

    launches_before = fused_scale_cast.launches
    ms = time_cuda(kernel_pass, reps)
    plain_ms = time_cuda(plain_pass, reps)
    library_ms = time_cuda(library_pass, reps)
    fused_scale_cast.launches = launches_before  # timing launches not counted
    bound_ms, bound_by = _bound_ms(total * 8, total)
    path_pass = dict(elements=total, tensors=len(flats), ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
    log("kernel_path_pass " + json.dumps(path_pass))

    # Timing 2: one buffer of every ResNet-50 gradient (25.56 M elements),
    # the bandwidth-bound case.
    big = torch.randn(big_n, generator=gen, device=device)
    rows = []
    for out_dt in (torch.float32, torch.bfloat16):
        out = torch.empty(big_n, dtype=out_dt, device=device)
        k_ms = time_cuda(lambda: fused_scale_cast(big, pre, out_dt), reps)
        p_ms = time_cuda(lambda: fused_scale_cast_plain(big, pre, out_dt),
                         reps)
        l_ms = time_cuda(lambda: torch.mul(big, pre, out=out), reps)
        b_ms, b_by = _bound_ms(big_n * (4 + out.element_size()), big_n)
        rows.append(dict(n=big_n, out=str(out_dt).replace("torch.", ""),
                         ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by))
        log("kernel_big_buffer " + json.dumps(rows[-1]))
    fused_scale_cast.launches = launches_before
    return dict(max_abs_err=max_err, compared=compared, path_pass=path_pass,
                big_buffer=rows)


# -- phase 3: the training path -------------------------------------------------

def make_optimizer(hvd, model, compression):
    import torch

    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=compression,
        gradient_predivide_factor=PREDIVIDE)


def train_phase(hvd, device, batch: int, image: int, stage_sizes):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ops import fused_scale_cast

    gen = torch.Generator().manual_seed(SEED)
    model = ResNet(stage_sizes, dtype=torch.bfloat16, device=device,
                   generator=gen)
    n_grads = sum(1 for p in model.parameters() if p.requires_grad)
    dgen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(batch, image, image, 3, generator=dgen, device=device)
    y = torch.randint(0, 1000, (batch,), generator=dgen, device=device)
    opt = make_optimizer(hvd, model, hvd.Compression.fp16)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    losses, step_s = [], []
    fused_scale_cast.launches = 0      # the main path's run starts here
    for step in range(WARMUP_STEPS + TIMED_STEPS):
        before = fused_scale_cast.launches
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        delta = fused_scale_cast.launches - before
        check(delta == 2 * n_grads,
              f"step {step}: {delta} fused_scale_cast launches, expected "
              f"{2 * n_grads}")
        check(math.isfinite(losses[-1]), f"step {step}: loss {losses[-1]}")
    launches = fused_scale_cast.launches  # read just after the main path
    timed = step_s[WARMUP_STEPS:]
    result = dict(
        batch=batch, image=image, grads=n_grads, losses=losses,
        step_ms=[t * 1e3 for t in step_s],
        images_per_s=batch * len(timed) / sum(timed),
        launches=launches, launches_per_step=launches // len(step_s),
        buckets=len(opt.buckets),
        peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    log("train " + json.dumps(result))
    return model, opt, x, y, result


# -- phase 4: the group reduction with the kernel and with the plain version --

def parity_phase(model, opt, x, y):
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import fused_scale_cast, fused_scale_cast_plain

    params = [p for p in model.parameters() if p.requires_grad]
    loss = F.cross_entropy(model(x), y)
    # autograd.grad leaves .grad alone, so the optimizer's hooks stay quiet
    grads = dict(zip(params, torch.autograd.grad(loss, params)))
    plain = dataclasses.replace(opt.reduction, scale=fused_scale_cast_plain)
    check(opt.reduction.scale is fused_scale_cast,
          "the optimizer's reduction does not use the kernel")
    launches_before = fused_scale_cast.launches
    n = 0
    for bucket in opt.buckets:
        bucket_grads = [grads[p] for p in bucket]
        got = opt.reduction.reduce(bucket_grads)
        want = plain.reduce(bucket_grads)
        for g, w in zip(got, want):
            check(torch.equal(g, w), "group reduction: kernel and plain "
                  "version differ")
            n += 1
    check(fused_scale_cast.launches - launches_before == 2 * n,
          "the group reduction did not launch the kernel")
    fused_scale_cast.launches = launches_before
    torch.cuda.synchronize()
    log(f"parity: {n} reduced gradients bitwise equal, kernel vs plain, "
        f"over {len(opt.buckets)} buckets")


# -- phase 5: a small run against plain PyTorch on the CPU --------------------

def reference_phase(hvd, device):
    """2 steps of a narrow float32 ResNet through the port on the card,
    against the same steps on the CPU with the reduction written out in
    plain PyTorch (world of one: g * 1/2 -> fp16 -> float32 * 2/1)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(SEED + 1)
        ref = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                     dtype=torch.float32, generator=gen)
        card = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                      dtype=torch.float32, device=device)
        card.load_state_dict(ref.state_dict())
        opt = make_optimizer(hvd, card, hvd.Compression.fp16)
        ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)
        dgen = torch.Generator().manual_seed(SEED + 2)
        losses = []
        for _ in range(2):
            xb = torch.randn(16, 32, 32, 3, generator=dgen)
            yb = torch.randint(0, 10, (16,), generator=dgen)
            opt.zero_grad()
            loss = F.cross_entropy(card(xb.to(device)), yb.to(device))
            loss.backward()
            opt.step()
            ref_opt.zero_grad()
            ref_loss = F.cross_entropy(ref(xb), yb)
            ref_loss.backward()
            with torch.no_grad():
                for p in ref.parameters():
                    w = (p.grad * (1.0 / PREDIVIDE)).to(torch.float16)
                    p.grad.copy_(w.to(torch.float32) * PREDIVIDE)
            ref_opt.step()
            losses.append((float(loss.detach()), float(ref_loss.detach())))
        worst = 0.0
        card_state = card.state_dict()
        for name, t in ref.state_dict().items():
            got = card_state[name].cpu()
            check(got.shape == t.shape and torch.isfinite(got).all(),
                  f"reference: {name} shape or finiteness")
            check(torch.allclose(got, t, rtol=1e-3, atol=1e-4),
                  f"reference: {name} differs from the CPU run")
            worst = max(worst, float((got - t).abs().max()))
        for got, want in losses:
            check(abs(got - want) <= 1e-3 * abs(want), "reference: loss")
        log(f"reference: narrow ResNet on the card agrees with the CPU run "
            f"(losses {losses}, max abs param diff {worst:.3g}, rtol 1e-3)")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "horovod_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the horovod_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s (sm_90a)")
    smi = nvidia_smi_line()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    hvd.init()                            # one-rank NCCL world on cuda:0
    device = hvd.device()
    try:
        grad_shapes = resnet50_grad_shapes()
        check(len(grad_shapes) == RESNET50_GRADS, "ResNet-50 inventory")
        big_n = sum(math.prod(s) for s in grad_shapes)
        kern = kernel_phase(device, grad_shapes, big_n, reps=20)

        torch.backends.cudnn.benchmark = True
        model, opt, x, y, train = train_phase(hvd, device, BATCH, IMAGE,
                                              [3, 4, 6, 3])
        check(train["grads"] == RESNET50_GRADS, "ResNet-50 gradients")
        parity_phase(model, opt, x, y)
        del model, opt, x, y
        reference_phase(hvd, device)
    finally:
        hvd.shutdown()

    log(f"{smi} | ResNet-50 bf16 batch {BATCH} {IMAGE}x{IMAGE}: "
        f"{train['images_per_s']:.1f} images/s")
    pp = kern["path_pass"]
    print(json.dumps({"kernels": [{
        "name": "fused_scale_cast",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/scale_cast.cu",
        "replaces": "horovod_tpu/ops/pallas_ops.py:101",
        "launches": train["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": pp["ms"],
        "plain_ms": pp["plain_ms"],
        "bound_ms": pp["bound_ms"],
        "bound_by": pp["bound_by"],
        "library_ms": pp["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

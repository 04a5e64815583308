#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` and then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds kernel A1 bitwise against its plain PyTorch versions: one
   tensor (``fused_scale_cast``, a table of one entry) over all 9 dtype
   pairs, lengths 1..2^20+3, aligned and unaligned buffers and every
   ResNet-50 gradient shape; the grouped passes (``scale_cast_pack``,
   ``unpack_cast_scale``, any NaN equal to any NaN) over the 161
   ResNet-50 gradients in both directions, the 9 (in, out) dtype pairs
   with each own dtype, scale 1 among the scales, sources and destinations at odd element
   offsets, a zero-length entry, NaN/inf/subnormal/-0 values, and a
   group larger than one table (more than one launch); then times the
   two passes over the 161 gradients against their bound,
   ``_foreach_mul`` and the per-tensor composition they replace, and one
   25.56 M buffer against ``torch.mul``;
3. trains full-width ResNet-50 (bf16, NHWC 224x224, batch 64, synthetic
   data from a seed) through ``hvd.DistributedOptimizer`` (SGD momentum
   0.9, ``Compression.fp16``, ``gradient_predivide_factor=2.0``) in a
   one-rank NCCL world: 2 warm-up and 5 timed steps, finite loss, and
   exactly 2 A1 launches per multi-tensor bucket a step;
4. reduces one batch's gradients through the optimizer's group reduction
   with the kernel and with the plain versions: bitwise equal; then
   times the group reduction over the real buckets, grouped and tensor
   by tensor; both in the training's configuration and in the
   optimizer's default (Average, no predivide: both scales 1);
5. holds kernels A2/A3, ``quantize_int8_blocks`` (both rounding modes)
   and ``dequantize_int8_blocks``, bitwise against their plain versions
   (any NaN equal to any NaN) over float32/bfloat16/float16 in and out,
   lengths 1..2^20+3 (at the edges of the kernels' words and blocks),
   aligned and offset views, codes at an odd address, the NaN/inf/zero/
   subnormal blocks, every ResNet-50 gradient shape and one 25.56 M
   buffer, and times them;
6. drives the int8 path at full width: one backward of the ResNet-50 of
   phase 3, its 161 gradients and their packed buffer through the
   engine's ``Compression.int8`` and ``int8_stochastic`` (161 + 1 A2 and
   A3 launches a codec), error bounds per block, stochastic rounding
   unbiased and moving the expected share of codes off ``rint``, the
   world-of-one ``allreduce(compression=int8)`` rule, and
   ``quantized_allreduce`` over the one-rank NCCL group bitwise equal to
   the same call on the CPU, then times it and its two codec phases on
   the bucket beside A2 and A3; then the torch surface's allreduce and
   allgather on card tensors that require grad carry their gradient;
   then the async controller: phase 3's 161 gradients (float32, in hook
   order) as a burst of ``allreduce_async_`` with the optimizer's
   arguments (Sum, prescale 1/2, postscale 2/1, fp16) and as one
   ``grouped_allreduce_async``, both again under ``none``: every result
   bitwise the plain composition of the group the controller's responses
   name (and ``GroupReduction``'s under ``none``), two A1 launches a
   fused group of several tensors and none a tensor, the host ms and
   controller cycles of each burst beside ``GroupReduction.reduce``'s ms
   on the same gradients; a
   process set {0} with its own NCCL groups; the BERT-base word
   embedding's sparse gradient through ``sparse_allreduce_async`` and a
   ``sparse_as_dense`` step; the other async ops against the sync ones;
   then the controller's zero-copy route: the 161 gradients as
   ``allreduce_async_`` with the optimizer's default arguments (Average,
   no codec, scales 1), values changed from burst to burst, 3 untimed
   bursts that learn the pack plan, then 10 timed bursts with the route
   on and off in turns: every result bitwise the staged route's and in
   the caller's tensor, 161 zero-copy ops and one A1 launch a fused group
   with the route on, 161 staged copies and two with it off, the plane
   (lockstep at one rank) and the predicted bursts (none);
   Adasum: ``pairwise_adasum`` over two batches' 161 gradients (float32,
   a segment a tensor) against the float64 reference, and a ResNet-50
   step with ``op=Adasum`` bitwise the ``op=Sum`` step;
   the stall watchdog: two of the port's amortized inspectors over one
   ``HashStore`` (ranks 0 and 1 of a set {0, 1}; heartbeat 0.05 s, warn
   0.3 s, abort 1.0 s), rank 0 running the optimizer's group reduction
   over phase 3's 161 gradients (A1's grouped passes and the one-rank NCCL
   allreduce) through ``dispatch`` / ``wait_ready``: 20 healthy ops with
   rank 1 mirroring each descriptor (no warning, bitwise the unguarded
   reduction, 2 A1 launches a multi-tensor bucket, the host µs
   ``pre_op`` adds and ``wait_ready``'s overshoot past the event's
   completion), a diverged op (the error names both ops; its detection
   latency), and a dead peer mid-op (the card sleeps 3 s before the
   reduction, rank 1's beats stop: the abort names rank 1 while the
   op's CUDA event is still pending; then one more reduction is bitwise
   the healthy one); which stores have ``list_keys`` and delete, and
   ``core.state.abort_group`` on a one-rank NCCL group;
   fault injection: phase 6b's fp16 burst clean, then under
   ``collective.pre:corrupt(nan)@count=K,times=1`` and
   ``corrupt(bitflip)``: one result differs from the clean composition,
   every result is the plain composition of its group over the
   poisoned input, 2 A1 launches a fused group, and the poisoning runs
   on the card under CUDA's sync-debug mode "error"; the dead-peer abort
   leaves a postmortem naming the op (the flight recorder writes into
   this run's temporary directory) and counts in the abort family;
   the observability planes: phase 3's training step in three modes in
   turns (every plane off; the reference's defaults: flight, stepprof,
   anomaly; defaults plus timeline and trace), each mode twice: the
   optimizer's reduction of one fixed backward bitwise across modes, 4
   A1 launches a step in each, the timeline's 161 gradient and 2 bucket
   spans a step, the trace merged by ``tools/hvtputrace``, images/s and
   the host µs of a hooked ``hvd.allreduce`` a mode, the host µs of one
   timeline event; ``GET /metrics`` and ``/debug`` on localhost (the op
   counters; the job, stall, flight, anomaly, stepprof and controller
   providers); stepprof's profile window over 3 steps (idle share within
   0.05 of the same trace read as ``torch_port_profile.py`` reads it,
   exposed comm, MFU from ``FlopCounterMode`` against the card's peak),
   its clock alignment held to a 20 ms sleep kernel within 2 ms; the
   async fp16 burst of 161 ``allreduce_async_`` with tracing on and off
   in turns, bitwise, every op's trace chain complete;
7. runs the ring collectives at full width: phase 3's batch as 8 virtual
   ranks of 8 images, each rank's 161 gradients packed (25.56 M float32),
   reduced on the card by ``ring_allreduce`` (A5 Sum and Average, A6
   quantized, all on the cluster kernels) and gathered by
   ``ring_allgather_2d`` (A4 on the cluster kernel, each rank's 1/8):
   one launch a call, outputs identical on every rank and bitwise the
   plain versions, A5 within ``n * 2^-23 * sum|x|`` of the float64 sum,
   A6 within ``2(n-1) * max sum|x| / 127``, A4 bitwise ``torch.cat``;
   then rings of 2 and 3 ranks, and of 3 ranks of NaN/inf/subnormal
   values, bitwise the plain versions; a ring of 12 ranks of 1,000,003
   elements on the global-slot A4/A5/A6 kernels, its own path, with the
   same checks; timing against the plain versions and the library calls
   that fill one output and every rank's (the 12-rank kernels at half a
   bucket a rank, and a call's time at 1,000,003), and the last timed
   call checked again;
8. checks a narrow float32 ResNet trained 2 steps on the card against the
   same steps computed on the CPU with plain PyTorch.

Prints one ``int8_quantized_allreduce {...}`` line, one ``async_path
{...}`` line (its ``zero_copy`` part the route's bursts), one ``adasum
{...}`` line, one ``stall {...}`` line, one ``faults {...}`` line, one
``obs {...}`` line, one ``ring_path {...}`` line, one ``{"kernels": [...]}`` line of 10 entries
(A1's with ``stall_launches`` and ``obs_launches_per_step``) and,
last,
``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no result, when CUDA is
absent, when the package is not beside this script, or when any phase
fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the int8 kernels' layout: a warp a 1024-element block, 16-byte words
# of 4 float32 or 8 16-bit elements, word w on lane w % 32
INT8_LENGTHS = [1, 8, 9, 128, 511, 512, 1023, 1024, 1025, 1032, 2047,
                2 ** 20 + 3]
FLT_MIN = 2.0 ** -126
# stochastic rounding over the 25.56 M buffer: |mean((x_hat - x) /
# scale)|, and the share of codes moved off rint against its expectation;
# each term is independent given the data and spans at most 1, so either
# mean's standard deviation is below 0.5 / sqrt(25.56e6) = 1e-4
UNBIASED_BOUND = 1e-3
RING_RANKS = 8            # phase 3's batch of 64 as 8 ranks of 8 images
RING_SMALL = 1_000_003    # elements a rank of the 2-, 3- and 12-rank rings
RING_WIDE = 12            # ranks of the ring past a cluster's 8 CTAs


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


# -- phase 2: kernel A1 against its plain versions ----------------------------

def special_values(dtype, device):
    """NaN, +-inf, +-0, float32/bfloat16/float16 subnormals, the edges of
    float16's range and ties of the narrow roundings, in ``dtype``."""
    import torch

    vals = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1e-40, -3e-39,
            FLT_MIN, 6e-8, -3e-5, 65504.0, 65520.0, -7e4, 3.0e38, 1e-38,
            1.0 + 2.0 ** -8, 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -9)]
    return torch.tensor(vals, dtype=torch.float32, device=device).to(dtype)


def _group_compare(tensors, scale: float, codec, what: str, outs=None):
    """``scale_cast_pack`` and ``unpack_cast_scale`` (into ``outs`` when
    given) bitwise their plain versions on one group; the unpack reads
    the packed buffer back, then a flat buffer of new values.  Returns
    the largest difference (0.0)."""
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.ops import (
        scale_cast_pack,
        scale_cast_pack_plain,
        unpack_cast_scale,
        unpack_cast_scale_plain,
    )

    flat, specs = scale_cast_pack(tensors, scale, codec)
    pflat, pspecs = scale_cast_pack_plain(tensors, scale, codec)
    check(specs == pspecs, f"scale_cast_pack {what}: specs")
    check(same_bits(flat, pflat), f"scale_cast_pack {what}: differs from "
          "the plain version")
    err = max_abs_diff(flat, pflat)
    gen = torch.Generator(device=flat.device).manual_seed(SEED + 5)
    # the contexts the codec's compress returns: None under none
    ctxs = [None if codec is Compression.none else t.dtype for t in tensors]
    for reduced in (flat, wide_values(flat.numel(), flat.dtype, flat.device,
                                      gen)):
        got = unpack_cast_scale(reduced, specs, ctxs, 1.0 / scale, outs)
        want = unpack_cast_scale_plain(reduced, specs, ctxs, 1.0 / scale)
        check(outs is None or all(g is o for g, o in zip(got, outs)),
              f"unpack_cast_scale {what}: did not write into outs")
        for i, (g, w) in enumerate(zip(got, want)):
            check(same_bits(g, w), f"unpack_cast_scale {what}: tensor {i} "
                  "differs from the plain version")
            err = max(err, max_abs_diff(g, w))
    return err


def _offset_views(tensors):
    """Each tensor again as a contiguous view one element into a larger
    buffer: a pointer 16-byte aligned in no dtype."""
    import torch

    out = []
    for t in tensors:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        out.append(view.copy_(t))
    return out


def grouped_checks(device, grad_shapes, gen):
    """The grouped passes bitwise their plain versions: returns (max
    difference, groups compared, launches of the group larger than one
    table)."""
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.ops import fused_scale_cast
    from horovod_tpu_torch.ops.scale_cast import max_entries

    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    err, groups = 0.0, 0

    # the main path: 161 float32 gradients, prescale 1/2 into the fp16
    # wire, postscale 2 back into float32 (spread and 50-decade values);
    # and the optimizer's default (Average, no predivide): scale 1 both
    # ways
    for values in (spread_values, wide_values):
        grads = [values(math.prod(s), torch.float32, device, gen).view(s)
                 for s in grad_shapes]
        outs = [torch.empty_like(g) for g in grads]
        for scale in (1.0 / PREDIVIDE, 1.0):
            err = max(err, _group_compare(grads, scale, Compression.fp16,
                                          f"ResNet-50 scale {scale}", outs))
            groups += 1

    # every (in, out) pair with each own dtype: a group of all three
    # dtypes under the none (flat float32), bf16 and fp16 wires; sizes
    # that put pieces at odd offsets, a zero-length entry, the special
    # values; then every tensor and out one element off alignment
    for codec in (Compression.none, Compression.bf16, Compression.fp16):
        group = []
        for n in LENGTHS:
            group += [spread_values(n, dt, device, gen) for dt in dtypes]
        group.insert(4, torch.empty(0, device=device))
        group += [special_values(dt, device) for dt in dtypes]
        for scale in (0.5, 2.0, 1.0 / 3.0, 1.0):
            what = f"{codec.__name__} scale {scale}"
            err = max(err, _group_compare(group, scale, codec, what))
            err = max(err, _group_compare(
                _offset_views(group), scale, codec, f"{what} offset 1",
                _offset_views([torch.empty_like(t) for t in group])))
            groups += 2

    # a group larger than one table: several launches, each counted
    m = max_entries()
    many = [spread_values(i % 7 + 1, dtypes[i % 3], device, gen)
            for i in range(m + 5)]
    before = fused_scale_cast.launches
    err = max(err, _group_compare(many, 0.5, Compression.none,
                                  f"{m + 5} tensors"))
    launches = fused_scale_cast.launches - before
    # one pack and two unpacks, each a launch a table
    check(launches == 3 * -(-len(many) // m),
          f"a group of {len(many)} tensors took {launches} launches, "
          f"{m} a table")
    torch.cuda.synchronize()
    return err, groups + 1, dict(tensors=len(many), max_entries=m,
                                 launches=launches)


def kernel_phase(device, grad_shapes, big_n: int, reps: int):
    import torch

    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.packing import pack_flat, unpack_flat
    from horovod_tpu_torch.ops import (
        fused_scale_cast,
        fused_scale_cast_plain,
        scale_cast_pack,
        scale_cast_pack_plain,
        unpack_cast_scale,
        unpack_cast_scale_plain,
    )

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
                    # unaligned view, scalar head and tail
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
    g_err, groups, many = grouped_checks(device, grad_shapes, gen)
    max_err = max(max_err, g_err)
    log(f"kernel: scale_cast_pack and unpack_cast_scale bitwise equal to "
        f"the plain versions over {groups} groups (the 161 ResNet-50 "
        f"gradients at scales 1/2 and 1, 9 (in, out) pairs x 3 own dtypes "
        f"x 4 scales, offset 1, a zero-length entry, NaN/inf/subnormal/-0); "
        f"{many}")

    # Timing 1: the two passes over the main path's shapes (161 float32
    # gradients, prescale 1/2 into the fp16 wire, postscale 2 back), as
    # the optimizer issues them, against the per-tensor composition they
    # replace (kernel per tensor, codec, pack / unpack, codec, kernel per
    # tensor and the copy into the gradient).
    launches_before = fused_scale_cast.launches
    grads = [torch.randn(s, generator=gen, device=device) for s in grad_shapes]
    flats = [g.reshape(-1) for g in grads]
    outs = [torch.empty_like(g) for g in grads]
    total = sum(f.numel() for f in flats)
    pre, post, codec = 1.0 / PREDIVIDE, PREDIVIDE, Compression.fp16
    flat, specs = scale_cast_pack(grads, pre, codec)
    ctxs = [torch.float32] * len(grads)

    def per_tensor_pre():
        wires = [codec.compress(fused_scale_cast(f, pre).reshape(g.shape))[0]
                 for f, g in zip(flats, grads)]
        return pack_flat(wires)

    def per_tensor_post():
        for piece, ctx, o in zip(unpack_flat(flat, specs), ctxs, outs):
            g = codec.decompress(piece, ctx)
            o.copy_(fused_scale_cast(g.reshape(-1), post).reshape(g.shape))

    bound_ms, bound_by = _bound_ms(total * (4 + 2), total)
    passes = {}
    for name, fn, plain, library, per_tensor in (
            ("pre", lambda: scale_cast_pack(grads, pre, codec),
             lambda: scale_cast_pack_plain(grads, pre, codec),
             lambda: torch._foreach_mul(flats, pre), per_tensor_pre),
            ("post", lambda: unpack_cast_scale(flat, specs, ctxs, post, outs),
             lambda: unpack_cast_scale_plain(flat, specs, ctxs, post, outs),
             lambda: torch._foreach_mul(outs, post), per_tensor_post)):
        passes[name] = dict(
            elements=total, tensors=len(grads), ms=time_cuda(fn, reps),
            plain_ms=time_cuda(plain, reps), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=time_cuda(library, reps),
            per_tensor_ms=time_cuda(per_tensor, reps))
        log(f"kernel_path_pass {name} " + json.dumps(passes[name]))
    # the last timed calls, checked again
    check(same_bits(scale_cast_pack(grads, pre, codec)[0],
                    per_tensor_pre()[0]), "the pre pass after timing is "
          "not the per-tensor composition")
    unpack_cast_scale(flat, specs, ctxs, post, outs)
    got = [o.clone() for o in outs]
    per_tensor_post()
    check(all(same_bits(g, o) for g, o in zip(got, outs)),
          "the post pass after timing is not the per-tensor composition")
    del flat, outs, got

    # Timing 2: one buffer of every ResNet-50 gradient (25.56 M elements),
    # the bandwidth-bound case, through the table of one entry.
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
    fused_scale_cast.launches = launches_before  # timing launches not counted
    return dict(max_abs_err=max_err, compared=compared, groups=groups,
                many=many, passes=passes, big_buffer=rows)


# -- phase 3: the training path -----------------------------------------------

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
    # one pre and one post pass of A1 a multi-tensor bucket; a bucket of
    # one tensor goes through comm/eager.allreduce
    multi = sum(len(b) > 1 for b in opt.buckets)

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
        check(delta == 2 * multi,
              f"step {step}: {delta} fused_scale_cast launches, expected "
              f"{2 * multi}")
        check(math.isfinite(losses[-1]), f"step {step}: loss {losses[-1]}")
    launches = fused_scale_cast.launches  # read just after the main path
    timed = step_s[WARMUP_STEPS:]

    # the same step with the group reduction tensor by tensor (as before
    # the grouped passes), in turns with the grouped one: 1 warm-up and
    # TIMED_STEPS timed steps a turn; launches not counted
    def turn(reduction):
        opt.reduction = reduction
        secs = []
        for _ in range(1 + TIMED_STEPS):
            t0 = time.perf_counter()
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.step()
            torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t0)
        return batch * TIMED_STEPS / sum(secs[1:])

    grouped, per_tensor = opt.reduction, per_tensor_reduction(opt.reduction)
    turns = {"per_tensor": [], "grouped": []}
    for name, reduction in (("per_tensor", per_tensor), ("grouped", grouped),
                            ("grouped", grouped), ("per_tensor", per_tensor)):
        turns[name].append(turn(reduction))
    opt.reduction = grouped
    fused_scale_cast.launches = launches
    result = dict(
        batch=batch, image=image, grads=n_grads, losses=losses,
        step_ms=[t * 1e3 for t in step_s],
        images_per_s=batch * len(timed) / sum(timed),
        images_per_s_turns=turns,
        launches=launches, launches_per_step=launches // len(step_s),
        buckets=len(opt.buckets), multi_tensor_buckets=multi,
        peak_mem_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
    log("train " + json.dumps(result))
    return model, opt, x, y, result


# -- phase 4: the group reduction with the kernel and with the plain version --

def per_tensor_reduction(reduction):
    """``reduction`` with the grouped passes turned off: every group takes
    the reference's steps tensor by tensor (``fused_scale_cast`` a
    tensor), as the optimizer did before the grouped passes."""
    from horovod_tpu_torch.torch.optimizer import GroupReduction

    @dataclasses.dataclass(frozen=True)
    class PerTensor(GroupReduction):
        def grouped(self, tensors) -> bool:
            return False

    fields = {f.name: getattr(reduction, f.name)
              for f in dataclasses.fields(reduction)}
    return PerTensor(**fields)


def parity_phase(model, opt, x, y, reps: int):
    """The optimizer's group reduction over one batch's real buckets,
    kernel against plain, bitwise, then timed grouped and tensor by
    tensor: in the main path's configuration (predivide 2: prescale
    1/2, postscale 1/2 for one rank) and in the optimizer's default
    (Average, no predivide: both scales 1)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.reduce_ops import ReduceOp
    from horovod_tpu_torch.ops import (
        fused_scale_cast,
        fused_scale_cast_plain,
        scale_cast_pack,
        scale_cast_pack_plain,
        unpack_cast_scale,
        unpack_cast_scale_plain,
    )

    params = [p for p in model.parameters() if p.requires_grad]
    loss = F.cross_entropy(model(x), y)
    # autograd.grad leaves .grad alone, so the optimizer's hooks stay
    # quiet; its results keep the layout the backward gave them, so they
    # are made contiguous, as AccumulateGrad lays out p.grad
    grads = {p: g.contiguous()
             for p, g in zip(params, torch.autograd.grad(loss, params))}
    red = opt.reduction
    check(red.pack is scale_cast_pack and red.unpack is unpack_cast_scale
          and red.scale is fused_scale_cast,
          "the optimizer's reduction does not use the kernel")
    # {name: (reduction, prefix of its timing keys)}
    configs = {"predivide": (red, ""), "default": (dataclasses.replace(
        red, op=ReduceOp.AVERAGE, prescale=1.0, postscale=1.0), "default_")}
    launches_before = fused_scale_cast.launches
    buckets = [[grads[p] for p in bucket] for bucket in opt.buckets]
    multi = sum(len(b) > 1 for b in buckets)
    n = 0
    for name, (cfg, _) in configs.items():
        plain = dataclasses.replace(cfg, scale=fused_scale_cast_plain,
                                    pack=scale_cast_pack_plain,
                                    unpack=unpack_cast_scale_plain)
        before = fused_scale_cast.launches
        for bucket_grads in buckets:
            got = cfg.reduce(bucket_grads)
            want = plain.reduce(bucket_grads)
            for g, w in zip(got, want):
                check(torch.equal(g, w), f"group reduction {name}: kernel "
                      "and plain versions differ")
                n += 1
        check(fused_scale_cast.launches - before == 2 * multi,
              f"the group reduction {name} did not launch the kernel once a "
              "direction a multi-tensor bucket")
    torch.cuda.synchronize()
    log(f"parity: {n} reduced gradients bitwise equal, kernel vs plain, "
        f"over {len(opt.buckets)} buckets, predivide {PREDIVIDE} and the "
        "default configuration")

    # the optimizer's reduction over the real buckets, launch + finish
    # into the gradients, grouped and tensor by tensor (one rank: NCCL
    # moves nothing; host-bound, so the events read the host's time)
    outs = [[torch.empty_like(g) for g in b] for b in buckets]

    def reduce_all(reduction):
        def run():
            for b, o in zip(buckets, outs):
                reduction.finish(reduction.launch(b), o)
        return run

    timing = {}
    for name, (cfg, key) in configs.items():
        per_tensor = per_tensor_reduction(cfg)
        timing[f"{key}group_reduce_ms"] = time_cuda(reduce_all(cfg), reps)
        timing[f"{key}per_tensor_reduce_ms"] = time_cuda(
            reduce_all(per_tensor), reps)
        by_tensor = [o.clone() for b in outs for o in b]  # last timed run
        reduce_all(cfg)()
        check(all(same_bits(w, o) for w, o in zip(
            by_tensor, [o for b in outs for o in b])),
            f"the grouped reduction {name} after timing is not the "
            "per-tensor one")
    fused_scale_cast.launches = launches_before
    log("reduction " + json.dumps(timing))
    return timing


# -- phase 5: kernels A2/A3 against their plain versions ----------------------

def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits, with any NaN equal to any NaN (the
    kernel and PyTorch narrow a NaN to other bits)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.view(as_int)[~na], b.view(as_int)[~na])


def max_abs_diff(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not both.any():
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def wide_values(n: int, dtype, device, gen):
    """float32 values over 50 decades, subnormals included, cast to
    ``dtype``."""
    import torch

    mag = 10.0 ** (torch.rand(n, generator=gen, device=device) * 50 - 40)
    return (torch.randn(n, generator=gen, device=device) * mag).to(dtype)


def special_blocks(device, gen):
    """Blocks of 1024 that the TPU's float32 semantics decide: NaN, inf,
    -inf, zero, a subnormal absmax, scale FLT_MIN with a subnormal
    element, a scale below FLT_MIN, and rounding ties, between ordinary
    blocks, then a ragged tail."""
    import torch

    rows = [
        [1.0, math.nan, 2.0, -3.0],
        [1.0, math.inf, 2.0],
        [1.0, -math.inf, 2.0],
        [],
        [3e-39, -2e-39, 1e-39],
        [FLT_MIN * 127.0, 1.1e-38, 1e-37],
        [1e-37, -5e-38],
        [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5],
    ]
    parts = []
    for vals in rows:
        parts.append(torch.randn(1024, generator=gen, device=device))
        block = torch.zeros(1024, device=device)
        block[:len(vals)] = torch.tensor(vals, dtype=torch.float32)
        parts.append(block)
    parts.append(torch.randn(700, generator=gen, device=device))
    return torch.cat(parts)


def _int8_bytes(n: int, in_size: int, out_size: int, quantize: bool):
    """Bytes the function must move: the input once, the output once.
    Quantize writes whole blocks of codes and one f32 scale a block;
    dequantize reads the n codes it needs and the scales."""
    blocks = -(-n // 1024)
    if quantize:
        return n * in_size + blocks * 1024 + 4 * blocks
    return n + 4 * blocks + n * out_size


def int8_kernel_phase(device, grad_shapes, big_n: int, reps: int):
    import torch

    from horovod_tpu_torch.ops import (
        dequantize_int8_blocks,
        dequantize_int8_blocks_plain,
        quantize_int8_blocks,
        quantize_int8_blocks_plain,
    )

    dtypes = [torch.float32, torch.bfloat16, torch.float16]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    seed = torch.tensor(1234567, dtype=torch.int32, device=device)
    err = {"q": 0.0, "s": 0.0, "d": 0.0}
    compared = 0

    def compare(x, what):
        nonlocal compared
        for stochastic in (False, True):
            tag = f"{what} stochastic={stochastic}"
            q, s, n = quantize_int8_blocks(x, stochastic=stochastic,
                                           seed=seed)
            pq, ps, pn = quantize_int8_blocks_plain(x, stochastic=stochastic,
                                                    seed=seed)
            check(n == pn and torch.equal(q, pq), f"A2 codes {tag}")
            check(same_bits(s, ps), f"A2 scales {tag}")
            err["q"] = max(err["q"], max_abs_diff(q.float(), pq.float()))
            err["s"] = max(err["s"], max_abs_diff(s, ps))
            # the codes at an odd address too: A3's byte-by-byte loads
            odd = torch.empty(q.numel() + 1, dtype=torch.int8,
                              device=device)[1:]
            odd.copy_(q.reshape(-1))
            for out_dt in dtypes:
                dp = dequantize_int8_blocks_plain(q, s, n, out_dt)
                for codes in (q, odd.view(q.shape)):
                    d = dequantize_int8_blocks(codes, s, n, out_dt)
                    check(same_bits(d, dp), f"A3 -> {out_dt} {tag} codes "
                          f"at {codes.data_ptr() % 16} mod 16")
                    err["d"] = max(err["d"], max_abs_diff(d, dp))
            compared += 1

    for in_dt in dtypes:
        for n in INT8_LENGTHS:
            x = wide_values(n + 1, in_dt, device, gen)
            # offset 0: 16-byte aligned, vector loads; offset 1: scalar
            compare(x[:n], f"{in_dt} n={n}")
            compare(x[1:], f"{in_dt} n={n} offset 1")
        blocks = special_blocks(device, gen).to(in_dt)
        compare(blocks, f"{in_dt} special blocks")
        compare(blocks[1:], f"{in_dt} special blocks offset 1")
    for shape in grad_shapes:
        compare(wide_values(math.prod(shape), torch.float32, device, gen),
                f"gradient {shape}")
    # the main path's buffer: 24,958 blocks, more CTAs than an SM wave
    compare(wide_values(big_n, torch.float32, device, gen),
            f"buffer of {big_n}")
    torch.cuda.synchronize()
    log(f"int8 kernels: A2 (both modes) and A3 (3 output dtypes, codes "
        f"aligned and at an odd address) bitwise equal to the plain versions "
        f"in {compared} x 2 comparisons (inputs f32/bf16/f16, lengths "
        f"{INT8_LENGTHS} aligned and offset, the special blocks, "
        f"{len(grad_shapes)} ResNet-50 gradient shapes, one {big_n}-element "
        "buffer)")

    # Timing 1: one pass over the main path's shapes, as the int8 codec
    # issues it: 161 float32 gradients (ResNet-50's parameters are
    # float32), one launch each, A3 writing float32.
    grads = [torch.randn(s, generator=gen, device=device).reshape(-1)
             for s in grad_shapes]
    coded = [quantize_int8_blocks(g) for g in grads]
    before = (quantize_int8_blocks.launches, dequantize_int8_blocks.launches)

    def pass_of(fn):
        return lambda: [fn(g) for g in grads]

    def deq_pass(fn):
        return lambda: [fn(q, s, n, torch.float32) for q, s, n in coded]

    def library_deq_pass():
        # int8 x float32 promotes to float32: one call dequantizes a
        # block-padded tensor; the trim to n is a view
        return [torch.mul(q.view(-1, 1024), s) for q, s, _ in coded]

    for (q, s, n), lib in zip(coded, library_deq_pass()):
        check(same_bits(lib.reshape(-1)[:n],
                        dequantize_int8_blocks_plain(q, s, n)),
              "A3's library call computes another function")
    q_bytes = sum(_int8_bytes(g.numel(), 4, 0, True) for g in grads)
    d_bytes = sum(_int8_bytes(g.numel(), 0, 4, False) for g in grads)
    total = sum(g.numel() for g in grads)
    cases = (
        ("quantize_deterministic",
         pass_of(quantize_int8_blocks),
         pass_of(quantize_int8_blocks_plain), None, q_bytes, 4 * total),
        ("quantize_stochastic",
         pass_of(lambda g: quantize_int8_blocks(g, stochastic=True,
                                                seed=seed)),
         pass_of(lambda g: quantize_int8_blocks_plain(g, stochastic=True,
                                                      seed=seed)),
         None, q_bytes, 5 * total),
        ("dequantize", deq_pass(dequantize_int8_blocks),
         deq_pass(dequantize_int8_blocks_plain), library_deq_pass,
         d_bytes, total),
    )
    # the passes are host-bound, and the host's speed drifts: the kernels'
    # passes and the library's are timed in 4 turns, forwards and
    # backwards, and each reports the median
    timed = [(name, fn) for name, fn, *_ in cases] + [
        ("library", library_deq_pass)]
    turns = {}
    for order in (timed, timed[::-1]) * 2:
        for key, fn in order:
            turns.setdefault(key, []).append(time_cuda(fn, reps))
    path = {}
    for name, fn, plain, library, nbytes, flops in cases:
        b_ms, b_by = _bound_ms(nbytes, flops)
        lib = turns["library"] if library else None
        path[name] = dict(
            tensors=len(grads), elements=total,
            ms=statistics.median(turns[name]), ms_turns=turns[name],
            plain_ms=time_cuda(plain, max(2, reps // 4)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=statistics.median(lib) if lib else None,
            library_ms_turns=lib)
        log(f"int8_path_pass {name} " + json.dumps(path[name]))

    # Timing 2: one buffer of every ResNet-50 gradient (25.56 M
    # elements), the bandwidth-bound case.
    big = {}
    for in_dt in (torch.float32, torch.bfloat16):
        x = torch.randn(big_n, generator=gen, device=device).to(in_dt)
        size = x.element_size()
        cases = [("quantize_deterministic",
                  lambda: quantize_int8_blocks(x),
                  lambda: quantize_int8_blocks_plain(x), None,
                  _int8_bytes(big_n, size, 0, True), 4 * big_n)]
        if in_dt == torch.float32:
            q, s, n = quantize_int8_blocks(x)
            cases += [
                ("quantize_stochastic",
                 lambda: quantize_int8_blocks(x, stochastic=True, seed=seed),
                 lambda: quantize_int8_blocks_plain(x, stochastic=True,
                                                    seed=seed), None,
                 _int8_bytes(big_n, 4, 0, True), 5 * big_n)]
            for out_dt in (torch.float32, torch.bfloat16):
                padded = torch.empty((s.shape[0], 1024), dtype=out_dt,
                                     device=device)
                torch.mul(q.view(-1, 1024), s, out=padded)
                check(same_bits(padded.reshape(-1)[:n],
                                dequantize_int8_blocks_plain(q, s, n, out_dt)),
                      f"A3's library call to {out_dt} computes another "
                      "function")
                cases.append((
                    f"dequantize_to_{str(out_dt)[6:]}",
                    lambda o=out_dt: dequantize_int8_blocks(q, s, n, o),
                    lambda o=out_dt: dequantize_int8_blocks_plain(q, s, n, o),
                    lambda p=padded: torch.mul(q.view(-1, 1024), s, out=p),
                    _int8_bytes(big_n, 0, padded.element_size(), False),
                    big_n))
        for name, fn, plain, library, nbytes, flops in cases:
            b_ms, b_by = _bound_ms(nbytes, flops)
            row = dict(n=big_n, input=str(in_dt)[6:], ms=time_cuda(fn, reps),
                       plain_ms=time_cuda(plain, max(2, reps // 4)),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=(time_cuda(library, reps) if library
                                   else None))
            big[f"{name}_{row['input']}"] = row
            log(f"int8_big_buffer {name} " + json.dumps(row))
        del x
    quantize_int8_blocks.launches, dequantize_int8_blocks.launches = before
    return dict(compared=compared, err=err, path_pass=path, big_buffer=big)


# -- phase 6: the int8 path at full width ----------------------------------

def int8_path_phase(model, x, y):
    """One backward of the training phase's ResNet-50 (bfloat16 compute,
    float32 parameters, so float32 gradients), its gradients and their
    packed buffer through the engine's int8 codecs,
    then the world-of-one allreduce and the quantized allreduce."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from horovod_tpu_torch.comm import eager, quantized
    from horovod_tpu_torch.comm.compression import Compression
    from horovod_tpu_torch.comm.packing import pack_flat
    from horovod_tpu_torch.ops import (
        dequantize_int8_blocks,
        dequantize_int8_blocks_plain,
        quantize_int8_blocks,
    )

    params = [p for p in model.parameters() if p.requires_grad]
    loss = F.cross_entropy(model(x), y)
    grads = list(torch.autograd.grad(loss, params))
    bucket, _ = pack_flat(grads)
    tensors = grads + [bucket]

    quantize_int8_blocks.launches = 0      # the int8 path's run starts here
    dequantize_int8_blocks.launches = 0
    runs, launches = {}, {}
    for mode, codec in (("deterministic", Compression.int8),
                        ("stochastic", Compression.int8_stochastic)):
        before = quantize_int8_blocks.launches
        runs[mode] = []
        for t in tensors:
            wire, ctx = codec.compress(t)
            runs[mode].append((wire, ctx, codec.decompress(wire, ctx)))
        launches[mode] = quantize_int8_blocks.launches - before
    torch.cuda.synchronize()
    a2, a3 = quantize_int8_blocks.launches, dequantize_int8_blocks.launches
    per_codec = len(tensors)
    check(launches == {"deterministic": per_codec, "stochastic": per_codec}
          and a3 == 2 * per_codec,
          f"int8 path: {launches} A2 and {a3} A3 launches, expected "
          f"{per_codec} of each a codec")

    worst = {"deterministic": 0.0, "stochastic": 0.0}
    for i, t in enumerate(tensors):
        x32 = t.float().reshape(-1)
        (dw, dctx, dback), (sw, sctx, sback) = (runs["deterministic"][i],
                                                runs["stochastic"][i])
        check(int((sw.int() - dw.int()).abs().max()) <= 1,
              f"tensor {i}: stochastic codes more than 1 from deterministic")
        for mode, wire, ctx, back, slack in (
                ("deterministic", dw, dctx, dback, 0.5),
                ("stochastic", sw, sctx, sback, 1.0)):
            _, shape, n, scale = ctx
            deq = dequantize_int8_blocks_plain(wire.reshape(-1, 128), scale,
                                               n)
            check(back.dtype == t.dtype and tuple(back.shape) == shape,
                  f"tensor {i} {mode}: dtype/shape")
            check(same_bits(back.reshape(-1), deq.to(t.dtype)),
                  f"tensor {i} {mode}: decompress is not the cast of q*s")
            per_elem = scale.reshape(-1).repeat_interleave(1024)[:n]
            # float32 rounding of x*inv and q*s adds < 3e-5 scale;
            # a flushed subnormal adds < FLT_MIN
            excess = ((deq - x32).abs()
                      - (per_elem * slack * (1 + 1e-4) + FLT_MIN))
            check(float(excess.max()) <= 0.0,
                  f"tensor {i} {mode}: error beyond {slack} scale")
            rel = ((deq - x32).abs() / per_elem.clamp_min(FLT_MIN)).max()
            worst[mode] = max(worst[mode], float(rel))
            if i == len(tensors) - 1:
                pos = per_elem > 0
                bias = float(((deq - x32)[pos] / per_elem[pos])
                             .double().mean())
                if mode == "stochastic":
                    check(abs(bias) <= UNBIASED_BOUND,
                          f"stochastic rounding biased: {bias}")
                    # deterministic rounding passes the checks above too;
                    # a dither moves an element off rint(t) with
                    # probability |t - rint(t)|, t = x / scale
                    t = x32[pos] / per_elem[pos]
                    expected = float((t - t.round()).abs().double().mean())
                    moved = float((sw.reshape(-1)[:n][pos]
                                   != dw.reshape(-1)[:n][pos])
                                  .double().mean())
                    check(expected > 10 * UNBIASED_BOUND
                          and abs(moved - expected) <= UNBIASED_BOUND,
                          f"stochastic codes differ from deterministic in "
                          f"{moved} of the elements, expected {expected}")
                    worst["dithered_share"] = [moved, expected]
                worst[f"bias_{mode}"] = bias
    check(worst["stochastic"] > 0.5 + 1e-3,
          f"stochastic error never exceeds 0.5 scale ({worst['stochastic']})")

    # world of one: no wire compression, one multiply by pre * post
    before = quantize_int8_blocks.launches
    got = eager.allreduce(bucket, compression=Compression.int8,
                          prescale_factor=0.5, postscale_factor=3.0)
    check(quantize_int8_blocks.launches == before,
          "allreduce at world size 1 compressed the wire")
    check(same_bits(got, bucket * torch.tensor(1.5, dtype=bucket.dtype,
                                               device=bucket.device)),
          "allreduce(compression=int8) at world size 1 is not bucket * 1.5")

    # the two-phase quantized allreduce over the one-rank NCCL group,
    # against the same call on the CPU over gloo
    cpu_group = dist.new_group(backend="gloo")
    try:
        for stochastic in (False, True):
            on_card = quantized.quantized_allreduce(bucket,
                                                    stochastic=stochastic)
            on_cpu = quantized.quantized_allreduce(
                bucket.cpu(), group=cpu_group, stochastic=stochastic)
            check(same_bits(on_card.cpu(), on_cpu),
                  f"quantized_allreduce(stochastic={stochastic}): card and "
                  "CPU differ")
    finally:
        dist.destroy_process_group(cpu_group)
    result = dict(tensors=len(grads), elements=bucket.numel(),
                  a2_launches=launches, a3_launches=a3,
                  worst_error_in_scales=worst)
    log("int8_path " + json.dumps(result))
    quantized_allreduce_timing(bucket, reps=5)
    return result


def quantized_allreduce_timing(bucket, reps: int):
    """The two-phase ``quantized_allreduce`` (plain torch ops, as the
    reference is XLA) on the packed bucket at one rank, and its two codec
    phases apart: ``_quantize`` of the bucket and ``_dequantize_sum`` of
    one rank's codes; beside A2 and A3 on the same buffer."""
    import torch

    from horovod_tpu_torch.comm import quantized
    from horovod_tpu_torch.ops import (
        dequantize_int8_blocks,
        quantize_int8_blocks,
    )

    before = (quantize_int8_blocks.launches, dequantize_int8_blocks.launches)
    n = bucket.numel()
    rows = bucket.reshape(1, n)
    q, s = quantized._quantize(rows)
    coded = quantize_int8_blocks(bucket)
    b_ms, b_by = _bound_ms(_int8_bytes(n, 4, 0, True)
                           + _int8_bytes(n, 0, 4, False), 5 * n)
    row = dict(
        elements=n, ranks=1,
        ms=time_cuda(lambda: quantized.quantized_allreduce(bucket), reps),
        stochastic_ms=time_cuda(lambda: quantized.quantized_allreduce(
            bucket, stochastic=True), reps),
        quantize_ms=time_cuda(lambda: quantized._quantize(rows), reps),
        dequantize_sum_ms=time_cuda(lambda: quantized._dequantize_sum(q, s),
                                    reps),
        a2_ms=time_cuda(lambda: quantize_int8_blocks(bucket), reps),
        a3_ms=time_cuda(lambda: dequantize_int8_blocks(*coded), reps),
        codec_bound_ms=b_ms, codec_bound_by=b_by)
    quantize_int8_blocks.launches, dequantize_int8_blocks.launches = before
    log("int8_quantized_allreduce " + json.dumps(row))


def surface_autograd_phase(hvd, device):
    """The torch surface's collectives on card tensors that require grad,
    in the one-rank world: the gradient of ``sum(y * w)`` is ``w``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    cases = [
        ("allreduce Sum", torch.float32, (1000,),
         lambda x: hvd.allreduce(x, op=hvd.Sum)),
        ("allreduce Average, fp16 codec", torch.bfloat16, (1000,),
         lambda x: hvd.allreduce(x, None, "g", hvd.Compression.fp16)),
        ("allgather", torch.float32, (33, 4), hvd.allgather),
    ]
    for what, dtype, shape, fn in cases:
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        w = torch.randn(shape, generator=gen, device=device).to(dtype)
        x.requires_grad_()
        y = fn(x)
        check(y.requires_grad and y.device == x.device
              and same_bits(y.detach(), x.detach()),
              f"surface {what}: forward")
        (y * w).sum().backward()
        check(x.grad is not None and same_bits(x.grad, w),
              f"surface {what}: gradient")
    log(f"surface_autograd: {len(cases)} collectives on {device} carry "
        "their gradient (world of one: x.grad == w)")


# -- phase 6b: the async controller ------------------------------------------

BERT_VOCAB, BERT_HIDDEN = 30522, 768     # BERT-Base, Uncased bert_config.json
SPARSE_BATCH, SPARSE_SEQ = 64, 128
ASYNC_REPS = 5


def hook_order_grads(model, opt, x, y):
    """The model's float32 gradients in the order its hooks fire in one
    backward, with their parameter names; the optimizer's own reduction
    of that backward is flushed and its gradients zeroed."""
    import torch
    import torch.nn.functional as F

    name_of = {p: n for n, p in model.named_parameters()}
    order = []
    handles = [p.register_post_accumulate_grad_hook(
        lambda p: order.append((name_of[p], p.grad.float().clone())))
        for p in model.parameters() if p.requires_grad]
    try:
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
    finally:
        for h in handles:
            h.remove()
    opt.synchronize()
    opt.zero_grad()
    torch.cuda.synchronize()
    return order


def _record_responses(ctrl):
    """Record the tensor names of every allreduce response the
    controller executes (a wrapper on the instance, not on the class)."""
    groups = []
    orig = ctrl._execute_allreduce

    def recorded(rs, payloads):
        groups.append(list(rs.tensor_names))
        return orig(rs, payloads)

    ctrl._execute_allreduce = recorded
    return groups


def _time_controller(ctrl):
    """Host seconds the controller spends negotiating (its core's drain,
    the transport's exchange, the core's apply; idle cycles included)
    and executing (the inputs' stream waits and each response's work,
    both done before its futures resolve), summed into the returned dict
    (wrappers on the instances)."""
    spent = {"negotiate": 0.0, "execute": 0.0}

    def timed(obj, attr, key):
        orig = getattr(obj, attr)

        def run(*args):
            t0 = time.perf_counter()
            try:
                return orig(*args)
            finally:
                spent[key] += time.perf_counter() - t0
        setattr(obj, attr, run)

    timed(ctrl._ctrl, "drain_requests", "negotiate")
    timed(ctrl._transport, "exchange", "negotiate")
    timed(ctrl._ctrl, "apply_responses", "negotiate")
    timed(ctrl, "_await_inputs", "execute")
    timed(ctrl, "_execute_one", "execute")
    return spent


def _plain_group(tensors, codec, pre: float, post: float):
    """The plain composition of one agreed group at one rank: a group of
    several tensors is prescale, compress and pack, the (identity) wire,
    unpack, decompress and postscale; a group of one is
    ``comm/eager.allreduce``'s rule, one multiply by ``pre * post``."""
    import torch

    from horovod_tpu_torch.ops import (
        scale_cast_pack_plain,
        unpack_cast_scale_plain,
    )

    if len(tensors) == 1:
        t = tensors[0]
        return [t * torch.tensor(pre * post, dtype=t.dtype, device=t.device)]
    flat, specs = scale_cast_pack_plain(tensors, pre, codec)
    return unpack_cast_scale_plain(flat, specs, [t.dtype for t in tensors],
                                   post)


ZC_LEARN = 3       # untimed bursts that learn the pack plan
# the timed bursts, zero-copy on (True) and off in turns
ZC_ORDER = (True, False, False, True, True, False, False, True, True, False)
ZC_WHY_LOCKSTEP = ("a world of one takes the lockstep plane: the streamed "
                   "plane and prediction start only past one rank, and "
                   "NCCL refuses two ranks of one communicator on one "
                   "device")


def _set_zero_copy(ctrl, on: bool, saved: dict) -> None:
    """Turn the controller's zero-copy route on or off between bursts:
    off sets the learned pack plan aside (and stops learning), on puts
    it back, so an on burst needs no new learning."""
    with ctrl._lock:
        if on and "plan" in saved:
            ctrl._pack_plan, specs = saved.pop("plan")
            ctrl._pack_group_specs.update(specs)
        elif not on and ctrl._pack_plan is not None:
            saved["plan"] = (ctrl._pack_plan, dict(ctrl._pack_group_specs))
            ctrl._release_open_packs()
            ctrl._pack_plan = None
            ctrl._pack_group_specs.clear()
        ctrl._zero_copy_on = on


def zero_copy_phase(hvd, ctrl, by_name, groups, spent, staged):
    """The controller's zero-copy route on the optimizer's default
    traffic: the 161 gradients as ``allreduce_async_`` (Average, no
    codec, scales 1) under names of their own, their values changed from
    burst to burst (an exchange buffer reused while a collective or an
    unpack still reads it would show).  ``ZC_LEARN`` untimed bursts learn
    the pack plan, then ``ZC_ORDER``'s timed bursts run with the route on
    and off in turns.  In every burst each result is bitwise the staged
    route's (``staged``, the controller's ``GroupReduction``, on the
    burst's inputs) and lands in the caller's tensor; with the route on
    every op of a fused group is a zero-copy op (all 161 at full width,
    two groups) and each fused group one A1 launch (its unpack), with it
    off they are staged copies and two launches a group."""
    import torch

    from horovod_tpu_torch.ops import fused_scale_cast

    names = {f"zc.{n}": g for n, g in by_name.items()}
    saved = {}

    def burst(k: int):
        inputs = {n: g * (1.0 + 0.125 * k) for n, g in names.items()}
        tensors = {n: t.clone() for n, t in inputs.items()}
        torch.cuda.synchronize()
        spent.update(negotiate=0.0, execute=0.0)
        zc0, st0 = ctrl.zero_copy_ops, ctrl.staged_copies
        pr0, cy0 = ctrl.predicted_bursts, ctrl._cycle
        groups.clear()
        fused_scale_cast.launches = 0       # the burst starts here
        t0 = time.perf_counter()
        ctrl.hint_burst(len(tensors))
        handles = {n: hvd.allreduce_async_(t, name=n)
                   for n, t in tensors.items()}
        t_enq = time.perf_counter()
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = fused_scale_cast.launches   # read just after it
        agreed = list(groups)
        check(sorted(n for g in agreed for n in g) == sorted(names),
              f"zero-copy burst {k}: the responses do not cover it")
        for g in agreed:
            for n, w in zip(g, staged.reduce([inputs[n] for n in g])):
                check(outs[n] is tensors[n] and same_bits(outs[n], w),
                      f"zero-copy burst {k}: {n} is not the staged "
                      "route's result, in the caller's tensor")
        return {"ms": (t1 - t0) * 1e3, "enqueue_ms": (t_enq - t0) * 1e3,
                "negotiate_ms": spent["negotiate"] * 1e3,
                "execute_ms": spent["execute"] * 1e3,
                "zero_copy_ops": ctrl.zero_copy_ops - zc0,
                "staged_copies": ctrl.staged_copies - st0,
                "predicted": ctrl.predicted_bursts - pr0,
                "cycles": ctrl._cycle - cy0,
                "group_sizes": [len(g) for g in agreed],
                "a1_launches": launches}

    def fused(r):
        # ops in fused groups (a group of one tensor takes neither route)
        return sum(n for n in r["group_sizes"] if n > 1)

    learn = [burst(k) for k in range(ZC_LEARN)]
    check(learn[-1]["zero_copy_ops"] == fused(learn[-1]) > 0,
          f"zero-copy: no plan learned in {ZC_LEARN} bursts ({learn})")
    timed = {True: [], False: []}
    for k, on in enumerate(ZC_ORDER, start=ZC_LEARN):
        _set_zero_copy(ctrl, on, saved)
        r = burst(k)
        multi = sum(n > 1 for n in r["group_sizes"])
        check(r["zero_copy_ops"] == (fused(r) if on else 0)
              and r["staged_copies"] == (0 if on else fused(r))
              and r["a1_launches"] == (1 if on else 2) * multi,
              f"zero-copy {'on' if on else 'off'}, burst {k}: {r}")
        timed[on].append(r)
    _set_zero_copy(ctrl, True, saved)

    # what the route adds to the enqueue, apart: the 161 copy_ calls
    # alone into one exchange buffer's slots, and ExchangeBuffer.write
    # (host clock, 5 turns each)
    from horovod_tpu_torch.comm.packing import ExchangeBuffer

    grads = list(names.values())
    xb = ExchangeBuffer([(tuple(g.shape), g.dtype,
                          g.numel() * g.element_size()) for g in grads],
                        grads[0].device)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        xb.reset()
        return (t1 - t0) * 1e3

    def copies():
        for v, g in zip(xb.views(), grads):
            v.copy_(g)

    def writes():
        for i, g in enumerate(grads):
            xb.write(i, g)

    copy_ms = [host_ms(copies) for _ in range(5)]
    write_ms = [host_ms(writes) for _ in range(5)]
    state = ctrl.debug_state()
    predicted = sum(r["predicted"] for r in learn + timed[True]
                    + timed[False])
    check(state["plane"] == "lockstep" and predicted == 0,
          "zero-copy: a world of one on another plane or predicting")
    return {
        "grads": len(names), "learn": learn,
        "timed_on": timed[True], "timed_off": timed[False],
        "median_ms_on": statistics.median(r["ms"] for r in timed[True]),
        "median_ms_off": statistics.median(r["ms"] for r in timed[False]),
        "a1_launches_on": timed[True][0]["a1_launches"],
        "a1_launches_off": timed[False][0]["a1_launches"],
        "copy_ms": copy_ms, "write_ms": write_ms,
        "plane": state["plane"], "predicted": predicted,
        "why": ZC_WHY_LOCKSTEP, "fusion_pool": state["fusion_pool"]}


def async_phase(hvd, device, model, opt, x, y, smi: str):
    """The async plane at full width in the one-rank NCCL world: the
    optimizer's 161 ResNet-50 gradients (float32) as a burst of
    ``allreduce_async_`` calls in hook order and as one
    ``grouped_allreduce_async``, under fp16 and none with the predivide
    scales; a process set {0}; the BERT-base word embedding's sparse
    gradient; the other async ops once each."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.compression import Compression as Engine
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.ops import fused_scale_cast

    model_names = {p: n for n, p in model.named_parameters()}
    grads = hook_order_grads(model, opt, x, y)
    check(len(grads) == RESNET50_GRADS, "async: hook order")
    n_elems = sum(g.numel() for _, g in grads)
    pre, post = 1.0 / PREDIVIDE, PREDIVIDE / hvd.size()
    ctrl = get_controller()
    groups = _record_responses(ctrl)
    spent = _time_controller(ctrl)
    by_name = {f"allreduce.{n}": g for n, g in grads}
    result = {"card": smi, "grads": len(grads), "elements": n_elems}

    def burst(codec, grouped: bool):
        """One pass of the traffic; returns {name: result} and its host
        ms: from the first enqueue to the last synchronize, to the last
        enqueue, and the controller's negotiation and execution; with
        the controller cycles and the allreduce responses of the pass."""
        tensors = {n: g.clone() for n, g in by_name.items()}
        torch.cuda.synchronize()
        spent.update(negotiate=0.0, execute=0.0)
        cycles0, groups0 = ctrl._cycle, len(groups)
        t0 = time.perf_counter()
        if grouped:
            names = list(tensors)
            handles = dict(zip(names, hvd.grouped_allreduce_async(
                [tensors[n] for n in names], names=names, op=hvd.Sum,
                compression=codec, prescale_factor=pre,
                postscale_factor=post)))
        else:
            # the reference optimizer's hint and per-hook calls
            ctrl.hint_burst(len(tensors))
            handles = {n: hvd.allreduce_async_(
                t, name=n, op=hvd.Sum, compression=codec,
                prescale_factor=pre, postscale_factor=post)
                for n, t in tensors.items()}
        t_enq = time.perf_counter()
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        return outs, {"ms": (t1 - t0) * 1e3, "enqueue_ms": (t_enq - t0) * 1e3,
                      "negotiate_ms": spent["negotiate"] * 1e3,
                      "execute_ms": spent["execute"] * 1e3,
                      "cycles": ctrl._cycle - cycles0,
                      "groups": len(groups) - groups0}

    surface = {"fp16": hvd.Compression.fp16, "none": hvd.Compression.none}
    engine = {"fp16": Engine.fp16, "none": Engine.none}
    none_red = dataclasses.replace(opt.reduction, compression=Engine.none)
    runs = {}
    for codec in ("fp16", "none"):
        for grouped in (False, True):
            key = f"{codec}_{'grouped' if grouped else 'burst'}"
            groups.clear()
            fused_scale_cast.launches = 0     # the async path starts here
            outs, first_ms = burst(surface[codec], grouped)
            launches = fused_scale_cast.launches   # read just after it
            first = list(groups)
            check(sorted(n for g in first for n in g) == sorted(by_name),
                  f"async {key}: the responses do not cover the burst")
            multi = sum(len(g) > 1 for g in first)
            check(launches == 2 * multi,
                  f"async {key}: {launches} A1 launches for {multi} fused "
                  "groups of several tensors (want two a group)")
            n = 0
            for g in first:
                want = _plain_group([by_name[t] for t in g], engine[codec],
                                    pre, post)
                for t, w in zip(g, want):
                    check(same_bits(outs[t], w), f"async {key}: {t} is not "
                          "the plain composition of its group")
                    n += 1
            if codec == "none":
                # the optimizer's GroupReduction over its bucket plan
                for bucket in opt.buckets:
                    bn = [f"allreduce.{model_names[p]}" for p in bucket]
                    got = none_red.reduce([by_name[t] for t in bn])
                    for t, w in zip(bn, got):
                        check(same_bits(outs[t], w), f"async {key}: {t} "
                              "is not GroupReduction's result")
            timed = [burst(surface[codec], grouped)[1]
                     for _ in range(ASYNC_REPS)]
            runs[key] = {
                **first_ms, "timed": timed,
                "median_ms": statistics.median(t["ms"] for t in timed),
                "median_cycles": statistics.median(t["cycles"]
                                                   for t in timed),
                "fused_groups": len(first), "multi_tensor_groups": multi,
                "group_sizes": [len(g) for g in first],
                "a1_launches": launches, "checked": n}
    result["runs"] = runs
    result["a1_launches"] = runs["fp16_burst"]["a1_launches"]
    result["zero_copy"] = zero_copy_phase(
        hvd, ctrl, by_name, groups, spent,
        dataclasses.replace(none_red, op=hvd.Average, prescale=1.0,
                            postscale=1.0))

    # GroupReduction.reduce over the same gradients, its bucket plan,
    # in the same call (host clock, synchronized)
    bucket_grads = [[by_name[f"allreduce.{model_names[p]}"] for p in b]
                    for b in opt.buckets]
    saved = fused_scale_cast.launches

    def group_reduce_ms(red):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bucket_grads:
            red.reduce(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for red, key in ((opt.reduction, "fp16"), (none_red, "none")):
        group_reduce_ms(red)
        times = [group_reduce_ms(red) for _ in range(ASYNC_REPS)]
        result[f"group_reduce_{key}_ms"] = times
        result[f"group_reduce_{key}_median_ms"] = statistics.median(times)
    fused_scale_cast.launches = saved

    # a process set {0}: its own groups; its allreduce is the global one's
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    t = torch.randn(4097, generator=gen, device=device)
    ps = hvd.add_process_set([0])
    psid = ps.process_set_id
    got = hvd.synchronize(hvd.allreduce_async(t, op=hvd.Sum, name="ps0",
                                              process_set=ps))
    want = hvd.synchronize(hvd.allreduce_async(t, op=hvd.Sum, name="glob"))
    check(same_bits(got, want), "async: process set {0} differs from the "
          "global set")
    hvd.barrier(process_set=ps)       # the set's own NCCL group
    check(hvd.remove_process_set(ps) and not hvd.remove_process_set(ps),
          "async: remove_process_set")
    result["process_set"] = {"id": psid, "bitwise": True}

    # the BERT-base word embedding's sparse gradient
    egen = torch.Generator().manual_seed(SEED + 7)
    emb = torch.nn.Embedding(BERT_VOCAB, BERT_HIDDEN, sparse=True,
                             device=device)
    with torch.no_grad():
        emb.weight.copy_(torch.randn(BERT_VOCAB, BERT_HIDDEN,
                                     generator=egen).to(device))
    ids = torch.randint(0, BERT_VOCAB, (SPARSE_BATCH, SPARSE_SEQ),
                        generator=egen).to(device)
    v = torch.randn(SPARSE_BATCH, SPARSE_SEQ, BERT_HIDDEN,
                    generator=egen).to(device)
    (emb(ids) * v).sum().backward()
    g = emb.weight.grad
    check(g.is_sparse, "async: the embedding's gradient is not sparse")
    out = hvd.synchronize(hvd.sparse_allreduce_async(g, name="emb",
                                                     op=hvd.Sum))
    want = g.coalesce()
    check(out.is_coalesced() and torch.equal(out.indices(), want.indices())
          and same_bits(out.values(), want.values()),
          "async: sparse_allreduce_async is not the coalesced gradient")
    # sparse_as_dense: the optimizer's step is the dense route's
    w0 = emb.weight.detach().clone()
    sparse_opt = hvd.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=0.1),
        named_parameters=emb.named_parameters(), sparse_as_dense=True)
    dense_w = torch.nn.Parameter(w0.clone())
    dense_opt = hvd.DistributedOptimizer(
        torch.optim.SGD([dense_w], lr=0.1),
        named_parameters=[("weight", dense_w)])
    sparse_opt.zero_grad()
    (emb(ids) * v).sum().backward()
    check(not emb.weight.grad.is_sparse, "async: sparse_as_dense left the "
          "gradient sparse")
    dense_w.grad = emb.weight.grad.clone()
    sparse_opt.step()
    dense_opt.step()
    check(same_bits(emb.weight.detach(), dense_w.detach())
          and not torch.equal(emb.weight.detach(), w0),
          "async: sparse_as_dense differs from the dense route")
    result["sparse"] = {"vocab": BERT_VOCAB, "hidden": BERT_HIDDEN,
                        "ids": SPARSE_BATCH * SPARSE_SEQ,
                        "nnz_coalesced": int(out.values().shape[0])}
    del emb, v, sparse_opt, dense_opt, dense_w

    # the other async ops once each, against the sync ops
    a = torch.randn(64, 33, generator=gen, device=device)
    h = hvd.allgather_async(a, name="ag")
    polled_before = hvd.poll(h)
    check(same_bits(hvd.synchronize(h), hvd.allgather(a)), "allgather_async")
    check(hvd.poll(h), "poll after synchronize")
    check(same_bits(hvd.synchronize(hvd.broadcast_async(a, 0, "bc")),
                    hvd.broadcast(a, 0)), "broadcast_async")
    check(same_bits(hvd.synchronize(hvd.alltoall_async(a, name="a2a")),
                    hvd.alltoall(a)), "alltoall_async")
    check(same_bits(hvd.synchronize(hvd.reducescatter_async(
        a, hvd.Sum, "rs")), hvd.reducescatter(a, hvd.Sum)),
        "reducescatter_async")
    check(hvd.join() == 0, "join")
    result["others"] = {"polled_before": bool(polled_before), "join": 0}
    log("async_path " + json.dumps(result))
    return result


# -- Adasum -------------------------------------------------------------------

# pairwise_adasum in float32 against float64, per segment: |got - ref| at
# most ADASUM_RTOL times the segment's largest |ref|.  The coefficients'
# dot products sum up to 2.36 M float32 products in cuBLAS's order (an
# error of some log2(n) float32 roundings of sum |a_i b_i|), and each
# output rounds once more.
ADASUM_RTOL = 1e-4


def adasum_phase(hvd, device, model, x, y):
    """Adasum on the card: ``pairwise_adasum`` over two backward passes'
    161 ResNet-50 gradients (phase 3's batch and a second one, float32,
    a segment a tensor) against the float64 reference on the CPU, with
    its time; then a full-width ResNet-50 step with ``op=Adasum`` at a
    world of one, bitwise the ``op=Sum`` step on the same gradients (at
    one rank Adasum returns the tensor itself)."""
    import itertools

    import numpy as np
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.adasum import (
        adasum_reduce_reference,
        pairwise_adasum,
    )
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ops import fused_scale_cast

    params = [p for p in model.parameters() if p.requires_grad]
    dgen = torch.Generator(device=device).manual_seed(SEED + 8)
    x2 = torch.randn(x.shape, generator=dgen, device=device)
    y2 = y.flip(0)
    a, b = (torch.cat([g.float().reshape(-1) for g in torch.autograd.grad(
        F.cross_entropy(model(xb), yb), params)]) for xb, yb in
        ((x, y), (x2, y2)))
    sizes = [p.numel() for p in params]
    segs = list(zip(itertools.accumulate([0] + sizes[:-1]), sizes))
    got = pairwise_adasum(a, b, segs)
    ms = time_cuda(lambda: pairwise_adasum(a, b, segs), reps=5)
    a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
    out = got.double().cpu().numpy()
    worst = 0.0
    for off, n in segs:
        ref = adasum_reduce_reference([a64[off:off + n], b64[off:off + n]])
        err = float(np.abs(out[off:off + n] - ref).max())
        top = float(np.abs(ref).max())
        worst = max(worst, err / top if top > 0
                    else (0.0 if err == 0 else math.inf))
    check(got.dtype == torch.float32 and torch.isfinite(got).all()
          and worst <= ADASUM_RTOL,
          f"adasum: pairwise_adasum off the float64 reference ({worst})")

    # one step with op=Adasum and one with op=Sum from the same weights
    # on the same gradients: bitwise the same weights and momenta
    models = [ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                     generator=torch.Generator().manual_seed(SEED))
              for _ in range(2)]
    opts = [hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
        named_parameters=m.named_parameters(), op=op)
        for m, op in zip(models, (hvd.Sum, hvd.Adasum))]
    saved = fused_scale_cast.launches
    w0 = [p.detach().clone() for p in models[0].parameters()]
    F.cross_entropy(models[0](x), y).backward()
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        q.grad = p.grad.detach().clone()
    for opt in opts:
        opt.step()
    torch.cuda.synchronize()
    fused_scale_cast.launches = saved
    moved = 0
    for (name, p), q, w in zip(models[0].named_parameters(),
                               models[1].parameters(), w0):
        check(same_bits(p, q) and same_bits(
            opts[0].state[p]["momentum_buffer"],
            opts[1].state[q]["momentum_buffer"]),
            f"adasum: the op=Adasum step differs from op=Sum at {name}")
        moved += not torch.equal(p, w)
    check(moved > 0, "adasum: the step moved no weight")
    n = a.numel()
    result = {"elements": n, "segments": len(segs), "ms": ms,
              # a and b read once, the result written once; 3 dot
              # products and the combination, 10 operations an element
              "bound_ms": _bound_ms(3 * 4 * n, 10 * n)[0],
              "max_rel_err": worst, "rtol": ADASUM_RTOL,
              "step_bitwise_sum": True, "params_moved": moved}
    log("adasum " + json.dumps(result))
    del models, opts
    return result


# -- the stall watchdog and fault injection on the card -----------------------

STALL_HB_S, STALL_WARN_S, STALL_ABORT_S = 0.05, 0.3, 1.0
# a peer whose beats stop is stale after 10 heartbeats, so the dead-peer
# run's abort comes at the abort time, within the card's sleep
STALL_STALE_S = 0.5
STALL_OPS = 20
STALL_SLEEP_S = 3.0


def _store_features():
    """Which stores of this torch have ``list_keys``, and whether a
    ``FileStore`` deletes: what ``KVTransport``'s docstring states."""
    import datetime
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="hvt_smoke_store_")
    tcp = dist.TCPStore("127.0.0.1", 0, 1, True,
                        timeout=datetime.timedelta(seconds=30))
    stores = {"HashStore": dist.HashStore(), "TCPStore": tcp,
              "FileStore": dist.FileStore(f"{tmp}/f", 1)}
    stores["PrefixStore"] = dist.PrefixStore("p", stores["HashStore"])
    features = {}
    for name, store in stores.items():
        store.set("probe", "1")
        try:
            keys = store.list_keys()
            features[f"{name}.list_keys"] = "probe" in keys
        except Exception as e:  # noqa: BLE001 — a feature probe
            features[f"{name}.list_keys"] = f"{type(e).__name__}: {e}"[:120]
        try:
            features[f"{name}.delete_key"] = bool(
                store.delete_key("probe")) and not store.check(["probe"])
        except Exception as e:  # noqa: BLE001 — a feature probe
            features[f"{name}.delete_key"] = f"{type(e).__name__}: {e}"[:120]
    del tcp
    return features


def _dead_peer_postmortem(tmp: Path, desc: str) -> dict:
    """The postmortem the dead-peer abort wrote (the inspector's
    heartbeat thread writes it as it latches the failure): its reason and
    the abort event naming ``desc``."""
    path = tmp / "postmortem-0-0.json"
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if path.exists():
            with open(path) as f:
                doc = json.load(f)
            events = [e for e in doc["events"] if e["kind"] == "stall_abort"
                      and desc in e.get("detail", "")]
            if events:
                return {"file": path.name, "reason": doc["reason"],
                        "reasons": doc["reasons"],
                        "event": events[-1]["detail"][:200]}
        time.sleep(0.05)
    raise SmokeFailure(f"stall: no postmortem naming {desc!r} in {tmp}")


def _sleep_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy ``seconds``,
    from a short calibration run."""
    import torch

    cycles = 50_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return int(cycles * seconds * 1e3 / start.elapsed_time(end))


def stall_phase(hvd, device, model, opt, x, y, smi: str, tmp: Path):
    """The watchdog on the card, two of the port's inspectors over one
    ``HashStore`` (ranks 0 and 1 of a set {0, 1}; neither installed, so
    no poison latch): rank 0 runs the optimizer's ``GroupReduction``
    over phase 3's 161 gradients (A1's grouped passes and the one-rank
    NCCL allreduce) through ``dispatch`` / ``wait_ready``.  Healthy: 20
    ops, rank 1 mirroring each descriptor; diverged: rank 1 posts
    another descriptor; dead peer mid-op: the card sleeps before the
    reduction and rank 1 stops beating; the flight recorder (installed by
    ``init()``, into ``tmp``) then holds a postmortem naming the op, and
    the abort family counted it."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.core.exceptions import HorovodInternalError
    from horovod_tpu_torch.core.kv import StoreKV
    from horovod_tpu_torch.core.retry import fenced_kv
    from horovod_tpu_torch.ops import fused_scale_cast

    params = [p for p in model.parameters() if p.requires_grad]
    grads = {p: g.contiguous() for p, g in zip(params, torch.autograd.grad(
        F.cross_entropy(model(x), y), params))}
    buckets = [[grads[p] for p in b] for b in opt.buckets]
    multi = sum(len(b) > 1 for b in buckets)
    red = opt.reduction
    want = [o for b in buckets for o in red.reduce(b)]     # unguarded
    outs = [[torch.empty_like(g) for g in b] for b in buckets]

    def launch(pre_sleep: int = 0, events=None):
        """The reduction of every bucket into ``outs``, then a timing
        event behind it: the event is what rank 0 waits on."""
        def run():
            if pre_sleep:
                torch.cuda._sleep(pre_sleep)
            for b, o in zip(buckets, outs):
                red.finish(red.launch(b), o)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            if events is not None:
                events.append(done)
            return done
        return run

    def got():
        return [o for b in outs for o in b]

    store = dist.HashStore()

    def pair(generation: int):
        return [stall.AmortizedStallInspector(
            fenced_kv(StoreKV(store, 2), rank=r), r, warn_s=STALL_WARN_S,
            abort_s=STALL_ABORT_S, heartbeat_s=STALL_HB_S,
            generation=generation, stale_s=STALL_STALE_S) for r in (0, 1)]

    members = [0, 1]
    result = {"card": smi, "heartbeat_s": STALL_HB_S, "warn_s": STALL_WARN_S,
              "abort_s": STALL_ABORT_S, "stale_s": STALL_STALE_S,
              "grads": len(params), "buckets": len(buckets),
              "multi_tensor_buckets": multi,
              "mode": core_state.global_state().config.stall_check_mode}

    # 1. healthy: 20 ops, rank 1 mirroring each descriptor
    r0, r1 = pair(1)
    warnings0 = stall.counters()["stall_warnings"]
    pre_us, overshoot_us, wait_us, done_to_return_us = [], [], [], []
    try:
        fused_scale_cast.launches = 0   # the guarded reduction starts here
        for i in range(STALL_OPS):
            desc = f"bucket_reduce:{i}:{len(buckets)}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r0.pre_op(0, members, desc)
            pre_us.append((time.perf_counter() - t0) * 1e6)
            r1.pre_op(0, members, desc)
            r1.wait_ready(0, None, desc)
            start = torch.cuda.Event(enable_timing=True)
            t_start = time.perf_counter()
            start.record()
            done, _pending = r0.dispatch(0, launch(), (), desc)
            t_w0 = time.perf_counter()
            r0.wait_ready(0, done, desc)
            t_w1 = time.perf_counter()
            check(done.query(), "stall: wait_ready returned before the "
                  "event completed")
            # the event completed at about t_start + its device time:
            # wait_ready's overshoot past that (or past its own call, when
            # the event was done before), and dispatch's handoff with it
            t_done = t_start + start.elapsed_time(done) / 1e3
            overshoot_us.append((t_w1 - max(t_w0, t_done)) * 1e6)
            done_to_return_us.append((t_w1 - t_done) * 1e6)
            wait_us.append((t_w1 - t_w0) * 1e6)
            check(all(same_bits(g, w) for g, w in zip(got(), want)),
                  f"stall: guarded op {i} is not the unguarded reduction")
        stall_launches = fused_scale_cast.launches   # read just after it
        check(stall_launches == 2 * multi * STALL_OPS,
              f"stall: {stall_launches} A1 launches in {STALL_OPS} guarded "
              f"reductions (want {2 * multi} an op)")
        time.sleep(3 * STALL_HB_S)
        check(r0.failure is None and r1.failure is None
              and stall.counters()["stall_warnings"] == warnings0,
              f"stall: the healthy run warned or failed ({r0.failure})")
    finally:
        r0.stop()
        r1.stop()
    result.update(
        ops=STALL_OPS, stall_launches=stall_launches,
        pre_op_us=pre_us, pre_op_median_us=statistics.median(pre_us),
        wait_ready_us=wait_us,
        wait_overshoot_us=overshoot_us,
        wait_overshoot_median_us=statistics.median(overshoot_us),
        done_to_return_us=done_to_return_us,
        done_to_return_median_us=statistics.median(done_to_return_us),
        healthy_bitwise=True, healthy_warnings=0)

    # 2. diverged: rank 1 posts another descriptor at the same seq
    r0, r1 = pair(2)
    try:
        mine, theirs = "bucket_reduce:grads", "broadcast:weights"
        t0 = time.perf_counter()
        r0.pre_op(0, members, mine)
        r1.pre_op(0, members, theirs)
        done, _pending = r0.dispatch(0, launch(), (), mine)
        try:
            r0.wait_ready(0, done, mine)
        except HorovodInternalError:
            pass            # the latch may already have landed
        while r0.failure is None and time.perf_counter() - t0 < 10.0:
            time.sleep(0.001)
        detect_s = time.perf_counter() - t0
        try:
            r0.pre_op(0, members, "next")
            raise SmokeFailure("stall: the diverged op was not diagnosed")
        except HorovodInternalError as e:
            msg = str(e)
        check("diverged" in msg and mine in msg and theirs in msg,
              f"stall: the divergence diagnosis does not name both ops: "
              f"{msg}")
    finally:
        r0.stop()
        r1.stop()
    result.update(diverged_detect_s=detect_s, diverged_message=msg[:240])

    # 3. dead peer mid-op: both ranks enter the op, rank 1's beats stop,
    # rank 0's card sleeps STALL_SLEEP_S before the reduction
    cycles = _sleep_cycles(STALL_SLEEP_S)
    r0, r1 = pair(3)
    try:
        desc = "bucket_reduce:dead_peer"
        r0.pre_op(0, members, desc)
        r1.pre_op(0, members, desc)
        time.sleep(2 * STALL_HB_S)     # both post caught-up beats
        r1._stopped.set()              # then rank 1 dies: no tombstone
        torch.cuda.synchronize()
        events = []
        raised_in = "dispatch"
        aborts = stall.counters()["stall_aborts"]
        t0 = time.perf_counter()
        try:
            done, _pending = r0.dispatch(0, launch(cycles, events), (), desc)
            raised_in = "wait_ready"
            r0.wait_ready(0, done, desc)
            raise SmokeFailure("stall: the dead peer was not diagnosed")
        except HorovodInternalError as e:
            raised_s = time.perf_counter() - t0
            # the launch may still be on the executor thread when the
            # abort comes from dispatch: no event recorded yet
            event_done = bool(events) and events[0].query()
            msg = str(e)
        check(not event_done, "stall: the abort came after the card's event "
              "completed")
        check("stalled collective" in msg and "[1]" in msg,
              f"stall: the abort does not name rank 1: {msg}")
        check(not stall.poisoned(), "stall: a standalone inspector latched "
              "the process-wide poison")
        postmortem = _dead_peer_postmortem(tmp, desc)
        check(stall.counters()["stall_aborts"] > aborts,
              "stall: the abort family did not count the dead peer")
        torch.cuda.synchronize()
        after_sleep_s = time.perf_counter() - t0
        for b, o in zip(buckets, outs):
            red.finish(red.launch(b), o)
        torch.cuda.synchronize()
        check(all(same_bits(g, w) for g, w in zip(got(), want)),
              "stall: the reduction after the abort is not the healthy one")
    finally:
        r0.stop()
        r1.stop()
    fused_scale_cast.launches = 0
    result.update(dead_peer_abort_s=raised_s, dead_peer_event_done=event_done,
                  dead_peer_raised_in=raised_in,
                  dead_peer_sleep_s=after_sleep_s,
                  dead_peer_message=msg[:240], after_abort_bitwise=True,
                  dead_peer_postmortem=postmortem)

    # the features the store adapter and the teardown rely on
    result["store"] = _store_features()
    group = dist.new_group([0])
    probe = torch.ones(8, device=device)
    dist.all_reduce(probe, group=group)
    torch.cuda.synchronize()
    core_state.abort_group(group)
    result["abort_group"] = "torch.distributed.distributed_c10d." \
        "_abort_process_group"
    result["counters"] = stall.counters()
    log("stall " + json.dumps(result))
    return result


FAULT_MODES = ("nan", "bitflip")


def faults_phase(hvd, device, model, opt, x, y, smi: str):
    """Fault injection on device tensors: phase 6b's async burst (the 161
    gradients as ``allreduce_async_`` with the optimizer's arguments:
    Sum, prescale 1/2, postscale 2/1, fp16) clean, then under
    ``collective.pre:corrupt(nan)@count=K,times=1`` and
    ``corrupt(bitflip)``: one result differs from the clean burst, it
    and its group are bitwise the plain composition over the poisoned
    input, 2 A1 launches a fused group, and the poisoning made no host
    round trip (it runs under CUDA's sync-debug mode "error")."""
    import torch

    from horovod_tpu_torch.comm.compression import Compression as Engine
    from horovod_tpu_torch.core import faults
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.ops import fused_scale_cast

    grads = hook_order_grads(model, opt, x, y)
    by_name = {f"allreduce.{n}": g for n, g in grads}
    order = list(by_name)
    pre, post = 1.0 / PREDIVIDE, PREDIVIDE / hvd.size()
    ctrl = get_controller()
    groups = _record_responses(ctrl)

    def burst():
        groups.clear()
        tensors = {n: g.clone() for n, g in by_name.items()}
        torch.cuda.synchronize()
        fused_scale_cast.launches = 0
        ctrl.hint_burst(len(tensors))
        handles = {n: hvd.allreduce_async_(
            t, name=n, op=hvd.Sum, compression=hvd.Compression.fp16,
            prescale_factor=pre, postscale_factor=post)
            for n, t in tensors.items()}
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        return outs, [list(g) for g in groups], fused_scale_cast.launches

    clean, clean_groups, _ = burst()
    # K: the middle gradient of the largest fused group (1-based: the
    # Kth enqueue of the burst fires the clause)
    biggest = max(clean_groups, key=len)
    target = biggest[len(biggest) // 2]
    k = order.index(target) + 1

    seen = []
    orig_poison = faults._poison

    def watched(tensor, mode):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig_poison(tensor, mode)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        seen.append((tensor.device.type, out.device.type, out.clone()))
        return out

    result = {"card": smi, "grads": len(order), "k": k, "target": target,
              "target_group_size": len(biggest), "runs": {}}
    faults._poison = watched
    try:
        for mode in FAULT_MODES:
            seen.clear()
            faults.install(f"collective.pre:corrupt({mode})@count={k},"
                           "times=1", rank=hvd.rank())
            try:
                outs, fgroups, launches = burst()
            finally:
                faults.uninstall()
            check(len(seen) == 1
                  and seen[0][:2] == (device.type, device.type),
                  f"faults {mode}: the poison did not run once on the card "
                  f"({[s[:2] for s in seen]})")
            poisoned = seen[0][2]
            # the controller fuses by arrival, so a burst's groups may
            # differ from the clean burst's: each burst is held against
            # the plain composition of its own groups, over the poisoned
            # input and over the clean one
            want_poisoned, want_clean = {}, {}
            for g in fgroups:
                clean_in = [by_name[t] for t in g]
                poisoned_in = [poisoned if t == target else by_name[t]
                               for t in g]
                want_clean.update(zip(g, _plain_group(
                    clean_in, Engine.fp16, pre, post)))
                want_poisoned.update(zip(g, _plain_group(
                    poisoned_in, Engine.fp16, pre, post)))
            check(all(same_bits(outs[t], want_poisoned[t]) for t in order),
                  f"faults {mode}: the burst is not the plain composition "
                  "of its groups over the poisoned input")
            differ = [n for n in order
                      if not same_bits(outs[n], want_clean[n])]
            check(differ == [target], f"faults {mode}: results differing "
                  f"from the clean composition: {differ[:5]} (want "
                  f"[{target}])")
            same_groups = fgroups == clean_groups
            if same_groups:
                check([n for n in order if not same_bits(outs[n], clean[n])]
                      == [target], f"faults {mode}: results differing from "
                      "the clean burst")
            multi = sum(len(g) > 1 for g in fgroups)
            check(launches == 2 * multi, f"faults {mode}: {launches} A1 "
                  f"launches for {multi} fused groups of several tensors")
            group = next(g for g in fgroups if target in g)
            result["runs"][mode] = {
                "differing": differ, "group_size": len(group),
                "groups_as_clean_burst": same_groups,
                "a1_launches": launches, "fused_groups": len(fgroups),
                "multi_tensor_groups": multi,
                "poisoned_on": seen[0][1], "sync_debug": "error",
                "poisoned_finite": bool(torch.isfinite(poisoned).all()),
                "result_finite": bool(torch.isfinite(outs[target]).all())}
    finally:
        faults._poison = orig_poison
        faults.uninstall()
    check(not faults.ACTIVE, "faults: the registry is still armed")
    log("faults " + json.dumps(result))
    return result


# -- phase 7: the ring collectives A4/A5/A6 over 8 virtual ranks -----------

# -- the observability planes on the training step --------------------------

OBS_MODES = ("off", "defaults", "full")
# each mode twice, in turns
OBS_ORDER = ("off", "defaults", "full", "full", "defaults", "off")
OBS_STEPS = 3          # timed steps a turn, after one warm-up step
OBS_PROBE_OPS = 200    # hooked hvd.allreduce calls a turn (host µs an op)
OBS_PROFILE_STEPS = 3  # steps in stepprof's profile window
OBS_SLEEP_S = 0.02     # the known sleep the clock alignment is held to
OBS_ALIGN_TOL_US = 2000.0
OBS_IDLE_TOL = 0.05
# tracing off/on in turns
OBS_BURST_ORDER = (False, True, True, False, False, True, True, False)
OBS_EVENTS = 2000      # timeline begin/end pairs timed alone


def _obs_mode(hvd, mode: str, tmp: Path, k: int) -> dict:
    """Put the planes in ``mode``: ``off`` (none), ``defaults`` (the
    reference's init defaults: flight, stepprof, anomaly) or ``full``
    (defaults, timeline and trace); fails unless each plane asked for is
    active.  Returns the timeline and trace paths of a full turn."""
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.obs import anomaly, flight, stepprof, tracing

    hvd.stop_timeline()
    tracing.uninstall()
    flight.uninstall()
    anomaly.uninstall()
    stepprof.uninstall()
    stepprof.ACTIVE = False
    paths = {}
    if mode != "off":
        flight.install(rank=0, size=1, out_dir=str(tmp), sigusr2=False)
        anomaly.install(rank=0, size=1)
        stepprof.ACTIVE = True
        stepprof.install()
    if mode == "full":
        paths["timeline"] = tmp / f"timeline_{k}.json"
        paths["trace"] = tmp / f"trace_{k}"
        hvd.start_timeline(str(paths["timeline"]))
        tracing.install(str(paths["trace"]), rank=0, size=1)
    on = mode != "off"
    active = {"flight": flight.ACTIVE, "anomaly": anomaly.ACTIVE,
              "stepprof": stepprof.ACTIVE,
              "timeline": core_state.global_state().timeline is not None,
              "tracing": tracing.ACTIVE}
    want = {"flight": on, "anomaly": on, "stepprof": on,
            "timeline": mode == "full", "tracing": mode == "full"}
    check(active == want, f"obs {mode}: planes {active}, asked {want}")
    return paths


def _trace_chains(trace_dir: Path) -> dict:
    """name -> [phases of its spans..., "DONE" when its instant came] in
    the rank-0 trace file; fails unless every B has its E."""
    with open(trace_dir / "rank0.trace.json") as f:
        events = json.load(f)
    chains, depth = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") == "B":
            chains.setdefault(args["tensor"], []).append(e["name"])
            depth[e["tid"]] = depth.get(e["tid"], 0) + 1
        elif e.get("ph") == "E":
            depth[e["tid"]] -= 1
        elif e.get("name") == "DONE":
            chains.setdefault(args["tensor"], []).append("DONE")
    check(all(v == 0 for v in depth.values()),
          f"obs: unmatched trace spans in {trace_dir}")
    return chains


def _timeline_event_us(tmp: Path) -> float:
    """Host µs one timeline event costs (a ``json.dump`` and a ``flush``
    into a file on this host's disk): OBS_EVENTS begin/end pairs."""
    from horovod_tpu_torch.obs.timeline import Timeline

    tl = Timeline(str(tmp / "events.json"))
    t0 = time.perf_counter()
    for i in range(OBS_EVENTS):
        tl.begin("probe", "NEGOTIATE_ALLREDUCE")
        tl.end("probe")
    secs = time.perf_counter() - t0
    tl.close()
    return secs / (2 * OBS_EVENTS) * 1e6


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def obs_phase(hvd, device, model, opt, x, y, smi: str, tmp: Path):
    """The observability planes on the training step of phase 3, in three
    modes in turns (every plane off; the reference's defaults; defaults
    plus timeline and trace): the optimizer's reduction of one fixed
    backward bitwise across modes, A1's launches a step, the timeline's
    spans a step, the trace merged by ``tools/hvtputrace``, images/s and
    the host µs of a hooked op; the metrics endpoint; stepprof's profile
    window (idle share, exposed comm, MFU) against the same trace read as
    ``torch_port_profile.py`` reads it, and its clock alignment against a
    known sleep; the async fp16 burst of 161 ``allreduce_async_`` with
    tracing on and off in turns."""
    import urllib.request

    import torch
    import torch.nn.functional as F
    from torch.profiler import record_function

    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.eager import get_controller
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.obs import metrics, profile, stepprof, tracing
    from horovod_tpu_torch.ops import fused_scale_cast

    params = [p for p in model.parameters() if p.requires_grad]
    raw = [g.contiguous() for g in torch.autograd.grad(
        F.cross_entropy(model(x), y), params)]
    multi = sum(len(b) > 1 for b in opt.buckets)
    result = {"card": smi, "steps_a_turn": OBS_STEPS, "order": OBS_ORDER}

    def reduce_once():
        """The optimizer's reduction of the fixed gradients (every hook
        unfired: ``synchronize`` launches each bucket)."""
        for p, g in zip(params, raw):
            p.grad = g.clone()
        opt.synchronize()
        out = [p.grad.clone() for p in params]
        opt.zero_grad()
        # the next step() synchronizes its own backward without warning
        opt._synchronized = False
        return out

    def train_step():
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
        metrics.note_step(examples=BATCH)

    per_mode = {m: {"images_per_s": [], "launches_per_step": [],
                    "probe_us": []} for m in OBS_MODES}
    reduced, spans, merged = {}, [], []
    probe = torch.ones(1024, device=device)
    for k, mode in enumerate(OBS_ORDER):
        paths = _obs_mode(hvd, mode, tmp, k)
        reductions = 0
        if mode not in reduced:
            reduced[mode] = reduce_once()
            reductions = 1
        torch.cuda.synchronize()
        secs = []
        fused_scale_cast.launches = 0
        for step in range(1 + OBS_STEPS):
            before = fused_scale_cast.launches
            t0 = time.perf_counter()
            train_step()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            delta = fused_scale_cast.launches - before
            check(delta == 2 * multi, f"obs {mode}: {delta} A1 launches in "
                  f"step {step}, expected {2 * multi}")
        per_mode[mode]["launches_per_step"].append(delta)
        per_mode[mode]["images_per_s"].append(
            BATCH * OBS_STEPS / sum(secs[1:]))
        t0 = time.perf_counter()
        for _ in range(OBS_PROBE_OPS):
            hvd.allreduce(probe, name="obs.probe")
        torch.cuda.synchronize()
        per_mode[mode]["probe_us"].append(
            (time.perf_counter() - t0) / OBS_PROBE_OPS * 1e6)
        if mode == "full":
            hvd.stop_timeline()
            with open(paths["timeline"]) as f:
                events = json.load(f)       # parses: the file is closed
            steps = 1 + OBS_STEPS + reductions
            neg = sum(1 for e in events if e.get("ph") == "B"
                      and e["name"] == "NEGOTIATE_ALLREDUCE")
            fused = sum(1 for e in events if e.get("ph") == "B"
                        and e["name"] == "NCCL_ALLREDUCE"
                        and e["args"]["tensor"].startswith("fused."))
            spans.append({"gradient_spans": neg / steps,
                          "bucket_spans": fused / steps})
            check(neg == RESNET50_GRADS * steps and fused == multi * steps,
                  f"obs: timeline holds {neg} gradient and {fused} bucket "
                  f"spans in {steps} steps")
            tracing.uninstall()
            chains = _trace_chains(paths["trace"])
            check(all(c[-1] == "DONE" for n, c in chains.items()
                      if n.startswith("allreduce.")),
                  "obs: a gradient's trace chain has no DONE")
            run = subprocess.run(
                [sys.executable, "-m", "tools.hvtputrace", "merge",
                 str(paths["trace"])], cwd=REPO, capture_output=True,
                text=True, timeout=120)
            check(run.returncode == 0,
                  f"obs: hvtputrace merge failed: {run.stderr[-400:]}")
            with open(paths["trace"] / "merged.trace.json") as f:
                merged.append(len(json.load(f)))
    for mode in OBS_MODES[1:]:
        check(all(same_bits(a, b) for a, b in
                  zip(reduced[mode], reduced["off"])),
              f"obs {mode}: the reduced gradients differ from the "
              "planes-off ones")
    for mode, d in per_mode.items():
        d["images_per_s_median"] = statistics.median(d["images_per_s"])
        d["probe_us_median"] = statistics.median(d["probe_us"])
    result.update(modes=per_mode, reduced_bitwise=True,
                  timeline_spans_per_step=spans,
                  merged_trace_events=merged,
                  event_us=_timeline_event_us(tmp))

    # the endpoints, in the defaults mode with the watchdog armed
    _obs_mode(hvd, "defaults", tmp, len(OBS_ORDER))
    st = core_state.global_state()
    stall._make_inspector(st, st.config)
    port = metrics.start_http_server(0, addr="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        debug = json.loads(urllib.request.urlopen(base + "/debug",
                                                  timeout=30).read())
    finally:
        metrics.stop_http_server()
        stall.stop(st)
    for family in ("hvtpu_allreduce_total", "hvtpu_optimizer_steps_total",
                   "hvtpu_allreduce_latency_seconds_bucket"):
        check(family in text, f"obs: /metrics lacks {family}")
    check({"job", "stall", "flight", "anomaly", "stepprof",
           "controller"} <= set(debug),
          f"obs: /debug providers {sorted(debug)}")
    result["endpoints"] = {"metrics_bytes": len(text),
                           "debug": sorted(debug)}

    # stepprof: one profile window over OBS_PROFILE_STEPS steps
    flop_model = ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(SEED))
    flops = stepprof.measured_flops(
        lambda: F.cross_entropy(flop_model(x), y).backward())
    del flop_model
    check(flops is not None and flops > 0, "obs: no FLOPs counted")
    stepprof.set_step_flops(flops)
    logdir = tmp / "stepprof"
    with stepprof.profile_window(str(logdir)) as joined:
        for _ in range(OBS_PROFILE_STEPS):
            with record_function("train_step"):
                train_step()
                torch.cuda.synchronize()
    check(joined["status"] == "ok", f"obs: stepprof join {joined}")
    events = profile.read_trace(profile.newest(str(logdir)))["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    steps_us = sum(e["dur"] for e in events if e.get("name") == "train_step"
                   and e.get("cat") == "user_annotation")
    idle_tpp = 1 - _union_us(kernels) / steps_us
    step_s = joined["window_s"] / OBS_PROFILE_STEPS
    mfu = stepprof.mfu(flops, step_s)
    check(abs(joined["idle_share"] - idle_tpp) <= OBS_IDLE_TOL,
          f"obs: stepprof's idle share {joined['idle_share']:.4f} against "
          f"{idle_tpp:.4f} read as torch_port_profile.py reads it")
    check(mfu is not None, "obs: no MFU on this card")

    # the clock alignment, against a known sleep of the card
    cycles = _sleep_cycles(OBS_SLEEP_S)
    aligndir = tmp / "align"
    with stepprof.profile_window(str(aligndir)) as joined2:
        time.sleep(0.005)
        ta = time.time()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        tb = time.time()
    prof = profile.load_profile(str(aligndir))
    origin = profile.marker_us(prof["doc"], stepprof.WINDOW_MARKER)
    ivs = [iv for lane in prof["planes"].values() for iv in lane]
    aligned, _shift = stepprof.align_device_intervals(
        ivs, joined2["window"][0] * 1e6, origin)
    spin = max(aligned, key=lambda iv: iv["t1_us"] - iv["t0_us"])
    lead_us, lag_us = spin["t0_us"] - ta * 1e6, tb * 1e6 - spin["t1_us"]
    check(lead_us >= -OBS_ALIGN_TOL_US and lag_us >= -OBS_ALIGN_TOL_US,
          f"obs: the sleep kernel aligned {lead_us:.0f} µs after its "
          f"launch and {lag_us:.0f} µs before its wait returned")
    result["stepprof"] = {
        "steps": OBS_PROFILE_STEPS, "window_s": joined["window_s"],
        "idle_share": joined["idle_share"],
        "idle_share_torch_port_profile": idle_tpp,
        "exposed_comm_ms_per_step":
            joined["exposed_comm_s"] / OBS_PROFILE_STEPS * 1e3,
        "overlap_fraction": joined["overlap_fraction"],
        "flops_per_step": flops, "peak_tflops": stepprof.peak_flops() / 1e12,
        "mfu": mfu, "device_planes": joined["device_planes"],
        "align": {"sleep_ms": (spin["t1_us"] - spin["t0_us"]) / 1e3,
                  "kernel": spin["op"][:60], "lead_us": lead_us,
                  "lag_us": lag_us}}

    # the async fp16 burst with tracing on and off in turns
    _obs_mode(hvd, "defaults", tmp, len(OBS_ORDER) + 1)
    grads = hook_order_grads(model, opt, x, y)
    by_name = {f"allreduce.{n}": g for n, g in grads}
    pre, post = 1.0 / PREDIVIDE, PREDIVIDE / hvd.size()
    ctrl = get_controller()
    bursts = {"off": [], "on": []}
    cycles = {"off": [], "on": []}
    outs0 = None
    for k, on in enumerate(OBS_BURST_ORDER):
        trace_dir = tmp / f"burst_trace_{k}"
        if on:
            tracing.install(str(trace_dir), rank=0, size=1)
        tensors = {n: g.clone() for n, g in by_name.items()}
        torch.cuda.synchronize()
        cycle0 = ctrl._cycle
        t0 = time.perf_counter()
        ctrl.hint_burst(len(tensors))
        handles = {n: hvd.allreduce_async_(
            t, name=n, op=hvd.Sum, compression=hvd.Compression.fp16,
            prescale_factor=pre, postscale_factor=post)
            for n, t in tensors.items()}
        outs = {n: hvd.synchronize(h) for n, h in handles.items()}
        torch.cuda.synchronize()
        bursts["on" if on else "off"].append(
            (time.perf_counter() - t0) * 1e3)
        cycles["on" if on else "off"].append(ctrl._cycle - cycle0)
        if outs0 is None:
            outs0 = outs
        check(all(same_bits(outs[n], outs0[n]) for n in by_name),
              f"obs: burst {k} (tracing {on}) differs from burst 0")
        if on:
            tracing.uninstall()
            chains = _trace_chains(trace_dir)
            for n in by_name:
                c = chains.get(n, [])
                check(c[:2] == ["NEGOTIATE", "QUEUE"] and "EXEC" in c
                      and c[-1] == "DONE",
                      f"obs: {n} traced as {c}")
    result["burst_ms"] = {m: {"runs": v, "median": statistics.median(v),
                              "cycles": cycles[m]}
                          for m, v in bursts.items()}
    _obs_mode(hvd, "off", tmp, len(OBS_ORDER) + 2)
    log("obs " + json.dumps(result))
    return result


def ring_buckets(model, x, y, ranks: int):
    """Data-parallel ResNet-50 over ``ranks`` virtual ranks: the batch in
    ``ranks`` shards, one backward each, each rank's 161 float32 gradients
    packed into one buffer."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.comm.packing import pack_flat

    params = [p for p in model.parameters() if p.requires_grad]
    buckets = []
    for xs, ys in zip(x.chunk(ranks), y.chunk(ranks)):
        grads = torch.autograd.grad(F.cross_entropy(model(xs), ys), params)
        check(len(grads) == RESNET50_GRADS, "ring: ResNet-50 gradients")
        buckets.append(pack_flat(list(grads))[0])
    for b in buckets:
        check(b.dtype == torch.float32 and bool(torch.isfinite(b).all()),
              "ring: a rank's gradients are not finite float32")
    check(not torch.equal(buckets[0], buckets[1]),
          "ring: the ranks' gradients are equal")
    return buckets


RING_KERNELS = ("A4_cluster", "A5_cluster", "A6_cluster", "A4_global",
                "A5_global", "A6_global")


def _ring_counts():
    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    return {"A4_cluster": ring_allgather_2d.cluster_launches,
            "A5_cluster": ring_allreduce.cluster_launches,
            "A6_cluster": ring_allreduce.quantized_cluster_launches,
            "A4_global": ring_allgather_2d.launches,
            "A5_global": ring_allreduce.launches,
            "A6_global": ring_allreduce.quantized_launches}


def _set_ring_counts(counts) -> None:
    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    ring_allgather_2d.cluster_launches = counts["A4_cluster"]
    ring_allreduce.cluster_launches = counts["A5_cluster"]
    ring_allreduce.quantized_cluster_launches = counts["A6_cluster"]
    ring_allgather_2d.launches = counts["A4_global"]
    ring_allreduce.launches = counts["A5_global"]
    ring_allreduce.quantized_launches = counts["A6_global"]


def _ring_key(kind: str, n: int) -> str:
    """The counter of the kernel that serves ``kind`` (A4, A5, A6) at
    ``n`` ranks: the wrapper's own dispatch."""
    from horovod_tpu_torch.ops.ring import kernel_route

    return f"{kind}_{kernel_route(n, kind == 'A6')}"


def _one_launch(kernel: str, fn):
    """``fn()``, checked to launch ``kernel`` once and nothing else."""
    before = _ring_counts()
    out = fn()
    after = _ring_counts()
    want = dict(before, **{kernel: before[kernel] + 1})
    check(after == want, f"ring: {kernel} call launched {after} from {before}")
    return out


def _held(outs, want, what: str) -> float:
    """Every rank's output bitwise equal to every other's and to the
    plain version's; returns the largest difference (0.0)."""
    for r, o in enumerate(outs):
        check(same_bits(o, outs[0]), f"ring: {what}: rank {r} differs "
              "from rank 0")
    check(len(outs) == len(want) and same_bits(outs[0], want[0]),
          f"ring: {what}: kernel and plain version differ")
    return max_abs_diff(outs[0], want[0])


def _ring_path(buckets, blocks, quantized: bool):
    """One path of the ring: Sum, Average, A6 when ``quantized`` and the
    all-gather, through the user's entry points, with every count set to
    0 just before and read just after."""
    import torch

    from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce

    _set_ring_counts(dict.fromkeys(RING_KERNELS, 0))
    sums = ring_allreduce(buckets)
    avgs = ring_allreduce(buckets, average=True)
    quant = ring_allreduce(buckets, quantized=True) if quantized else None
    gathered = ring_allgather_2d(blocks)
    torch.cuda.synchronize()
    launches = _ring_counts()
    n = len(buckets)
    want = dict.fromkeys(RING_KERNELS, 0)
    want[_ring_key("A5", n)] = 2
    want[_ring_key("A4", n)] = 1
    if quantized:
        want[_ring_key("A6", n)] = 1
    check(launches == want, f"ring: {n}-rank path launched {launches}, "
          f"expected {want}")
    return sums, avgs, quant, gathered, launches


def _quantized_checks(quant, buckets, what: str):
    """A6 identical on every rank, bitwise the plain version and within
    ``2(n-1) max sum|x| / 127`` of the float64 sum; returns the largest
    difference to the plain version (0.0), the largest and mean error
    and the bound."""
    import torch

    from horovod_tpu_torch.ops import ring_allreduce_plain

    n = len(buckets)
    held = _held(quant, ring_allreduce_plain(buckets, quantized=True),
                 f"{what} A6")
    stacked = torch.stack(buckets)
    q_err = (quant[0].double() - stacked.double().sum(0)).abs()
    q_bound = 2 * (n - 1) * float(stacked.abs().double().sum(0).max()) / 127
    check(float(q_err.max()) <= q_bound,
          f"ring: {what}: A6 error {float(q_err.max())} beyond {q_bound}")
    return held, float(q_err.max()), float(q_err.mean()), q_bound


def _sum_checks(sums, avgs, buckets, what: str) -> float:
    """A5 Sum and Average bitwise the plain versions, Average bitwise
    ``sum * f32(1/n)``, the sum within ``n 2^-23 sum|x|`` of float64."""
    import torch

    from horovod_tpu_torch.ops import ring_allreduce_plain
    from horovod_tpu_torch.ops.quantize import flush

    n = len(buckets)
    err = max(_held(sums, ring_allreduce_plain(buckets), f"{what} sum"),
              _held(avgs, ring_allreduce_plain(buckets, average=True),
                    f"{what} average"))
    check(same_bits(avgs[0], flush(sums[0] * torch.tensor(
        1.0 / n, dtype=torch.float32))),
        f"ring: {what}: Average is not sum * f32(1/n)")
    stacked = torch.stack(buckets)
    exact = stacked.double().sum(0)
    magnitude = stacked.abs().double().sum(0)
    check(bool(((sums[0].double() - exact).abs()
                <= n * 2.0 ** -23 * magnitude).all()),
          f"ring: {what}: A5 beyond n * 2^-23 * sum|x| of the float64 sum")
    return err


def _rank_blocks(buckets):
    """Rank r's 1/n of its bucket as ``(CH, 128)``, zero-padded as the
    allreduce pads it."""
    import torch

    from horovod_tpu_torch.ops.ring import chunk_elems

    n, size = len(buckets), buckets[0].numel()
    e = chunk_elems(size, n)
    return [torch.nn.functional.pad(b, (0, n * e - size))[r * e:(r + 1) * e]
            .reshape(-1, 128) for r, b in enumerate(buckets)]


def _time_ring(buckets, blocks, reps: int, plain_reps: int = 2):
    """ms of A5 (Sum) and A4 through the wrappers, their plain versions,
    one library call that fills one output and the library calls that
    fill every rank's output; the last timed call of each is checked
    again."""
    import torch

    from horovod_tpu_torch.ops import (
        ring_allgather_2d,
        ring_allgather_2d_plain,
        ring_allreduce,
        ring_allreduce_plain,
    )

    n = len(buckets)
    stacked = torch.stack(buckets)
    total = torch.empty_like(buckets[0])
    sum_outs = [torch.empty_like(b) for b in buckets]
    whole = torch.cat(blocks)
    cat_outs = [torch.empty_like(whole) for _ in range(n)]

    def sum_all_ranks():
        torch.sum(stacked, 0, out=total)
        for o in sum_outs:
            o.copy_(total)

    def cat_all_ranks():
        for o in cat_outs:
            torch.cat(blocks, out=o)

    last = {}

    def timed(key, fn):
        return lambda: last.__setitem__(key, fn())

    a5 = dict(ms=time_cuda(timed("A5", lambda: ring_allreduce(buckets)),
                           reps),
              plain_ms=time_cuda(lambda: ring_allreduce_plain(buckets),
                                 plain_reps, 1),
              library_ms=time_cuda(lambda: stacked.sum(0), reps),
              library_all_ranks_ms=time_cuda(sum_all_ranks, reps))
    _held(last["A5"], ring_allreduce_plain(buckets), f"A5 n={n} after timing")
    check(same_bits(sum_outs[-1], stacked.sum(0)),
          "ring: the all-ranks library call of A5 computes another sum")
    a4 = dict(ms=time_cuda(timed("A4", lambda: ring_allgather_2d(blocks)),
                           reps),
              plain_ms=time_cuda(lambda: ring_allgather_2d_plain(blocks),
                                 plain_reps, 1),
              library_ms=time_cuda(lambda: torch.cat(blocks), reps),
              library_all_ranks_ms=time_cuda(cat_all_ranks, reps))
    _held(last["A4"], ring_allgather_2d_plain(blocks),
          f"A4 n={n} after timing")
    check(same_bits(cat_outs[-1], whole),
          "ring: the all-ranks library call of A4 is not torch.cat")
    return a4, a5


def _a6_bound(n: int, size: int):
    """A6's least bytes (each rank's input read once, its output written
    once) and its operations: a quantize (~6) and an FMA a hop and
    element, the owner's quantize and every rank's dequantize."""
    return dict(zip(("bound_ms", "bound_by"), _bound_ms(
        2 * n * size * 4, size * (6 * (n - 1) + 4) + n * size)))


def _time_a6(buckets, reps: int, plain_reps: int = 2):
    """ms of A6 through the wrapper and its plain version; the last
    timed call is checked again."""
    from horovod_tpu_torch.ops import ring_allreduce, ring_allreduce_plain

    last = {}
    a6 = dict(ms=time_cuda(lambda: last.__setitem__(
        "A6", ring_allreduce(buckets, quantized=True)), reps),
              plain_ms=time_cuda(lambda: ring_allreduce_plain(
                  buckets, quantized=True), plain_reps, 1),
              library_ms=None, library_all_ranks_ms=None)
    _held(last["A6"], ring_allreduce_plain(buckets, quantized=True),
          f"A6 n={len(buckets)} after timing")
    return dict(a6, **_a6_bound(len(buckets), buckets[0].numel()))


def _ring_bounds(n: int, size: int, e: int):
    """The least bytes of A4 and A5 (each rank's input read once, its
    output written once) and A5's float32 additions."""
    a5 = _bound_ms(2 * n * size * 4, (n - 1) * size)
    a4 = _bound_ms(n * e * 4 + n * n * e * 4, 0)
    return dict(zip(("bound_ms", "bound_by"), a4)), dict(
        zip(("bound_ms", "bound_by"), a5))


def _wide_ranks(buckets, m: int, elements: int):
    """``m`` ranks of ``elements`` gradients each, distinct slices of the
    ``n`` buckets (rank r: bucket r mod n, slice r // n), each slice at a
    16-byte aligned offset so that no wrapper copies it."""
    n = len(buckets)
    stride = -(-elements // 4) * 4
    check(-(-m // n) * stride <= buckets[0].numel(),
          f"ring: {m} ranks of {elements} do not fit the buckets")
    return [buckets[r % n][(r // n) * stride:(r // n) * stride + elements]
            for r in range(m)]


def ring_phase(buckets, reps: int):
    """The ring collectives at full width (8 ranks x 25.56 M float32
    gradients, the main path: A4, A5 and A6 on the cluster kernels),
    rings of 2 and 3 ranks, the 12-rank ring on the global-slot A4/A5/A6
    kernels (a path of its own), timing (the 12-rank kernels at half a
    bucket a rank, where the kernel and not the call around it takes the
    time), and calls back to back."""
    import torch

    from horovod_tpu_torch.ops import (
        ring_allgather_2d,
        ring_allgather_2d_plain,
        ring_allreduce,
        ring_allreduce_plain,
    )
    from horovod_tpu_torch.ops.ring import chunk_elems, cluster_info

    n, size = len(buckets), buckets[0].numel()
    e = chunk_elems(size, n)
    blocks = _rank_blocks(buckets)

    # the main path
    sums, avgs, quant, gathered, launches = _ring_path(buckets, blocks, True)
    check(all(_ring_key(k, n).endswith("_cluster")
              for k in ("A4", "A5", "A6")),
          f"ring: {n} ranks not on the cluster kernels")
    err = dict.fromkeys(RING_KERNELS, 0.0)
    err["A5_cluster"] = _sum_checks(sums, avgs, buckets, f"n={n}")
    err["A6_cluster"], a6_max, a6_mean, q_bound = _quantized_checks(
        quant, buckets, f"n={n}")
    err["A4_cluster"] = _held(gathered, ring_allgather_2d_plain(blocks), "A4")
    check(same_bits(gathered[0], torch.cat(blocks)),
          "ring: A4 is not torch.cat")
    del sums, avgs, quant, gathered
    log(f"ring: {n} ranks x {size} elements, A5 Sum/Average and A6 "
        "(cluster) identical on every rank and bitwise the plain "
        "versions, A4 (cluster) bitwise torch.cat")

    # smaller rings: n = 2 and n = 3 (not a power of two: the reciprocal
    # Average), then 3 ranks of values over 50 decades with subnormals,
    # NaN, inf and -inf; comparisons, not a path
    gen = torch.Generator(device=buckets[0].device).manual_seed(SEED + 4)
    special = [wide_values(RING_SMALL, torch.float32, buckets[0].device, gen)
               for _ in range(3)]
    special[0][5], special[1][1030], special[2][2100] = (
        math.nan, math.inf, -math.inf)
    rings = [(f"n={m}", [b[:RING_SMALL] for b in buckets[:m]])
             for m in (2, 3)] + [("special n=3", special)]
    for what, xs in rings:
        m = len(xs)
        for kind, kw in (("A5", {}), ("A5", {"average": True}),
                         ("A6", {"quantized": True})):
            key = _ring_key(kind, m)
            outs = _one_launch(key, lambda: ring_allreduce(xs, **kw))
            err[key] = max(err[key], _held(
                outs, ring_allreduce_plain(xs, **kw), f"{what} {kw}"))
        rows = RING_SMALL // 128
        bl = [x[:rows * 128].reshape(rows, 128) for x in xs]
        key = _ring_key("A4", m)
        outs = _one_launch(key, lambda: ring_allgather_2d(bl))
        err[key] = max(err[key], _held(outs, ring_allgather_2d_plain(bl),
                                       f"A4 {what}"))
        check(same_bits(outs[0], torch.cat(bl)), f"ring: A4 {what} cat")

    # the 12-rank ring: past a cluster's 8 CTAs, so A4, A5 and A6 take
    # the global-slot kernels; each rank a distinct RING_SMALL slice of
    # the gradients
    m = RING_WIDE
    wide = _wide_ranks(buckets, m, RING_SMALL)
    wide_blocks = _rank_blocks(wide)
    wsums, wavgs, wquant, wgathered, wide_launches = _ring_path(
        wide, wide_blocks, True)
    check(all(_ring_key(k, m).endswith("_global")
              for k in ("A4", "A5", "A6")),
          f"ring: {m} ranks not on the global-slot kernels")
    err["A5_global"] = _sum_checks(wsums, wavgs, wide, f"n={m}")
    err["A6_global"], wide_a6_max, _, wide_q_bound = _quantized_checks(
        wquant, wide, f"n={m}")
    err["A4_global"] = _held(wgathered, ring_allgather_2d_plain(wide_blocks),
                             f"A4 n={m}")
    check(same_bits(wgathered[0], torch.cat(wide_blocks)),
          f"ring: A4 n={m} is not torch.cat")
    del wsums, wavgs, wquant, wgathered
    log(f"ring: {m} ranks x {RING_SMALL} elements on the global-slot "
        "A4/A5/A6 kernels, identical on every rank and bitwise the plain "
        "versions")

    # timing; the last timed call of each is checked again
    saved = _ring_counts()
    a4c, a5c = _time_ring(buckets, blocks, reps)
    a6c = _time_a6(buckets, reps)
    # the 12-rank kernels: per call at RING_SMALL (launch, flag memset,
    # slot allocation and 22 handshakes a slice outweigh the bytes), then
    # at half a bucket a rank, the size the kernel's rate is read at
    wide_small_ms = {
        "A5_global": time_cuda(lambda: ring_allreduce(wide), reps),
        "A4_global": time_cuda(lambda: ring_allgather_2d(wide_blocks), reps),
        "A6_global": time_cuda(
            lambda: ring_allreduce(wide, quantized=True), reps)}
    wide_elements = size // 2 // 4 * 4
    big = _wide_ranks(buckets, m, wide_elements)
    big_blocks = _rank_blocks(big)
    a4g, a5g = _time_ring(big, big_blocks, reps)
    a6g = _time_a6(big, reps)
    del big, big_blocks
    _set_ring_counts(saved)

    we = chunk_elems(wide_elements, m)
    b4, b5 = _ring_bounds(n, size, e)
    a4c.update(b4)
    a5c.update(b5)
    wb4, wb5 = _ring_bounds(m, wide_elements, we)
    a4g.update(wb4)
    a5g.update(wb5)
    # what each ring moves besides the bound: the cluster kernels' hops
    # through distributed shared memory; the global-slot kernels' hops
    # through HBM (payload into the neighbour's slot and back out, the
    # local chunk again each reduce-scatter hop)
    dsmem_bytes = {"A5_cluster": n * 4 * e * (2 * n - 2),
                   "A4_cluster": n * 4 * e * (n - 1),
                   "A6_cluster": n * (2 * n - 2) * (e + 4 * e // 1024)}
    hbm_ring_bytes = {
        "A6_global": m * we * (8 + 2 * (m - 1) * (6 + 1 / 128)),
        "A5_global": m * 4 * we * (6 * m - 4),
        "A4_global": m * 4 * we * (2 + 3 * (m - 1))}
    config = {f"{kind}_cluster": cluster_info(kind, n)
              for kind in ("A4", "A5", "A6")}
    result = dict(ranks=n, elements=size, chunk=e, launches=launches,
                  wide_ranks=m, wide_elements=RING_SMALL,
                  wide_launches=wide_launches,
                  wide_small_ms=wide_small_ms,
                  wide_timed_elements=wide_elements, small_rings=[2, 3],
                  small_elements=RING_SMALL,
                  a6_max_err=a6_max, a6_mean_err=a6_mean,
                  a6_bound=q_bound, wide_a6_max_err=wide_a6_max,
                  wide_a6_bound=wide_q_bound, max_abs_err=err,
                  cluster_config=config, dsmem_bytes=dsmem_bytes,
                  hbm_ring_bytes=hbm_ring_bytes,
                  hbm_ring_ms={k: v / HBM_BYTES_PER_S * 1e3
                               for k, v in hbm_ring_bytes.items()},
                  A4_cluster=a4c, A5_cluster=a5c, A6_cluster=a6c,
                  A4_global=a4g, A5_global=a5g, A6_global=a6g)
    log("ring_path " + json.dumps(result))
    return result


# -- phase 8: a small run against plain PyTorch on the CPU --------------------

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

    # the flight recorder's postmortems go to a directory of this run
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    os.environ["HVTPU_FLIGHT_DIR"] = str(tmp)
    hvd.init()                            # one-rank NCCL world on cuda:0
    device = hvd.device()
    try:
        grad_shapes = resnet50_grad_shapes()
        check(len(grad_shapes) == RESNET50_GRADS, "ResNet-50 inventory")
        big_n = sum(math.prod(s) for s in grad_shapes)
        kern = kernel_phase(device, grad_shapes, big_n, reps=20)
        int8_kern = int8_kernel_phase(device, grad_shapes, big_n, reps=20)

        torch.backends.cudnn.benchmark = True
        model, opt, x, y, train = train_phase(hvd, device, BATCH, IMAGE,
                                              [3, 4, 6, 3])
        check(train["grads"] == RESNET50_GRADS, "ResNet-50 gradients")
        reduction = parity_phase(model, opt, x, y, reps=20)
        int8_path = int8_path_phase(model, x, y)
        surface_autograd_phase(hvd, device)
        async_path = async_phase(hvd, device, model, opt, x, y, smi)
        adasum_phase(hvd, device, model, x, y)
        stall_line = stall_phase(hvd, device, model, opt, x, y, smi, tmp)
        faults_phase(hvd, device, model, opt, x, y, smi)
        obs = obs_phase(hvd, device, model, opt, x, y, smi, tmp)
        ring = ring_phase(ring_buckets(model, x, y, RING_RANKS), reps=10)
        del model, opt, x, y
        reference_phase(hvd, device)
    finally:
        hvd.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    log(f"{smi} | ResNet-50 bf16 batch {BATCH} {IMAGE}x{IMAGE}: "
        f"{train['images_per_s']:.1f} images/s")
    pre, post = kern["passes"]["pre"], kern["passes"]["post"]
    # A1: the grouped pre pass (scale_cast_pack) over the 161 gradients;
    # the post pass (unpack_cast_scale) beside it; library_ms is
    # _foreach_mul over the same tensors, per_tensor_ms the per-tensor
    # composition the passes replace
    kernels = [{
        "name": "fused_scale_cast (grouped: scale_cast_pack / "
                "unpack_cast_scale)",
        "route": "cuda",
        "source": "horovod_tpu_torch/csrc/scale_cast.cu",
        "replaces": "horovod_tpu/ops/pallas_ops.py:101",
        "launches": train["launches"],
        "async_launches": async_path["a1_launches"],
        "zero_copy_launches": async_path["zero_copy"]["a1_launches_on"],
        "stall_launches": stall_line["stall_launches"],
        "obs_launches_per_step": {m: d["launches_per_step"]
                                  for m, d in obs["modes"].items()},
        "max_abs_err": kern["max_abs_err"],
        "ms": pre["ms"],
        "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"],
        "per_tensor_ms": pre["per_tensor_ms"],
        "post": {k: post[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "per_tensor_ms")},
        "big_buffer": kern["big_buffer"],
        **reduction,
    }]
    ipp, err = int8_kern["path_pass"], int8_kern["err"]
    big = int8_kern["big_buffer"]
    for name, key, line, launches, max_err, buffers in (
            ("quantize_int8_blocks (deterministic)", "quantize_deterministic",
             185, int8_path["a2_launches"]["deterministic"],
             max(err["q"], err["s"]),
             ("quantize_deterministic_float32",
              "quantize_deterministic_bfloat16")),
            ("quantize_int8_blocks (stochastic)", "quantize_stochastic", 185,
             int8_path["a2_launches"]["stochastic"],
             max(err["q"], err["s"]), ("quantize_stochastic_float32",)),
            ("dequantize_int8_blocks", "dequantize", 214,
             int8_path["a3_launches"], err["d"],
             ("dequantize_to_float32_float32",
              "dequantize_to_bfloat16_float32"))):
        # ms: the pass over the 161 gradients, host included; A3's
        # library call is one torch.mul of the codes by the scales, A2
        # has none; big_buffer: the 25.56 M buffer
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/quantize_int8.cu",
            "replaces": f"horovod_tpu/ops/pallas_ops.py:{line}",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": ipp[key]["ms"],
            "plain_ms": ipp[key]["plain_ms"],
            "bound_ms": ipp[key]["bound_ms"],
            "bound_by": ipp[key]["bound_by"],
            "library_ms": ipp[key]["library_ms"],
            "big_buffer": {b: big[b] for b in buffers},
        })
    for key, name, line, source, path in (
            ("A4_cluster", "ring_allgather_2d (cluster, n <= 8)", 94,
             "ring_cluster.cu", "launches"),
            ("A5_cluster", "ring_allreduce (cluster, n <= 8)", 180,
             "ring_cluster.cu", "launches"),
            ("A4_global", "ring_allgather_2d (global slots, n > 8)", 94,
             "ring.cu", "wide_launches"),
            ("A5_global", "ring_allreduce (global slots, n > 8)", 180,
             "ring.cu", "wide_launches"),
            ("A6_cluster", "ring_allreduce (quantized, cluster, n <= 8)",
             296, "ring_cluster.cu", "launches"),
            ("A6_global", "ring_allreduce (quantized, global slots, n > 8)",
             296, "ring.cu", "wide_launches")):
        # A5's library call is x.sum(0) on the stacked ranks, A4's
        # torch.cat, each filling one output; library_all_ranks_ms fills
        # every rank's; A6 has none
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{source}",
            "replaces": f"horovod_tpu/ops/ring.py:{line}",
            "launches": ring[path][key],
            "max_abs_err": ring["max_abs_err"][key],
            "ms": ring[key]["ms"],
            "plain_ms": ring[key]["plain_ms"],
            "bound_ms": ring[key]["bound_ms"],
            "bound_by": ring[key]["bound_by"],
            "library_ms": ring[key]["library_ms"],
            "library_all_ranks_ms": ring[key]["library_all_ranks_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
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

#!/usr/bin/env python3
"""Where the time of the port's training steps goes, on one GPU.

    python3 torch_port_profile.py [--model resnet50|transformer|
                                   ResNet101|InceptionV3|VGG16]
                                  [--steps 3] [--out .profile_out]

Builds the same step as ``chip_smoke.py``: ``resnet50`` (the default;
ResNet-50 bf16, NHWC 224x224, batch 64, ``DistributedOptimizer`` with
fp16 wire and predivide 2.0), ``transformer`` (the reference's
``TransformerConfig()``, bf16, ``megatron_sp``, batch 8 x 2049,
``make_train_step`` with Adam 3e-3) or a model of the benchmark trio
(``chip_smoke.MODEL_TRIO``: its batch and lr, the same optimizer as
ResNet-50's); runs its 7 steps as warm-up, then
traces ``--steps`` steps with ``torch.profiler`` and prints one JSON
line: step wall time, the card's busy and idle share over the traced
steps (the union of kernel intervals against the steps' wall clock), and
device time by kernel group (ResNet-50: the ``fused_scale_cast`` kernel,
NCCL, convolution; the transformer: GEMMs, softmax, elementwise,
reductions; everything else), plus the top kernels by device time.  The
chrome trace goes to ``--out``.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gzip
import json
import re
import sys
import time
from pathlib import Path

import chip_smoke

GROUPS = {
    "resnet50": [
        ("fused_scale_cast", re.compile(r"scale_cast_table_kernel")),
        ("nccl", re.compile(r"nccl", re.I)),
        ("conv", re.compile(r"conv|cudnn|xmma|implicit_gemm|dgrad|wgrad|"
                            r"sm90_", re.I)),
    ],
    "transformer": [
        ("nccl", re.compile(r"nccl", re.I)),
        ("gemm", re.compile(r"nvjet|gemm|cutlass|sm90_", re.I)),
        ("softmax", re.compile(r"softmax", re.I)),
        ("elementwise", re.compile(r"elementwise", re.I)),
        ("reduce", re.compile(r"reduce_kernel", re.I)),
    ],
}


for _name, *_ in chip_smoke.MODEL_TRIO:
    GROUPS[_name] = GROUPS["resnet50"]


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def _resnet50_step(hvd):
    """chip_smoke's train phase: it builds the step and runs 7 steps."""
    import torch
    import torch.nn.functional as F

    torch.backends.cudnn.benchmark = True
    model, opt, x, y, _ = chip_smoke.train_phase(
        hvd, hvd.device(), chip_smoke.BATCH, chip_smoke.IMAGE, [3, 4, 6, 3])

    def step():
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()

    return step


def _transformer_step(hvd):
    """chip_smoke's transformer step, run 7 times."""
    import torch

    from horovod_tpu_torch import parallel as par
    from horovod_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig()
    layout = par.make_layout()
    model = tfm.Transformer(cfg, layout,
                            generator=chip_smoke._seeded(chip_smoke.SEED))
    train = tfm.make_train_step(
        cfg, layout, torch.optim.Adam(model.parameters(),
                                      lr=chip_smoke.TFM_LR))
    toks = chip_smoke._tfm_tokens(cfg, chip_smoke.TFM_BATCH, hvd.device())

    def step():
        train(model, toks)

    for _ in range(chip_smoke.WARMUP_STEPS + chip_smoke.TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    return step


def _trio_step(hvd, name: str):
    """A model of chip_smoke's trio at its benchmark batch, run 7 times."""
    import torch

    torch.backends.cudnn.benchmark = True
    _, side, batch, lr = next(t for t in chip_smoke.MODEL_TRIO
                              if t[0] == name)
    step, _, _ = chip_smoke.model_step(hvd, hvd.device(), name, side, batch,
                                       lr)
    for _ in range(chip_smoke.WARMUP_STEPS + chip_smoke.TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    return step


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(GROUPS), default="resnet50")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=".profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(chip_smoke.REPO))
    import horovod_tpu_torch as hvd

    hvd.init()
    if args.model in ("resnet50", "transformer"):
        step = {"resnet50": _resnet50_step,
                "transformer": _transformer_step}[args.model](hvd)
    else:
        step = _trio_step(hvd, args.model)
    windows = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            with record_function("train_step"):
                step()
                torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / f"{args.model}_step_trace.json.gz"
    prof.export_chrome_trace(str(trace_path))
    hvd.shutdown()

    with gzip.open(trace_path, "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    steps = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    wall_us = sum(e["dur"] for e in steps)
    busy_us = _union_us([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    groups = GROUPS[args.model]
    by_group = {name: 0.0 for name, _ in groups}
    by_group["other"] = 0.0
    by_name = {}
    for k in kernels:
        group = next((g for g, rx in groups if rx.search(k["name"])), "other")
        by_group[group] += k["dur"]
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"]
    n = max(len(steps), 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    result = {
        "device": torch.cuda.get_device_name(0),
        "model": args.model,
        "steps": len(steps),
        "step_ms_host": [w * 1e3 for w in windows],
        "step_ms_traced": wall_us / n / 1e3,
        "kernels_per_step": len(kernels) / n,
        "device_busy_ms_per_step": busy_us / n / 1e3,
        "device_idle_share": (1 - busy_us / wall_us) if wall_us else None,
        "device_ms_per_step_by_group": {g: v / n / 1e3
                                        for g, v in by_group.items()},
        "top_kernels_ms_per_step": [[name[:90], v / n / 1e3]
                                    for name, v in top],
        "trace": str(trace_path),
    }
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What the stall watchdog's hooks cost the port's training step at a
world of one, on one GPU.

    python3 torch_port_watchdog_ab.py [--turns 4] [--steps 10]

Builds the step of ``chip_smoke.py`` (ResNet-50 bf16, NHWC 224x224, batch
64, ``DistributedOptimizer`` with fp16 wire and predivide 2.0), warms it
up, then runs ``--turns`` pairs of turns of ``--steps`` steps each: one
with the shipped hooks (``comm/stall.py``'s ``check`` / ``dispatch`` /
``finish`` in the bucket reduction and the sync ops, which pass through
at one rank) and one with those three replaced by the plain pass-through
they reduce to (``check`` returns None, ``dispatch`` calls the launch,
``finish`` returns its argument), in the order on, off, off, on, ...
Prints one JSON line: images/s of every turn, the median of each side,
and the card's name and power limit.  Needs one card; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import chip_smoke


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_watchdog_ab: CUDA is not available")
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.comm import stall
    from horovod_tpu_torch.models import ResNet
    from horovod_tpu_torch.ops import _build

    _build.build_all()
    smi = chip_smoke.nvidia_smi_line()
    hvd.init()
    device = hvd.device()
    try:
        torch.backends.cudnn.benchmark = True
        gen = torch.Generator().manual_seed(chip_smoke.SEED)
        model = ResNet([3, 4, 6, 3], dtype=torch.bfloat16, device=device,
                       generator=gen)
        dgen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
        x = torch.randn(chip_smoke.BATCH, chip_smoke.IMAGE, chip_smoke.IMAGE,
                        3, generator=dgen, device=device)
        y = torch.randint(0, 1000, (chip_smoke.BATCH,), generator=dgen,
                          device=device)
        opt = chip_smoke.make_optimizer(hvd, model, hvd.Compression.fp16)

        def turn(n):
            secs = []
            for _ in range(n):
                t0 = time.perf_counter()
                opt.zero_grad()
                F.cross_entropy(model(x), y).backward()
                opt.step()
                torch.cuda.synchronize(device)
                secs.append(time.perf_counter() - t0)
            return chip_smoke.BATCH * n / sum(secs)

        shipped = (stall.check, stall.dispatch, stall.finish)
        plain = (lambda st, ps, desc: None,
                 lambda st, ps, fn, args, **kw: fn(*args),
                 lambda st, ps, out, desc=None: out)

        def hooks(on: bool):
            stall.check, stall.dispatch, stall.finish = (
                shipped if on else plain)

        turn(5)                                     # warm-up
        runs = {"on": [], "off": []}
        order = []
        for i in range(args.turns):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                hooks(on)
                runs["on" if on else "off"].append(turn(args.steps))
                order.append("on" if on else "off")
        hooks(True)
    finally:
        hvd.shutdown()
    print(json.dumps({
        "card": smi, "steps_a_turn": args.steps, "order": order,
        "images_per_s": runs,
        "median_on": statistics.median(runs["on"]),
        "median_off": statistics.median(runs["off"])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

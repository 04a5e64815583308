"""The readings a cell's limits are set from, on the card at the cell's
own size.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --modes program,control,half_batch[,no_update,no_exchange] \\
        [--ranks 2]

``program``: the program's checked steps against the reference on each
seed (the lower readings; on several chips through the program's
launcher, one rank a card).  ``no_update``: the same with the program's
update left out (``opt.step()`` only synchronizes); under SGD a state
left unchanged reads 1 on every gradient, buffer and change number by
the check's own measure and needs no run, but AdamW's first gradient is
the reduced ``.grad``, which it leaves as it is.  ``control``: the
reference computed in fp8 put in the program's place (each reference's
``layers.operand``); ``fp8_branches`` and ``bf16_stats``: narrower
controls, fp8 in the residual branches' convolutions alone, the norms'
statistics in bfloat16.  ``half_batch`` (the first half of each rank's
rows: images, or sequences) and ``no_exchange``: the reference with that
fault put in the program's place (``reference/train.py``).  The exchange
exists past one rank: ``--ranks`` runs a one-chip cell's traffic on that
many (the program through the launcher, the reference's ranks in one
process).  ``layout``: the reference in channels-last memory in the
program's place, the same function through other kernels: how far
rounding alone moves each number.  Every mode runs on a configuration of
either task (``tasks/``).  Prints one JSON line a seed and mode, then
each number's largest program reading and smallest reading of each
other mode.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

from . import cell, check, run

# the controls: the reference at a lower precision in the program's place
CONTROLS = {"control": "fp8", "fp8_branches": "fp8_branches",
            "bf16_stats": "bf16_stats"}


def program_rank(spec: dict) -> list:
    """This rank's program readings on each of ``spec['seeds']``, with
    rank 0's reference readings beside them."""
    import torch

    import horovod_tpu_torch as hvd

    config, traffic = spec["config"], spec["traffic"]
    hvd.init(device="cpu" if spec["device"] == "cpu" else None)
    dev, rank, world = hvd.device(), hvd.rank(), hvd.size()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    out = []
    for seed in spec["seeds"]:
        model, opt, step, feed, weights = cell.build_program(
            hvd, config, traffic, seed, dev, rank, spec.get("fault"))
        prog = cell.program_readings(model, opt, step, feed, weights,
                                     traffic["check_steps"], world, config)
        buffers = prog.pop("buffers")
        del model, opt, step, feed, weights
        cell._free(dev)
        row = {"seed": seed, "rank": rank, "program": prog}
        if rank == 0:
            row["reference"] = cell.reference_readings(
                config, traffic, seed, world, dev, against=buffers)
            cell._free(dev)
            if dev.type == "cuda":
                torch.backends.cudnn.benchmark = True
        del buffers
        out.append(row)
    hvd.shutdown()
    return out


def rank_main(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)
    rows = program_rank(spec)
    cell.write_json(str(Path(spec["out_dir"]) / f"rank{rows[0]['rank']}.json"),
                    rows)
    return 0


def program_readings(spec: dict) -> list:
    """``[(seed, readings)]`` of the program (with ``spec['fault']``
    planted, if any), one process a rank."""
    work = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
    try:
        env = run.environment(work)
        if spec["chips"] == 1:
            os.environ["HVTPU_FLIGHT_DIR"] = env["HVTPU_FLIGHT_DIR"]
            ranks = [program_rank(spec)]
        else:
            ranks = run.launch(spec, work, env,
                               ["portbench.calibrate", "--rank-spec"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = []
    for i, seed in enumerate(spec["seeds"]):
        rows = sorted((r[i] for r in ranks), key=lambda r: r["rank"])
        digests = ([r["program"]["digest"] for r in rows]
                   if len(rows) > 1 else None)
        out.append((seed, check.readings(rows[0]["program"],
                                         rows[0]["reference"], digests)))
    return out


def reference_in_place(spec: dict, mode: str) -> list:
    """``[(seed, readings)]`` of the reference with ``mode`` (``control``,
    ``layout`` or a fault) in the program's place, all ranks in this
    process."""
    import torch

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    world = spec["traffic"]["ranks"]
    out = []
    for seed in spec["seeds"]:
        alt = cell.reference_readings(
            spec["config"], spec["traffic"], seed, world, dev,
            precision=CONTROLS.get(mode, "bf16"),
            fault=None if mode in (*CONTROLS, "layout") else mode,
            channels_last=mode == "layout", keep_buffers=True)
        ref = cell.reference_readings(spec["config"], spec["traffic"], seed,
                                      world, dev, against=alt.pop("buffers"))
        out.append((seed, check.readings(alt, ref, alt["digests"])))
        del alt, ref
        cell._free(dev)
    return out


def summary(rows: dict) -> dict:
    """Each number's largest program (and layout) reading and each
    other mode's smallest."""
    out = {}
    for mode, got in rows.items():
        pick = max if mode in ("program", "layout") else min
        names = got[0][1] if got else {}
        out[mode] = {n: pick(r[n] for _, r in got) for n in names}
    return out


def calibrate(spec: dict, modes) -> int:
    """Read each of ``modes`` on ``spec['seeds']`` and print the lines."""
    rows = {}
    for mode in modes:
        t = time.perf_counter()
        if mode in ("program", "no_update"):
            got = program_readings(dict(
                spec, fault=None if mode == "program" else mode))
        else:
            got = reference_in_place(spec, mode)
        rows[mode] = got
        for seed, r in got:
            print(json.dumps({"cell": spec["cell"], "mode": mode,
                              "seed": seed, **r}), flush=True)
        print(json.dumps({"cell": spec["cell"], "mode": mode,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"cell": spec["cell"], "summary": summary(rows)}),
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--modes", default="program,control,half_batch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--rank-spec")
    args = ap.parse_args(argv)
    if args.rank_spec:
        return rank_main(args.rank_spec)
    spec = run.make_spec(args.workload, 0, 0, 0)
    spec["device"] = args.device
    spec["seeds"] = [int(s) for s in args.seeds.split(",")]
    if args.ranks:
        spec["chips"] = spec["traffic"]["ranks"] = args.ranks
    return calibrate(spec, args.modes.split(","))


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``), its traffic
(``portbench/traffic/<traffic>.json``) and its chips; its limits are in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.  A cell on one chip runs in this
process; a cell on more starts the program's launcher (``python -m
horovod_tpu_torch.runner -np <chips>``), one rank a card, and this
process gathers what the ranks wrote.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics from a ``torch.profiler`` trace
of ``trace_steps`` steps.  The last lines on standard error, and the
line's last key, ``checks``, give each number the check compared beside
its limit.  Without CUDA, or with fewer cards than the cell asks for,
the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches the program or torch may fill, at fixed places in the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/portbench/triton",
              "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}
TRACE_DIR = "build/portbench/traces"


class RunError(Exception):
    """The run cannot produce a result (exit 2, nothing printed)."""


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def make_spec(cell: str, seed: int, seconds: float, trace: int,
              root: Path = ROOT) -> dict:
    """Everything one run of ``cell`` needs, from ``BENCHMARK.json`` and
    the cell's files."""
    bench = _read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise RunError(f"no workload {cell!r} in BENCHMARK.json")
    config = _read_json(root / "portbench" / "configs"
                        / f"{entry['config']}.json")
    traffic = _read_json(root / "portbench" / "traffic"
                         / f"{entry['traffic']}.json")
    if "port_module" in config:
        # a cell times and checks the port's own models, never a
        # stand-in; only the tests' configuration (tests/tiny.py) names one
        raise RunError(f"{cell}: configuration {entry['config']} names "
                       f"port_module {config['port_module']!r}")
    if traffic["ranks"] != entry["chips"]:
        raise RunError(f"{cell}: traffic {entry['traffic']} runs "
                       f"{traffic['ranks']} ranks on {entry['chips']} chips")
    limits_path = root / "portbench" / "limits" / f"{cell}.json"
    limits = _read_json(limits_path) if limits_path.exists() else {}
    return spec_of(bench, cell, config, traffic, limits, seed, seconds,
                   trace, root)


def spec_of(bench: dict, cell: str, config: dict, traffic: dict,
            limits: dict, seed: int, seconds: float, trace: int,
            root: Path = ROOT) -> dict:
    """A run's spec from its parts; the metrics are ``bench``'s that
    apply to ``cell``."""
    return {
        "cell": cell, "seed": int(seed), "seconds": float(seconds),
        "trace": int(trace), "chips": traffic["ranks"], "config": config,
        "traffic": traffic, "limits": limits, "device": "cuda",
        "t0": T0, "trace_dir": str(root / TRACE_DIR),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, cell)],
        "per_layer": [m["name"] for m in bench["per_layer"]
                      if _applies(m, cell)],
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }


def _mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def assemble(spec: dict, ranks: List[dict]) -> dict:
    """The result line of a run from its ranks' results."""
    from .cell import judge_ranks, p90

    ranks = sorted(ranks, key=lambda r: r["rank"])
    r0 = ranks[0]
    correct, rows = judge_ranks(ranks, spec["limits"])
    device = {"platform": "gpu" if r0["device"].startswith("cuda")
              else r0["device"],
              "kind": r0["device_name"], "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    metrics = {}
    if spec["trace"]:
        traced = [r["trace"] for r in ranks if "busy_s" in r.get("trace", {})]
        attempted = sum(r["trace"]["steps"] for r in ranks)
        if traced:
            device["busy_s"] = _mean([t["busy_s"] for t in traced])
            device["window_s"] = _mean([t["window_s"] for t in traced])
            for name in spec["per_layer"]:
                vals = [t["metrics"].get(name) for t in traced]
                if all(v is not None for v in vals):
                    metrics[name] = {"value": _mean(vals),
                                     "unit": spec["units"][name]}
    else:
        attempted = sum(r["steps"] for r in ranks)
        # samples: an image, or a sequence of a causal LM's seq_len tokens
        images = sum(r["steps"] * r["images_per_step"] for r in ranks)
        values = {"images_per_s": images / r0["wall_s"],
                  "step_ms_p90": p90(r0["step_ms"]),
                  "peak_memory_gib": device["memory_peak_bytes"] / 2 ** 30,
                  "setup_s": r0["setup_s"]}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted,
           "failed": sum(r["failed"] for r in ranks), "metrics": metrics,
           "device": device}
    if spec["trace"] and "breakdown" in r0.get("trace", {}):
        out["breakdown"] = r0["trace"]["breakdown"]
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rows}
    return out


def launch(spec: dict, work: Path, env: dict, module: List[str]
           ) -> list:
    """Start ``spec['chips']`` ranks through the program's launcher, each
    ``python -m <module...> <spec.json>``; returns what each wrote into
    ``work`` as ``rank<r>.json``, in rank order."""
    spec_path = work / "spec.json"
    with open(spec_path, "w") as f:
        json.dump(dict(spec, out_dir=str(work)), f)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(spec["chips"])]
    if spec["device"] == "cpu":
        cmd += ["--cpu-devices", "1"]
    cmd += ["--", sys.executable, "-m", *module, str(spec_path)]
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env,
                          stdout=sys.stderr, stderr=sys.stderr)
    if proc.returncode != 0:
        raise RunError(f"the launcher exited {proc.returncode}")
    files = sorted(work.glob("rank*.json"))
    if len(files) != spec["chips"]:
        raise RunError(f"{len(files)} of {spec['chips']} ranks wrote a "
                       "result")
    return [_read_json(p) for p in files]


def environment(work: Path) -> dict:
    """The run's environment: the program's caches at fixed places in
    the checkout, its flight records under the run's own directory."""
    env = dict(os.environ)
    for key, rel in CACHE_DIRS.items():
        env[key] = str(ROOT / rel)
    env["HVTPU_FLIGHT_DIR"] = str(work / "flight")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def execute(spec: dict) -> dict:
    """Run ``spec`` (this process or the launcher's ranks) and return its
    result line."""
    from . import cell

    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        env = environment(work)
        if spec["chips"] == 1:
            os.environ.update({k: env[k] for k in
                               (*CACHE_DIRS, "HVTPU_FLIGHT_DIR")})
            ranks = [cell.execute(spec)]
        else:
            ranks = launch(spec, work, env, ["portbench.worker"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = sorted(set(cell.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if found:
        raise RunError(f"modules that must not load were loaded: {found}")
    return assemble(spec, ranks)


def report(line: dict) -> None:
    for name, row in line["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = make_spec(args.workload, args.seed, args.seconds, args.trace)
        import torch

        if not torch.cuda.is_available():
            raise RunError("CUDA is not available")
        if torch.cuda.device_count() < spec["chips"]:
            raise RunError(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {spec['chips']}")
        line = execute(spec)
    except (RunError, FileNotFoundError, ImportError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

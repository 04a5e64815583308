"""Runs fabric-simulator cases of the reference (``horovod_tpu.sim``) and
of the port (``horovod_tpu_torch.sim``) side by side, each package in a
subprocess of its own under ``PYTHONHASHSEED=0`` (the interpreter the
reference's CLI re-execs into), every case of a list in one process.

A case is ``[scenario, ranks, seed, kwargs]``; the scenario
``bench-negotiation`` is the CLI's ``bench`` negotiation run.  The port
runs its controller scenarios with ``device="cpu"``.  For each case a
run leaves the event log (the canonical JSONL the CLI digests) in a
file and reports its sha256, the sha256 of the canonical ``stats`` JSON
and the stats themselves.

Run as a script: ``python tests/torch_port_sim_util.py PKG OUT CASES``
(``CASES`` a JSON object of case id -> case), or with ``--cli MODULE
OUT CALLS`` to call a CLI's ``main`` once a call (:func:`run_cli_calls`).
"""

import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("horovod_tpu", "horovod_tpu_torch")


def stats_digest(stats) -> str:
    """sha256 of the canonical JSON of a run's ``stats``."""
    return hashlib.sha256(
        json.dumps(stats, sort_keys=True).encode()).hexdigest()


def _run_cases(pkg: str, out_dir: str, cases: dict) -> None:
    import importlib

    scenarios = importlib.import_module(pkg + ".sim.scenarios")
    port = pkg == "horovod_tpu_torch"
    report = {}
    for cid, (name, ranks, seed, kwargs) in cases.items():
        kwargs = dict(kwargs, device="cpu") if port else dict(kwargs)
        t0 = time.perf_counter()
        if name == "bench-negotiation":
            result = scenarios.bench_negotiation(ranks, seed, **kwargs)
        else:
            result = scenarios.run_scenario(name, ranks, seed, **kwargs)
        wall = time.perf_counter() - t0
        log = "".join(json.dumps(rec, sort_keys=True) + "\n"
                      for rec in result["events"])
        path = os.path.join(out_dir, f"{pkg}.{cid}.jsonl")
        with open(path, "w") as f:
            f.write(log)
        report[cid] = {
            "log": path,
            "sha256": hashlib.sha256(log.encode()).hexdigest(),
            "stats_sha256": stats_digest(result["stats"]),
            "stats": result["stats"],
            "events": len(result["events"]),
            "devices": result.get("devices"),
            "wall_s": wall,
        }
    with open(os.path.join(out_dir, f"{pkg}.json"), "w") as f:
        json.dump(report, f)


def start(pkg: str, out_dir: str, cases: dict, tag: str = "") -> tuple:
    """Start one package's subprocess over ``cases``; returns the handle
    :func:`finish` takes."""
    sub = os.path.join(out_dir, f"{pkg}{tag}")
    os.makedirs(sub, exist_ok=True)
    env = dict(os.environ, PYTHONHASHSEED="0", PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu")
    # the scenarios' warnings (one a rank and peer) go to a file
    with open(os.path.join(sub, "stderr.log"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), pkg, sub,
             json.dumps(cases)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err)
    return proc, pkg, sub


def finish(handle, timeout: float = 300.0) -> dict:
    """Wait for a :func:`start`-ed run; its report by case id."""
    proc, pkg, sub = handle
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    if proc.returncode != 0:
        with open(os.path.join(sub, "stderr.log")) as f:
            err = f.read()
        raise RuntimeError(
            f"{pkg} simulator run failed (exit {proc.returncode}):\n"
            f"{err[-4000:]}")
    with open(os.path.join(sub, f"{pkg}.json")) as f:
        return json.load(f)


def run_both(cases: dict, out_dir: str, shards: int = 1,
             timeout: float = 300.0, groups=None) -> dict:
    """Every case in both packages, all processes started at once:
    ``groups`` (lists of case ids) a process each, else ``shards``
    processes a package dealt round robin; returns ``{package: {case
    id: report}}``."""
    ids = list(cases)
    if groups is None:
        groups = [ids[i::shards] for i in range(shards)]
    handles = []
    for pkg in PACKAGES:
        for i, group in enumerate(groups):
            part = {c: cases[c] for c in group}
            if part:
                handles.append(start(pkg, out_dir, part, tag=f".{i}"))
    out = {pkg: {} for pkg in PACKAGES}
    for h in handles:
        out[h[1]].update(finish(h, timeout))
    return out


def first_difference(path_a: str, path_b: str):
    """``None`` when the two logs are byte-identical, else ``(line
    number, reference line, port line)`` of the first line that
    differs (a missing line reads as ``None``)."""
    with open(path_a) as f:
        a = f.read().splitlines()
    with open(path_b) as f:
        b = f.read().splitlines()
    if a == b:
        return None
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else None
        y = b[i] if i < len(b) else None
        if x != y:
            return i, x, y
    return None


def _run_cli(module: str, out_dir: str, calls: dict) -> None:
    """Call ``module``'s ``main(argv)`` for each ``name -> argv`` of
    ``calls`` in this process, each call's stdout into
    ``<out_dir>/<name>.out`` (the interpreter already runs under
    ``PYTHONHASHSEED=0``, so ``main`` does not re-exec)."""
    import contextlib
    import importlib

    main = importlib.import_module(module).main
    for name, argv in calls.items():
        with open(os.path.join(out_dir, f"{name}.out"), "w") as f, \
                contextlib.redirect_stdout(f):
            rc = main(argv)
        if rc != 0:
            raise SystemExit(f"{module} {argv}: exit {rc}")


def run_cli_calls(module: str, calls: dict, out_dir: str):
    """Start :func:`_run_cli` in a subprocess under ``PYTHONHASHSEED=0``;
    returns the Popen.  Each call's stdout lands in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONHASHSEED="0", PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu")
    with open(os.path.join(out_dir, "stderr.log"), "w") as err:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cli", module,
             out_dir, json.dumps(calls)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err)


if __name__ == "__main__":
    if sys.argv[1] == "--cli":
        _run_cli(sys.argv[2], sys.argv[3], json.loads(sys.argv[4]))
    else:
        _run_cases(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]))

"""The port's launcher: ``python -m horovod_tpu_torch.runner`` and the
programmatic ``run()`` / ``run_elastic()``.

Counterpart of ``horovod_tpu/runner`` (parity surface:
``horovod/runner/`` — ``horovodrun`` (launch.py), ``horovod.run()``
(``__init__.py``), host parsing, safe shell execution, and the elastic
driver, ``horovod_tpu_torch.elastic.driver``)::

    python -m horovod_tpu_torch.runner -np 4 -- python train.py
    python -m horovod_tpu_torch.runner -np 2 --cpu-devices 1 -- python t.py
    python -m horovod_tpu_torch.runner --host-discovery-script ./hosts.sh \
        --min-np 2 --max-np 8 -- python train.py

    from horovod_tpu_torch.runner import run
    results = run(fn, np=2, cpu_devices=1)   # per-rank results, by rank

The function channel of ``run()`` is pickled with ``cloudpickle`` where
it is installed (closures, lambdas) and with ``pickle`` otherwise
(module-level functions only), and signed per job (``secret.py``).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional

from .hosts import (  # noqa: F401
    HostSlots,
    SlotInfo,
    get_host_assignments,
    parse_host_spec,
)
from .launch import (  # noqa: F401
    build_worker_env,
    find_free_port,
    launch_workers,
    main,
    parse_args,
    unported_settings,
)


class RunError(RuntimeError):
    """A worker failed during ``run()``; carries the rank's traceback."""

    def __init__(self, rank: int, worker_traceback: str):
        super().__init__(
            f"rank {rank} failed:\n{worker_traceback}"
        )
        self.rank = rank
        self.worker_traceback = worker_traceback


def _dump_fn(fn: Callable, args, kwargs, path: str, key: str):
    """Pickle + HMAC-sign the function blob (parity: secret.py-signed
    service messages; workers refuse unsigned/tampered payloads)."""
    from . import secret

    try:
        import cloudpickle as pickler
    except ImportError:  # module-level functions only
        import pickle as pickler
    blob = pickler.dumps((fn, tuple(args), dict(kwargs or {})))
    with open(path, "wb") as f:
        f.write(secret.sign(key, blob))


def _refuse_unported(ns, environ) -> None:
    """Raise ``ValueError`` before any spawn when the job asks for a
    setting the port does not apply (``launch.unported_settings``)."""
    unported = unported_settings(ns, environ)
    if unported:
        raise ValueError("; ".join(unported))


def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[Dict[str, Any]] = None,
    np: int = 2,
    cpu_devices: Optional[int] = None,
    hosts: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    timeout: Optional[float] = 600.0,
    start_timeout: Optional[float] = None,  # rendezvous window (env)
    extra_flags: Optional[List[str]] = None,
    verbose: bool = False,
) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` local worker processes and
    return the per-rank results, ordered by rank.

    Parity: ``horovod.run()`` (horovod/runner/__init__.py) — the
    function rides cloudpickle to each rank; each rank's return value is
    collected by the launcher.  ``cpu_devices=1`` runs every worker on
    the CPU over gloo (the localhost-as-cluster test mode).  ``timeout`` is a hard deadline for
    the whole job (None = unlimited) — unlike the CLI, the
    programmatic API defaults to bounded so test harnesses can't hang.
    ``start_timeout`` only bounds the workers' rendezvous window
    (parity: horovod.run's start_timeout), not job duration.
    """
    from . import launch as launch_mod
    from . import secret

    job_key = secret.make_secret_key()
    with tempfile.TemporaryDirectory(prefix="hvtpu_torch_run_") as tmp:
        fn_path = os.path.join(tmp, "fn.pkl")
        out_dir = os.path.join(tmp, "results")
        os.makedirs(out_dir)
        _dump_fn(fn, args, kwargs, fn_path, job_key)
        argv = ["-np", str(np)]
        if cpu_devices is not None:
            argv += ["--cpu-devices", str(cpu_devices)]
        if verbose:
            argv += ["--verbose"]
        if start_timeout is not None:
            argv += ["--start-timeout", str(start_timeout)]
        argv += extra_flags or []
        argv += [
            sys.executable, "-m", "horovod_tpu_torch.runner.run_task",
            fn_path, out_dir,
        ]
        ns = launch_mod.parse_args(argv)
        base_env = dict(os.environ)
        base_env.update(env or {})
        _refuse_unported(ns, base_env)
        # key travels by 0600 file, not env value: the ssh path
        # serializes the worker env into world-readable argv (the
        # fn/result channel already requires a shared filesystem, so
        # the key file rides the same one)
        key_path = os.path.join(tmp, "job.key")
        secret.write_key_file(job_key, key_path)
        base_env[secret.ENV_KEY_FILE] = key_path
        base_env.pop(secret.ENV_KEY, None)
        # hosts: e.g. "localhost:2,127.0.0.1:2" to shape local/cross
        # topology while still spawning locally (both names are local)
        host_spec = hosts or f"localhost:{np}"
        slots = get_host_assignments(parse_host_spec(host_spec), np)
        port = launch_mod.find_free_port()
        code = launch_workers(
            ns.command,
            slots,
            "127.0.0.1",
            port,
            args=ns,
            base_env=base_env,
            job_timeout=timeout,
        )
        # Collect every rank's payload FIRST, then report the most
        # informative failure: a rank that wrote (ok=False, traceback)
        # beats 'no result file' from a peer the launcher terminated.
        payloads: Dict[int, tuple] = {}
        bad_signature: Dict[int, str] = {}
        for r in range(np):
            path = os.path.join(out_dir, f"rank_{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    # verify the worker's signature before unpickling —
                    # result files cross the same trust boundary as the
                    # shipped function.  A bad signature on one rank must
                    # not abort collection of the rest: record it and keep
                    # going so the report carries every rank's status
                    # (the tampered blob is still never unpickled).
                    try:
                        blob = secret.verify(job_key, f.read())
                    except secret.SignatureError as e:
                        bad_signature[r] = str(e)
                        continue
                payloads[r] = pickle.loads(blob)
        def _others(r: int) -> str:
            return "Other ranks: " + ", ".join(
                f"rank {q}: "
                + ("failed" if q in payloads and not payloads[q][0] else
                   "ok" if q in payloads else
                   "bad signature" if q in bad_signature else
                   "no result file")
                for q in range(np) if q != r
            )

        for r in range(np):
            item = payloads.get(r)
            if item is not None and not item[0]:
                # a concurrent tampering signal must not be buried under
                # an ordinary worker crash — carry every rank's status
                raise RunError(r, item[1] + "\n" + _others(r))
        if bad_signature:
            r = min(bad_signature)
            raise RunError(
                r,
                f"result file failed signature verification "
                f"({bad_signature[r]}); the blob was not unpickled. "
                + _others(r),
            )
        for r in range(np):
            if r not in payloads:
                raise RunError(
                    r,
                    f"no result file (worker exit code {code}; it may "
                    "have crashed or been terminated before writing "
                    "results)",
                )
        if code != 0:
            raise RunError(-1, f"launcher observed exit code {code}")
        return [payloads[r][1] for r in range(np)]


def run_elastic(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[Dict[str, Any]] = None,
    num_proc: int = 2,
    min_np: Optional[int] = None,
    max_np: Optional[int] = None,
    cpu_devices: Optional[int] = None,
    host_discovery_script: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    start_timeout: Optional[float] = None,
    verbose: bool = False,
) -> List[Any]:
    """Run ``fn`` under the ELASTIC driver and return per-rank results
    of the final world, ordered by rank.

    Parity: ``horovod.spark.run_elastic`` (horovod/spark/__init__.py)
    / the elastic half of ``horovodrun`` — ``fn`` is expected to follow
    the elastic contract (build a ``hvd.elastic.TorchState``, decorate
    the loop with ``@hvd.elastic.run``); membership changes restart it
    from the last commit.  Without ``host_discovery_script`` a static
    ``localhost:num_proc`` discovery is generated (the reference's
    local-mode CI shape); with one, the world resizes live as its
    output changes.
    """
    from . import launch as launch_mod
    from . import secret
    from ..elastic.driver import run_elastic_driver

    job_key = secret.make_secret_key()
    with tempfile.TemporaryDirectory(prefix="hvtpu_torch_el_") as tmp:
        fn_path = os.path.join(tmp, "fn.pkl")
        out_dir = os.path.join(tmp, "results")
        os.makedirs(out_dir)
        _dump_fn(fn, args, kwargs, fn_path, job_key)
        if host_discovery_script is None:
            host_discovery_script = os.path.join(tmp, "discover.sh")
            with open(host_discovery_script, "w") as f:
                f.write(f"#!/bin/sh\necho localhost:{num_proc}\n")
            os.chmod(host_discovery_script, 0o755)
        argv = ["--host-discovery-script", host_discovery_script,
                "-np", str(num_proc)]
        if min_np is not None:
            argv += ["--min-np", str(min_np)]
        if max_np is not None:
            argv += ["--max-np", str(max_np)]
        if cpu_devices is not None:
            argv += ["--cpu-devices", str(cpu_devices)]
        if start_timeout is not None:
            argv += ["--start-timeout", str(start_timeout)]
        if verbose:
            argv += ["--verbose"]
        argv += ["--", sys.executable, "-m",
                 "horovod_tpu_torch.runner.run_task", fn_path, out_dir]
        ns = launch_mod.parse_args(argv)
        _refuse_unported(ns, {**os.environ, **(env or {})})
        key_path = os.path.join(tmp, "job.key")
        secret.write_key_file(job_key, key_path)
        # the elastic driver builds worker env from the launcher's
        # process env; scope the additions to this call
        added = {secret.ENV_KEY_FILE: key_path, **(env or {})}
        # the key must travel by file, never env value (the ssh path
        # serializes env into argv) — and the caller's own value must
        # come back afterwards, so it joins the save/restore set
        saved = {k: os.environ.get(k)
                 for k in (*added, secret.ENV_KEY)}
        os.environ.update(added)
        os.environ.pop(secret.ENV_KEY, None)
        try:
            code, driver = run_elastic_driver(ns)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if code != 0:
            raise RunError(-1, f"elastic driver exit code {code}")
        # collect the FINAL world's results only: a shrink leaves
        # higher-rank files from earlier incarnations behind, and a
        # recovered crash leaves an ok=False file — both stale
        final_np = driver.final_world_size or 0
        results: Dict[int, Any] = {}
        for name in sorted(os.listdir(out_dir)):
            if not (name.startswith("rank_") and name.endswith(".pkl")):
                continue
            r = int(name[len("rank_"):-len(".pkl")])
            if r >= final_np:
                continue
            try:
                with open(os.path.join(out_dir, name), "rb") as f:
                    blob = secret.verify(job_key, f.read())
            except secret.SignatureError as e:
                raise RunError(
                    r, f"result file failed signature verification "
                       f"({e}); the blob was not unpickled.")
            ok, payload = pickle.loads(blob)
            if not ok:
                raise RunError(r, payload)
            results[r] = payload
        missing = [r for r in range(final_np) if r not in results]
        if missing:
            raise RunError(
                missing[0],
                f"no result file for rank(s) {missing} of the final "
                f"{final_np}-rank world")
        return [results[r] for r in sorted(results)]

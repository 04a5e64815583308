"""Execution backends for the Spark estimators (counterpart of
``horovod_tpu/spark/common/backend.py``).

Parity surface: ``horovod/spark/common/backend.py`` (``Backend``,
``SparkBackend``) — the reference's Backend answers two questions for
an estimator: how many training processes, and "run this function on
all of them and give me the per-rank results".

Ranks are placed by the port's launcher (``horovod_tpu_torch.runner``:
one local worker process a rank), not by Spark executor placement.
``LocalBackend`` is therefore the real implementation; ``SparkBackend``
probes for pyspark, reads its parallelism for the default ``num_proc``,
and executes through the same launcher in local mode (the reference's
own CI runs its estimators on local-mode Spark).

Every rank runs on the card (NCCL on ``cuda:{local_rank}``) unless the
caller asks for the CPU with ``cpu_devices=1`` (gloo).  A host with
fewer cards than ranks fails in the workers' ``init()``, naming
``--cpu-devices 1``; nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class Backend:
    """run(fn) across ranks + num_processes (reference Backend ABC)."""

    def num_processes(self) -> int:
        raise NotImplementedError

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[Dict[str, Any]] = None,
            env: Optional[Dict[str, str]] = None) -> List[Any]:
        raise NotImplementedError


class LocalBackend(Backend):
    """Estimator execution over the port's local launcher: real worker
    processes, real cross-process collectives (NCCL on the cards by
    default, gloo on the CPU when ``cpu_devices=1``)."""

    def __init__(self, num_proc: int = 2,
                 cpu_devices: Optional[int] = None,
                 start_timeout: Optional[float] = None,
                 verbose: bool = False):
        self._np = num_proc
        self._cpu_devices = cpu_devices
        self._start_timeout = start_timeout
        self._verbose = verbose

    def num_processes(self) -> int:
        return self._np

    def run(self, fn, args=(), kwargs=None, env=None):
        from ... import runner

        return runner.run(
            fn, args=args, kwargs=kwargs, np=self._np,
            cpu_devices=self._cpu_devices, env=env,
            start_timeout=self._start_timeout, verbose=self._verbose,
        )


class SparkBackend(LocalBackend):
    """pyspark-aware backend: takes ``num_proc`` from the active
    SparkSession's default parallelism when not given, then executes
    through the local launcher (executor placement is out of scope; the
    collective fabric is the launcher's either way)."""

    def __init__(self, num_proc: Optional[int] = None, **kwargs):
        if num_proc is None:
            num_proc = self._spark_parallelism() or 2
        super().__init__(num_proc=num_proc, **kwargs)

    @staticmethod
    def _spark_parallelism() -> Optional[int]:
        try:
            from pyspark.sql import SparkSession
        except ImportError:
            return None
        session = SparkSession.getActiveSession()
        if session is None:
            return None
        return session.sparkContext.defaultParallelism

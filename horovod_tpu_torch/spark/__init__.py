"""Spark integration surface, local-mode functional (counterpart of
``horovod_tpu/spark``).

Parity surface: ``horovod.spark`` (horovod/spark/__init__.py /
runner.py + common/ + torch/ + keras/) — ``run(fn)`` executes one
Horovod rank per process and returns per-rank results, and the
Estimator surface (``TorchEstimator``/``KerasEstimator`` over a
``Store`` + ``Backend``) gives DataFrame-in → trained-Model-out::

    from horovod_tpu_torch.spark import LocalStore, TorchEstimator
    est = TorchEstimator(model=model, optimizer=opt, loss=loss_fn,
                         feature_cols=["features"], label_cols=["label"],
                         store=LocalStore("/shared/run"), num_proc=1)
    trained = est.fit(df)                 # ranks on the card
    out = trained.transform(df)           # "label__output" appended

A Spark-executor *placement* backend is out of scope; everything else
is the same API executed in **local mode**: ranks are launched as local
worker processes through the port's launcher (the reference itself runs
its estimator CI on local-mode Spark), DataFrames are pandas/dict frames
(pyspark frames accepted when pyspark is importable), and Petastorm's
role is played by columnar npz materialization in the Store
(``common.data``).

Every entry point runs its ranks on the card (NCCL on
``cuda:{local_rank}``) unless the caller asks for the CPU with
``cpu_devices=1`` (gloo); a host with fewer cards than ranks fails in
the workers' ``init()``, naming ``--cpu-devices 1``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .common import (  # noqa: F401
    Backend,
    EstimatorParams,
    FilesystemStore,
    HorovodEstimator,
    HorovodModel,
    LocalBackend,
    LocalStore,
    SparkBackend,
    Store,
)
from .keras import KerasEstimator, KerasModel  # noqa: F401
from .torch import TorchEstimator, TorchModel  # noqa: F401


def run(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[Dict[str, Any]] = None,
    num_proc: Optional[int] = None,
    extra_mpi_args=None,        # accepted for source compat; unused
    env: Optional[Dict[str, str]] = None,
    start_timeout: Optional[float] = None,
    verbose: int = 0,
    cpu_devices: Optional[int] = None,
) -> List[Any]:
    """Run ``fn`` on ``num_proc`` ranks and return per-rank results.

    Local-mode execution via the port's launcher: same signature shape
    and return convention as the reference's ``horovod.spark.run`` (fn
    rides pickle to each rank; results come back ordered by rank).  The
    ranks run on the card; ``cpu_devices=1`` runs them on the CPU over
    gloo.
    """
    from .. import runner

    return runner.run(
        fn, args=args, kwargs=kwargs, np=num_proc or 2,
        cpu_devices=cpu_devices, env=env, verbose=bool(verbose),
        start_timeout=start_timeout,
    )


def run_elastic(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[Dict[str, Any]] = None,
    num_proc: Optional[int] = None,
    min_np: Optional[int] = None,
    max_np: Optional[int] = None,
    env: Optional[Dict[str, str]] = None,
    start_timeout: Optional[float] = None,
    verbose: int = 0,
    cpu_devices: Optional[int] = None,
) -> List[Any]:
    """Run ``fn`` under the elastic driver (parity:
    ``horovod.spark.run_elastic``): ``fn`` follows the elastic contract
    (``hvd.elastic.TorchState`` + ``@hvd.elastic.run``), and membership
    changes restart it from the last commit.  Local-mode execution —
    Spark-executor *placement* stays out of scope, exactly as with
    :func:`run`; the ranks run on the card unless ``cpu_devices=1``."""
    from .. import runner

    return runner.run_elastic(
        fn, args=args, kwargs=kwargs, num_proc=num_proc or 2,
        min_np=min_np, max_np=max_np, cpu_devices=cpu_devices,
        env=env, start_timeout=start_timeout, verbose=bool(verbose),
    )

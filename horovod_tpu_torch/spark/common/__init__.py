"""Shared estimator infrastructure (counterpart of
``horovod_tpu/spark/common``; reference: horovod/spark/common/)."""

from .backend import Backend, LocalBackend, SparkBackend  # noqa: F401
from .estimator import HorovodEstimator, HorovodModel  # noqa: F401
from .params import EstimatorParams  # noqa: F401
from .store import FilesystemStore, LocalStore, Store  # noqa: F401

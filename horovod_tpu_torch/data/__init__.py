"""horovod_tpu_torch.data — elastic-aware sharded input pipeline
(counterpart of ``horovod_tpu/data``).

Checkpointable iterators over deterministic sample-space shards:
``ElasticDataLoader`` prefetches on a background thread (and copies
onto the training device on its own CUDA stream), registers its
``LoaderState`` with the elastic state for exactly-once sample delivery
across preemptions and resizes, and agrees epoch boundaries across
ranks.
"""

from .loader import ElasticDataLoader, LoaderState, quiesce_all
from .sharder import (Sharder, epoch_permutation, shard_window,
                      steps_remaining)
from .sources import (ArraySource, DataSource, FileListSource,
                      SyntheticSource, map_structure)

__all__ = [
    "ElasticDataLoader",
    "LoaderState",
    "quiesce_all",
    "Sharder",
    "epoch_permutation",
    "shard_window",
    "steps_remaining",
    "DataSource",
    "ArraySource",
    "FileListSource",
    "SyntheticSource",
    "map_structure",
]

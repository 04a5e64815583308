"""Torch-surface elastic state.

Counterpart of ``horovod_tpu/torch/elastic.py`` (parity:
``horovod/torch/elastic/state.py`` ``TorchState`` and
``horovod/torch/elastic/sampler.py`` ``ElasticSampler``): capture
``nn.Module`` / optimizer ``state_dict``s for commit and rollback,
broadcast them on sync, and reshard the sampler when the world changes.

The in-memory snapshot copies the ``state_dict``s where they live (on
the card for a model on the card); the durable payload is host tensors
serialized with ``torch.save`` (``elastic/state.py``), and a load puts
them on this process's device before ``load_state_dict`` copies them in.
Every ``elastic`` name is re-exported here, so ``hvd.elastic.run``,
``hvd.elastic.ObjectState`` and the exceptions are reached the
reference's way.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from ..core.exceptions import (  # noqa: F401
    DrainInterrupt,
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from ..elastic.state import ObjectState, ShardedTorchState, State  # noqa: F401
from ..elastic.worker import RESET_EXIT_CODE, run  # noqa: F401


class TorchState(ObjectState):
    """Elastic state tracking torch modules/optimizers plus plain
    attributes (parity: TorchState(model=..., optimizer=..., epoch=0)).

    Modules and optimizers (and anything else with ``state_dict()``,
    such as a data loader's ``LoaderState``, which is restored in place)
    are captured via ``state_dict()`` / ``load_state_dict()``;
    everything else behaves like ObjectState.
    """

    def __init__(self, model=None, optimizer=None, **kwargs):
        self._handles: Dict[str, Any] = {}
        if model is not None:
            self._handles["model"] = model
        if optimizer is not None:
            self._handles["optimizer"] = optimizer
        # also accept arbitrary named modules/optimizers in kwargs
        plain = {}
        for k, v in list(kwargs.items()):
            if isinstance(v, torch.nn.Module) or hasattr(v, "state_dict"):
                self._handles[k] = v
            else:
                plain[k] = v
        super().__init__(**plain)
        for k, v in self._handles.items():
            setattr(self, k, v)
        self.save_to_memory()

    # -- payload capture over state_dicts --
    def _capture(self) -> Dict[str, Any]:
        payload = {
            k: copy.deepcopy(getattr(self, k)) for k in self._tracked
        }
        for k, h in self._handles.items():
            payload["__sd__" + k] = copy.deepcopy(h.state_dict())
        return payload

    def _apply(self, payload: Dict[str, Any]):
        for k, v in payload.items():
            if k.startswith("__sd__"):
                self._handles[k[len("__sd__"):]].load_state_dict(v)
            else:
                setattr(self, k, v)


class ElasticSampler(torch.utils.data.Sampler):
    """Distributed sampler that reshards on world changes and skips
    already-processed indices after a restore (parity: ElasticSampler).
    """

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        from ..core.state import rank as hvd_rank
        from ..core.state import size as hvd_size

        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()
        self.rank = hvd_rank()
        self.num_replicas = hvd_size()
        self._reshard()

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.processed_indices = set()
        self._reshard()

    def record_batch(self, batch_idx: int, batch_size: int):
        """Mark ``batch_size`` samples starting at ``batch_idx`` as
        processed so a restore doesn't revisit them."""
        lo = batch_idx * batch_size
        self.processed_indices.update(self.indices[lo:lo + batch_size])

    def load_state_dict(self, sd: Dict[str, Any]):
        self.epoch = sd["epoch"]
        self.processed_indices = set(sd["processed_indices"])
        self._reshard()

    def state_dict(self) -> Dict[str, Any]:
        return {
            "epoch": self.epoch,
            "processed_indices": sorted(self.processed_indices),
        }

    def _reshard(self):
        from ..core.state import rank as hvd_rank
        from ..core.state import size as hvd_size

        self.rank = hvd_rank()
        self.num_replicas = hvd_size()
        remaining = [
            i for i in range(len(self.dataset))
            if i not in self.processed_indices
        ]
        if self.shuffle:
            g = torch.Generator()
            g.manual_seed(self.seed + self.epoch)
            perm = torch.randperm(len(remaining), generator=g).tolist()
            remaining = [remaining[i] for i in perm]
        # drop the tail so every replica sees the same count
        per = len(remaining) // self.num_replicas
        self.indices = remaining[
            self.rank * per:(self.rank + 1) * per
        ]

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


__all__ = [
    "State", "ObjectState", "TorchState", "ShardedTorchState",
    "ElasticSampler", "run",
    "RESET_EXIT_CODE", "HorovodInternalError", "HostsUpdatedInterrupt",
    "DrainInterrupt",
]

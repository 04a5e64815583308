"""Elastic training: commit/restore state over restart-based membership
changes (counterpart of ``horovod_tpu/elastic``; parity: ``hvd.elastic``).

Worker-side usage (the reference's shape)::

    import horovod_tpu_torch as hvd

    hvd.init()
    state = hvd.elastic.TorchState(model, optimizer, epoch=0)

    @hvd.elastic.run
    def train(state):
        while state.epoch < EPOCHS:
            ...train one step...
            state.commit()

    train(state)

``HVTPU_ELASTIC=1`` arms the preemption watcher at ``init()``;
``HVTPU_ELASTIC_STATE_DIR`` names the durable commit directory and
``HVTPU_ELASTIC_GENERATION`` the incarnation.

Launcher side (``driver.py``, ``discovery.py``)::

    python -m horovod_tpu_torch.runner --host-discovery-script ./hosts.sh \
        --min-np 2 --max-np 8 -- python train.py

The driver polls the discovery script, relaunches the world on a fresh
coordinator port after a crash (charged to ``--max-restarts``), a reset
(exit 73, or SIGUSR1 it sends on a host update), a drain (exit 79) or a
fence (exit 89), and exits 0 once an incarnation ends cleanly.  ``JaxState`` and ``ShardedJaxState`` are the JAX package's:
``TorchState`` and ``ElasticSampler`` (``horovod_tpu_torch.torch.elastic``,
also exported here, so ``hvd.elastic`` is the same surface from the
package root and from ``horovod_tpu_torch.torch``) and ``ObjectState``
carry tensors here, and ``ShardedTorchState`` carries global arrays
sharded across processes (``DTensor``s), committed by every process
through ``api/sharded_checkpoint.py`` and resharded onto the new world's
layouts at ``sync()``::

    from horovod_tpu_torch.models import transformer as tfm

    state = hvd.elastic.ShardedTorchState(
        params=tfm.global_params(model.state_dict(), cfg, layout), step=0)
    state.sync()                # after a restart: onto this layout
    model.load_state_dict(tfm.local_params(state.params))
"""

from ..core.exceptions import (  # noqa: F401
    DrainInterrupt,
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from .state import ObjectState, ShardedTorchState, State  # noqa: F401
from .worker import RESET_EXIT_CODE, run  # noqa: F401

__all__ = [
    "State", "ObjectState", "TorchState", "ShardedTorchState",
    "ElasticSampler", "run",
    "RESET_EXIT_CODE", "HorovodInternalError", "HostsUpdatedInterrupt",
    "DrainInterrupt",
]


def __getattr__(name: str):
    # TorchState and ElasticSampler live in torch/elastic.py, which
    # imports this package: resolve them at first use
    if name in ("TorchState", "ElasticSampler"):
        from ..torch import elastic as torch_elastic

        return getattr(torch_elastic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Lightning estimator: param-compatible N/A shim (counterpart of
``horovod_tpu/spark/lightning``).

Parity surface: ``horovod/spark/lightning/ (LightningEstimator)``.
pytorch-lightning is not a dependency of this build, so a TESTED port
is impossible here; this shim keeps the reference's import path and
constructor signature importable and fails fast with guidance instead
of an AttributeError deep inside user code.  The supported migration
is ``horovod_tpu_torch.spark.TorchEstimator`` with a plain ``nn.Module`` —
or install lightning and drive your ``LightningModule``'s
``training_step`` yourself (see docs/migration.md, "Estimator
surface").
"""

from __future__ import annotations

_GUIDANCE = (
    "LightningEstimator is not available in this build: "
    "pytorch-lightning is not a dependency. Migrate to "
    "horovod_tpu_torch.spark.TorchEstimator with a plain nn.Module "
    "(same fit(df)->Model->transform lifecycle over a Store), or "
    "install pytorch-lightning and invoke your LightningModule's "
    "training_step from a TorchEstimator loss callable. See "
    "docs/migration.md section 'Estimator surface: edges and scope'."
)


class LightningEstimator:
    """Reference-shaped constructor that raises with migration
    guidance (parity: horovod/spark/lightning/estimator.py)."""

    def __init__(self, model=None, *, num_proc=None, backend=None,
                 store=None, loader_num_epochs=None, input_shapes=None,
                 feature_cols=None, label_cols=None, validation=None,
                 batch_size=None, epochs=None, verbose=None,
                 callbacks=None, random_seed=None, run_id=None,
                 train_steps_per_epoch=None,
                 validation_steps_per_epoch=None,
                 transformation_fn=None, **kwargs):
        raise ImportError(_GUIDANCE)


class LightningModel:
    def __init__(self, *args, **kwargs):
        raise ImportError(_GUIDANCE)


# The reference exports the lightning estimator under this name
# (horovod/spark/lightning/__init__.py: `from ...estimator import
# TorchEstimator`) — keep the upstream import path working.
TorchEstimator = LightningEstimator
TorchModel = LightningModel

"""TF/Keras elastic state (counterpart of
``horovod_tpu/tensorflow/elastic.py``; parity:
``horovod/tensorflow/elastic.py``): model and optimizer weights captured
as host arrays for commit and rollback, over the port's
``ObjectState``, whose ``sync`` broadcasts rank 0's payload and whose
durable commits go through ``core/durable.py``."""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np

from ..elastic import run  # noqa: F401  (parity: hvd.elastic.run)
from ..elastic.state import ObjectState


class TensorFlowState(ObjectState):
    """Elastic state over a list of ``tf.Variable``s (parity:
    ``TensorFlowState(variables, session)``).  TF2-eager: pass the
    variables explicitly (the reference's no-argument default reads the
    TF1 global-variables collection, which does not exist eagerly)."""

    def __init__(self, variables=None, **kwargs):
        if variables is None:
            raise ValueError(
                "TensorFlowState needs an explicit `variables` list "
                "(TF2 eager has no global-variables collection); pass "
                "e.g. model.trainable_variables")
        self._variables = list(variables)
        super().__init__(**kwargs)  # ObjectState snapshots at the end

    def _capture(self) -> Dict[str, Any]:
        payload = super()._capture()
        payload["__vars__"] = [np.asarray(v.numpy())
                               for v in self._variables]
        return payload

    def _apply(self, payload: Dict[str, Any]):
        for k, v in payload.items():
            if k == "__vars__":
                if len(v) != len(self._variables):
                    raise ValueError(
                        f"snapshot holds {len(v)} variables but this "
                        f"state tracks {len(self._variables)} — the "
                        "variable list changed since the commit; "
                        "refusing a partial restore")
                for var, val in zip(self._variables, v):
                    var.assign(val)
            else:
                setattr(self, k, v)


class TensorFlowKerasState(ObjectState):
    """Elastic state of a keras model (and optionally its optimizer) plus
    plain attributes (parity: TensorFlowKerasState(model, optimizer,
    batch=0, epoch=0))."""

    def __init__(self, model, optimizer=None, **kwargs):
        self._model_handle = model
        self._opt_handle = optimizer
        super().__init__(**kwargs)
        self.model = model
        self.optimizer = optimizer
        self.save_to_memory()

    def _capture(self) -> Dict[str, Any]:
        payload = {
            k: copy.deepcopy(getattr(self, k)) for k in self._tracked
        }
        payload["__model_weights__"] = [
            np.asarray(w) for w in self._model_handle.get_weights()
        ]
        if self._opt_handle is not None:
            payload["__opt_vars__"] = [np.asarray(v)
                                       for v in self._opt_vars()]
        return payload

    def _opt_vars(self):
        opt_vars = self._opt_handle.variables
        if callable(opt_vars):  # legacy optimizers: a method
            opt_vars = opt_vars()
        return opt_vars

    def _apply(self, payload: Dict[str, Any]):
        for k, v in payload.items():
            if k == "__model_weights__":
                self._model_handle.set_weights(list(v))
            elif k == "__opt_vars__":
                opt_vars = self._opt_vars()
                if len(opt_vars) != len(v) \
                        and not getattr(self._opt_handle, "built", True):
                    # an elastic restart holds a fresh optimizer whose
                    # slots do not exist until it is built: build it on
                    # the model's trainables, then restore
                    try:
                        self._opt_handle.build(
                            self._model_handle.trainable_variables)
                    except Exception:  # noqa: BLE001 — the count check
                        pass           # below refuses what did not build
                    opt_vars = self._opt_vars()
                if len(opt_vars) != len(v):
                    raise ValueError(
                        f"snapshot holds {len(v)} optimizer variables "
                        f"but the live optimizer has {len(opt_vars)} "
                        "— commit after the optimizer's first step, "
                        "or pass a built optimizer; refusing a "
                        "partial restore")
                for var, val in zip(opt_vars, v):
                    var.assign(val)
            else:
                setattr(self, k, v)

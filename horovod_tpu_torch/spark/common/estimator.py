"""Estimator/Model base classes — the shared fit/transform lifecycle
(counterpart of ``horovod_tpu/spark/common/estimator.py``).

Parity surface: ``horovod/spark/common/estimator.py``
(``HorovodEstimator``, ``HorovodModel``): ``fit(df)`` materializes the
DataFrame into the Store, launches distributed training through the
Backend (one Horovod rank per process), loads the trained artifacts
back on the driver, and returns a Model whose ``transform(df)`` appends
prediction columns.  The reference subclasses pyspark's
``Estimator``/``Model``; here the same lifecycle runs over pandas /
dict-of-columns frames (pyspark frames are accepted and collected —
see common.data), so the surface works with or without a Spark
installation.  With no ``backend`` the ranks run on the card
(``LocalBackend``'s default).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List

from . import data as data_mod
from .backend import Backend, LocalBackend
from .params import EstimatorParams, Params


def resolve_compression(hvd_frontend, value):
    """Estimator ``compression`` param → frontend compressor class.
    Accepts the reference's style (a compressor object/class, e.g.
    ``hvd.Compression.fp16``) or a name string; a typo gets a clear
    error naming the options.  Shared by the torch and keras
    trainers."""
    if value is None:
        return hvd_frontend.Compression.none
    if isinstance(value, str):
        comp = getattr(hvd_frontend.Compression, value, None)
        if comp is None or value.startswith("_"):
            options = [a for a in dir(hvd_frontend.Compression)
                       if not a.startswith("_") and a != "from_name"]
            raise ValueError(
                f"unknown compression {value!r}; options: {options}")
        return comp
    return value


class HorovodEstimator(EstimatorParams):
    """fit(df) → trained HorovodModel, over Store + Backend."""

    # -- subclass hooks ----------------------------------------------
    def _remote_trainer(self):
        """Module-level worker function (rides the launcher's signed
        pickle channel by reference, not by value)."""
        raise NotImplementedError

    def _serialize_training_spec(self) -> Dict[str, Any]:
        """Framework-specific picklable bundle shipped to every rank."""
        raise NotImplementedError

    def _create_model(self, rank_results: List[Any], run_id: str,
                      store) -> "HorovodModel":
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------
    def _check_params(self):
        if self.getModel() is None:
            raise ValueError("model param is required")
        if not self.getFeatureCols():
            raise ValueError("feature_cols param is required")
        if not self.getLabelCols():
            raise ValueError("label_cols param is required")
        if self.getStore() is None:
            raise ValueError(
                "store param is required (e.g. LocalStore(prefix)) — "
                "it holds materialized data and run checkpoints")
        if self.getResumeFromCheckpoint() and not self.getRunId():
            raise ValueError(
                "resume_from_checkpoint=True requires an explicit "
                "run_id (each fit otherwise generates a fresh run id "
                "whose checkpoint path cannot exist — the resume "
                "would silently no-op)")
        if self.getSampleWeightCol() is not None \
                and self.getTransformationFn() is not None:
            raise ValueError(
                "sample_weight_col cannot be combined with "
                "transformation_fn: the transform may reorder or "
                "resize rows and the weight column would silently "
                "misalign; fold the weighting into the "
                "transformation instead")

    def _resolve_backend(self) -> Backend:
        backend = self.getBackend()
        if backend is None:
            backend = LocalBackend(num_proc=self.getNumProc() or 2)
        return backend

    def fit(self, df) -> "HorovodModel":
        self._check_params()
        store = self.getStore()
        backend = self._resolve_backend()
        run_id = self.getRunId() or f"run_{uuid.uuid4().hex[:12]}"
        n_train, n_val = data_mod.materialize(
            df, store,
            feature_cols=list(self.getFeatureCols()),
            label_cols=list(self.getLabelCols()),
            validation=self.getValidation(),
            sample_weight_col=self.getSampleWeightCol(),
            seed=self.getRandomSeed(),
        )
        spec = self._serialize_training_spec()
        spec.update(
            store_prefix=store.prefix_path,
            run_id=run_id,
            n_train=n_train,
            n_val=n_val,
            params={
                k: v for k, v in self.param_dict().items()
                # objects that must not ride the wire (store/backend are
                # driver-side; model/loss/... travel inside `spec`)
                if k not in ("store", "backend", "model", "loss",
                             "optimizer", "custom_objects", "callbacks",
                             "metrics", "transformation_fn")
            },
        )
        results = backend.run(self._remote_trainer(), args=(spec,))
        return self._create_model(results, run_id, store)


class HorovodModel(Params):
    """Trained-model half of the lifecycle (reference: HorovodModel).

    ``transform(df)`` appends prediction columns named by
    ``output_cols`` (default ``<label>__output``, the reference's
    convention); ``getHistory()`` exposes per-epoch training history.
    """

    _param_defs = {
        "model": None,
        "feature_cols": None,
        "label_cols": None,
        "output_cols": None,
        "run_id": None,
        "store": None,
        "history": None,
        "batch_size": 128,
    }

    def _predict_columns(self, features: Dict[str, Any]) -> List[Any]:
        """Framework forward pass → list of per-output-column arrays."""
        raise NotImplementedError

    def _output_col_names(self) -> List[str]:
        out = self.getOutputCols()
        if out:
            return list(out)
        return [f"{c}__output" for c in self.getLabelCols()]

    def transform(self, df):
        """Append prediction columns; returns the same frame kind it
        was given (pandas → pandas copy, dict → dict copy, pyspark →
        pandas)."""
        if hasattr(df, "toPandas") and not hasattr(df, "assign"):
            df = df.toPandas()  # collect ONCE; to_columns reuses it
        features = data_mod.to_columns(df, list(self.getFeatureCols()))
        outputs = self._predict_columns(features)
        names = self._output_col_names()
        if len(outputs) != len(names):
            raise ValueError(
                f"model produced {len(outputs)} output column(s) but "
                f"output_cols names {len(names)}: {names}")
        if isinstance(df, dict):
            out = dict(df)
            out.update(zip(names, outputs))
            return out
        return df.assign(**dict(zip(names, outputs)))

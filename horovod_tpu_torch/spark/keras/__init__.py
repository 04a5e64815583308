"""KerasEstimator — Spark-style estimator over the port's keras
frontend (counterpart of ``horovod_tpu/spark/keras``).

Parity surface: ``horovod/spark/keras/estimator.py``
(``KerasEstimator``, ``KerasModel``) + ``.../keras/remote.py``: fit()
rebuilds the model on every rank from its architecture JSON + initial
weights, compiles it with the wrapped ``DistributedOptimizer`` and the
Horovod callbacks (broadcast at start, metric averaging), trains
``model.fit`` on the rank's shard, checkpoints through the Store, and
returns a KerasModel for transform().

The gradients under the wrapped optimizer go through
``horovod_tpu_torch.keras`` (tf tensors bridged onto the torch engine
by DLPack); each rank calls its ``init()`` before importing keras, so
it runs on the card unless the backend asks for the CPU
(``cpu_devices=1``).  Data is the Store's materialized npz
(common.data), not Petastorm.  The optimizer ships as a keras config
dict (not pickle) — its slot variables are rank-local and must be built
fresh against the rebuilt model; the rest rides the launcher's one
pickle of the spec (``runner.pickler``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from ..common.data import TRAIN_NPZ, VAL_NPZ, load_shard
from ..common.estimator import (
    HorovodEstimator,
    HorovodModel,
    resolve_compression,
)

CHECKPOINT_FILE = "checkpoint.npz"
MODEL_JSON_FILE = "model.json"


def _keras_trainer(spec: Dict[str, Any]):
    """Per-rank training loop (reference: keras/remote.py) —
    module-level so the launcher channel pickles it by reference."""
    import numpy as np

    import horovod_tpu_torch.keras as hvd
    from ..common.store import FilesystemStore

    hvd.init()
    import keras

    p = spec["params"]
    seed = p.get("random_seed")
    if seed is not None:
        keras.utils.set_random_seed(seed + hvd.rank())

    model = keras.models.model_from_json(
        spec["model_json"], custom_objects=spec["custom_objects"])
    model.set_weights(spec["weights"])
    # Resume (parity: reference checkpoint-resume on refit): rank 0
    # loads the run's latest Store checkpoint over the shipped
    # weights; BroadcastGlobalVariablesCallback propagates them.
    if p.get("resume_from_checkpoint") and hvd.rank() == 0:
        import os as _os

        _ckpt = _os.path.join(
            FilesystemStore(spec["store_prefix"]).get_checkpoint_path(
                spec["run_id"]), CHECKPOINT_FILE)
        if _os.path.exists(_ckpt):
            with np.load(_ckpt) as z:
                model.set_weights(
                    [z[f"w{i}"] for i in range(len(z.files))])
    optimizer = keras.optimizers.deserialize(
        json.loads(spec["optimizer_config"]))
    loss, metrics, user_callbacks, transformation_fn = spec["train"]
    model.compile(
        optimizer=hvd.DistributedOptimizer(
            optimizer,
            compression=resolve_compression(
                hvd, p.get("gradient_compression")
                or p.get("compression"))),
        loss=loss, metrics=metrics or None,
        loss_weights=p.get("loss_weights"),
        weighted_metrics=None,
    )

    store = FilesystemStore(spec["store_prefix"])
    run_id = spec["run_id"]
    shard = load_shard(store.get_train_data_path(), TRAIN_NPZ,
                       hvd.rank(), hvd.size())
    if len(next(iter(shard.values()))) == 0:
        raise ValueError(
            f"rank {hvd.rank()}'s training shard is empty "
            f"({spec['n_train']} rows over {hvd.size()} ranks); "
            "reduce num_proc or provide more data")
    # rank-CONSISTENT batch count: strided shards differ by up to one
    # row, which can flip ceil(rows/batch) on one rank — and every
    # training batch fires collective gradient allreduces, so unequal
    # counts deadlock the epoch. Trim to the global minimum (drops at
    # most one row per rank per epoch).
    min_rows = max(1, spec["n_train"] // hvd.size())
    shard = {c: v[:min_rows] for c, v in shard.items()}

    feature_cols = p["feature_cols"]
    label_cols = p["label_cols"]

    def xy(source):
        xs = [source[c] for c in feature_cols]
        ys = [source[c] for c in label_cols]
        x = xs[0] if len(xs) == 1 else xs
        y = ys[0] if len(ys) == 1 else ys
        if transformation_fn is not None:
            x, y = transformation_fn(x, y)
        return x, y

    x, y = xy(shard)
    fit_kwargs: Dict[str, Any] = {}
    # validation engages only when EVERY rank's strided shard is
    # non-empty (rows[r::size] nonempty iff r < n_val) — a per-rank
    # skip would desync the metric-averaging collectives, and an empty
    # shard would crash keras mid-fit while peers sit in a collective
    if 0 < spec["n_val"] < hvd.size() and hvd.rank() == 0:
        import logging

        logging.getLogger("horovod_tpu_torch").warning(
            "validation disabled: %d validation rows cannot cover %d "
            "ranks (every rank needs >=1 row or the metric collectives "
            "desync); grow the validation split or reduce num_proc",
            spec["n_val"], hvd.size())
    if spec["n_val"] >= hvd.size():
        vshard = load_shard(store.get_val_data_path(), VAL_NPZ,
                            hvd.rank(), hvd.size())
        vx, vy = xy(vshard)
        if p.get("sample_weight_col"):
            # weighted val_loss, matching the torch trainer's
            # weighted validation for the same param
            fit_kwargs["validation_data"] = (
                vx, vy, vshard[p["sample_weight_col"]])
        else:
            fit_kwargs["validation_data"] = (vx, vy)
        if p.get("validation_steps_per_epoch") is not None:
            fit_kwargs["validation_steps"] = \
                p["validation_steps_per_epoch"]
    if p.get("sample_weight_col"):
        fit_kwargs["sample_weight"] = shard[p["sample_weight_col"]]
    if p.get("train_steps_per_epoch") is not None:
        fit_kwargs["steps_per_epoch"] = p["train_steps_per_epoch"]

    ckpt_dir = store.get_checkpoint_path(run_id)

    class _Checkpoint(keras.callbacks.Callback):
        """rank-0 per-epoch Store checkpoint (reference: the estimator
        installs a best-model checkpoint callback writing to the
        Store)."""

        def on_epoch_end(self, epoch, logs=None):
            if hvd.rank() != 0:
                return
            os.makedirs(ckpt_dir, exist_ok=True)
            tmp = os.path.join(ckpt_dir, CHECKPOINT_FILE + ".tmp.npz")
            np.savez(tmp, **{f"w{i}": w for i, w in
                             enumerate(self.model.get_weights())})
            os.replace(tmp, os.path.join(ckpt_dir, CHECKPOINT_FILE))

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
        _Checkpoint(),
    ] + list(user_callbacks or [])

    hist = model.fit(
        x, y,
        batch_size=p["batch_size"],
        epochs=p["epochs"],
        shuffle=p.get("shuffle", True),
        verbose=p.get("verbose", 1) if hvd.rank() == 0 else 0,
        callbacks=callbacks,
        **fit_kwargs,
    )

    history = {k: [float(v) for v in vs] for k, vs in
               hist.history.items()}
    result: Dict[str, Any] = {"history": history}
    if hvd.rank() == 0:
        store.write_text(
            os.path.join(store.get_logs_path(run_id), "history.json"),
            json.dumps(history))
        store.write_text(
            os.path.join(ckpt_dir, MODEL_JSON_FILE), spec["model_json"])
        result["weights"] = model.get_weights()
    hvd.shutdown()
    return result


class KerasEstimator(HorovodEstimator):
    """Reference-shaped params: ``model`` (keras.Model), ``optimizer``
    (keras optimizer instance or name), ``loss`` (name or callable),
    ``custom_objects`` for model rebuild on the ranks."""

    _param_defs = {
        "optimizer": None,
        "custom_objects": {},
    }

    def _check_params(self):
        super()._check_params()
        if self.getOptimizer() is None:
            raise ValueError("optimizer param is required")
        if self.getLoss() is None:
            raise ValueError("loss param is required")
        lw = self.getLossWeights()
        if lw is not None and len(lw) != len(self.getLabelCols() or []):
            raise ValueError(
                f"loss_weights has {len(lw)} entries for "
                f"{len(self.getLabelCols() or [])} output column(s)")

    def _serialize_training_spec(self) -> Dict[str, Any]:
        import keras

        model = self.getModel()
        if not model.built:
            raise ValueError(
                "the keras model must be built before fit() so its "
                "initial weights can broadcast — call model.build() "
                "or pass an Input layer")
        opt = self.getOptimizer()
        if isinstance(opt, str):
            opt = keras.optimizers.get(opt)
        return {
            "model_json": model.to_json(),
            "weights": model.get_weights(),
            "optimizer_config": json.dumps(
                keras.optimizers.serialize(opt)),
            "custom_objects": dict(self.getCustomObjects() or {}),
            "train": (
                self.getLoss(), list(self.getMetrics() or []),
                list(self.getCallbacks() or []),
                self.getTransformationFn()),
        }

    def _remote_trainer(self):
        return _keras_trainer

    def _create_model(self, rank_results, run_id, store):
        import keras

        weights = next(r["weights"] for r in rank_results
                       if "weights" in r)
        trained = keras.models.model_from_json(
            self.getModel().to_json(),
            custom_objects=dict(self.getCustomObjects() or {}))
        trained.set_weights(weights)
        return KerasModel(
            model=trained,
            feature_cols=list(self.getFeatureCols()),
            label_cols=list(self.getLabelCols()),
            output_cols=self.getOutputCols(),
            run_id=run_id, store=store,
            history=rank_results[0]["history"],
            batch_size=self.getBatchSize(),
        )


class KerasModel(HorovodModel):
    _param_defs = {"custom_objects": {}}

    def _predict_columns(self, features):
        import numpy as np

        model = self.getModel()
        xs = [features[c] for c in self.getFeatureCols()]
        x = xs[0] if len(xs) == 1 else xs
        out = model.predict(x, batch_size=self.getBatchSize(),
                            verbose=0)
        if not isinstance(out, (tuple, list)):
            out = [out]
        return [np.asarray(m).reshape(-1)
                if np.asarray(m).ndim == 2 and np.asarray(m).shape[1] == 1
                else (list(np.asarray(m)) if np.asarray(m).ndim > 1
                      else np.asarray(m))
                for m in out]

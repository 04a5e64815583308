"""Estimator parameter machinery (counterpart of
``horovod_tpu/spark/common/params.py``).

Parity surface: ``horovod/spark/common/params.py`` (``EstimatorParams``)
— the reference builds on ``pyspark.ml.param.Params``: every knob is a
named Param with a ``setFoo``/``getFoo`` pair and a default, validated
at fit time.  pyspark is optional here, so this is a dependency-free
re-implementation of the same contract: snake_case constructor kwargs,
camelCase setter/getter pairs generated from the param table, unknown
names rejected eagerly (a typo'd param must not silently train with a
default).
"""

from __future__ import annotations

from typing import Any, Dict


def _camel(name: str) -> str:
    return "".join(p.capitalize() for p in name.split("_"))


class Params:
    """Minimal pyspark-ml-style Params: subclasses declare
    ``_param_defs = {snake_name: default}``; instances get
    ``set<Camel>(v)`` (chainable) and ``get<Camel>()`` for each."""

    _param_defs: Dict[str, Any] = {}

    def __init__(self, **kwargs):
        import copy

        # merge param tables down the MRO so Torch/Keras subclasses
        # inherit the shared EstimatorParams names; deep-copied so a
        # mutable default ([], {}) appended to on one instance cannot
        # leak into the class table and every later instance
        defs: Dict[str, Any] = {}
        for klass in reversed(type(self).__mro__):
            defs.update(getattr(klass, "_param_defs", {}))
        self._params = copy.deepcopy(defs)
        unknown = set(kwargs) - set(defs)
        if unknown:
            raise ValueError(
                f"unknown param(s) {sorted(unknown)} for "
                f"{type(self).__name__}; valid: {sorted(defs)}"
            )
        self._params.update(kwargs)

    def __getattr__(self, name: str):
        # generated accessors: setEpochs(5) / getEpochs()
        params = self.__dict__.get("_params")
        if params is not None:
            for snake in params:
                cam = _camel(snake)
                if name == f"get{cam}":
                    return lambda snake=snake: params[snake]
                if name == f"set{cam}":
                    def _set(value, snake=snake):
                        params[snake] = value
                        return self
                    return _set
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def _get(self, name: str):
        return self._params[name]

    def param_dict(self) -> Dict[str, Any]:
        return dict(self._params)


class EstimatorParams(Params):
    """The shared estimator knob set (reference: EstimatorParams).

    Names and defaults follow ``horovod/spark/common/params.py``;
    knobs whose reference meaning is Petastorm-specific
    (``train_reader_num_workers`` et al.) are accepted for source
    compat and ignored by the npz data path.
    """

    _param_defs = {
        "num_proc": None,           # ranks (default: backend's)
        "model": None,
        "backend": None,            # common.backend.Backend
        "store": None,              # common.store.Store
        "loss": None,
        "metrics": [],
        "feature_cols": None,       # list[str]
        "label_cols": None,         # list[str]
        "output_cols": None,        # transform() output column names
        "validation": None,         # float fraction | indicator column
        "sample_weight_col": None,
        "compression": None,
        # reference spelling of the same knob (horovod estimators name
        # it gradient_compression); either works, reference wins when
        # both are set
        "gradient_compression": None,
        # per-output loss scaling for multi-output models (reference:
        # loss_weights on both estimators)
        "loss_weights": None,
        "batch_size": 32,
        "val_batch_size": None,
        "epochs": 1,
        "verbose": 1,
        "shuffle": True,
        "shuffle_buffer_size": None,   # accepted; npz path shuffles fully
        "callbacks": [],
        "random_seed": None,
        "run_id": None,
        # load the run's latest Store checkpoint before training (rank
        # 0 loads, broadcast propagates) — the reference's resume
        # semantics; default is a fresh fit from the shipped weights
        "resume_from_checkpoint": False,
        "train_steps_per_epoch": None,
        "validation_steps_per_epoch": None,
        # (features, labels) hook applied to each rank's shard at data
        # load — one contract across the torch and keras trainers
        "transformation_fn": None,
        "partitions_per_process": None,   # petastorm-era; ignored
        "train_reader_num_workers": None, # petastorm-era; ignored
        "val_reader_num_workers": None,   # petastorm-era; ignored
        "inmemory_cache_all": True,       # npz path is always in-memory
        "label_shapes": None,
    }

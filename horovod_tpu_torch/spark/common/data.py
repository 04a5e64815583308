"""DataFrame materialization for the estimators — the Petastorm seam
(counterpart of ``horovod_tpu/spark/common/data.py``).

Parity surface: ``horovod/spark/common/util.py``
(``prepare_data`` / ``check_validation``) — the reference materializes
the input DataFrame to a Parquet intermediate in the Store and streams
it back per-rank through Petastorm readers.  Petastorm is scoped out;
the replacement materializes to columnar ``.npz`` in the Store (static
shapes, mmap back) and shards rows **rank-strided** across workers —
the DistributedSampler convention the torch frontend already follows.

Accepted inputs: pandas DataFrame, dict of column arrays, or a pyspark
DataFrame when pyspark is importable (collected via ``toPandas()`` —
local-mode scale, same as the reference's CI).  Neither pandas nor
pyspark is imported unless the frame needs it: a dict of columns works
with neither installed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

TRAIN_NPZ = "train.npz"
VAL_NPZ = "val.npz"


def to_columns(df, cols: List[str]) -> Dict[str, np.ndarray]:
    """Extract named columns as numpy arrays from any accepted
    DataFrame shape.  Object columns of fixed-length sequences stack
    into one static-shaped array (ragged rows are rejected — the estimators
    batch by slicing rectangular tensors, and the reference's Parquet
    path is rectangular too)."""
    try:
        import pyspark.sql as psql  # noqa: F401

        if hasattr(df, "toPandas"):
            df = df.toPandas()
    except ImportError:
        pass
    out = {}
    for c in cols:
        if isinstance(df, dict):
            col = np.asarray(df[c])
        else:  # pandas
            col = df[c].to_numpy()
        if col.dtype == object:
            try:
                col = np.stack([np.asarray(v) for v in col])
            except ValueError as e:
                raise ValueError(
                    f"column {c!r} holds ragged sequences; estimator "
                    "columns must be rectangular (static shapes)"
                ) from e
        out[c] = col
    return out


def split_validation(
    columns: Dict[str, np.ndarray],
    validation,
    seed: Optional[int],
) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """Reference semantics (``check_validation``): ``validation`` is a
    float fraction (random row split) or the NAME of an indicator
    column whose nonzero rows are the validation set."""
    if validation is None:
        return columns, None
    n = len(next(iter(columns.values())))
    if isinstance(validation, str):
        if validation not in columns:
            raise ValueError(
                f"validation column {validation!r} not among the "
                f"materialized columns {sorted(columns)}; include it "
                "in feature/label extraction")
        mask = columns[validation].astype(bool)
    elif isinstance(validation, float):
        if not 0.0 < validation < 1.0:
            raise ValueError(
                f"validation fraction must be in (0, 1), got {validation}")
        rng = np.random.RandomState(0 if seed is None else seed)
        mask = rng.rand(n) < validation
    else:
        raise TypeError(
            f"validation must be a float fraction or an indicator "
            f"column name, got {type(validation).__name__}")
    train = {c: v[~mask] for c, v in columns.items()}
    val = {c: v[mask] for c, v in columns.items()}
    return train, val


def materialize(
    df,
    store,
    feature_cols: List[str],
    label_cols: List[str],
    validation=None,
    sample_weight_col: Optional[str] = None,
    seed: Optional[int] = None,
) -> Tuple[int, int]:
    """Write the train (and optional val) split as columnar npz into
    the Store's intermediate paths + a JSON metadata sidecar; returns
    ``(n_train, n_val)``."""
    cols = list(dict.fromkeys(
        feature_cols + label_cols
        + ([sample_weight_col] if sample_weight_col else [])
        + ([validation] if isinstance(validation, str) else [])))
    columns = to_columns(df, cols)
    train, val = split_validation(columns, validation, seed)
    if isinstance(validation, str):  # indicator column is not a feature
        train.pop(validation, None)
        if val:
            val.pop(validation, None)

    train_dir = store.get_train_data_path()
    os.makedirs(train_dir, exist_ok=True)
    np.savez(os.path.join(train_dir, TRAIN_NPZ), **train)
    n_val = 0
    if val is not None and len(next(iter(val.values()))):
        val_dir = store.get_val_data_path()
        os.makedirs(val_dir, exist_ok=True)
        np.savez(os.path.join(val_dir, VAL_NPZ), **val)
        n_val = len(next(iter(val.values())))
    meta = {
        "n_train": int(len(next(iter(train.values())))),
        "n_val": int(n_val),
        "feature_cols": feature_cols,
        "label_cols": label_cols,
        "sample_weight_col": sample_weight_col,
        "schema": {c: {"dtype": str(v.dtype), "shape": list(v.shape[1:])}
                   for c, v in train.items()},
    }
    store.write_text(store.get_data_metadata_path(), json.dumps(meta))
    return meta["n_train"], n_val


def load_shard(path: str, npz_name: str, rank: int, size: int,
               ) -> Dict[str, np.ndarray]:
    """This rank's strided row slice of a materialized split
    (``rows[rank::size]`` — every rank gets ⌈n/size⌉ or ⌊n/size⌋ rows,
    the DistributedSampler convention, so no rank starves and epochs
    stay near-lockstep)."""
    with np.load(os.path.join(path, npz_name), mmap_mode="r") as z:
        return {c: np.asarray(z[c][rank::size]) for c in z.files}

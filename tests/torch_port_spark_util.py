"""Helpers of the Spark estimator tests of the port: the reference's
frames and a runner of one thunk a package at once."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import horovod_tpu.spark as ref_spark
import horovod_tpu_torch.spark as port_spark

PACKAGES = {"ref": ref_spark, "port": port_spark}


@pytest.fixture(autouse=True)
def flight_dir(tmp_path, monkeypatch):
    """The workers' postmortems go to the test's directory."""
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))


def _regression_frame(n=256, d=4, seed=0):
    import pandas as pd

    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.randn(d, 1).astype(np.float32)
    y = x @ w + 0.01 * rng.randn(n, 1).astype(np.float32)
    return pd.DataFrame({"features": list(x), "label": list(y)}), x, y


def _classification_frame(n=256, d=4, k=3, seed=0):
    import pandas as pd

    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.randn(d, k).astype(np.float32)
    y = (x @ w).argmax(axis=1)
    return pd.DataFrame({"features": list(x), "label": y}), x, y


def both(make):
    """``make(pkg, name)`` -> a thunk; run the reference's and the
    port's thunks at once and return {name: result or exception}."""
    thunks = {name: make(pkg, name) for name, pkg in PACKAGES.items()}

    def call(thunk):
        try:
            return thunk()
        except Exception as e:  # noqa: BLE001 — compared by the caller
            return e

    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {name: pool.submit(call, t) for name, t in thunks.items()}
        return {name: f.result() for name, f in futures.items()}


def _column(out, name="label__output"):
    col = out[name]
    col = col.to_numpy() if hasattr(col, "to_numpy") else col
    return np.stack([np.asarray(v, dtype=np.float32) for v in col]) \
        if np.asarray(col).dtype == object else np.asarray(col)

"""The port's ``KerasEstimator`` (``horovod_tpu_torch.spark``) fitting
across real ranks, held against the reference's (``horovod_tpu.spark``):
counterparts of the keras cases of ``tests/test_spark_estimator.py``.

One seeded keras model is built here and cloned, one a package; each
package's estimator fits it on the same frame at once, in two threads
(``torch_port_spark_util.both``), its ranks on the CPU
(``cpu_devices=1``: the port's keras frontend bridges the gradients onto
its torch engine over gloo).  The weights, the history and
``transform``'s outputs are held bitwise.  The one-rank pair is tier-1;
the 2-rank counterparts keep the reference's ``slow`` mark.

``chip_smoke.py``'s keras branch of its ``spark`` phase runs here too, in
a process of its own started with the module, beside the pair: each fit
spends most of its time starting a worker.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import horovod_tpu_torch.spark as port_spark  # noqa: E402
from torch_port_spark_util import (  # noqa: E402,F401
    PACKAGES,
    _classification_frame,
    _column,
    both,
    flight_dir,
)
from torch_port_util import no_leaked_reference  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def keras_branch(tmp_path_factory):
    """``chip_smoke._spark_keras`` at one CPU rank, in a process started
    when this module starts; the test that needs its result waits."""
    out = tmp_path_factory.mktemp("keras_branch")
    code = ("import json, sys; from pathlib import Path; import chip_smoke;"
            " from horovod_tpu_torch import spark; print(json.dumps("
            "chip_smoke._spark_keras(spark, Path(sys.argv[1]), 1)))")
    env = dict(os.environ, HVTPU_FLIGHT_DIR=str(out))
    with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
        proc = subprocess.Popen([sys.executable, "-c", code, str(out)],
                                cwd=_REPO, env=env, stdout=so, stderr=se)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _keras_fits(tmp_path, frame, num_proc, layers, **kw):
    """Fit one seeded keras model through each package's
    ``KerasEstimator`` at ``num_proc`` CPU ranks; the keras models are
    built here, one a package, with the same weights."""
    import keras

    keras.utils.set_random_seed(3)
    first = keras.Sequential(
        [keras.layers.Input((4,))] + [keras.layers.Dense(*a, **k)
                                      for a, k in layers])
    models = {"ref": first, "port": keras.models.clone_model(first)}
    models["port"].set_weights(first.get_weights())
    ests = {}
    for name, pkg in PACKAGES.items():
        ests[name] = pkg.KerasEstimator(
            model=models[name], optimizer=keras.optimizers.SGD(0.2),
            loss="sparse_categorical_crossentropy",
            feature_cols=["features"], label_cols=["label"],
            verbose=0, random_seed=7,
            backend=pkg.LocalBackend(num_proc=num_proc, cpu_devices=1),
            store=pkg.LocalStore(str(tmp_path / name)), **kw)
    out = both(lambda pkg, name: lambda: ests[name].fit(frame))
    for name, r in out.items():
        if isinstance(r, Exception):
            raise AssertionError(f"{name} fit failed") from r
    return out


def _keras_held(kms, frame):
    ref, port = kms["ref"], kms["port"]
    assert ref.getHistory() == port.getHistory()
    wr, wp = ref.getModel().get_weights(), port.getModel().get_weights()
    assert len(wr) == len(wp)
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for a, b in zip(wr, wp))
    outs = [_column(m.transform(frame)) for m in (ref, port)]
    assert outs[0].tobytes() == outs[1].tobytes()
    return outs[1]


class TestKerasEstimator:
    def test_fit_transform_checkpoint_1proc(self, tmp_path):
        """One rank each: the weights, the history and transform's
        outputs bitwise; the checkpoint and the model JSON in the
        Store."""
        df, x, y = _classification_frame(n=128)
        kms = _keras_fits(
            tmp_path, df, 1,
            [((8,), {"activation": "relu"}),
             ((3,), {"activation": "softmax"})],
            batch_size=32, epochs=2, validation=0.25,
            metrics=["accuracy"])
        km = kms["port"]
        assert isinstance(km, port_spark.KerasModel)
        hist = km.getHistory()
        assert set(hist) >= {"loss", "accuracy", "val_loss",
                             "val_accuracy"}
        ckpt_dir = km.getStore().get_checkpoint_path(km.getRunId())
        assert os.path.exists(os.path.join(ckpt_dir, "checkpoint.npz"))
        assert os.path.exists(os.path.join(ckpt_dir, "model.json"))
        pred = _keras_held(kms, df)
        assert pred.shape == (len(df), 3)
        np.testing.assert_allclose(
            pred, km.getModel().predict(x, verbose=0), rtol=1e-5)

    @pytest.mark.slow
    def test_fit_transform_checkpoint_2proc(self, tmp_path):
        df, x, y = _classification_frame()
        kms = _keras_fits(
            tmp_path, df, 2,
            [((8,), {"activation": "relu"}),
             ((3,), {"activation": "softmax"})],
            batch_size=32, epochs=3, validation=0.2, metrics=["accuracy"])
        pred = _keras_held(kms, df)
        hist = kms["port"].getHistory()
        assert hist["loss"][-1] < hist["loss"][0]
        assert (pred.argmax(1) == y).mean() > 0.7

    @pytest.mark.slow
    def test_keras_uneven_shards_train_in_lockstep(self, tmp_path):
        """65 rows over 2 ranks: the min-rows trim keeps the ranks'
        batch counts equal."""
        df, x, y = _classification_frame(n=65)
        kms = _keras_fits(tmp_path, df, 2,
                          [((3,), {"activation": "softmax"})],
                          batch_size=32, epochs=2)
        assert len(kms["port"].getHistory()["loss"]) == 2
        _keras_held(kms, df)

    @pytest.mark.slow
    def test_keras_resume_from_checkpoint_2proc(self, tmp_path):
        df, _x, _y = _classification_frame()
        layers = [((8,), {"activation": "relu"}),
                  ((3,), {"activation": "softmax"})]
        kw = dict(batch_size=32, epochs=2, run_id="keras_resume_run")
        first = _keras_fits(tmp_path, df, 2, layers,
                            resume_from_checkpoint=False, **kw)
        second = _keras_fits(tmp_path, df, 2, layers,
                             resume_from_checkpoint=True, **kw)
        for kms in (first, second):
            _keras_held(kms, df)
        h1 = first["port"].getHistory()["loss"]
        h2 = second["port"].getHistory()["loss"]
        assert h1[-1] < h1[0]
        assert h2[0] < (h1[0] + h1[-1]) / 2


def test_chip_smoke_keras_branch_on_the_cpu(keras_branch):
    """``chip_smoke.py``'s keras branch of the ``spark`` phase (it runs
    on the card only where keras and tensorflow are installed): a seeded
    MLP through the port's ``KerasEstimator`` at one CPU rank, transform
    bitwise the trained model's ``predict``."""
    import chip_smoke

    proc, out = keras_branch
    assert proc.wait(timeout=300) == 0, \
        (out / "stderr").read_text()[-3000:]
    result = json.loads((out / "stdout").read_text().splitlines()[-1])
    assert len(result["history"]["loss"]) == chip_smoke.SPARK_EPOCHS
    assert result["fit_s"] > 0

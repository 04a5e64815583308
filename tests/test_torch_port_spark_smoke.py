"""``chip_smoke.py``'s ``spark`` phase rehearsed on the CPU at a tiny size,
and the estimators' pickle fallback.

The rehearsal runs the phase as the card runs it, with
``device="cpu"``: a narrow ResNet fit through ``TorchEstimator`` with
``LocalBackend(num_proc=1, cpu_devices=1)``, the smoke's loss and metric
pickled by reference from ``chip_smoke`` (the workers import it),
transform bitwise the module's forward, ``spark.run`` and
``RayExecutor(use_gpu=False)`` on the CPU, and the keras branch taken
where keras and tensorflow are installed (its fit,
``chip_smoke._spark_keras``, runs in
``tests/test_torch_port_spark_keras.py``).  On the CPU A1 launches
nothing, and the phase expects 0 a step there.

The fallback: with ``cloudpickle`` hidden, the launcher pickles the
training spec with ``pickle``, and the optimizer still refers to the
model's parameters.
"""

import pickle
import sys
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402
import horovod_tpu_torch.spark as port_spark  # noqa: E402
from torch_port_spark_util import flight_dir  # noqa: E402,F401
from torch_port_util import no_leaked_reference  # noqa: E402,F401


def test_chip_smoke_spark_phase_on_the_cpu(tmp_path, monkeypatch, capsys):
    for name, value in (("SPARK_ROWS", 40), ("SPARK_IMAGE", 32),
                        ("SPARK_STAGES", (1, 1, 1, 1)),
                        ("SPARK_FILTERS", 8), ("SPARK_CLASSES", 10),
                        ("SPARK_BATCH", 8), ("SPARK_KERAS_ROWS", 64)):
        monkeypatch.setattr(chip_smoke, name, value)
    import importlib.util

    keras_here = all(importlib.util.find_spec(m) is not None
                     for m in ("keras", "tensorflow"))
    keras_calls = []
    monkeypatch.setattr(chip_smoke, "_spark_keras",
                        lambda spark, tmp, cpu_devices: keras_calls.append(
                            (spark, cpu_devices)) or {"fit_s": 0.0})
    line = chip_smoke.spark_phase("cpu rehearsal", tmp_path, device="cpu")
    assert keras_calls == ([(port_spark, 1)] if keras_here else [])
    assert line["worker_device"] == "cpu"
    assert line["run_devices"] == ["cpu"] and line["ray_devices"] == ["cpu"]
    assert line["a1_launches_per_step"] == 0
    assert line["history"]["spark_a1_launches"] == [0.0, 0.0]
    assert line["steps_per_epoch"] == -(-line["n_train"] // 8)
    assert line["n_train"] + line["n_val"] == 40
    assert line["keras_estimator"] == ("ran" if keras_here else None)
    assert line["first_step_s"] < line["fit_s"]
    assert '\nspark {"card": "cpu rehearsal"' in "\n" + capsys.readouterr().out


def test_pickle_where_cloudpickle_is_missing(tmp_path, monkeypatch):
    from horovod_tpu_torch.runner import pickler

    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    assert pickler() is pickle
    torch.manual_seed(3)
    model = nn.Sequential(nn.Linear(4, 1))
    est = port_spark.TorchEstimator(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
        loss=F.mse_loss, feature_cols=["features"], label_cols=["label"],
        batch_size=16, epochs=2, verbose=0, random_seed=7,
        store=port_spark.LocalStore(str(tmp_path / "store")),
        backend=port_spark.LocalBackend(num_proc=1, cpu_devices=1))
    got_model, got_opt, losses, metrics, fn = pickle.loads(
        pickler().dumps(est._serialize_training_spec()))["train"]
    assert got_opt.param_groups[0]["params"][0] is \
        next(got_model.parameters())
    assert losses == [F.mse_loss] and metrics == [] and fn is None

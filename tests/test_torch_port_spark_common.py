"""The port's Spark estimator surface on the driver
(``horovod_tpu_torch/spark``) held against the reference's
(``horovod_tpu/spark``), case by case of ``tests/test_spark_estimator.py``
that spawns no rank: the Store, the params, the data materialization,
the backends, the estimators' driver-side checks and the lightning shim.

Every case runs through both packages on the same seeded inputs: the
same Store layout, the same ``split_validation`` masks, materialized
arrays bitwise and ``_metadata.json`` equal, and the same error and
warning texts apart from the package's name.  The rank-spawning cases
are ``tests/test_torch_port_spark_estimator.py``'s.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.nn as nn

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tests"))

import horovod_tpu.spark as ref_spark  # noqa: E402
import horovod_tpu_torch.spark as port_spark  # noqa: E402
from horovod_tpu.spark.common import data as ref_data  # noqa: E402
from horovod_tpu_torch.spark.common import data as port_data  # noqa: E402
from torch_port_spark_util import _regression_frame  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

PACKAGES = {"ref": ref_spark, "port": port_spark}
DATA = {"ref": ref_data, "port": port_data}


def _same_text(ref: str, port: str) -> bool:
    """Equal apart from the package's name."""
    return ref == port.replace("horovod_tpu_torch", "horovod_tpu")


def _raised(fn, exc=Exception):
    with pytest.raises(exc) as info:
        fn()
    return info.value


def _store_files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _npz(path):
    with np.load(path) as z:
        return {c: z[c] for c in z.files}


def _same_arrays(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[c].dtype == b[c].dtype and a[c].shape == b[c].shape
        and a[c].tobytes() == b[c].tobytes() for c in a)


class TestStore:
    def test_layout_and_io(self, tmp_path):
        layouts = {}
        for name, pkg in PACKAGES.items():
            root = tmp_path / name
            store = pkg.LocalStore(str(root))
            assert store.get_checkpoint_path("r1").endswith(
                os.path.join("runs", "r1", "checkpoints"))
            assert store.get_logs_path("r1").endswith(
                os.path.join("runs", "r1", "logs"))
            store.write_text("runs/r1/meta.json", json.dumps({"a": 1}))
            assert store.exists("runs/r1/meta.json")
            assert store.read_json("runs/r1/meta.json") == {"a": 1}
            assert store.get_checkpoints("r1") == []
            layouts[name] = [
                os.path.relpath(p, str(root)) for p in (
                    store.get_train_data_path(), store.get_train_data_path(3),
                    store.get_val_data_path(), store.get_val_data_path(0),
                    store.get_data_metadata_path(), store.get_runs_path(),
                    store.get_run_path("r1"), store.get_checkpoint_path("r1"),
                    store.get_logs_path("r1"))]
            layouts[name].append(_store_files(root))
        assert layouts["ref"] == layouts["port"]

    def test_create_factory_schemes(self, tmp_path):
        texts = {}
        for name, pkg in PACKAGES.items():
            s = pkg.Store.create(f"file://{tmp_path}/{name}")
            assert type(s) is pkg.FilesystemStore
            assert isinstance(s, pkg.LocalStore.__mro__[1])
            e = _raised(lambda: pkg.Store.create("s3://bucket/prefix"),
                        NotImplementedError)
            assert "s3" in str(e)
            texts[name] = str(e)
        assert _same_text(texts["ref"], texts["port"])

    def test_write_text_is_atomic_and_saving_runs(self, tmp_path):
        for name, pkg in PACKAGES.items():
            store = pkg.FilesystemStore(str(tmp_path / name),
                                        save_runs=False)
            store.write_text("a/b.txt", "x")
            store.write_text("a/b.txt", "y")
            assert store.read("a/b.txt") == b"y"
            assert os.listdir(tmp_path / name / "a") == ["b.txt"]
            assert store.saving_runs() is False


class TestParams:
    def test_generated_accessors_roundtrip(self):
        for pkg in PACKAGES.values():
            p = pkg.EstimatorParams(epochs=5, feature_cols=["x"])
            assert p.getEpochs() == 5
            assert p.setBatchSize(64) is p  # chainable
            assert p.getBatchSize() == 64
            assert p.getFeatureCols() == ["x"]

    def test_unknown_param_rejected(self):
        texts = [str(_raised(lambda: pkg.EstimatorParams(epohcs=5),
                             ValueError)) for pkg in PACKAGES.values()]
        assert "unknown param" in texts[0]
        assert texts[0] == texts[1]

    @pytest.mark.parametrize("cls", ["EstimatorParams", "TorchEstimator",
                                     "KerasEstimator", "TorchModel",
                                     "KerasModel"])
    def test_param_tables_equal(self, cls):
        tables = []
        for pkg in PACKAGES.values():
            inst = getattr(pkg, cls)()
            tables.append(inst.param_dict())
        assert tables[0] == tables[1]

    def test_mutable_defaults_are_per_instance(self):
        for pkg in PACKAGES.values():
            a, b = pkg.EstimatorParams(), pkg.EstimatorParams()
            a.getMetrics().append("acc")
            assert b.getMetrics() == []
            assert pkg.EstimatorParams._param_defs["metrics"] == []

    def test_unknown_accessor_raises_attribute_error(self):
        texts = [str(_raised(lambda: pkg.EstimatorParams().getNope(),
                             AttributeError)) for pkg in PACKAGES.values()]
        assert texts[0] == texts[1]


class TestDataMaterialization:
    def test_ragged_column_rejected(self):
        texts = []
        for data in DATA.values():
            e = _raised(lambda: data.to_columns(
                {"c": np.array([[1, 2], [1]], dtype=object)}, ["c"]),
                ValueError)
            assert "ragged" in str(e)
            texts.append(str(e))
        assert texts[0] == texts[1]

    @pytest.mark.parametrize("seed", [None, 0, 3, 7])
    @pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5])
    def test_split_validation_masks_equal(self, seed, fraction):
        rng = np.random.RandomState(11)
        cols = {"f": rng.rand(101, 3).astype(np.float32),
                "l": rng.randint(0, 5, 101)}
        splits = [data.split_validation(cols, fraction, seed)
                  for data in DATA.values()]
        for part in (0, 1):
            assert _same_arrays(splits[0][part], splits[1][part])

    @pytest.mark.parametrize("validation", [0.5, 1.0, 0, "x", None])
    def test_split_validation_errors_equal(self, validation):
        cols = {"f": np.zeros((4, 2), np.float32)}
        outs = []
        for data in DATA.values():
            try:
                outs.append(data.split_validation(cols, validation, 1))
            except (TypeError, ValueError) as e:
                outs.append((type(e), str(e)))
        if isinstance(outs[0], tuple) and isinstance(outs[0][0], type):
            assert outs[0] == outs[1]
        else:
            assert _same_arrays(outs[0][0], outs[1][0])
            assert (outs[0][1] is None) == (outs[1][1] is None)

    def test_validation_fraction_split(self, tmp_path):
        df, x, y = _regression_frame()
        results = {}
        for name, pkg in PACKAGES.items():
            store = pkg.LocalStore(str(tmp_path / name))
            n_train, n_val = DATA[name].materialize(
                df, store, ["features"], ["label"], validation=0.25,
                seed=3)
            assert n_train + n_val == len(df) and 0 < n_val < len(df)
            meta = store.read_json(store.get_data_metadata_path())
            assert meta["schema"]["features"]["shape"] == [4]
            results[name] = (
                (n_train, n_val), meta,
                _npz(os.path.join(store.get_train_data_path(),
                                  DATA[name].TRAIN_NPZ)),
                _npz(os.path.join(store.get_val_data_path(),
                                  DATA[name].VAL_NPZ)))
        ref, port = results["ref"], results["port"]
        assert ref[:2] == port[:2]
        assert _same_arrays(ref[2], port[2])
        assert _same_arrays(ref[3], port[3])

    def test_validation_indicator_column(self, tmp_path):
        df, x, y = _regression_frame()
        df = df.assign(is_val=(np.arange(len(df)) % 4 == 0))
        shards = {}
        for name, pkg in PACKAGES.items():
            store = pkg.LocalStore(str(tmp_path / name))
            n_train, n_val = DATA[name].materialize(
                df, store, ["features"], ["label"], validation="is_val")
            assert n_val == len(df) // 4
            # the indicator column must not leak into the features
            shard = DATA[name].load_shard(
                store.get_train_data_path(), DATA[name].TRAIN_NPZ, 0, 1)
            assert set(shard) == {"features", "label"}
            shards[name] = (shard, store.read_json(
                store.get_data_metadata_path()))
        assert _same_arrays(shards["ref"][0], shards["port"][0])
        assert shards["ref"][1] == shards["port"][1]

    def test_missing_indicator_column_message(self, tmp_path):
        cols = {"f": np.zeros((4, 2), np.float32)}
        texts = [str(_raised(lambda: data.split_validation(
            cols, "is_val", None), ValueError)) for data in DATA.values()]
        assert texts[0] == texts[1]

    @pytest.mark.parametrize("n,size", [(101, 2), (127, 2), (50, 3),
                                        (7, 4)])
    def test_strided_shards_cover_all_rows(self, tmp_path, n, size):
        df, x, y = _regression_frame(n=n)
        shards = {}
        for name, pkg in PACKAGES.items():
            store = pkg.LocalStore(str(tmp_path / name))
            DATA[name].materialize(df, store, ["features"], ["label"],
                                   sample_weight_col=None)
            shards[name] = [DATA[name].load_shard(
                store.get_train_data_path(), DATA[name].TRAIN_NPZ, r,
                size) for r in range(size)]
            total = sum(len(s["label"]) for s in shards[name])
            assert total == n
            merged = np.concatenate([s["features"] for s in shards[name]])
            assert sorted(map(tuple, merged)) == sorted(map(tuple, x))
        for a, b in zip(shards["ref"], shards["port"]):
            assert _same_arrays(a, b)

    def test_dict_frame_needs_no_pandas(self, tmp_path, monkeypatch):
        """A dict of columns is materialized with pandas (and pyspark)
        absent: the port imports neither unless the frame needs it."""
        rng = np.random.RandomState(0)
        frame = {"features": rng.rand(40, 4).astype(np.float32),
                 "label": rng.rand(40, 1).astype(np.float32),
                 "w": np.ones(40, np.float32)}
        monkeypatch.setitem(sys.modules, "pandas", None)
        monkeypatch.setitem(sys.modules, "pyspark", None)
        monkeypatch.setitem(sys.modules, "pyspark.sql", None)
        store = port_spark.LocalStore(str(tmp_path))
        n_train, n_val = port_data.materialize(
            frame, store, ["features"], ["label"], validation=0.25,
            sample_weight_col="w", seed=1)
        assert n_train + n_val == 40
        shard = port_data.load_shard(store.get_train_data_path(),
                                     port_data.TRAIN_NPZ, 0, 1)
        assert set(shard) == {"features", "label", "w"}


class TestBackends:
    def test_local_backend_runs_across_ranks(self):
        for pkg in PACKAGES.values():
            backend = pkg.LocalBackend(num_proc=2)
            assert backend.num_processes() == 2

    def test_spark_backend_without_pyspark_defaults(self):
        for pkg in PACKAGES.values():
            b = pkg.SparkBackend()
            assert b.num_processes() == 2  # no pyspark here: default

    def test_port_defaults_ask_for_the_card(self):
        """The reference's ``cpu_devices=1`` default means one XLA CPU
        device a rank; the port's ``None`` means the card (the CPU only
        when the caller passes ``cpu_devices=1``)."""
        import inspect

        assert port_spark.LocalBackend()._cpu_devices is None
        assert port_spark.SparkBackend()._cpu_devices is None
        assert ref_spark.LocalBackend()._cpu_devices == 1
        for fn in (port_spark.run, port_spark.run_elastic):
            assert inspect.signature(fn).parameters[
                "cpu_devices"].default is None
        est = port_spark.TorchEstimator(num_proc=3)
        backend = est._resolve_backend()
        assert type(backend) is port_spark.LocalBackend
        assert (backend.num_processes(), backend._cpu_devices) == (3, None)
        assert port_spark.TorchEstimator()._resolve_backend() \
            .num_processes() == 2

    def test_run_passes_the_device_choice_to_the_launcher(self,
                                                          monkeypatch):
        from horovod_tpu_torch import runner

        seen = []
        monkeypatch.setattr(runner, "run",
                            lambda fn, **kw: seen.append(kw) or [])
        monkeypatch.setattr(runner, "run_elastic",
                            lambda fn, **kw: seen.append(kw) or [])
        port_spark.run(abs)
        port_spark.run(abs, num_proc=3, cpu_devices=1)
        port_spark.run_elastic(abs)
        port_spark.LocalBackend(num_proc=1).run(abs)
        assert [(k.get("np", k.get("num_proc")), k["cpu_devices"])
                for k in seen] == [(2, None), (3, 1), (2, None), (1, None)]


def _est(pkg, tmp_path, **kw):
    model = nn.Sequential(nn.Linear(4, 1))
    kw.setdefault("optimizer", torch.optim.SGD(model.parameters(), lr=0.1))
    return pkg.TorchEstimator(
        model=model, feature_cols=["features"], label_cols=["label"],
        batch_size=32, epochs=1, num_proc=2,
        store=pkg.LocalStore(str(tmp_path)), **kw)


class TestTorchEstimatorDriverSide:
    def test_sample_weight_col_driver_side_guards(self, tmp_path):
        df, _x, _y = _regression_frame()
        df["w"] = 1.0
        for kw, match in (
                (dict(loss=nn.MSELoss(), sample_weight_col="w"),
                 "sample_weight"),
                (dict(loss=lambda o, y, w: ((o - y) ** 2 * w).mean(),
                      sample_weight_col="w",
                      transformation_fn=lambda f, l: (f, l)),
                 "transformation_fn")):
            texts = []
            for name, pkg in PACKAGES.items():
                # fails at fit() on the DRIVER, before any rank
                e = _raised(lambda: _est(pkg, tmp_path / name,
                                         **kw).fit(df), ValueError)
                assert match in str(e)
                texts.append(str(e))
            assert texts[0] == texts[1]

    def test_sample_weight_nonweight_third_arg_warns(self, tmp_path):
        def focal(output, target, gamma):
            return ((output - target) ** 2 * gamma).mean()

        def weighted(output, target, sample_weight):
            return ((output - target) ** 2 * sample_weight).mean()

        texts = []
        for name, pkg in PACKAGES.items():
            with pytest.warns(UserWarning, match="'gamma'") as rec:
                _est(pkg, tmp_path / name, loss=focal,
                     sample_weight_col="w")._check_params()
            texts.append(str(rec[0].message))
            # a weight-named third arg stays silent
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                _est(pkg, tmp_path / name, loss=weighted,
                     sample_weight_col="w")._check_params()
        assert texts[0] == texts[1]

    def test_sample_weight_strict_mode_errors(self, tmp_path, monkeypatch):
        def focal(output, target, gamma):
            return ((output - target) ** 2 * gamma).mean()

        ests = {name: _est(pkg, tmp_path / name, loss=focal,
                           sample_weight_col="w")
                for name, pkg in PACKAGES.items()}
        monkeypatch.setenv("HVTPU_SPARK_STRICT", "1")
        texts = [str(_raised(est._check_params, ValueError))
                 for est in ests.values()]
        assert "'gamma'" in texts[0] and texts[0] == texts[1]
        # falsy spellings keep the warning behavior
        for falsy in ("0", "false", "no", ""):
            monkeypatch.setenv("HVTPU_SPARK_STRICT", falsy)
            for est in ests.values():
                with pytest.warns(UserWarning, match="HVTPU_SPARK_STRICT"):
                    est._check_params()

    def test_compression_param_object_and_typo(self):
        import horovod_tpu.torch as ref_torch
        import horovod_tpu_torch.torch as port_torch
        from horovod_tpu.spark.common.estimator import \
            resolve_compression as ref_resolve
        from horovod_tpu_torch.spark.common.estimator import \
            resolve_compression as port_resolve

        texts = []
        for hvd_torch, resolve in ((ref_torch, ref_resolve),
                                   (port_torch, port_resolve)):
            assert resolve(hvd_torch, None) is hvd_torch.Compression.none
            assert resolve(hvd_torch, "fp16") is hvd_torch.Compression.fp16
            assert resolve(hvd_torch, "bf16") is hvd_torch.Compression.bf16
            assert resolve(hvd_torch, hvd_torch.Compression.fp16) \
                is hvd_torch.Compression.fp16
            for typo in ("fp32", "_private"):
                e = _raised(lambda: resolve(hvd_torch, typo), ValueError)
                assert "options" in str(e)
                texts.append(str(e))
        assert texts[:2] == texts[2:]

    @pytest.mark.parametrize("missing,match", [
        ("optimizer", "optimizer"), ("loss", "loss"),
        ("model", "model"), ("feature_cols", "feature_cols"),
        ("label_cols", "label_cols"), ("store", "store")])
    def test_missing_params_raise(self, tmp_path, missing, match):
        texts = []
        for name, pkg in PACKAGES.items():
            model = nn.Linear(2, 1)
            kw = dict(model=model,
                      optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                      loss=nn.MSELoss(), feature_cols=["f"],
                      label_cols=["l"],
                      store=pkg.LocalStore(str(tmp_path / name)))
            kw[missing] = None
            est = pkg.TorchEstimator(**kw)
            e = _raised(lambda: est.fit(
                {"f": np.zeros((4, 2)), "l": np.zeros(4)}), ValueError)
            assert match in str(e)
            texts.append(str(e))
        assert texts[0] == texts[1]

    def test_resume_needs_a_run_id_and_loss_weights_length(self, tmp_path):
        df, _x, _y = _regression_frame(n=16)
        for kw in (dict(resume_from_checkpoint=True),
                   dict(loss_weights=[1.0, 2.0])):
            texts = []
            for name, pkg in PACKAGES.items():
                e = _raised(lambda: _est(pkg, tmp_path / name,
                                         loss=nn.MSELoss(), **kw).fit(df),
                            ValueError)
                texts.append(str(e))
            assert texts[0] == texts[1]

    def test_lightning_shim_raises_with_guidance(self):
        from horovod_tpu.spark.lightning import LightningEstimator as ref
        from horovod_tpu_torch.spark.lightning import \
            LightningEstimator as port

        texts = []
        for cls in (ref, port):
            e = _raised(lambda: cls(model=object(), num_proc=2),
                        ImportError)
            assert "TorchEstimator" in str(e)
            texts.append(str(e))
        assert _same_text(*texts)
        assert "horovod_tpu_torch.spark.TorchEstimator" in texts[1]

    def test_lightning_shim_upstream_name(self):
        # the reference exports the lightning estimator as
        # horovod.spark.lightning.TorchEstimator — same path here
        import horovod_tpu.spark.lightning as ref
        import horovod_tpu_torch.spark.lightning as port

        texts = []
        for mod in (ref, port):
            assert mod.TorchEstimator is mod.LightningEstimator
            assert mod.TorchModel is mod.LightningModel
            e = _raised(lambda: mod.TorchEstimator(model=object()),
                        ImportError)
            assert "migration.md" in str(e)
            texts.append(str(e))
            e = _raised(lambda: mod.TorchModel(), ImportError)
            texts.append(str(e))
        assert _same_text(texts[0], texts[2])
        assert _same_text(texts[1], texts[3])


@pytest.mark.parametrize("module", [
    "spark", "spark.common", "spark.common.params", "spark.common.store",
    "spark.common.data", "spark.common.backend", "spark.common.estimator",
    "spark.torch", "spark.keras", "spark.lightning", "ray"])
def test_public_names_match_the_reference(module):
    import importlib

    ref = importlib.import_module(f"horovod_tpu.{module}")
    port = importlib.import_module(f"horovod_tpu_torch.{module}")

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and getattr(getattr(mod, n), "__module__", "").startswith(
                    mod.__name__.split(".")[0])}

    assert public(ref) == public(port)

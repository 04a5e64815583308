"""The port's estimators (``horovod_tpu_torch.spark.TorchEstimator`` /
``KerasEstimator``) fitting across real ranks, held against the
reference's (``horovod_tpu.spark``) on the same frame and one seeded
module: counterparts of the rank-spawning tests of
``tests/test_spark_estimator.py``.

Each case fits the reference's estimator (JAX workers, one XLA CPU
device a rank) and the port's (gloo workers, ``cpu_devices=1``) at
once, in two threads, and holds the history, the final ``state_dict``
and ``transform``'s outputs bitwise.  Every case is bitwise at 2 ranks:
a 2-rank sum is one float32 addition in either package and the Average
halves it exactly.  The counterparts of the reference's ``slow`` cases
keep that mark.  The last tests show the device rule: the port's
default backend asks for the card and its workers raise, naming
``--cpu-devices 1``, where there is none; nothing falls back to the
CPU.
"""

import copy
import io
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tests"))

import horovod_tpu_torch.spark as port_spark  # noqa: E402
from torch_port_spark_util import (  # noqa: E402,F401
    PACKAGES,
    _column,
    _regression_frame,
    both,
    flight_dir,
)
from torch_port_util import no_leaked_reference  # noqa: E402,F401


def _seeded_linear(seed=3):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(4, 1))


def _backend(pkg):
    # the reference's default is one XLA CPU device a rank; the port's
    # CPU is asked for explicitly
    return pkg.LocalBackend(num_proc=2, cpu_devices=1)


def _torch_fits(tmp_path, frame, module, **kw):
    """Fit a deep copy of ``module`` through each package's
    ``TorchEstimator`` (SGD lr 0.1 unless given, MSE), at 2 ranks."""
    lr = kw.pop("lr", 0.1)
    loss = kw.pop("loss", F.mse_loss)

    def make(pkg, name):
        model = copy.deepcopy(module)
        est = pkg.TorchEstimator(
            model=model,
            optimizer=torch.optim.SGD(model.parameters(), lr=lr),
            loss=loss, feature_cols=["features"], label_cols=["label"],
            verbose=0, backend=_backend(pkg),
            store=pkg.LocalStore(str(tmp_path / name)), **kw)
        return lambda: (est.fit(frame), est)

    out = both(make)
    for name, r in out.items():
        if isinstance(r, Exception):
            raise AssertionError(f"{name} fit failed") from r
    return {name: r[0] for name, r in out.items()}


def _same_state(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def _held(models, frame, x):
    """History, final state_dict and transform outputs bitwise, and the
    reference's own claim that transform is the module's forward."""
    ref, port = models["ref"], models["port"]
    assert ref.getHistory() == port.getHistory()
    assert _same_state(ref.getModel().state_dict(),
                       port.getModel().state_dict())
    outs = {n: _column(m.transform(frame)) for n, m in models.items()}
    assert outs["ref"].dtype == outs["port"].dtype
    assert outs["ref"].tobytes() == outs["port"].tobytes()
    with torch.no_grad():
        direct = port.getModel()(torch.from_numpy(x)).numpy().reshape(-1)
    np.testing.assert_array_equal(outs["port"].astype(np.float32), direct)
    return outs["port"]


class TestTorchEstimator:
    def test_fit_transform_checkpoint_2proc(self, tmp_path):
        df, x, y = _regression_frame()
        module = _seeded_linear()
        models = _torch_fits(tmp_path, df, module, batch_size=32,
                             epochs=3, validation=0.2, random_seed=7)
        tm = models["port"]
        assert isinstance(tm, port_spark.TorchModel)
        hist = tm.getHistory()
        # training must actually train, and validation must be tracked
        assert hist["loss"][-1] < hist["loss"][0]
        assert len(hist["val_loss"]) == 3
        out = _held(models, df, x)
        # the checkpoint landed in the Store, a file of CPU tensors the
        # driver loads without CUDA
        store = tm.getStore()
        assert store.get_checkpoints(tm.getRunId()) == ["checkpoint.pt"]
        ckpt = torch.load(os.path.join(
            store.get_checkpoint_path(tm.getRunId()), "checkpoint.pt"),
            weights_only=True)
        assert set(ckpt) == {"model", "optimizer", "epoch"}
        assert ckpt["epoch"] == 2
        assert all(t.device.type == "cpu" for t in ckpt["model"].values())
        assert _same_state(ckpt["model"], tm.getModel().state_dict())
        ref_store = models["ref"].getStore()
        assert os.path.exists(os.path.join(
            ref_store.get_checkpoint_path(models["ref"].getRunId()),
            "checkpoint.pt"))
        # the fit ran on the CPU, so transform runs there too
        assert next(tm.getModel().parameters()).device.type == "cpu"
        # fitting must not mutate the user's original module in place
        assert tm.getModel() is not module
        assert _same_state(module.state_dict(), _seeded_linear().state_dict())
        # dict-frame input round-trips too
        dict_out = tm.transform({"features": x, "label": y})
        np.testing.assert_array_equal(
            np.asarray(dict_out["label__output"], dtype=np.float32), out)
        with open(os.path.join(store.get_logs_path(tm.getRunId()),
                               "history.json")) as f:
            import json

            assert json.load(f) == hist

    def test_shard_smaller_than_batch_still_trains(self, tmp_path):
        """50 rows over 2 ranks at batch_size=32: every rank's shard (25
        rows) is smaller than one batch."""
        df, x, y = _regression_frame(n=50)
        models = _torch_fits(tmp_path, df, _seeded_linear(),
                             batch_size=32, epochs=4, random_seed=7)
        hist = models["port"].getHistory()
        assert hist["loss"][-1] < hist["loss"][0]
        assert all(v > 0 for v in hist["loss"])  # steps actually ran
        _held(models, df, x)

    def test_uneven_shards_bps_and_compression(self, tmp_path):
        """127 rows over 2 ranks (64/63-row shards) +
        backward_passes_per_step=2 + the fp16 wire, through the
        estimator's params."""
        df, x, y = _regression_frame(n=127)
        models = _torch_fits(tmp_path, df, _seeded_linear(),
                             batch_size=16, epochs=4,
                             backward_passes_per_step=2,
                             compression="fp16", random_seed=7)
        hist = models["port"].getHistory()
        assert len(hist["loss"]) == 4
        assert hist["loss"][-1] < hist["loss"][0]
        _held(models, df, x)

    def test_steps_cap_below_bps_raises(self, tmp_path):
        from horovod_tpu.runner import RunError as RefRunError
        from horovod_tpu_torch.runner import RunError as PortRunError

        df, x, y = _regression_frame(n=128)
        module = _seeded_linear()

        def make(pkg, name):
            model = copy.deepcopy(module)
            est = pkg.TorchEstimator(
                model=model,
                optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
                loss=F.mse_loss, feature_cols=["features"],
                label_cols=["label"], batch_size=16, epochs=1,
                verbose=0, train_steps_per_epoch=1,
                backward_passes_per_step=2, backend=_backend(pkg),
                store=pkg.LocalStore(str(tmp_path / name)))
            return lambda: est.fit(df)

        out = both(make)
        assert isinstance(out["ref"], RefRunError)
        assert isinstance(out["port"], PortRunError)
        for e in out.values():
            assert "no optimizer step" in str(e)
        assert out["ref"].worker_traceback.splitlines()[-1] \
            == out["port"].worker_traceback.splitlines()[-1]

    @pytest.mark.slow
    def test_resume_from_checkpoint_2proc(self, tmp_path):
        """Refit with the same run_id and resume_from_checkpoint=True
        continues from the Store checkpoint, in both packages alike."""
        df, x, _y = _regression_frame()
        module = _seeded_linear()
        kw = dict(batch_size=32, epochs=2, random_seed=7,
                  run_id="resume_run")
        first = _torch_fits(tmp_path, df, module,
                            resume_from_checkpoint=False, **kw)
        second = _torch_fits(tmp_path, df, module,
                             resume_from_checkpoint=True, **kw)
        fresh = _torch_fits(tmp_path / "fresh", df, module,
                            resume_from_checkpoint=False, **kw)
        for models in (first, second, fresh):
            _held(models, df, x)
        h1 = first["port"].getHistory()["loss"]
        h2 = second["port"].getHistory()["loss"]
        assert h1[-1] < h1[0]
        assert h2[0] < (h1[0] + h1[-1]) / 2
        assert h2[-1] <= h1[-1] * 1.5
        assert fresh["port"].getHistory()["loss"][0] > h2[0]

    @pytest.mark.slow
    def test_sample_weight_col_2proc(self, tmp_path):
        """The weight batch is the loss callable's third argument:
        zero-weighted poisoned rows are ignored by the weighted fit."""
        import pandas as pd

        rng = np.random.RandomState(0)
        x = rng.rand(256, 4).astype(np.float32)
        w_true = rng.randn(4, 1).astype(np.float32)
        y = x @ w_true
        weight = np.ones(256, np.float32)
        weight[::2] = 0.0
        y_corrupt = y.copy()
        y_corrupt[::2] += 25.0
        df = pd.DataFrame({"features": list(x), "label": list(y_corrupt),
                           "w": weight})

        def weighted_mse(output, label, weight):
            return ((output - label) ** 2 * weight.unsqueeze(1)).sum() \
                / weight.sum().clamp(min=1.0)

        clean = {"features": x, "label": y}
        tm = _torch_fits(tmp_path, df, _seeded_linear(), lr=0.2,
                         loss=weighted_mse, sample_weight_col="w",
                         batch_size=32, epochs=4, random_seed=7,
                         run_id="weighted")
        pred = _held(tm, clean, x)
        clean_mse = float(((pred - y.reshape(-1)) ** 2).mean())
        assert clean_mse < 0.5
        um = _torch_fits(tmp_path, df, _seeded_linear(), lr=0.2,
                         batch_size=32, epochs=4, random_seed=7,
                         run_id="unweighted")
        upred = _held(um, clean, x)
        assert float(((upred - y.reshape(-1)) ** 2).mean()) \
            > clean_mse * 10

    @pytest.mark.slow
    def test_loss_weights_and_gradient_compression_params(self, tmp_path):
        df, x, _y = _regression_frame()
        kw = dict(batch_size=32, epochs=1, train_steps_per_epoch=1,
                  random_seed=7)
        base = _torch_fits(tmp_path, df, _seeded_linear(),
                           run_id="lw_base", **kw)
        doubled = _torch_fits(tmp_path, df, _seeded_linear(),
                              run_id="lw_x2", loss_weights=[2.0], **kw)
        b = base["port"].getHistory()["loss"][0]
        d = doubled["port"].getHistory()["loss"][0]
        assert abs(d - 2.0 * b) < 1e-4 * max(abs(b), 1.0)
        fp16 = _torch_fits(tmp_path, df, _seeded_linear(),
                           run_id="gc_fp16", gradient_compression="fp16",
                           **kw)
        assert len(fp16["port"].getHistory()["loss"]) == 1
        for models in (base, doubled, fp16):
            _held(models, df, x)


class TestDeviceRule:
    def test_default_backend_asks_for_the_card(self, tmp_path,
                                               monkeypatch):
        """No backend: ``LocalBackend(num_proc=2)`` with the port's
        default device, the card.  With no card visible each worker's
        ``init()`` raises naming ``--cpu-devices 1``; nothing trains on
        the CPU (no checkpoint, no result)."""
        from horovod_tpu_torch.runner import RunError

        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        df, x, y = _regression_frame(n=64)
        model = _seeded_linear()
        est = port_spark.TorchEstimator(
            model=model,
            optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
            loss=F.mse_loss, feature_cols=["features"],
            label_cols=["label"], batch_size=16, epochs=1, verbose=0,
            run_id="card", store=port_spark.LocalStore(str(tmp_path)))
        assert est._resolve_backend()._cpu_devices is None
        with pytest.raises(RunError, match="--cpu-devices 1") as info:
            est.fit(df)
        assert "CUDA is not available" in str(info.value)
        assert est.getStore().get_checkpoints("card") == []
        # spark.run's default asks for the card in the same way (a
        # nested function: cloudpickle ships it by value)
        def init_and_report():
            import horovod_tpu_torch.torch as hvd

            hvd.init()
            try:
                return str(hvd.device())
            finally:
                hvd.shutdown()

        with pytest.raises(RunError, match="--cpu-devices 1"):
            port_spark.run(init_and_report, num_proc=1)

    def test_more_ranks_than_cards_are_refused(self, monkeypatch):
        """Two ranks on a host of one card: the second rank's ``init()``
        names the card count and ``--cpu-devices 1``; it does not move
        to the CPU."""
        from horovod_tpu_torch.core import state
        from horovod_tpu_torch.core.config import Config

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        cfg = Config(rank=1, local_rank=1)
        with pytest.raises(RuntimeError) as info:
            state._resolve_device(None, cfg)
        assert "launch at most 1 rank(s) a host, or pass --cpu-devices 1" \
            in str(info.value)
        assert state._resolve_device(None, Config(rank=0, local_rank=0)) \
            == torch.device("cuda", 0)
        assert state._resolve_device(None, Config(cpu_devices=1)) \
            == torch.device("cpu")

    def test_transform_runs_where_the_fit_ran(self, tmp_path,
                                              monkeypatch):
        """``_create_model`` puts the trained module on the device the
        rank reported, and transform's forward follows the module: a
        card fit never transforms quietly on the CPU."""
        est = port_spark.TorchEstimator(
            model=_seeded_linear(), feature_cols=["features"],
            label_cols=["label"])
        buf = io.BytesIO()
        torch.save(_seeded_linear(5).state_dict(), buf)
        moved = []
        monkeypatch.setattr(nn.Module, "to",
                            lambda self, *a, **k: moved.append(a) or self)
        tm = est._create_model(
            [{"history": {"loss": [1.0]}, "state_dict": buf.getvalue(),
              "device": "cuda:0"}], "r", None)
        assert moved == [("cuda:0",)]
        assert _same_state(tm.getModel().state_dict(),
                           _seeded_linear(5).state_dict())


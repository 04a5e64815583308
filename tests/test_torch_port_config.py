"""The port's ``Config`` and the reference's knobs, on the CPU.

* ``Config`` has the reference's fields with the reference's defaults,
  but ``eager_multidevice`` (one device a process), and ``from_env``
  reads the same variables the same way: unset, and under one setting
  of every ``HVTPU_*`` variable the fields read.
* ``HVTPU_EAGER_DEBUG`` turns the controller's prediction-abort
  diagnostics into errors on stderr, as the reference's.
* ``HVTPU_SKIP_NATIVE_BUILD`` never compiles: it loads a library already
  built, and with none it raises and names ``HVTPU_FORCE_PY_CONTROLLER``
  (the reference quietly runs its Python core).
"""

import dataclasses
import logging
import shutil
from types import SimpleNamespace

import pytest

from horovod_tpu.core.config import Config as RefConfig
from horovod_tpu_torch import Config
from horovod_tpu_torch.native import _build, core
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

KEPT_OUT = {"eager_multidevice"}    # the port runs one device a process

# one value for every variable the fields read, none of them a default
SETTING = {
    "FUSION_THRESHOLD": "1048576", "CYCLE_TIME": "2.5",
    "CACHE_CAPACITY": "17", "BATCH_D2D_MEMCOPIES": "0",
    "COMPRESSION": "fp16", "ADASUM": "1", "HIERARCHICAL_ALLREDUCE": "1",
    "UNIFORM_LOCAL_SIZE": "4", "TIMELINE": "/tmp/tl.json",
    "TIMELINE_MARK_CYCLES": "1", "TRACE": "/tmp/trace",
    "TRACE_CLOCK_PINGS": "3", "STALL_CHECK_DISABLE": "1",
    "STALL_CHECK_TIME_SECONDS": "7", "STALL_SHUTDOWN_TIME_SECONDS": "9",
    "STALL_CHECK_MODE": "strict", "STALL_HEARTBEAT_SECONDS": "0.25",
    "AUTOTUNE": "1", "AUTOTUNE_LOG": "/tmp/at.csv",
    "AUTOTUNE_WARMUP_SAMPLES": "5", "AUTOTUNE_STEPS_PER_SAMPLE": "6",
    "AUTOTUNE_GP_SAMPLES": "8", "AUTOTUNE_MODE": "grid",
    "LOG_LEVEL": "debug", "RANK": "3", "SIZE": "8", "LOCAL_RANK": "1",
    "LOCAL_SIZE": "2", "CROSS_RANK": "1", "CROSS_SIZE": "4",
    "COORDINATOR_ADDR": "10.0.0.1", "COORDINATOR_PORT": "1234",
    "START_TIMEOUT": "33", "CONTROLLER_ADDR": "10.0.0.2",
    "CONTROLLER_PORT": "4321", "ELASTIC": "1", "ELASTIC_TIMEOUT": "44",
    "ELASTIC_DISCOVERY_INTERVAL": "0.2", "MAX_RESTARTS": "3",
    "RESTART_WINDOW_SECONDS": "60", "BLACKLIST_COOLDOWN_SECONDS": "5",
    "BLACKLIST_COOLDOWN_MAX_SECONDS": "50", "PREEMPT_SIGNAL": "SIGUSR2",
    "PREEMPT_NOTICE_FILE": "/tmp/notice", "DRAIN_GRACE_SECONDS": "12",
    "FAULT_SPEC": "worker.step:kill@rank=0", "FAULT_SEED": "9",
    "CPU_DEVICES": "1",
}

NEW_FIELDS = ["adasum", "batch_d2d_memcopies", "compression",
              "controller_addr", "controller_port",
              "blacklist_cooldown_seconds", "blacklist_cooldown_max_seconds",
              "elastic_discovery_interval", "max_restarts",
              "restart_window_seconds"]


@pytest.fixture
def clean_env(monkeypatch):
    import os

    for k in list(os.environ):
        if k.startswith(("HVTPU_", "HOROVOD_")):
            monkeypatch.delenv(k)
    return monkeypatch


def _fields(cls) -> dict:
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_fields_and_defaults_are_the_references():
    ref, port = _fields(RefConfig), _fields(Config)
    assert set(ref) - set(port) == KEPT_OUT
    assert set(port) <= set(ref)
    assert {k: port[k] for k in port} == {k: ref[k] for k in port}
    assert set(NEW_FIELDS) <= set(port)


def _shared(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in KEPT_OUT}


def test_from_env_unset_is_the_references(clean_env):
    port = Config.from_env()
    assert port.max_restarts == -1
    assert _shared(port) == _shared(RefConfig.from_env())


@pytest.mark.parametrize("prefix", ["HVTPU_", "HOROVOD_"])
def test_from_env_agrees_under_one_setting(clean_env, prefix):
    for k, v in SETTING.items():
        clean_env.setenv(prefix + k, v)
    port, ref = Config.from_env(), RefConfig.from_env()
    assert _shared(port) == _shared(ref)
    assert (port.max_restarts, port.compression, port.adasum,
            port.batch_d2d_memcopies, port.controller_addr,
            port.controller_port) == (3, "fp16", True, False, "10.0.0.2",
                                      4321)
    defaults = Config()
    assert all(getattr(port, k) != getattr(defaults, k) for k in NEW_FIELDS)


def _controller(monkeypatch, debug):
    from horovod_tpu_torch.eager.controller import EagerController

    if debug:
        monkeypatch.setenv("HVTPU_EAGER_DEBUG", "1")
    else:
        monkeypatch.delenv("HVTPU_EAGER_DEBUG", raising=False)
    return EagerController(0, 1, manual=True)


@pytest.mark.parametrize("debug,level", [(False, logging.DEBUG),
                                         (True, logging.ERROR)])
def test_eager_debug_raises_the_prediction_abort_to_an_error(
        monkeypatch, caplog, debug, level):
    from horovod_tpu_torch.native import wire

    ctrl = _controller(monkeypatch, debug)
    try:
        assert ctrl._debug is debug
        # a predicted schedule that covers another tensor than the drain
        ctrl._stream = ctrl._predict_on = True
        ctrl._burst_stable = 2
        blob = wire.serialize_response_list(wire.ResponseList(
            [wire.Response(tensor_names=["a"], tensor_shapes=[(1,)])]))
        monkeypatch.setattr(ctrl._ctrl, "predict_responses",
                            lambda bits: blob)
        parsed = SimpleNamespace(cache_bypass=True, cache_bits=[1])
        with caplog.at_level(logging.DEBUG,
                             logger="horovod_tpu_torch.eager"):
            assert ctrl._try_predict(parsed, ["b"]) is False
        aborts = [r for r in caplog.records if "predict abort" in r.message]
        assert [r.levelno for r in aborts] == [level]
    finally:
        ctrl.stop()


@pytest.fixture(scope="module")
def real_library():
    """The library of the current sources, in the real build directory."""
    return _build.build()


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(core, "_lib", None)
    monkeypatch.setattr(core, "_lib_error", None)
    monkeypatch.delenv("HVTPU_FORCE_PY_CONTROLLER", raising=False)
    monkeypatch.setenv("HVTPU_SKIP_NATIVE_BUILD", "1")

    def never(out):
        raise AssertionError("compiled under HVTPU_SKIP_NATIVE_BUILD")

    monkeypatch.setattr(_build, "_compile", never)
    return tmp_path


def test_skip_native_build_without_a_library_raises(fresh_native):
    with pytest.raises(RuntimeError, match="HVTPU_FORCE_PY_CONTROLLER") as e:
        core.load()
    assert "HVTPU_SKIP_NATIVE_BUILD" in str(e.value)
    assert not list(fresh_native.glob("*.so"))


def test_skip_native_build_loads_a_library_built_before(real_library,
                                                        fresh_native,
                                                        monkeypatch):
    # the library of other sources an edit leaves behind: loaded as it
    # is, nothing compiled, its ABI checked
    old = fresh_native / "libhvt_core-0123456789abcdef.so"
    shutil.copy(real_library, old)
    assert _build.build() == old
    assert core.load().hvt_abi_version() == core.ABI_VERSION

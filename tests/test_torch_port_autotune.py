"""The port's autotuner (``horovod_tpu_torch/obs/autotune.py``, its GP in
``obs/gaussian_process.py`` and the native core) against the JAX
package's (``horovod_tpu/obs``), on the CPU.

* Under one fake ``time.monotonic`` and the same byte counts, the port's
  ``Autotuner`` gives the JAX one's candidate sequence, pinned best and
  CSV log, byte for byte, in ``grid`` mode and in ``gp`` mode.
* The controller wiring of ``tests/test_obs.py``'s
  ``TestAutotunerControllerWiring`` on CPU tensors, on both negotiation
  cores: rank 0 scores each cycle and publishes the tuner's values,
  every rank applies them from the ResponseList, and once tuned no rank
  predicts a schedule (a world of 2 controllers on the streamed plane,
  against the same world without a tuner, which predicts).
* ``init()`` makes the ``Autotuner`` under ``HVTPU_AUTOTUNE`` and hands it
  to the controller; ``shutdown()`` clears it.
* The launcher accepts ``--autotune*`` and forwards them as the JAX
  package's ``build_worker_env`` does; ``--compression int8`` and
  ``--nonfinite-action`` stay refused.
"""

import csv
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.core.config import Config as JaxConfig
from horovod_tpu.obs import autotune as jax_autotune
from horovod_tpu.runner import hosts as ref_hosts
from horovod_tpu.runner import launch as ref_launch
from horovod_tpu_torch.comm.reduce_ops import ReduceOp
from horovod_tpu_torch.core.config import Config
from horovod_tpu_torch.eager.controller import EagerController, KVTransport
from horovod_tpu_torch.obs import Autotuner
from horovod_tpu_torch.runner import hosts as port_hosts
from horovod_tpu_torch.runner import launch as port_launch
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

CORES = ["native", "py"]


@pytest.fixture
def core(request, monkeypatch):
    if request.param == "py":
        monkeypatch.setenv("HVTPU_FORCE_PY_CONTROLLER", "1")
    else:
        monkeypatch.delenv("HVTPU_FORCE_PY_CONTROLLER", raising=False)
    return request.param


class FakeClock:
    """``time.monotonic`` advancing by a seeded step at each call."""

    def __init__(self, seed: int):
        self._rng = np.random.RandomState(seed)
        self.t = 1000.0

    def __call__(self) -> float:
        self.t += float(self._rng.uniform(0.001, 0.05))
        return self.t


def _drive(tuner, monkeypatch, seed: int, steps: int):
    """Report ``steps`` steps of seeded byte counts under a fake clock;
    returns the (fusion threshold, cycle ms) in force after each."""
    monkeypatch.setattr(time, "monotonic", FakeClock(seed))
    rng = np.random.RandomState(seed + 1)
    seen = []
    for _ in range(steps):
        tuner.record_step(int(rng.randint(1 << 20, 64 << 20)))
        seen.append(tuner.current)
    return seen


@pytest.mark.parametrize("mode,steps", [("grid", 40), ("gp", 60)])
def test_candidates_pin_and_log_match_the_jax_tuner(mode, steps, tmp_path,
                                                    monkeypatch):
    runs = {}
    for name, cfg_cls, tuner_cls in (
            ("port", Config, Autotuner),
            ("jax", JaxConfig, jax_autotune.Autotuner)):
        log = tmp_path / f"{name}.csv"
        cfg = cfg_cls(autotune=True, autotune_log=str(log),
                      autotune_warmup_samples=2,
                      autotune_steps_per_sample=3, autotune_gp_samples=8,
                      autotune_mode=mode)
        monkeypatch.setattr(time, "monotonic", FakeClock(0))
        tuner = tuner_cls(cfg)
        seen = _drive(tuner, monkeypatch, 7, steps)
        runs[name] = (seen, tuner.done, tuner.current, log.read_bytes())
        monkeypatch.undo()
    assert runs["port"] == runs["jax"]
    seen, done, pinned, log = runs["port"]
    assert done and seen[-1] == pinned
    rows = list(csv.reader(log.decode().splitlines()))
    assert rows[0] == ["fusion_threshold", "cycle_time_ms", "bytes_per_sec"]
    assert len(rows) - 1 == (7 if mode == "grid" else 8)
    assert len(set(seen)) > 2


def test_explicit_grid_is_grid_mode():
    grid = [(1 << 20, 2.0), (4 << 20, 7.5)]
    tuner = Autotuner(Config(autotune_mode="gp"), grid=grid)
    ref = jax_autotune.Autotuner(JaxConfig(autotune_mode="gp"), grid=grid)
    assert tuner.mode == ref.mode == "grid"
    assert tuner.current == ref.current == grid[0]


# -- the controller ------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """The data plane under the in-process controllers."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("core", CORES, indirect=True)
def test_autotuner_applies_to_the_controller(core):
    """``tests/test_obs.py``'s wiring test on CPU tensors."""
    grid = [(1 << 20, 2.0), (4 << 20, 7.5)]
    cfg = Config(autotune=True, autotune_warmup_samples=0,
                 autotune_steps_per_sample=1)
    tuner = Autotuner(cfg, grid=grid)
    ctrl = EagerController(0, 1, manual=True, autotuner=tuner,
                           fusion_threshold=64 << 20, cycle_time_ms=1.0)
    try:
        assert type(ctrl._ctrl).__name__ == (
            "PyController" if core == "py" else "NativeController")
        # candidate 0 scores and candidate 1 is published in the next
        # ResponseList; one more cycle applies it
        ctrl.enqueue("allreduce", torch.ones(8), name="t0")
        ctrl.run_cycle_once()
        ctrl.run_cycle_once()
        assert ctrl.cycle_time_s == grid[1][1] / 1000.0
        assert ctrl._ctrl.fusion_threshold == grid[1][0]
        # the second scored step pins the best and keeps applying it
        ctrl.enqueue("allreduce", torch.ones(8), name="t1")
        ctrl.run_cycle_once()
        ctrl.run_cycle_once()
        assert tuner.done
        assert (ctrl._ctrl.fusion_threshold,
                ctrl.cycle_time_s * 1000.0) == tuner.current
        assert ctrl._tuned_seen
    finally:
        ctrl.stop()


def _world(size, tuner):
    store = dist.HashStore()
    ctrls = [EagerController(
        r, size, transport=KVTransport(r, size, client=store, timeout_s=20.0),
        cycle_time_ms=0.5, fusion_threshold=64 << 20,
        autotuner=tuner if r == 0 else None) for r in range(size)]
    for c in ctrls:
        c.start()
    return ctrls


def _steady(ctrls, steps):
    for step in range(steps):
        futs = [c.enqueue("allreduce", torch.full((4,), float(step)),
                          name=f"at/{i}", op=ReduceOp.AVERAGE)
                for c in ctrls for i in range(3)]
        for f in futs:
            assert torch.equal(f.result(timeout=20),
                               torch.full((4,), float(step)))


def _stop(ctrls):
    for c in ctrls:
        c.request_shutdown()
    for c in ctrls:
        c.stop()


@pytest.mark.parametrize("core", CORES, indirect=True)
def test_tuned_values_reach_every_rank_and_prediction_stays_off(core):
    grid = [(2 << 20, 0.5), (8 << 20, 0.75)]
    tuner = Autotuner(Config(autotune=True, autotune_warmup_samples=0,
                             autotune_steps_per_sample=2), grid=grid)
    tuned = _world(2, tuner)
    try:
        _steady(tuned, 30)
        assert tuner.done
        for c in tuned:
            assert c._tuned_seen and c._thread_error is None
            assert c._ctrl.fusion_threshold == tuner.current[0]
            assert c.cycle_time_s == tuner.current[1] / 1000.0
            assert c.predicted_bursts == 0
        assert tuned[1]._autotuner is None    # applied, not scored there
    finally:
        _stop(tuned)
    plain = _world(2, None)
    try:
        _steady(plain, 30)
        assert all(c.predicted_bursts > 0 and not c._tuned_seen
                   for c in plain)
    finally:
        _stop(plain)


def test_init_makes_the_autotuner_and_shutdown_clears_it(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.eager import get_controller

    hvd.shutdown()
    try:
        monkeypatch.setenv("HVTPU_AUTOTUNE", "1")
        monkeypatch.setenv("HVTPU_AUTOTUNE_MODE", "grid")
        monkeypatch.setenv("HVTPU_AUTOTUNE_STEPS_PER_SAMPLE", "4")
        hvd.init(device="cpu")
        st = core_state.global_state()
        assert isinstance(st.autotuner, Autotuner)
        assert st.autotuner.mode == "grid"
        assert st.autotuner._steps_per_sample == 4
        assert get_controller()._autotuner is st.autotuner
        hvd.shutdown()
        assert core_state.global_state().autotuner is None
        monkeypatch.delenv("HVTPU_AUTOTUNE")
        hvd.init(device="cpu")
        assert core_state.global_state().autotuner is None
    finally:
        hvd.shutdown()
        monkeypatch.undo()
        hvd.init(device="cpu")


# -- the launcher ----------------------------------------------------------------

AUTOTUNE_SETTINGS = [
    (["--autotune"], None),
    (["--autotune-log", "/tmp/a.csv"], None),
    (["--autotune-warmup-samples", "5"], None),
    (["--autotune-steps-per-sample", "5"], None),
    (["--autotune-bayes-opt-max-samples", "20"], None),
    ([], ("HVTPU_AUTOTUNE", "1")),
]


@pytest.mark.parametrize("flags,env", AUTOTUNE_SETTINGS)
def test_autotune_settings_launch_and_reach_the_worker_env(flags, env,
                                                           monkeypatch):
    seen = []
    monkeypatch.setattr(port_launch, "launch_workers",
                        lambda *a, **k: seen.append(a) or 0)
    if env is not None:
        monkeypatch.setenv(*env)
    assert port_launch.main(flags + ["-np", "1", "--", "true"]) == 0
    assert len(seen) == 1
    argv = flags + ["-np", "2", "--", "python", "x.py"]
    envs = []
    for launch, hosts in ((port_launch, port_hosts),
                          (ref_launch, ref_hosts)):
        args = launch.parse_args(argv)
        slot = hosts.get_host_assignments(
            hosts.parse_host_spec("localhost:2"), 2)[1]
        envs.append({k: v for k, v in launch.build_worker_env(
            {}, slot, "10.0.0.1", 4321, args).items()
            if k.startswith("HVTPU_AUTOTUNE")})
    assert envs[0] == envs[1]
    if flags:
        assert envs[0]


@pytest.mark.parametrize("flags", [["--compression", "int8"],
                                   ["--nonfinite-action", "abort"]])
def test_codec_and_nonfinite_settings_stay_refused(flags, monkeypatch,
                                                   capsys):
    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(port_launch, "launch_workers", no_spawn)
    assert port_launch.main(["--autotune"] + flags
                            + ["-np", "1", "--", "true"]) == 2
    assert "stay refused" in capsys.readouterr().err

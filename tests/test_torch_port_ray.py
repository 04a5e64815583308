"""The port's Ray executors (``horovod_tpu_torch.ray``) held against the
reference's (``horovod_tpu.ray``): counterparts of the 8 tests of
``tests/test_ray_actors.py``, driven by the same mocked ``ray`` module,
and the port's device rule.

With ``use_gpu`` off every rank's env is the reference's key for key
(uniform 2+2 and ragged 2+1 placements).  With ``use_gpu=True`` each
rank's env names no ``HVTPU_CPU_DEVICES`` and carries its host's
``CUDA_VISIBLE_DEVICES``, each local rank's own GPU at its local rank's
index (the port's ``init()`` takes ``cuda:{local_rank}``).  Where no
actor is placed (the local mode and ``ElasticRayExecutor``) the ranks
ask for the card by default and with ``use_gpu=True``: with none
visible the worker raises, naming ``--cpu-devices 1``.  The CPU is
asked for with ``use_gpu=False`` or ``cpu_devices=1``.
"""

import os
import sys
import types

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tests"))

import horovod_tpu.ray as ref_ray  # noqa: E402
import horovod_tpu_torch.ray as port_ray  # noqa: E402
from test_ray_actors import _FakeRef, _make_fake_ray  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

PACKAGES = {"ref": ref_ray, "port": port_ray}
NODES = ["10.0.0.1", "10.0.0.1", "10.0.0.2", "10.0.0.2"]


def _isolated(mod, recorded=None, tag_rank=False):
    """The fake actors run IN-PROCESS: setup records the env instead of
    writing it into this process's os.environ."""

    class Worker(mod._ActorWorker):
        def setup(self, env):
            self.env = dict(env)
            if recorded is not None:
                recorded.append(dict(env))
            return True

        def execute(self, fn, args=(), kwargs=None):
            out = fn(*args, **(kwargs or {}))
            return (int(self.env["HVTPU_RANK"]), out) if tag_rank else out

    return Worker


def _with_gpus(ray, ids_by_actor):
    """The fake ``ray`` with each actor's ``node_info`` also answering
    its GPU ids (``ray.get_gpu_ids()`` inside a real actor)."""
    remote = ray.remote

    def remote_with_gpus(**opts):
        base = remote(**opts)

        class Factory(base):
            def remote(self):
                handle = super().remote()
                inst = handle._instance
                info = inst.node_info
                ids = ids_by_actor[len(ray._state["actors"]) - 1]
                inst.node_info = lambda: info() + (list(ids),)
                return handle

        return Factory

    ray.remote = remote_with_gpus
    return ray


def _start(mod, monkeypatch, nodes=NODES, gpus=None, recorded=None,
           tag_rank=False, **kw):
    ray = _make_fake_ray(nodes)
    if gpus is not None:
        _with_gpus(ray, gpus)
    monkeypatch.setitem(sys.modules, "ray", ray)
    monkeypatch.setattr(mod, "_ActorWorker",
                        _isolated(mod, recorded, tag_rank))
    ex = mod.RayExecutor(**kw)
    ex.start()
    return ex, ray


class TestRayActorPath:
    def test_actors_created_with_resources(self, monkeypatch):
        states = []
        for mod in PACKAGES.values():
            ex, ray = _start(mod, monkeypatch, num_workers=4,
                             cpus_per_worker=3)
            st = ray._state
            assert st["remote_opts"] == [{"num_cpus": 3}]
            assert len(st["actors"]) == 4
            ex.shutdown()
            states.append((st["remote_opts"], len(st["actors"])))
        assert states[0] == states[1]

    def test_env_assignment_and_rank_order(self, monkeypatch):
        envs, results = {}, {}
        for name, mod in PACKAGES.items():
            envs[name] = []
            ex, _ray = _start(mod, monkeypatch, recorded=envs[name],
                              tag_rank=True, num_workers=4)
            results[name] = ex.run(lambda a: a * 2, args=(21,))
        recorded = envs["port"]
        assert [int(e["HVTPU_RANK"]) for e in recorded] == [0, 1, 2, 3]
        assert [e["HVTPU_LOCAL_RANK"] for e in recorded] == \
            ["0", "1", "0", "1"]
        assert [e["HVTPU_CROSS_RANK"] for e in recorded] == \
            ["0", "0", "1", "1"]
        assert all(e["HVTPU_COORDINATOR_ADDR"] == "10.0.0.1"
                   for e in recorded)
        # every env the reference's, key for key (the default use_gpu
        # off: one CPU device a rank in each)
        assert envs["ref"] == envs["port"]
        assert all(e["HVTPU_CPU_DEVICES"] == "1" for e in recorded)
        assert results["port"] == [(0, 42), (1, 42), (2, 42), (3, 42)]
        assert results["ref"] == results["port"]

    def test_run_remote_returns_refs_execute_resolves(self, monkeypatch):
        for mod in PACKAGES.values():
            ex, _ray = _start(mod, monkeypatch, num_workers=2)
            refs = ex.run_remote(lambda: "x")
            assert all(isinstance(r, _FakeRef) for r in refs)
            assert ex.execute(refs) == ["x", "x"]
            assert ex.execute(lambda: "y") == ["y", "y"]
            ex.shutdown()

    def test_shutdown_kills_actors(self, monkeypatch):
        for mod in PACKAGES.values():
            ex, ray = _start(mod, monkeypatch, num_workers=3)
            ex.shutdown()
            assert len(ray._state["killed"]) == 3
            assert ex._actors is None
            with pytest.raises(RuntimeError, match="start"):
                ex.run(abs)

    def test_env_vars_forwarded(self, monkeypatch):
        envs = {}
        for name, mod in PACKAGES.items():
            envs[name] = []
            _start(mod, monkeypatch, recorded=envs[name], num_workers=2,
                   env_vars={"MY_FLAG": "7", "HVTPU_CPU_DEVICES": "1"})
        assert all(e["MY_FLAG"] == "7" for e in envs["port"])
        assert envs["ref"] == envs["port"]

    def test_gpu_request_forwarded(self, monkeypatch):
        for mod in PACKAGES.values():
            ex, ray = _start(mod, monkeypatch, num_workers=1, use_gpu=True,
                             gpus_per_worker=2)
            assert ray._state["remote_opts"][-1] == {
                "num_cpus": 1, "num_gpus": 2}
            ex.shutdown()


class TestTopology:
    @pytest.mark.parametrize("nodes", [
        ["a", "a", "b", "b"], ["a", "a", "b"], ["a", "b", "a"],
        ["a"], ["a", "b", "c", "a", "b"]])
    @pytest.mark.parametrize("cpu_devices", [None, 1])
    def test_envs_equal_the_reference_without_gpus(self, nodes,
                                                   cpu_devices):
        infos = [(ip, 29500 + r) for r, ip in enumerate(nodes)]
        extra = {"X": "1"}
        want = ref_ray._topology_envs(infos, extra, cpu_devices)
        assert port_ray._topology_envs(infos, extra, cpu_devices) == want
        # the port's actors also answer their (empty) GPU ids
        infos3 = [info + ([],) for info in infos]
        assert port_ray._topology_envs(infos3, extra, cpu_devices) == want

    def test_ragged_cross_layout(self):
        infos = [("a", 1), ("a", 2), ("b", 3)]
        envs = port_ray._topology_envs(infos)
        assert [e["HVTPU_CROSS_SIZE"] for e in envs] == ["2", "1", "2"]
        assert [e["HVTPU_UNIFORM_LOCAL_SIZE"] for e in envs] == \
            ["0", "0", "0"]

    def test_visible_devices_put_each_rank_at_its_local_rank(self):
        infos = [("a", 1, ["3"]), ("a", 2, ["1"]), ("b", 3, ["0"]),
                 ("a", 4, ["0"])]
        envs = port_ray._topology_envs(infos, None, None, use_gpu=True)
        assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == \
            ["3,1,0", "3,1,0", "0", "3,1,0"]
        for e, (_ip, _p, ids) in zip(envs, infos):
            visible = e["CUDA_VISIBLE_DEVICES"].split(",")
            assert visible[int(e["HVTPU_LOCAL_RANK"])] == ids[0]
            assert "HVTPU_CPU_DEVICES" not in e
        # two GPUs an actor: each rank's first id at its local rank, the
        # rest after
        envs = port_ray._topology_envs(
            [("a", 1, ["0", "1"]), ("a", 2, ["2", "3"])], use_gpu=True)
        assert {e["CUDA_VISIBLE_DEVICES"] for e in envs} == {"0,2,1,3"}
        # use_gpu off: GPU ids never reach the env
        envs = port_ray._topology_envs([("a", 1, ["0"])], None, 1)
        assert "CUDA_VISIBLE_DEVICES" not in envs[0]

    def test_use_gpu_actors_get_their_hosts_visible_devices(
            self, monkeypatch):
        recorded = []
        ex, ray = _start(port_ray, monkeypatch, recorded=recorded,
                         gpus=[["1"], ["0"], ["0"], ["1"]], num_workers=4,
                         use_gpu=True)
        assert ray._state["remote_opts"] == [{"num_cpus": 1,
                                              "num_gpus": 1}]
        assert [e["CUDA_VISIBLE_DEVICES"] for e in recorded] == \
            ["1,0", "1,0", "0,1", "0,1"]
        assert not any("HVTPU_CPU_DEVICES" in e for e in recorded)
        ex.shutdown()

    def test_actor_node_info_answers_gpu_ids(self, monkeypatch):
        ray = types.ModuleType("ray")
        ray.get_gpu_ids = lambda: [2]
        monkeypatch.setitem(sys.modules, "ray", ray)
        ip, port, ids = port_ray._ActorWorker().node_info()
        assert isinstance(ip, str) and port > 0 and ids == ["2"]
        monkeypatch.setitem(sys.modules, "ray", None)
        assert port_ray._ActorWorker().node_info()[2] == []


class TestLocalFallback:
    def test_no_ray_module_falls_back(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "ray", None)
        for mod in PACKAGES.values():
            assert mod._probe_ray() is None
            ex = mod.RayExecutor(num_workers=2)
            ex.start()
            assert ex._actors is None

    def test_uninitialized_ray_falls_back(self, monkeypatch):
        ray = types.ModuleType("ray")
        ray.is_initialized = lambda: False
        monkeypatch.setitem(sys.modules, "ray", ray)
        for mod in PACKAGES.values():
            assert mod._probe_ray() is None

    def test_local_mode_runs_fn_on_two_gloo_ranks(self, monkeypatch,
                                                  tmp_path):
        """No Ray: ``run`` goes through the port's launcher, the ranks on
        the CPU over gloo (``use_gpu=False``), results ordered by rank."""
        monkeypatch.setitem(sys.modules, "ray", None)
        monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))

        def fn(scale):
            import torch

            import horovod_tpu_torch.torch as hvd

            hvd.init()
            try:
                t = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]),
                                  op=hvd.Sum, name="x")
                return (hvd.rank(), hvd.size(), str(hvd.device()),
                        float(t[0]) * scale)
            finally:
                hvd.shutdown()

        ex = port_ray.RayExecutor(num_workers=2, use_gpu=False)
        ex.start()
        assert ex.run(fn, args=(2.0,)) == [(0, 2, "cpu", 6.0),
                                           (1, 2, "cpu", 6.0)]
        ex.shutdown()

    @pytest.mark.parametrize("kw", [{"use_gpu": True}, {}],
                             ids=["use_gpu", "default"])
    def test_use_gpu_asks_for_the_card(self, monkeypatch, tmp_path, kw):
        """``use_gpu=True`` in local mode, and the default: the ranks ask
        for the card; with none visible the worker raises naming
        ``--cpu-devices 1`` and nothing runs on the CPU."""
        from horovod_tpu_torch.runner import RunError

        monkeypatch.setitem(sys.modules, "ray", None)
        monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")

        def fn():
            import horovod_tpu_torch.torch as hvd

            hvd.init()
            hvd.shutdown()
            return "ran"

        ex = port_ray.RayExecutor(num_workers=1, **kw)
        ex.start()
        with pytest.raises(RunError, match="--cpu-devices 1"):
            ex.run(fn)


class TestElasticRayExecutor:
    def test_settings_and_min_workers(self):
        for mod in PACKAGES.values():
            s = mod.ElasticRayExecutor.create_settings(
                min_np=2, max_np=4, discovery_script="/bin/d")
            ex = mod.ElasticRayExecutor(s)
            assert (ex.num_workers, ex.min_workers, ex.max_workers,
                    ex.host_discovery_script) == (4, 2, 4, "/bin/d")
            with pytest.raises(RuntimeError, match="start"):
                ex.run(abs)
        texts = []
        for mod in PACKAGES.values():
            with pytest.raises(ValueError) as info:
                mod.ElasticRayExecutor(min_workers=3, num_workers=2)
            texts.append(str(info.value))
        assert texts[0] == texts[1]

    @pytest.mark.parametrize("use_gpu,cpu_devices,want", [
        (False, 1, 1), (True, 1, None), (False, None, 1),
        (None, None, None), (None, 1, 1)])
    def test_use_gpu_is_honoured(self, monkeypatch, use_gpu, cpu_devices,
                                 want):
        """The reference accepts ``use_gpu`` and always passes
        ``cpu_devices``; the port's ranks go to the card with it and by
        default, and to the CPU when the caller asks for it."""
        from horovod_tpu_torch import runner

        seen = []
        monkeypatch.setattr(runner, "run_elastic",
                            lambda fn, **kw: seen.append(kw) or ["ok"])
        kw = {k: v for k, v in (("use_gpu", use_gpu),
                                ("cpu_devices", cpu_devices))
              if v is not None}
        ex = port_ray.ElasticRayExecutor(num_workers=2, **kw)
        ex.start()
        assert ex.run(abs, args=(1,)) == ["ok"]
        assert seen[0]["cpu_devices"] == want
        assert seen[0]["num_proc"] == 2

    @pytest.mark.parametrize("use_gpu,want", [
        (False, 1), (True, None), (None, None)])
    def test_local_run_passes_the_device_choice(self, monkeypatch,
                                                use_gpu, want):
        from horovod_tpu_torch import runner

        seen = []
        monkeypatch.setitem(sys.modules, "ray", None)
        monkeypatch.setattr(runner, "run",
                            lambda fn, **kw: seen.append(kw) or [])
        kw = {} if use_gpu is None else {"use_gpu": use_gpu}
        ex = port_ray.RayExecutor(num_workers=3, **kw)
        ex.start()
        ex.run(abs)
        assert (seen[0]["np"], seen[0]["cpu_devices"]) == (3, want)

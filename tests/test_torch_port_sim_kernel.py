"""The port's fabric simulator (``horovod_tpu_torch/sim``) below its
scenarios, held against the reference's (``horovod_tpu/sim``):

- the kernel contract of ``tests/test_sim.py``'s ``TestKernel``, run on
  both kernels: the same parked tasks named by ``DeadlockError``, the
  same budget and cancelled-timeout semantics, the same ``rng(name)``
  draws;
- the fabric's client tiers, timeouts and ``NOT_FOUND``, the same op
  counts and virtual times as the reference's fabric;
- the sim seams of the port's control plane (``preempt.use`` /
  ``_current``, ``audit.verify(client=, world=)`` and
  ``reset_sequences``), and that nothing routes through them without a
  simulator;
- determinism in the port (same seed, same log; another seed, another
  log), the catalog and the unknown-name error, the device rule, and
  that ``patch_data_plane`` restores what it stubs;
- the sim-purity rule of ``tools/hvtpulint/sim_purity.py`` on the port's
  sim files, extended to torch's ambient RNG.
"""

import ast
import json
import os
import sys
import threading
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import horovod_tpu.sim as ref_sim  # noqa: E402
import horovod_tpu_torch.sim as port_sim  # noqa: E402
from horovod_tpu.sim import fabric as ref_fabric  # noqa: E402
from horovod_tpu.sim import kernel as ref_kernel  # noqa: E402
from horovod_tpu_torch.sim import fabric as port_fabric  # noqa: E402
from horovod_tpu_torch.sim import kernel as port_kernel  # noqa: E402

from torch_port_util import no_leaked_reference  # noqa: E402,F401

pytestmark = pytest.mark.sim

KERNELS = {"reference": ref_kernel, "port": port_kernel}
FABRICS = {"reference": (ref_kernel, ref_fabric),
           "port": (port_kernel, port_fabric)}


# ---------------------------------------------------------------------------
# the kernel contract, on both kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(KERNELS))
class TestKernel:
    def test_deadlock_detection_names_parked_tasks(self, pkg):
        mod = KERNELS[pkg]
        k = mod.SimKernel(seed=0)

        def body():
            k.block(mod.WaitToken(), None,
                    "waiting for a put that never comes")

        k.spawn("stuck", body)
        with pytest.raises(mod.DeadlockError, match="stuck.*never comes"):
            k.run()

    def test_virtual_time_budget(self, pkg):
        mod = KERNELS[pkg]
        k = mod.SimKernel(seed=0)
        k.spawn("sleeper", lambda: k.sleep(1e6))
        with pytest.raises(mod.SimTimeBudgetExceeded):
            k.run(max_virtual_s=10.0)

    def test_cancelled_timeout_does_not_advance_virtual_time(self, pkg):
        mod = KERNELS[pkg]
        k = mod.SimKernel(seed=0)
        token = mod.WaitToken()
        k.spawn("getter", lambda: k.block(token, 600.0, "get"))
        k.spawn("putter", lambda: (k.sleep(0.001), k.notify(token)))
        k.run()
        assert k.now < 1.0, f"stale timeout advanced the clock: {k.now}"

    def test_task_error_propagates(self, pkg):
        k = KERNELS[pkg].SimKernel(seed=0)

        def boom():
            raise ValueError("protocol bug")

        k.spawn("bad", boom)
        with pytest.raises(ValueError, match="protocol bug"):
            k.run()

    def test_named_rng_streams_are_seed_deterministic(self, pkg):
        mod = KERNELS[pkg]
        a = mod.SimKernel(seed=7).rng("victims").random()
        b = mod.SimKernel(seed=7).rng("victims").random()
        c = mod.SimKernel(seed=8).rng("victims").random()
        d = mod.SimKernel(seed=7).rng("other").random()
        assert a == b
        assert a != c
        assert a != d

    def test_virtual_exit_is_a_base_exception(self, pkg):
        mod = KERNELS[pkg]
        assert issubclass(mod.VirtualExit, BaseException)
        assert not issubclass(mod.VirtualExit, Exception)
        k = mod.SimKernel(seed=0)

        def body():
            try:
                raise mod.VirtualExit(79)
            except Exception:  # noqa: BLE001 — must not catch the exit
                pytest.fail("except Exception swallowed a VirtualExit")

        task = k.spawn("leaver", body)
        k.run()
        assert task.exit_code == 79 and task.done


def _park_world(mod, n_stuck: int):
    """A world with sleepers, a finished task and ``n_stuck`` tasks
    parked on tokens nobody notifies; returns the DeadlockError text and
    the kernel's clock."""
    k = mod.SimKernel(seed=3)
    k.spawn("done", lambda: k.sleep(0.5))
    for i in range(n_stuck):
        k.spawn(f"stuck{i}",
                lambda i=i: k.block(mod.WaitToken(), None, f"kv.get(k{i})"),
                delay_s=0.01 * i)
    with pytest.raises(mod.DeadlockError) as e:
        k.run()
    return str(e.value), k.now


@pytest.mark.parametrize("n_stuck", [1, 8, 11])
def test_deadlock_names_the_same_parked_tasks(n_stuck):
    assert _park_world(port_kernel, n_stuck) == _park_world(ref_kernel,
                                                            n_stuck)


def _budget_world(mod):
    k = mod.SimKernel(seed=0)
    token = mod.WaitToken()
    k.spawn("getter", lambda: k.block(token, 5.0, "get(a)"))
    k.spawn("sleeper", lambda: k.sleep(30.0))
    with pytest.raises(mod.SimTimeBudgetExceeded) as e:
        k.run(max_virtual_s=20.0)
    return str(e.value), k.now, token.state


def test_budget_and_timeout_semantics_match():
    assert _budget_world(port_kernel) == _budget_world(ref_kernel)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_rng_streams_draw_the_references_values(seed):
    for name in ("victims", "link/3", "edge/1/2", "fleet-service"):
        p = port_kernel.SimKernel(seed=seed).rng(name)
        r = ref_kernel.SimKernel(seed=seed).rng(name)
        assert ([p.random() for _ in range(5)] + [p.randrange(97)]
                == [r.random() for _ in range(5)] + [r.randrange(97)])


def _log_world(mod):
    k = mod.SimKernel(seed=11)

    def body(i):
        k.sleep(0.1 * i + k.rng(f"j{i}").random() / 1e3)
        k.log("step", rank=i, value=1.0 / 3.0, t=round(k.now, 9))

    for i in range(4):
        k.spawn(f"r{i}", lambda i=i: body(i))
    k.run()
    return k.dump_events()


def test_event_log_serialisation_matches():
    assert _log_world(port_kernel) == _log_world(ref_kernel)


def test_virtual_clock_is_the_ports_clock_seam():
    from horovod_tpu_torch.core import clock

    k = port_kernel.SimKernel(seed=0)
    seen = {}

    def body():
        assert clock.get() is k.clock
        t0 = clock.monotonic()
        clock.sleep(2.5)
        seen["dt"] = clock.monotonic() - t0
        seen["wall"] = clock.wall()

    k.spawn("t", body)
    k.run()
    assert isinstance(k.clock, clock.Clock)
    assert seen["dt"] == 2.5
    assert seen["wall"] == port_kernel.VirtualClock.EPOCH + 2.5
    assert clock.installed() is None   # the caller's thread is untouched


# ---------------------------------------------------------------------------
# the fabric
# ---------------------------------------------------------------------------


def _fabric_world(pkg):
    kmod, fmod = FABRICS[pkg]
    k = kmod.SimKernel(seed=5)
    fab = fmod.SimFabric(k)
    out = []

    def writer():
        c = fab.client(1, caps="bytes")
        k.sleep(0.01)
        c.key_value_set_bytes("a/x", b"12345")
        c.key_value_set("a/y", "v")
        c.key_value_set("b/z", "w")

    def reader():
        c = fab.client(0, caps="dir")
        out.append(("blocking", c.blocking_key_value_get("a/x", 1000),
                    round(k.now, 9)))
        try:
            c.key_value_try_get("missing")
        except KeyError as e:
            out.append(("try_get", str(e), round(k.now, 9)))
        try:
            c.blocking_key_value_get("never", 50)
        except TimeoutError as e:
            out.append(("timeout", str(e), round(k.now, 9)))
        k.sleep(0.1)
        out.append(("dir", c.key_value_dir_get("a/"), round(k.now, 9)))
        c.key_value_delete("a/")
        out.append(("after", c.key_value_dir_get(""), round(k.now, 9)))
        fab.set_down(True)
        try:
            c.key_value_set("c", "1")
        except ConnectionError as e:
            out.append(("down", str(e), round(k.now, 9)))

    k.spawn("writer", writer)
    k.spawn("reader", reader)
    k.run()
    return out, dict(fab.ops)


def test_fabric_semantics_match_the_references():
    port, ref = _fabric_world("port"), _fabric_world("reference")
    assert port == ref
    kinds = [o[0] for o in port[0]]
    assert kinds == ["blocking", "try_get", "timeout", "dir", "after",
                     "down"]
    assert "NOT_FOUND" in port[0][1][1]
    assert "DEADLINE_EXCEEDED" in port[0][2][1]
    assert "UNAVAILABLE" in port[0][5][1]


@pytest.mark.parametrize("caps,methods", [
    ("str", {"key_value_set", "blocking_key_value_get",
             "key_value_try_get", "key_value_delete"}),
    ("dir", {"key_value_dir_get"}),
    ("bytes", {"key_value_dir_get", "key_value_set_bytes",
               "blocking_key_value_get_bytes", "key_value_dir_get_bytes"}),
])
def test_client_tiers_offer_the_references_methods(caps, methods):
    k = port_kernel.SimKernel(seed=0)
    c = port_fabric.SimFabric(k).client(0, caps=caps)
    rc = ref_fabric.SimFabric(ref_kernel.SimKernel(seed=0)).client(
        0, caps=caps)
    for m in methods:
        assert hasattr(c, m) and hasattr(rc, m)
    public = {m for m in dir(c) if m.startswith("key_value")}
    assert public == {m for m in dir(rc) if m.startswith("key_value")}
    with pytest.raises(ValueError, match="caps must be"):
        port_fabric.SimFabric(k).client(0, caps="grpc")


def test_fabric_env_knobs(monkeypatch):
    monkeypatch.setenv("HVTPU_SIM_LATENCY_US", "200")
    monkeypatch.setenv("HVTPU_SIM_BANDWIDTH_GBPS", "8")
    monkeypatch.setenv("HVTPU_SIM_JITTER_FRAC", "0")
    link = port_fabric.SimFabric(port_kernel.SimKernel(seed=0)).link(3)
    assert link.latency_s == pytest.approx(200e-6)
    assert link.bandwidth_bps == pytest.approx(1e9)
    assert link.delay(1000) == pytest.approx(200e-6 + 1e-6)
    monkeypatch.setenv("HVTPU_SIM_LATENCY_US", "fast")
    with pytest.raises(ValueError, match="HVTPU_SIM_LATENCY_US"):
        port_fabric.SimFabric(port_kernel.SimKernel(seed=0))


# ---------------------------------------------------------------------------
# the seams of the port's control plane
# ---------------------------------------------------------------------------


def test_preempt_use_routes_the_module_surface_per_thread():
    from horovod_tpu_torch.core import preempt

    coord = preempt._DrainCoordinator(
        rank=1, size=4, grace_s=30.0, notice_file=None, generation=0,
        client=None, start_watcher=False, shared_pending=False,
        exit_fn=lambda code: None)
    assert preempt._current() is preempt._coord
    seen = {}

    def rank_thread():
        preempt.use(coord)
        try:
            seen["current"] = preempt._current()
            seen["pending0"] = preempt.pending()
            preempt.notice("sim")
            seen["pending1"] = preempt.pending()
            seen["state"] = preempt.debug_state()
            seen["draining"] = preempt.draining_ranks()
        finally:
            preempt.use(None)
        seen["after"] = preempt._current()

    t = threading.Thread(target=rank_thread)
    t.start()
    t.join()
    assert seen["current"] is coord
    assert seen["pending0"] is False and seen["pending1"] is True
    assert seen["state"]["departing"] is True
    assert seen["state"]["reason"] == "sim"
    assert seen["after"] is preempt._coord
    # the caller's thread never saw the virtual rank's notice
    assert preempt.pending() is preempt.PENDING
    assert preempt._current() is preempt._coord
    coord.stop()


def test_audit_verify_takes_an_injected_client_and_world():
    from horovod_tpu_torch.core import audit
    from horovod_tpu_torch.sim import WorldView

    k = port_kernel.SimKernel(seed=0)
    fab = port_fabric.SimFabric(k)
    reports = {}

    def rank(r):
        def body():
            reports[r] = audit.verify(
                {"w": [1.0, 2.0 if r != 2 else 9.0]}, label="t",
                action="warn", timeout_s=60.0,
                client=fab.client(r, caps="str"), world=WorldView(r, 3, 0))
        return body

    audit.reset_sequences()
    for r in range(3):
        k.spawn(f"r{r}", rank(r))
    k.run()
    assert all(rep["ranks"] == [2] for rep in reports.values())
    assert fab.ops["put"] == 3 and fab.ops["get"] == 6
    # a second round reuses the label: a fresh sequence number
    assert audit._seq[(0, 0, "t")] == 1
    audit.reset_sequences()
    assert audit._seq == {}


def test_audit_without_a_world_is_the_process_state():
    from horovod_tpu_torch.core import audit

    rep = audit.verify({"x": torch.ones(2)}, label="solo", action="abort")
    assert rep == {"label": "solo", "divergent": {}, "ranks": []}


def test_nested_dir_get_is_only_the_simulators():
    from horovod_tpu_torch.core.kv import StoreKV
    from horovod_tpu_torch.core.retry import resilient_kv
    from horovod_tpu_torch.fleet.job import prefixed_client

    fab = port_fabric.SimFabric(port_kernel.SimKernel(seed=0))
    assert resilient_kv(fab.client(0, caps="dir")).nested_dir_get is True
    assert prefixed_client(fab.client(0, caps="dir"),
                           "j").nested_dir_get is True
    assert not hasattr(fab.client(0, caps="str"), "nested_dir_get")
    assert not hasattr(StoreKV(None, 2), "nested_dir_get")
    assert prefixed_client(StoreKV(None, 2), "j").nested_dir_get is False


def test_patch_data_plane_restores_what_it_stubs():
    from horovod_tpu_torch.comm import eager as eager_comm
    from horovod_tpu_torch.eager import controller

    names = ("allreduce", "grouped_allreduce", "allgather", "broadcast",
             "alltoall", "reducescatter", "barrier",
             "_reduce", "_resolve_process_set", "count_collective")
    before = {n: getattr(eager_comm, n) for n in names}
    group = controller.GroupReduction
    x = torch.arange(3.0)
    with port_sim.patch_data_plane():
        assert eager_comm.allreduce(x) is x
        assert eager_comm.barrier() is None
        assert controller.GroupReduction(None).reduce([x]) == [x]
    assert {n: getattr(eager_comm, n) for n in names} == before
    assert controller.GroupReduction is group


# ---------------------------------------------------------------------------
# the catalog, determinism and the device rule
# ---------------------------------------------------------------------------


def _dump(result):
    return "".join(json.dumps(rec, sort_keys=True) + "\n"
                   for rec in result["events"])


def test_catalog_is_the_references():
    from horovod_tpu.sim.scenarios import SCENARIOS as ref_catalog

    assert list(port_sim.SCENARIOS) == list(ref_catalog)
    assert sorted(port_sim.__all__) == sorted(ref_sim.__all__)
    for name, fn in port_sim.SCENARIOS.items():
        assert ((fn.__doc__ or "").strip().split("\n")[0]
                == (ref_catalog[name].__doc__ or "").strip().split("\n")[0])


def test_unknown_scenario_raises_the_references_error():
    with pytest.raises(KeyError) as port_err:
        port_sim.run_scenario("no-such-scenario", 8)
    with pytest.raises(KeyError) as ref_err:
        ref_sim.run_scenario("no-such-scenario", 8)
    assert str(port_err.value) == str(ref_err.value)
    assert "steady-drain" in str(port_err.value)


@pytest.mark.parametrize("name", ["steady-drain", "kill-blacklist",
                                  "checkpoint-storm",
                                  "compression-negotiation",
                                  "coordinator-loss", "lossy-link"])
def test_same_seed_byte_identical(name):
    a = _dump(port_sim.run_scenario(name, 16, seed=7, device="cpu"))
    b = _dump(port_sim.run_scenario(name, 16, seed=7, device="cpu"))
    assert a == b
    assert a, "scenario produced an empty event log"


def test_different_seed_diverges():
    a = _dump(port_sim.run_scenario("kv-brownout", 16, seed=7, steps=2))
    b = _dump(port_sim.run_scenario("kv-brownout", 16, seed=8, steps=2))
    assert a != b, "chaos timing ignores the seed"


def test_controller_scenarios_need_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in port_sim.scenarios.CONTROLLER_SCENARIOS:
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_sim.run_scenario(name, 8, seed=7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_sim.scenarios.bench_negotiation(8, 0)
    # scenarios without tensors ignore the device
    r = port_sim.run_scenario("thundering-rendezvous", 8, seed=7)
    assert "devices" not in r


def test_controller_scenario_payloads_follow_the_device():
    r = port_sim.run_scenario("compression-negotiation", 8, seed=7,
                              device="cpu")
    assert r["devices"] == ["cpu"]
    assert r["virtual_s"] > 0
    assert port_sim.scenarios.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# sim purity: no host clock, no ambient randomness
# ---------------------------------------------------------------------------


class _TorchRngVisitor(ast.NodeVisitor):
    """torch's ambient RNG: ``torch.manual_seed`` anywhere, and
    ``torch.rand*`` / ``randn*`` / ``randint*`` / ``randperm`` without a
    ``generator=``."""

    def __init__(self):
        self.hits = []

    def visit_Call(self, node):
        fn = node.func
        if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                and fn.value.id == "torch"):
            if fn.attr in ("manual_seed", "seed"):
                self.hits.append((node.lineno, f"torch.{fn.attr}"))
            elif fn.attr.startswith(("rand", "normal", "bernoulli",
                                     "multinomial", "poisson")):
                if not any(kw.arg == "generator" for kw in node.keywords):
                    self.hits.append((node.lineno, f"torch.{fn.attr}"))
        self.generic_visit(node)


def _sim_files():
    files = sorted((REPO / "horovod_tpu_torch" / "sim").glob("*.py"))
    assert {f.name for f in files} >= {
        "__init__.py", "__main__.py", "kernel.py", "fabric.py",
        "context.py", "workers.py", "transport.py", "scenarios.py"}
    return files


def test_sim_purity_no_host_clock_or_module_random():
    from tools.hvtpulint.sim_purity import _Visitor

    hits = []
    for path in _sim_files():
        v = _Visitor()
        v.visit(ast.parse(path.read_text(), filename=str(path)))
        hits += [(path.name, line, what) for line, what in v.hits]
    assert hits == []


def test_sim_purity_no_ambient_torch_rng():
    hits = []
    for path in _sim_files():
        v = _TorchRngVisitor()
        v.visit(ast.parse(path.read_text(), filename=str(path)))
        hits += [(path.name, line, what) for line, what in v.hits]
    assert hits == []


@pytest.mark.parametrize("src,want", [
    ("import time\ntime.sleep(1)\n", ["time.sleep"]),
    ("from time import monotonic as m\nm()\n", ["time.monotonic"]),
    ("import random\nrandom.random()\nrandom.Random(3)\n",
     ["random.random"]),
])
def test_purity_visitor_catches_host_clock_and_random(src, want):
    from tools.hvtpulint.sim_purity import _Visitor

    v = _Visitor()
    v.visit(ast.parse(src))
    assert [w for _, w in v.hits] == want


@pytest.mark.parametrize("src,want", [
    ("torch.manual_seed(0)\n", ["torch.manual_seed"]),
    ("torch.rand(3)\ntorch.randn(2, generator=g)\n", ["torch.rand"]),
    ("torch.randint(0, 5, (2,))\ntorch.tensor([1.0])\n",
     ["torch.randint"]),
])
def test_torch_rng_visitor_catches_ambient_draws(src, want):
    v = _TorchRngVisitor()
    v.visit(ast.parse(src))
    assert [w for _, w in v.hits] == want


def test_sim_package_imports_nothing_of_the_reference():
    forbidden = ("jax", "jaxlib", "horovod_tpu", "tools")
    for path in _sim_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in forbidden, (path.name, n)
    assert os.path.isfile(REPO / "horovod_tpu_torch" / "sim" / "__main__.py")

"""The port's elastic driver and host discovery
(``horovod_tpu_torch/elastic/{driver,discovery}.py``).

* ``HostDiscoveryScript`` / ``HostManager`` behave as the JAX package's
  classes on the same scripts and the same fake clock (the diff, the
  cooldown doubling and its cap, readmission, strike decay,
  ``exhausted``, the hints file), and so do ``ElasticDriver``'s restart
  budget and coordinator re-election: the cases of
  ``tests/test_elastic.py``, parametrized over the two packages; resets
  that keep relaunching the same world stop after ``--max-restarts`` in
  both, and the port's timeout falls back to its ``Config``.
* On gloo (``--cpu-devices 1``), the narrow-ResNet elastic worker of
  ``torch_port_util.elastic_incarnation`` killed in generation 0 and
  relaunched by the driver ends bitwise at the uninterrupted run's model
  and optimizer state (the uninterrupted run is a static ``-np 1``
  launch); a discovery script that goes from ``localhost:2`` to
  ``localhost:1`` resizes the world: exits 73 and 73, then 0, and the
  relaunched worker sees a world of one.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_port_util import ELASTIC_EPOCHS, ELASTIC_IMAGES, \
    ELASTIC_BATCH, committed_step
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
SCRIPT = TESTS / "torch_port_driver_script.py"
PKGS = {"ref": "horovod_tpu", "port": "horovod_tpu_torch"}
both = pytest.mark.parametrize("pkg", ["ref", "port"])


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _script(tmp_path, content, name="discover.sh"):
    p = tmp_path / name
    p.write_text(f"#!/bin/sh\n{content}\n")
    p.chmod(0o755)
    return str(p)


def _manager(pkg, tmp_path, spec="a:2\nb:2", base=10.0):
    disc = _mod(pkg, "elastic.discovery")
    hosts_file = tmp_path / "hosts.txt"
    hosts_file.write_text(spec + "\n")
    return disc.HostManager(
        disc.HostDiscoveryScript(_script(tmp_path, f'cat "{hosts_file}"')),
        cooldown_base_s=base), hosts_file


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def monotonic(self):
        return self.t

    def wall(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds

    def call_later(self, delay_s, fn):  # pragma: no cover
        raise AssertionError("no timers expected in these paths")


@pytest.fixture
def fake_clock(request):
    clock = _mod(request.node.callspec.params["pkg"], "core.clock")
    fc = _FakeClock()
    clock.install(fc)
    try:
        yield fc
    finally:
        clock.install(None)


# -- discovery -----------------------------------------------------------------

@both
def test_parse_hosts_and_slots(pkg, tmp_path):
    disc = _mod(pkg, "elastic.discovery")
    script = _script(tmp_path, 'echo "hostA:2"; echo "# c"; echo "hostB:3";'
                     ' echo "hostA:1"')
    assert disc.HostDiscoveryScript(script).find_available_hosts_and_slots() \
        == {"hostA": 3, "hostB": 3}


@both
def test_script_failure_raises(pkg, tmp_path):
    disc = _mod(pkg, "elastic.discovery")
    with pytest.raises(RuntimeError, match="boom"):
        disc.HostDiscoveryScript(_script(
            tmp_path, "echo boom >&2; exit 3")).find_available_hosts_and_slots()


@both
def test_diff_and_blacklist(pkg, tmp_path):
    mgr, hosts_file = _manager(pkg, tmp_path)
    assert mgr.refresh() is True and mgr.available_slots() == 4
    assert mgr.refresh() is False
    hosts_file.write_text("a:2\n")
    assert mgr.refresh() is True and mgr.host_spec() == "a:2"
    mgr.blacklist_host("a")
    hosts_file.write_text("a:2\nb:1\n")
    assert mgr.refresh() is True
    assert (mgr.available_slots(), mgr.host_spec()) == (1, "b:1")


@both
def test_cooldown_doubles_and_caps(pkg, tmp_path):
    mgr, _ = _manager(pkg, tmp_path)
    assert [mgr.blacklist_host("a", now=100.0) for _ in range(3)] == \
        [10.0, 20.0, 40.0]
    assert mgr.strikes("a") == 3
    mgr.cooldown_max_s = 25.0
    assert mgr.blacklist_host("a", now=0.0) == 25.0


@both
def test_readmission_and_decay(pkg, tmp_path):
    mgr, _ = _manager(pkg, tmp_path)
    mgr.blacklist_host("a", now=100.0)
    assert mgr.refresh(now=105.0) is True and mgr.host_spec() == "b:2"
    assert mgr.refresh(now=111.0) is True and mgr.host_spec() == "a:2,b:2"
    mgr.blacklist_host("a", now=0.0)
    mgr.record_success("a")
    mgr.record_success("a")
    assert mgr.strikes("a") == 0
    mgr.record_success("a")
    assert mgr.blacklist_host("a", now=0.0) == 10.0


@both
def test_exhausted_and_next_readmission(pkg, tmp_path):
    mgr, _ = _manager(pkg, tmp_path)
    mgr.refresh(now=100.0)
    assert mgr.exhausted(2, now=100.0) is False
    mgr.blacklist_host("a", now=100.0)
    mgr.blacklist_host("b", now=100.0)
    mgr.blacklist_host("b", now=100.0)
    mgr.refresh(now=105.0)
    assert mgr.exhausted(2, now=105.0) is True
    assert mgr.next_readmission_s(now=105.0) == 5.0
    assert mgr.exhausted(2, now=115.0) is False


@both
def test_hints_round_trip(pkg, tmp_path):
    mgr, _ = _manager(pkg, tmp_path)
    mgr.blacklist_host("a", now=100.0)
    mgr.blacklist_host("a", now=100.0)
    path = str(tmp_path / "state" / "host_hints.json")
    mgr.save_hints(path, now=105.0)
    other, _ = _manager(pkg, tmp_path)
    assert other.load_hints(path, now=0.0) == 1
    assert other.strikes("a") == 2
    assert other.next_readmission_s(now=0.0) == 15.0
    assert other.load_hints(str(tmp_path / "missing.json")) == 0


def test_hints_file_crosses_packages(tmp_path):
    ref, _ = _manager("ref", tmp_path)
    ref.blacklist_host("h", now=0.0)
    path = str(tmp_path / "hints.json")
    ref.save_hints(path, now=0.0)
    port, _ = _manager("port", tmp_path)
    assert port.load_hints(path, now=0.0) == 1
    assert port.strikes("h") == 1


@both
def test_cooldown_on_the_clock_seam(pkg, tmp_path, fake_clock):
    mgr, _ = _manager(pkg, tmp_path)
    mgr.refresh()
    fake_clock.t = 100.0
    assert mgr.blacklist_host("a") == 10.0
    assert mgr.next_readmission_s() == pytest.approx(10.0)
    fake_clock.t = 105.0
    assert mgr.blacklisted_now() == ["a"] and mgr.refresh() is True
    fake_clock.t = 110.5
    assert mgr.blacklisted_now() == [] and mgr.refresh() is True
    assert mgr.strikes("a") == 1
    fake_clock.t = 120.0
    mgr.blacklist_host("b")
    assert mgr.exhausted(min_np=1) is False
    mgr.blacklist_host("a")
    assert mgr.exhausted(min_np=1) is True


# -- the driver: budget and re-election ---------------------------------------

def _driver(pkg, tmp_path, hosts="localhost:2", **kw):
    drv = _mod(pkg, "elastic.driver")
    disc = _mod(pkg, "elastic.discovery")
    lines = "\n".join(f"echo {h}" for h in hosts.split(","))
    return drv.ElasticDriver(
        command=["true"],
        discovery=disc.HostDiscoveryScript(_script(tmp_path, lines)),
        min_np=2, state_dir=str(tmp_path), **kw)


@both
def test_budget_unlimited_by_default(pkg, tmp_path):
    d = _driver(pkg, tmp_path)
    assert all(d._restart_budget_ok() for _ in range(50))


@both
@pytest.mark.parametrize("budget", [0, 2])
def test_budget_trips(pkg, budget, tmp_path, capsys):
    d = _driver(pkg, tmp_path, max_restarts=budget)
    d._last_crash_summary = "rank 1 on localhost exited 1"
    assert [d._restart_budget_ok() for _ in range(budget + 1)] == \
        [True] * budget + [False]
    err = capsys.readouterr().err
    assert "restart budget exhausted" in err
    assert "rank 1 on localhost exited 1" in err


@both
def test_budget_window_on_the_clock_seam(pkg, tmp_path, fake_clock, capsys):
    d = _driver(pkg, tmp_path, max_restarts=1, restart_window=60.0)
    fake_clock.t = 0.0
    assert d._restart_budget_ok() is True
    fake_clock.t = 120.0
    assert d._restart_budget_ok() is True
    fake_clock.t = 121.0
    assert d._restart_budget_ok() is False


def _slots(pkg, d, np_):
    hosts_mod = _mod(pkg, "runner.hosts")
    return hosts_mod.get_host_assignments(
        hosts_mod.parse_host_spec(d.hosts.host_spec()), np_)


@both
def test_blacklisted_rank0_host_moves_the_coordinator(pkg, tmp_path):
    flight = _mod(pkg, "obs.flight")
    d = _driver(pkg, tmp_path, hosts="hosta:2,hostb:2")
    d.hosts.refresh()
    d._generation += 1
    assert d._elect_coordinator(_slots(pkg, d, 4)) == "hosta"
    d._generation += 1
    flight.install(rank="driver", out_dir=str(tmp_path))
    try:
        d.hosts.blacklist_host("hosta")
        assert d.hosts.refresh() is True
        assert d._elect_coordinator(_slots(pkg, d, 2)) == "hostb"
        evs = [e for e in flight.get_recorder().events()
               if e["kind"] == "coordinator_reelected"]
        assert [(e["old"], e["new"], e["generation"]) for e in evs] == \
            [("hosta", "hostb", 1)]
    finally:
        flight.uninstall()


@both
def test_stable_coordinator_emits_no_event(pkg, tmp_path):
    flight = _mod(pkg, "obs.flight")
    d = _driver(pkg, tmp_path, hosts="hosta:2,hostb:2")
    d.hosts.refresh()
    flight.install(rank="driver", out_dir=str(tmp_path))
    try:
        assert d._elect_coordinator(_slots(pkg, d, 4)) == "hosta"
        assert d._elect_coordinator(_slots(pkg, d, 4)) == "hosta"
        assert not [e for e in flight.get_recorder().events()
                    if e["kind"] == "coordinator_reelected"]
    finally:
        flight.uninstall()


class _Exited:
    """A worker that has exited with ``code`` (what ``_finish_incarnation``
    reads of a ``WorkerProcess``)."""

    def __init__(self, rank, code):
        self.rank, self.code = rank, code

    def poll(self):
        return self.code

    def terminate(self, grace_s=None):
        pass

    def wait(self, timeout=None):
        return self.code


@pytest.mark.parametrize("codes,port,ref", [
    ([73, 73], "reset", "restart"),
    ([0, 73], "reset", "restart"),
    ([1, 73], "restart", "restart"),
    ([79, 73], "drain", "drain"),
    ([89, 73], "restart", "restart"),
    ([-15, 73], "restart", "restart"),
])
def test_incarnation_outcome(codes, port, ref, tmp_path):
    """How an ended incarnation is charged.  Both packages: a crash, a
    fence or a worker the escalation killed is a charged restart, a drain
    is not.  A reset (exit 73) with none of those beside it: the port
    relaunches it uncharged, as the exit-code table of
    ``docs/robustness.md`` says ("only if accompanied by a crash"); the
    JAX package's driver charges it (ROADMAP Queue C)."""
    for pkg, want in (("port", port), ("ref", ref)):
        (tmp_path / pkg).mkdir()
        d = _driver(pkg, tmp_path / pkg)
        d.hosts.refresh()
        workers = [_Exited(r, c) for r, c in enumerate(codes)]
        crashed = [(w, c) for w, c in zip(workers, codes)
                   if c not in (0, 73, 79, 89)]
        assert d._finish_incarnation(workers, _slots(pkg, d, 2),
                                     crashed) == want, pkg


def _loop(pkg, tmp_path, monkeypatch, outcomes, specs, **kw):
    """Run ``_run_loop`` with the launch and supervision stubbed: each
    incarnation ends with the next of ``outcomes`` and, before the next
    discovery, the hosts file becomes the next of ``specs``.  Returns the
    exit code and the host spec of every launch."""
    d, hosts_file = _manager(pkg, tmp_path, spec=specs[0])
    drv = _mod(pkg, "elastic.driver")
    driver = drv.ElasticDriver(command=["true"], discovery=d._discovery,
                               min_np=1, state_dir=str(tmp_path), **kw)
    launched = []
    ends = iter(outcomes)
    nexts = iter(specs[1:])

    def supervise(workers, slots):
        hosts_file.write_text(next(nexts, specs[-1]) + "\n")
        return next(ends)

    monkeypatch.setattr(driver, "_spawn", lambda slots, port: launched.append(
        driver.hosts.host_spec()) or [])
    monkeypatch.setattr(driver, "_supervise", supervise)
    return driver._run_loop(), launched


@both
def test_resets_into_the_same_world_are_bounded(pkg, tmp_path, monkeypatch,
                                                fake_clock, capsys):
    """Workers that ask for a reset every time, with no membership change:
    both packages stop after ``--max-restarts`` relaunches (the JAX
    package charges each reset to the restart budget; the port bounds
    resets in a row into the same world by the same number)."""
    code, launched = _loop(pkg, tmp_path, monkeypatch, ["reset"] * 5,
                           ["a:2"], max_restarts=2)
    assert code == 1 and launched == ["a:2"] * 3
    assert "--max-restarts=2" in capsys.readouterr().err


def test_resets_that_change_the_world_relaunch_uncharged(tmp_path,
                                                         monkeypatch):
    """Under ``--max-restarts 1``, resets each followed by a membership
    change are not counted: the port relaunches every one, and a charged
    restart in between starts the count of resets into the same world
    afresh; the job ends cleanly."""
    code, launched = _loop(
        "port", tmp_path, monkeypatch,
        ["reset", "reset", "reset", "restart", "reset", "done"],
        ["a:2", "a:2\nb:2", "a:2", "a:2", "a:2\nb:2", "a:2\nb:2"],
        max_restarts=1)
    assert code == 0
    assert launched == ["a:2", "a:2,b:2", "a:2", "a:2", "a:2,b:2",
                        "a:2,b:2"]


@pytest.mark.parametrize("flag,env,want", [
    (None, None, 600.0), (None, "42", 42.0), (7.0, "42", 7.0)])
def test_elastic_timeout_flag_then_config(flag, env, want, tmp_path,
                                          monkeypatch):
    """The driver's timeout: ``--elastic-timeout``, else the port's
    ``Config`` (``HVTPU_ELASTIC_TIMEOUT``), else 600 s."""
    drv = _mod("port", "elastic.driver")
    if env is not None:
        monkeypatch.setenv("HVTPU_ELASTIC_TIMEOUT", env)
    monkeypatch.setattr(drv.ElasticDriver, "run", lambda self: 0)
    argv = ["--host-discovery-script", _script(tmp_path, "echo a:1"),
            "-np", "1"]
    if flag is not None:
        argv += ["--elastic-timeout", str(flag)]
    argv += ["--", "true"]
    code, driver = drv.run_elastic_driver(
        _mod("port", "runner.launch").parse_args(argv))
    assert code == 0 and driver.elastic_timeout == want


# -- the driver on gloo --------------------------------------------------------

def _run(tmp, argv, extra, timeout=240):
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "HVTPU_FAULT_SPEC",
              "HVT_USR1_AFTER", "HVT_TERM_AFTER"):
        env.pop(k, None)
    env.update({"PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)]),
                "JAX_PLATFORMS": "cpu", "HVTPU_FLIGHT_DIR": str(tmp),
                "HVTPU_CKPT_FSYNC": "0",
                "HVTPU_ELASTIC_DISCOVERY_INTERVAL": "0.2"})
    env.update(extra)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *argv],
        env=env, cwd=str(tmp), capture_output=True, text=True,
        timeout=timeout)


def _ended(stderr: str):
    """(outcome, exits) of every incarnation, from the driver's
    ``--verbose`` lines."""
    return [(m.group(1), json.loads(m.group(2))) for m in re.finditer(
        r"generation \d+ ended: (\w+), exits (\[[^\]]*\])", stderr)]


@pytest.fixture(scope="module")
def crash_runs(tmp_path_factory):
    plain = tmp_path_factory.mktemp("plain")
    p = _run(plain, ["-np", "1", "--cpu-devices", "1", "--",
                     sys.executable, str(SCRIPT), "elastic"],
             {"HVT_PKG": "port", "HVT_LOG": str(plain / "log.jsonl"),
              "HVT_OUT": str(plain / "out.pt"), "HVTPU_ELASTIC": "1",
              "HVTPU_ELASTIC_STATE_DIR": str(plain / "state"),
              "HVTPU_ELASTIC_GENERATION": "0"})
    el = tmp_path_factory.mktemp("driver")
    plan = {"0": {"HVTPU_FAULT_SPEC": "worker.step:kill@count=4"}}
    d = _run(el, ["--host-discovery-script",
                  _script(el, "echo localhost:1"), "--min-np", "1",
                  "--max-np", "1", "--cpu-devices", "1", "--verbose", "--",
                  sys.executable, str(SCRIPT), "elastic"],
             {"HVT_PKG": "port", "HVT_LOG": str(el / "log.jsonl"),
              "HVT_OUT": str(el / "out.pt"), "HVT_PLAN": json.dumps(plan),
              "HVTPU_ELASTIC_STATE_DIR": str(el / "state")})
    return p, plain, d, el


def test_driver_relaunches_a_killed_worker(crash_runs):
    p, _, d, el = crash_runs
    assert p.returncode == 0, p.stderr[-3000:]
    assert d.returncode == 0, d.stderr[-3000:]
    assert _ended(d.stderr) == [("restart", [1]), ("done", [0])]
    assert "relaunch charged to the restart budget (1 charged)" in d.stderr
    # the kill's line reached the driver through the rank-0 pump
    assert "[0]<stderr>:" in d.stderr
    total = ELASTIC_EPOCHS * ELASTIC_IMAGES // ELASTIC_BATCH
    assert committed_step(el / "state", "port") == total


def test_driver_run_bitwise_the_uninterrupted_run(crash_runs):
    _, plain, _, el = crash_runs
    want = torch.load(plain / "out.pt")
    got = torch.load(el / "out.pt")
    for k, t in want["model"].items():
        assert torch.equal(got["model"][k], t), k
    assert len(got["momentum"]) == len(want["momentum"])
    for a, b in zip(got["momentum"], want["momentum"]):
        assert torch.equal(a, b)
    gens = {json.loads(line)["gen"]
            for line in (el / "log.jsonl").read_text().splitlines()}
    assert gens == {0, 1}


def test_discovery_shrink_resizes_the_world(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("localhost:2\n")
    log = tmp_path / "log.jsonl"
    d = _run(tmp_path, ["--host-discovery-script",
                        _script(tmp_path, f'cat "{hosts}"'),
                        "--cpu-devices", "1", "--verbose", "--",
                        sys.executable, str(SCRIPT), "resize"],
             {"HVT_LOG": str(log), "HVT_HOSTS_FILE": str(hosts),
              "HVTPU_ELASTIC_STATE_DIR": str(tmp_path / "state")},
             timeout=120)
    assert d.returncode == 0, d.stderr[-3000:]
    assert _ended(d.stderr) == [("reset", [73, 73]), ("done", [0])]
    assert "relaunch charged" not in d.stderr
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert {r["size"] for r in recs if r["gen"] == 0} == {2}
    assert {(r["size"], r["rank"]) for r in recs if r["gen"] == 1} == {(1, 0)}
    last = [r["step"] for r in recs if r["gen"] == 1]
    assert last[-1] == 8 and last == list(range(last[0], 9))

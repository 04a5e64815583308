"""The port's fleet arbiter (``horovod_tpu_torch/fleet``) held against the
reference's (``horovod_tpu/fleet``), case by case of
``tests/test_fleet.py``'s unit tier.

Every case runs its body once on each package (:func:`twin`): the same
fake discovery, the same fake runner and the same fake clock, each
installed through that package's own ``core.clock.install``.  Both
bodies assert the reference's expectations; besides, after every
``tick`` the twin records ``debug_state()``, the events of the tick and
the bytes of every file in the fleet directory (``state.json``, the
intake journal and its cursor, the rejection files), and the two
packages' records must be equal.  The CLI cases run
``python -m horovod_tpu_torch.fleet``'s ``main`` beside
``tools.hvtpufleet.__main__.main``: the same exit codes, output and
files.  The health cases hold ``summarize`` to the same dict and each
package's readers to the other's summaries.

CPU only, no processes: the real runner and driver are
``tests/test_torch_port_fleet_runner.py``'s.
"""

import json
import os
import re
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import horovod_tpu.fleet as _ref_fleet  # noqa: E402
import horovod_tpu_torch.fleet as _port_fleet  # noqa: E402
from horovod_tpu.core import clock as _ref_clock  # noqa: E402
from horovod_tpu.fleet import autoscale as _ref_autoscale  # noqa: E402
from horovod_tpu.fleet import health as _ref_health  # noqa: E402
from horovod_tpu.obs import metrics as _ref_metrics  # noqa: E402
from horovod_tpu_torch.core import clock as _port_clock  # noqa: E402
from horovod_tpu_torch.fleet import autoscale as _port_autoscale  # noqa: E402,E501
from horovod_tpu_torch.fleet import health as _port_health  # noqa: E402
from horovod_tpu_torch.obs import metrics as _port_metrics  # noqa: E402
from horovod_tpu_torch.fleet.__main__ import main as _port_cli  # noqa: E402
from tools.hvtpufleet.__main__ import main as _ref_cli  # noqa: E402

from torch_port_util import no_leaked_reference  # noqa: E402,F401


class Pkg:
    """One package's fleet and the modules its cases touch."""

    def __init__(self, name, fleet, clock, metrics, autoscale, health,
                 cli_main):
        self.name = name
        self.fleet = fleet
        self.clock = clock
        self.metrics = metrics
        self.autoscale = autoscale
        self.health = health
        self.cli_main = cli_main


REF = Pkg("ref", _ref_fleet, _ref_clock, _ref_metrics, _ref_autoscale,
          _ref_health, _ref_cli)
PORT = Pkg("port", _port_fleet, _port_clock, _port_metrics,
           _port_autoscale, _port_health, _port_cli)


# ---------------------------------------------------------------------------
# shared fakes (the reference's, package-independent)
# ---------------------------------------------------------------------------


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


class _FakeDiscovery:
    """Mutable pool: duck-types HostDiscoveryScript."""

    def __init__(self, hosts=None):
        self.hosts = dict(hosts or {})

    def find_available_hosts_and_slots(self):
        return dict(self.hosts)


class _FakeRunner:
    """Handle-protocol fake: the test scripts the drain/relaunch
    transitions the real ElasticJobRunner derives from its driver."""

    def __init__(self, job):
        self.name = job.name
        self.charged_restarts = 0
        self.drains = 0
        self._phase = "pending"
        self._np = 0
        self._alloc = {}
        self._target = None
        self._exit = None
        self.shrink_requests = []
        self.escalations = 0
        self.stopped = False
        self.refuse_shrink = False
        self.started = False

    def start(self, allocation):
        self.started = True
        self._alloc = dict(allocation)
        self._np = sum(allocation.values())
        self._phase = "running"

    def poll(self):
        return self._exit

    def phase(self):
        return self._phase

    def current_np(self):
        return self._np

    def target_np(self):
        return self._target

    def allocation(self):
        return dict(self._alloc)

    def request_shrink(self, new_np):
        if self.refuse_shrink or self._phase != "running":
            return False
        self.shrink_requests.append(new_np)
        self._target = new_np
        self._phase = "draining"
        return True

    def escalate(self):
        victims = self._np - (self._target or self._np)
        self.escalations += 1
        self.charged_restarts += 1  # bare SIGTERM = crash = charged
        self._apply_target()
        self._phase = "running"
        return victims

    def update_allocation(self, allocation):
        self._alloc = dict(allocation)
        self._np = sum(allocation.values())

    def stop(self):
        self.stopped = True

    def drain_lands(self):
        self.drains += 1
        self._apply_target()
        self._phase = "resizing"

    def relaunch(self):
        self._phase = "running"
        self._np = sum(self._alloc.values())

    def exit(self, code):
        self._exit = code
        self._alloc = {}

    def _apply_target(self):
        shed = self._np - self._target
        for h in sorted(self._alloc, reverse=True):
            if shed <= 0:
                break
            got = min(self._alloc[h], shed)
            self._alloc[h] -= got
            shed -= got
        self._alloc = {h: n for h, n in self._alloc.items() if n > 0}
        self._np = self._target
        self._target = None


def _files(d):
    """Relative path -> text of every file under ``d``."""
    out = {}
    for root, _dirs, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read().decode("latin-1")
    return out


class Run:
    """One package's side of a twin case: its fake clock (installed
    through the package's own seam), its arbiters and the record of
    every tick."""

    def __init__(self, pkg, root, capsys=None):
        self.pkg = pkg
        self.F = pkg.fleet
        self.root = root
        root.mkdir(parents=True, exist_ok=True)
        self.clock = _FakeClock(t=1000.0)
        self.trace = []
        self._capsys = capsys
        self._n_arbiters = 0

    def __enter__(self):
        self.pkg.clock.install(self.clock)
        return self

    def __exit__(self, *exc):
        self.pkg.clock.install(None)

    def _norm(self, obj):
        text = json.dumps(obj, sort_keys=True, default=repr)
        return json.loads(text.replace(str(self.root), "<root>"))

    def spec(self, name, min_np=1, max_np=None, priority=0, **kw):
        return self.F.JobSpec(name, ["job-cmd"], min_np=min_np,
                              max_np=max_np, priority=priority, **kw)

    def fleet_dir(self):
        d = self.root / "fleet"
        (d / "submit").mkdir(parents=True, exist_ok=True)
        (d / "cancel").mkdir(exist_ok=True)
        return d

    def journal(self, fleet_dir):
        return self.F.SubmitJournal(str(fleet_dir))

    def arbiter(self, hosts, *, fleet_dir=None, runner_factory=_FakeRunner,
                **kw):
        pool = _FakeDiscovery(hosts)
        events = []

        def event_fn(kind, **fields):
            events.append((kind.replace("fleet.", "", 1), fields))

        arb = self.F.FleetArbiter(
            pool, fleet_dir=str(fleet_dir) if fleet_dir else None,
            runner_factory=runner_factory, event_fn=event_fn,
            register_debug=False, **kw)
        arb.pool = pool
        arb.events = events
        index = self._n_arbiters
        self._n_arbiters += 1
        seen = [0]
        tick = arb.tick

        def recorded_tick():
            try:
                tick()
            finally:
                snap = {"arbiter": index, "debug": arb.debug_state(),
                        "events": events[seen[0]:]}
                seen[0] = len(events)
                if fleet_dir:
                    snap["files"] = _files(fleet_dir)
                self.trace.append(self._norm(snap))

        arb.tick = recorded_tick
        return arb

    def std(self):
        """The reference's ``arbiter`` fixture: 2 hosts of 4 slots."""
        return self.arbiter({"h1": 4, "h2": 4}, tick_s=0.5,
                            drain_grace_s=30.0)

    def cli(self, *argv, files=None):
        """Run the package's CLI; records (exit code, stdout, stderr)
        and the files under ``files``; returns the record."""
        main = self.pkg.cli_main
        self._capsys.readouterr()
        try:
            rc = main([str(a) for a in argv])
        except SystemExit as e:
            rc = ("SystemExit", e.code)
        out, err = self._capsys.readouterr()
        rec = self._norm({"rc": rc, "out": out, "err": err})
        if files is not None:
            rec["files"] = self._norm(_files(files))
        self.trace.append(rec)
        return rec


def twin(tmp_path, body, capsys=None):
    """Run ``body(run)`` on the reference, then on the port; their
    records and their return values must be equal."""
    out = {}
    for pkg in (REF, PORT):
        with Run(pkg, tmp_path / pkg.name, capsys) as r:
            res = body(r)
        out[pkg.name] = (r.trace, res)
    (ref_trace, ref_res), (port_trace, port_res) = out["ref"], out["port"]
    assert len(port_trace) == len(ref_trace)
    for i, (want, got) in enumerate(zip(ref_trace, port_trace)):
        assert got == want, f"record {i}: the port differs from the reference"
    assert port_res == ref_res
    return out


def _kinds(arb):
    return [k for k, _ in arb.events]


# ---------------------------------------------------------------------------
# JobSpec validation matrix
# ---------------------------------------------------------------------------


_BAD_SPECS = [
    ("name", {"name": "bad name!"}),
    ("name", {"name": ""}),
    ("name", {"name": "-leading-dash"}),
    ("command", {"command": []}),
    ("command", {"command": "not-a-list"}),
    ("command", {"command": ["ok", ""]}),
    ("priority", {"priority": -1}),
    ("priority", {"priority": "hi"}),
    ("priority", {"priority": True}),
    ("min_np", {"min_np": 0}),
    ("min_np", {"min_np": 2.5}),
    ("max_np", {"min_np": 4, "max_np": 2}),
    ("max_np", {"max_np": 0}),
    ("env", {"env": {"A": 1}}),
    ("env", {"env": "PATH=x"}),
    ("max_restarts", {"max_restarts": -2}),
    ("restart_window", {"restart_window": -1}),
    ("drain_grace", {"drain_grace": 0.1}),
    ("autoscale.high", {"autoscale": {"low": 1}}),
    ("autoscale.low", {"autoscale": {"high": 1, "low": 2}}),
    ("autoscale.step", {"autoscale": {"high": 2, "low": 1, "step": 0}}),
    ("autoscale.debounce_s",
     {"autoscale": {"high": 2, "low": 1, "debounce_s": -1}}),
    ("autoscale.signal_file",
     {"autoscale": {"high": 2, "low": 1, "signal_file": ""}}),
    ("autoscale.bogus", {"autoscale": {"high": 2, "low": 1, "bogus": 1}}),
    ("frobnicate", {"frobnicate": 1}),
]
_BAD_IDS = [f"{f}-{i}" for i, (f, _) in enumerate(_BAD_SPECS)]


def _spec_error(pkg, d):
    with pytest.raises(pkg.fleet.FleetSpecError) as ei:
        pkg.fleet.JobSpec.from_dict(d)
    return ei.value.field, str(ei.value)


class TestJobSpecValidation:
    @pytest.mark.parametrize("field,overlay", _BAD_SPECS, ids=_BAD_IDS)
    def test_malformed_field_is_named(self, field, overlay):
        d = {"name": "ok", "command": ["run"]}
        d.update(overlay)
        ref, port = _spec_error(REF, d), _spec_error(PORT, d)
        assert port == ref
        assert port[0] == field and f"field '{field}'" in port[1]

    @pytest.mark.parametrize("missing", ["name", "command"])
    def test_required_fields(self, missing):
        d = {"name": "ok", "command": ["run"]}
        del d[missing]
        assert _spec_error(PORT, d) == _spec_error(REF, d)
        assert _spec_error(PORT, d)[0] == missing

    def test_non_object_spec(self):
        assert _spec_error(PORT, [1, 2]) == _spec_error(REF, [1, 2])
        assert _spec_error(PORT, [1, 2])[0] == "spec"

    def test_load_invalid_json_and_missing_file(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        got = {}
        for pkg in (REF, PORT):
            F = pkg.fleet
            with pytest.raises(F.FleetSpecError, match="invalid JSON") as ei:
                F.JobSpec.load(str(p))
            assert ei.value.field == "spec"
            with pytest.raises(F.FleetSpecError, match="unreadable") as e2:
                F.JobSpec.load(str(tmp_path / "absent.json"))
            got[pkg.name] = (str(ei.value), str(e2.value))
        assert got["port"] == got["ref"]

    def test_round_trip(self):
        dicts = []
        for pkg in (REF, PORT):
            spec = pkg.fleet.JobSpec(
                "train-a", ["python", "t.py"], priority=3, min_np=2,
                max_np=8, env={"K": "v"}, max_restarts=2,
                restart_window=60.0, drain_grace=5.0,
                autoscale={"high": 10, "low": 2, "step": 2})
            again = pkg.fleet.JobSpec.from_dict(spec.to_dict())
            assert again.to_dict() == spec.to_dict()
            dicts.append(json.dumps(spec.to_dict(), sort_keys=True))
        assert dicts[1] == dicts[0]

    def test_effective_max(self):
        for pkg in (REF, PORT):
            def spec(**kw):
                return pkg.fleet.JobSpec("a", ["job-cmd"], **kw)
            assert spec(min_np=2).effective_max(8) == 8
            assert spec(min_np=2).effective_max() == 2
            assert spec(min_np=2, max_np=16).effective_max(8) == 8
            assert spec(min_np=2, max_np=4).effective_max(8) == 4


class TestLifecycle:
    def test_illegal_transition_raises(self, tmp_path):
        def body(r):
            F = r.F
            j = F.Job(r.spec("a"), 1)
            with pytest.raises(RuntimeError,
                               match="illegal transition") as e1:
                j.to(F.RESIZING)
            for s in (F.RUNNING, F.DRAINING, F.RESIZING, F.RUNNING,
                      F.DONE):
                j.to(s)
            assert j.terminal
            with pytest.raises(RuntimeError,
                               match="illegal transition") as e2:
                j.to(F.RUNNING)
            return [str(e1.value), str(e2.value), r._norm(j.info())]

        twin(tmp_path, body)

    def test_queue_wait_stamped_once(self, tmp_path):
        def body(r):
            j = r.F.Job(r.spec("a"), 1)
            r.clock.t += 12.5
            j.to(r.F.RUNNING)
            assert j.queue_wait_s == pytest.approx(12.5)
            return r._norm(j.info())

        twin(tmp_path, body)


# ---------------------------------------------------------------------------
# job-scoped KV prefixing
# ---------------------------------------------------------------------------


class _StrKV:
    def __init__(self):
        self.d = {}

    def key_value_set(self, k, v):
        self.d[k] = v

    def blocking_key_value_get(self, k, timeout_ms):
        return self.d[k]

    def key_value_try_get(self, k):
        return self.d.get(k)

    def key_value_delete(self, k):
        self.d.pop(k, None)


class _DirKV(_StrKV):
    def key_value_dir_get(self, prefix):
        return sorted((k, v) for k, v in self.d.items()
                      if k.startswith(prefix))


class _BytesKV(_DirKV):
    def key_value_set_bytes(self, k, v):
        self.d[k] = v

    def blocking_key_value_get_bytes(self, k, timeout_ms):
        return self.d[k]

    def key_value_try_get_bytes(self, k):
        return self.d.get(k)


class TestPrefixedClient:
    def _both(self, fn):
        got = {}
        for pkg in (REF, PORT):
            inner = _DirKV()
            got[pkg.name] = (fn(pkg.fleet.prefixed_client, inner), inner.d)
        assert got["port"] == got["ref"]
        return got["port"]

    def test_jobs_are_namespaced_apart(self):
        def fn(pc, inner):
            a, b = pc(inner, "job-a"), pc(inner, "job-b")
            a.key_value_set("hvtdrain/0/notice/3", "x")
            assert "fleet/job-a/hvtdrain/0/notice/3" in inner.d
            assert b.key_value_try_get("hvtdrain/0/notice/3") is None
            return a.key_value_try_get("hvtdrain/0/notice/3")

        assert self._both(fn)[0] == "x"

    def test_dir_get_reroots_results(self):
        def fn(pc, inner):
            a = pc(inner, "job-a")
            a.key_value_set("hvtdrain/0/notice/1", "n1")
            a.key_value_set("hvtdrain/0/notice/2", "n2")
            pc(inner, "job-b").key_value_set("hvtdrain/0/notice/9",
                                             "other")
            return a.key_value_dir_get("hvtdrain/0/notice")

        assert self._both(fn)[0] == [("hvtdrain/0/notice/1", "n1"),
                                     ("hvtdrain/0/notice/2", "n2")]

    def test_capability_tiers_are_mirrored(self):
        for pkg in (REF, PORT):
            pc = pkg.fleet.prefixed_client
            assert not hasattr(pc(_StrKV(), "j"), "key_value_dir_get")
            assert hasattr(pc(_DirKV(), "j"), "key_value_dir_get")
            assert not hasattr(pc(_DirKV(), "j"), "key_value_set_bytes")
            b = pc(_BytesKV(), "j")
            b.key_value_set_bytes("k", b"v")
            assert b.key_value_try_get_bytes("k") == b"v"

    def test_delete_is_scoped(self):
        def fn(pc, inner):
            a = pc(inner, "job-a")
            a.key_value_set("k", "v")
            a.key_value_delete("k")

        assert self._both(fn)[1] == {}

    def test_port_prefix_over_the_store_client(self):
        """The port's prefixed client over its own store client
        (``core/kv.py`` ``StoreKV``) keeps the reference's layout."""
        import torch.distributed as dist

        from horovod_tpu_torch.core.kv import StoreKV

        store = dist.HashStore()
        a = PORT.fleet.prefixed_client(StoreKV(store, 1), "job-a")
        a.key_value_set("health", "{}")
        assert store.get("fleet/job-a/health") == b"{}"
        assert a.key_value_try_get("health") == "{}"


# ---------------------------------------------------------------------------
# gang scheduling + preemption edge cases (fake clock, fake runners)
# ---------------------------------------------------------------------------


class TestGangScheduling:
    def test_full_gang_or_nothing(self, tmp_path):
        def body(r):
            arb = r.std()
            j1 = arb.submit(r.spec("holder", min_np=5, max_np=5))
            j2 = arb.submit(r.spec("waiter", min_np=5, max_np=5))
            arb.tick()
            assert j1.state == r.F.RUNNING
            assert sum(j1.allocation.values()) == 5
            assert j2.state == r.F.PENDING
            assert j2.allocation == {} and j2.handle is None
            arb.tick()
            arb.tick()
            assert _kinds(arb).count("job_waiting") == 1

        twin(tmp_path, body)

    def test_backfill_behind_starved_job(self, tmp_path):
        def body(r):
            arb = r.std()
            arb.submit(r.spec("holder", min_np=4, max_np=4))
            big = arb.submit(r.spec("big", min_np=6, max_np=6))
            small = arb.submit(r.spec("small", min_np=2, max_np=2))
            arb.tick()
            assert big.state == r.F.PENDING
            assert small.state == r.F.RUNNING

        twin(tmp_path, body)

    def test_never_fits_fails_fast_with_diagnostic(self, tmp_path):
        def body(r):
            arb = r.std()
            j = arb.submit(r.spec("galaxy", min_np=100))
            arb.tick()
            assert j.state == r.F.FAILED
            assert "min_np=100" in j.reason
            assert "8 total slots" in j.reason
            assert "job_unschedulable_fatal" in _kinds(arb)
            return j.reason

        twin(tmp_path, body)

    def test_start_time_expansion_toward_max(self, tmp_path):
        def body(r):
            arb = r.std()
            j = arb.submit(r.spec("wide", min_np=2, max_np=6))
            arb.tick()
            assert sum(j.allocation.values()) == 6
            assert j.handle.started
            return j.allocation

        twin(tmp_path, body)

    def test_no_expansion_while_another_waits(self, tmp_path):
        def body(r):
            arb = r.std()
            wide = arb.submit(r.spec("wide", min_np=2))
            arb.submit(r.spec("waiter", min_np=20))
            arb.cancel("waiter")
            arb.submit(r.spec("waiter2", min_np=7, max_np=7))
            arb.tick()
            assert sum(wide.allocation.values()) == 2

        twin(tmp_path, body)

    def test_duplicate_live_name_rejected(self, tmp_path):
        def body(r):
            arb = r.std()
            arb.submit(r.spec("dup"))
            with pytest.raises(r.F.FleetSpecError) as ei:
                arb.submit(r.spec("dup"))
            assert ei.value.field == "name"
            return str(ei.value)

        twin(tmp_path, body)

    def test_resubmit_after_terminal_ok(self, tmp_path):
        def body(r):
            arb = r.std()
            j = arb.submit(r.spec("again", min_np=2, max_np=2))
            arb.tick()
            j.handle.exit(0)
            arb.tick()
            assert j.state == r.F.DONE
            j2 = arb.submit(r.spec("again", min_np=2, max_np=2))
            arb.tick()
            assert j2.state == r.F.RUNNING

        twin(tmp_path, body)

    def test_queue_wait_measured_on_injected_clock(self, tmp_path):
        def body(r):
            arb = r.std()
            arb.pool.hosts = {}
            j = arb.submit(r.spec("late", min_np=4, max_np=4))
            arb.tick()
            assert j.state == r.F.PENDING
            r.clock.t += 7.5
            arb.pool.hosts = {"h1": 4}
            arb.tick()
            assert j.state == r.F.RUNNING
            assert j.queue_wait_s == pytest.approx(7.5)
            start = [f for k, f in arb.events if k == "job_start"][0]
            assert start["queue_wait_s"] == pytest.approx(7.5)

        twin(tmp_path, body)

    def test_cancel_pending_and_running(self, tmp_path):
        def body(r):
            F = r.F
            arb = r.std()
            p = arb.submit(r.spec("p", min_np=20))
            assert arb.cancel("p") is True
            assert p.state == F.FAILED and p.reason == "cancelled"
            j = arb.submit(r.spec("r", min_np=2, max_np=2))
            arb.tick()
            assert arb.cancel("r") is True
            assert j.handle.stopped
            j.handle.exit(1)
            arb.tick()
            assert j.state == F.FAILED and j.reason == "cancelled"
            assert arb.cancel("r") is False
            assert arb.cancel("ghost") is False

        twin(tmp_path, body)

    def test_run_until_idle_on_fake_clock(self, tmp_path):
        class _InstantRunner(_FakeRunner):
            def poll(self):
                return 0 if self.started else None

        def body(r):
            arb = r.arbiter({"h1": 4}, tick_s=0.5,
                            runner_factory=_InstantRunner)
            j = arb.submit(r.spec("quick", min_np=2, max_np=2))
            t0 = r.clock.t
            arb.run(until_idle=True)
            assert j.state == r.F.DONE
            assert r.clock.t > t0
            return r.clock.t - t0

        twin(tmp_path, body)


class TestPreemption:
    @staticmethod
    def _running_pair(r, arb):
        old = arb.submit(r.spec("old-lo", min_np=2, max_np=5))
        young = arb.submit(r.spec("young-lo", min_np=2, max_np=5))
        arb.tick()
        assert sum(old.allocation.values()) == 5
        assert sum(young.allocation.values()) == 3
        return old, young

    def test_youngest_victim_yields_first(self, tmp_path):
        def body(r):
            arb = r.std()
            old, young = self._running_pair(r, arb)
            hi = arb.submit(r.spec("hi", min_np=1, max_np=1, priority=5))
            arb.tick()
            assert young.state == r.F.DRAINING
            assert young.handle.shrink_requests == [2]
            assert old.state == r.F.RUNNING
            assert old.handle.shrink_requests == []
            assert hi.state == r.F.PENDING

        twin(tmp_path, body)

    def test_preempt_spreads_across_victims_toward_min(self, tmp_path):
        def body(r):
            arb = r.std()
            old, young = self._running_pair(r, arb)
            arb.submit(r.spec("hi", min_np=4, max_np=4, priority=5))
            arb.tick()
            assert young.handle.shrink_requests == [2]
            assert old.handle.shrink_requests == [2]

        twin(tmp_path, body)

    def test_never_below_min_reports_waiting(self, tmp_path):
        def body(r):
            arb = r.std()
            old, young = self._running_pair(r, arb)
            hi = arb.submit(r.spec("hi", min_np=5, max_np=5, priority=5))
            arb.tick()
            assert old.state == r.F.RUNNING
            assert young.state == r.F.RUNNING
            assert old.handle.shrink_requests == []
            assert hi.state == r.F.PENDING
            waits = [f for k, f in arb.events if k == "job_waiting"]
            assert len(waits) == 1 and waits[0]["missing"] == 1

        twin(tmp_path, body)

    def test_drain_resize_lifecycle_and_latency(self, tmp_path):
        def body(r):
            F = r.F
            arb = r.std()
            old, young = self._running_pair(r, arb)
            hi = arb.submit(r.spec("hi", min_np=4, max_np=4, priority=5))
            arb.tick()
            assert young.state == F.DRAINING and old.state == F.DRAINING
            r.clock.t += 1.0
            young.handle.drain_lands()
            old.handle.drain_lands()
            arb.tick()
            assert young.state == F.RESIZING
            assert young.handle.drains == 1
            r.clock.t += 0.5
            young.handle.relaunch()
            old.handle.relaunch()
            arb.tick()
            assert young.state == F.RUNNING and old.state == F.RUNNING
            assert young.preemptions == 1
            assert young.charged_restarts == 0
            assert old.charged_restarts == 0
            assert young.shrink_deadline is None
            resized = [f for k, f in arb.events if k == "resized"]
            assert resized and resized[0]["resize_s"] == pytest.approx(1.5)
            assert hi.state == F.RUNNING
            assert sum(hi.allocation.values()) == 4

        twin(tmp_path, body)

    def test_grace_expiry_escalates_and_charges(self, tmp_path):
        def body(r):
            arb = r.std()
            _old, young = self._running_pair(r, arb)
            arb.submit(r.spec("hi", min_np=1, max_np=1, priority=5))
            arb.tick()
            assert young.state == r.F.DRAINING
            r.clock.t += 30.0
            arb.tick()
            assert young.handle.escalations == 1
            assert "drain_grace_expired" in _kinds(arb)
            arb.tick()
            assert young.charged_restarts == 1
            assert young.state == r.F.RUNNING
            r.clock.t += 60.0
            arb.tick()
            assert young.handle.escalations == 1

        twin(tmp_path, body)

    def test_shrink_retries_between_incarnations(self, tmp_path):
        def body(r):
            arb = r.std()
            holder = arb.submit(r.spec("holder", min_np=2, max_np=2))
            vict = arb.submit(r.spec("vict", min_np=2, max_np=6))
            arb.tick()
            assert sum(vict.allocation.values()) == 6
            arb.submit(r.spec("hi", min_np=4, max_np=4, priority=5))
            vict.handle.refuse_shrink = True
            arb.tick()
            assert vict.state == r.F.RUNNING
            vict.handle.refuse_shrink = False
            arb.tick()
            assert vict.state == r.F.DRAINING
            assert vict.handle.shrink_requests == [2]
            assert holder.handle.shrink_requests == []

        twin(tmp_path, body)

    def test_equal_priority_never_preempts(self, tmp_path):
        def body(r):
            arb = r.std()
            old, young = self._running_pair(r, arb)
            peer = arb.submit(r.spec("peer", min_np=3, max_np=3))
            arb.tick()
            arb.tick()
            assert peer.state == r.F.PENDING
            assert old.handle.shrink_requests == []
            assert young.handle.shrink_requests == []

        twin(tmp_path, body)


# ---------------------------------------------------------------------------
# autoscaling: debounce / cooldown on the injected clock
# ---------------------------------------------------------------------------


def _evaluations(steps, **kw):
    """The same signal sequence through both packages' Autoscaler:
    [(now, value)] -> the list of decisions (equal across packages)."""
    got = {}
    for pkg in (REF, PORT):
        sig = {"v": None}
        asc = pkg.fleet.Autoscaler(lambda s=sig: s["v"], **kw)
        out = []
        for now, v in steps:
            sig["v"] = v
            out.append(asc.evaluate(now=now))
        got[pkg.name] = (out, asc.debug_state())
    assert got["port"] == got["ref"]
    return got["port"][0]


class TestAutoscaler:
    def test_debounce_requires_sustained_signal(self):
        out = _evaluations(
            [(100.0, 50.0), (103.0, 50.0), (104.0, 5.0), (105.0, 50.0),
             (110.0, 50.0)],
            high=10, low=2, step=2, debounce_s=5.0, cooldown_s=0.0)
        assert out == [None, None, None, None, ("grow", 2)]

    def test_cooldown_blocks_thrash(self):
        out = _evaluations(
            [(100.0, 50.0), (105.0, 50.0), (119.9, 50.0), (121.0, 50.0)],
            high=10, low=2, step=1, debounce_s=0.0, cooldown_s=20.0)
        assert out == [("grow", 1), None, None, ("grow", 1)]

    def test_shrink_on_low_watermark(self):
        out = _evaluations([(10.0, 1.0), (14.0, 1.0)], high=10, low=2,
                           step=3, debounce_s=4.0, cooldown_s=0.0)
        assert out == [None, ("shrink", 3)]

    def test_no_signal_resets_never_acts(self):
        out = _evaluations(
            [(0.0, 50.0), (10.0, None), (11.0, 50.0), (14.0, 50.0)],
            high=10, low=2, debounce_s=3.0, cooldown_s=0.0)
        assert out == [None, None, None, ("grow", 1)]

    def test_inverted_watermarks_rejected(self):
        msgs = []
        for pkg in (REF, PORT):
            with pytest.raises(ValueError, match="inverted") as ei:
                pkg.fleet.Autoscaler(lambda: None, high=1, low=2)
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]

    def test_file_signal(self, tmp_path):
        p = tmp_path / "depth"
        for pkg in (REF, PORT):
            if p.exists():
                p.unlink()
            sig = pkg.autoscale.FileSignal(str(p))
            assert sig() is None
            p.write_text("42.5\n")
            assert sig() == 42.5
            p.write_text("not a number")
            assert sig() is None

    def test_from_spec_env_fallback(self, tmp_path, monkeypatch):
        for pkg in (REF, PORT):
            monkeypatch.delenv("HVTPU_FLEET_AUTOSCALE_SIGNAL_FILE",
                               raising=False)
            assert pkg.fleet.Autoscaler.from_spec(
                {"high": 2, "low": 1}) is None
            monkeypatch.setenv("HVTPU_FLEET_AUTOSCALE_SIGNAL_FILE",
                               str(tmp_path / "s"))
            asc = pkg.fleet.Autoscaler.from_spec({"high": 2, "low": 1})
            assert isinstance(asc.signal_fn, pkg.autoscale.FileSignal)

    def test_arbiter_grow_and_shrink(self, tmp_path):
        def body(r):
            F = r.F
            arb = r.std()
            j = arb.submit(r.spec("serve", min_np=2, max_np=6))
            filler = arb.submit(r.spec("filler", min_np=6, max_np=6))
            arb.tick()
            assert sum(j.allocation.values()) == 2
            sig = {"v": 5.0}
            arb.attach_autoscaler(
                "serve", F.Autoscaler(lambda: sig["v"], high=10, low=2,
                                      step=2, debounce_s=1.0,
                                      cooldown_s=0.0))
            filler.handle.exit(0)
            arb.tick()
            assert filler.state == F.DONE
            sig["v"] = 40.0
            arb.tick()
            r.clock.t += 1.0
            arb.tick()
            assert sum(j.allocation.values()) == 4
            assert j.handle.current_np() == 4
            sig["v"] = 1.0
            r.clock.t += 5.0
            arb.tick()
            r.clock.t += 1.0
            arb.tick()
            assert j.state == F.DRAINING
            assert j.handle.shrink_requests == [2]
            grow = [f for k, f in arb.events
                    if k == "autoscale" and f["direction"] == "grow"]
            shrink = [f for k, f in arb.events
                      if k == "autoscale" and f["direction"] == "shrink"]
            assert len(grow) == 1 and len(shrink) == 1

        twin(tmp_path, body)

    def test_grow_clamped_by_pool_and_max(self, tmp_path):
        def body(r):
            arb = r.std()
            j = arb.submit(r.spec("serve", min_np=2, max_np=3))
            arb.tick()
            assert sum(j.allocation.values()) == 3
            arb.attach_autoscaler(
                "serve", r.F.Autoscaler(lambda: 99.0, high=10, low=2,
                                        step=4, debounce_s=0.0,
                                        cooldown_s=0.0))
            arb.tick()
            assert sum(j.allocation.values()) == 3

        twin(tmp_path, body)


# ---------------------------------------------------------------------------
# spool protocol, crash recovery
# ---------------------------------------------------------------------------


def _write_spec(d, name="spooled", **overlay):
    spec = {"name": name, "command": ["run"], "min_np": 2, "max_np": 2}
    spec.update(overlay)
    p = d / f"{name}.json"
    p.write_text(json.dumps(spec))
    return str(p)


class TestSpoolProtocol:
    @staticmethod
    def _arbiter(r, fd):
        return r.arbiter({"h1": 4}, fleet_dir=fd, tick_s=0.5)

    def test_spooled_spec_starts_and_state_published(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            spec = _write_spec(fd / "submit")
            arb.tick()
            assert not os.path.exists(spec)
            assert arb.jobs["spooled"].state == r.F.RUNNING
            state = json.loads((fd / "state.json").read_text())
            assert state["pool"]["slots_total"] == 4
            assert state["jobs"][0]["name"] == "spooled"
            assert state["jobs"][0]["state"] == "RUNNING"

        twin(tmp_path, body)

    def test_malformed_spool_rejected_with_error_file(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            _write_spec(fd / "submit", name="bad", min_np=0)
            arb.tick()
            assert "bad" not in arb.jobs
            err = (fd / "rejected" / "bad.json.error").read_text()
            assert "min_np" in err

        twin(tmp_path, body)

    def test_cancel_marker(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            _write_spec(fd / "submit")
            arb.tick()
            (fd / "cancel" / "spooled").write_text("cancel\n")
            arb.tick()
            assert arb.jobs["spooled"].handle.stopped

        twin(tmp_path, body)


class TestCrashRecovery:
    @staticmethod
    def _arbiter(r, fd):
        return r.arbiter({"h1": 4}, fleet_dir=fd, tick_s=0.5)

    def test_recover_resumes_running_job_once(self, tmp_path):
        def body(r):
            F = r.F
            fd = r.fleet_dir()
            arb1 = self._arbiter(r, fd)
            _write_spec(fd / "submit")
            arb1.tick()
            assert arb1.jobs["spooled"].state == F.RUNNING
            arb1.jobs["spooled"].preemptions = 3
            arb1.jobs["spooled"].handle.charged_restarts = 1
            arb1.tick()
            _write_spec(fd / "submit")
            arb2 = self._arbiter(r, fd)
            assert arb2.recover() == 1
            job = arb2.jobs["spooled"]
            assert job.state == F.PENDING
            assert job.preemptions == 3
            assert job.charged_restarts == 1
            assert ("recover", {"job": "spooled",
                                "prior_state": "RUNNING"}) in arb2.events
            arb2.tick()
            assert not os.path.exists(str(fd / "submit" / "spooled.json"))
            assert not os.path.exists(
                str(fd / "rejected" / "spooled.json.error"))
            assert "spool_duplicate" in _kinds(arb2)
            assert "submit_rejected" not in _kinds(arb2)
            assert arb2.jobs["spooled"].state == F.RUNNING
            assert arb2.jobs["spooled"].handle.started

        twin(tmp_path, body)

    def test_recover_skips_terminal_jobs(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb1 = self._arbiter(r, fd)
            _write_spec(fd / "submit", name="done-job")
            _write_spec(fd / "submit", name="live-job")
            arb1.tick()
            arb1.jobs["done-job"].handle.exit(0)
            arb1.tick()
            assert arb1.jobs["done-job"].state == r.F.DONE
            arb2 = self._arbiter(r, fd)
            assert arb2.recover() == 1
            assert "done-job" not in arb2.jobs
            assert arb2.jobs["live-job"].state == r.F.PENDING

        twin(tmp_path, body)

    def test_recover_without_state_json_is_a_noop(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            assert arb.recover() == 0
            (fd / "state.json").write_text("{not json")
            assert arb.recover() == 0

        twin(tmp_path, body)

    def test_recover_is_idempotent(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb1 = self._arbiter(r, fd)
            _write_spec(fd / "submit")
            arb1.tick()
            arb2 = self._arbiter(r, fd)
            assert arb2.recover() == 1
            assert arb2.recover() == 0
            assert len(arb2.jobs) == 1

        twin(tmp_path, body)

    def test_changed_spool_spec_after_recovery_is_rejected(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb1 = self._arbiter(r, fd)
            _write_spec(fd / "submit")
            arb1.tick()
            _write_spec(fd / "submit", priority=7)
            arb2 = self._arbiter(r, fd)
            arb2.recover()
            arb2.tick()
            err = (fd / "rejected" / "spooled.json.error").read_text()
            assert "already exists" in err
            assert arb2.jobs["spooled"].spec.priority == 0

        twin(tmp_path, body)

    def test_state_json_of_one_package_recovers_in_the_other(self,
                                                              tmp_path):
        """A fleet directory outlives its server: the port's arbiter
        resumes the reference's ``state.json`` (and back)."""
        out = {}
        for writer, reader in ((REF, PORT), (PORT, REF)):
            fd = tmp_path / f"{writer.name}-{reader.name}"
            (fd / "submit").mkdir(parents=True)
            with Run(writer, tmp_path / f"w-{writer.name}") as r:
                arb = r.arbiter({"h1": 4}, fleet_dir=fd, tick_s=0.5)
                _write_spec(fd / "submit", name="carried")
                arb.tick()
                arb.jobs["carried"].preemptions = 2
                arb.tick()
            with Run(reader, tmp_path / f"r-{reader.name}") as r:
                arb = r.arbiter({"h1": 4}, fleet_dir=fd, tick_s=0.5)
                assert arb.recover() == 1
                job = arb.jobs["carried"]
                assert job.preemptions == 2
                out[writer.name] = job.spec.to_dict()
        assert out["ref"] == out["port"]


# ---------------------------------------------------------------------------
# the CLI: python -m horovod_tpu_torch.fleet beside tools/hvtpufleet
# ---------------------------------------------------------------------------


class TestCLI:
    @pytest.mark.parametrize("field,overlay", _BAD_SPECS, ids=_BAD_IDS)
    def test_submit_malformed_exits_2_naming_field(self, tmp_path, capsys,
                                                   field, overlay):
        def body(r):
            spec = _write_spec(r.root, **overlay)
            rec = r.cli("--fleet-dir", r.root, "submit", "--spec", spec,
                        files=r.root)
            assert rec["rc"] == 2
            assert f"field '{field}'" in rec["err"]
            assert not os.path.exists(str(r.root / "submit"
                                          / "spooled.json"))
            assert not (r.root / "journal.jsonl").exists()

        twin(tmp_path, body, capsys)

    def test_submit_invalid_json_exits_2(self, tmp_path, capsys):
        def body(r):
            p = r.root / "broken.json"
            p.write_text("{oops")
            rec = r.cli("--fleet-dir", r.root, "submit", "--spec", p)
            assert rec["rc"] == 2
            assert "invalid JSON" in rec["err"]

        twin(tmp_path, body, capsys)

    def test_missing_fleet_dir_exits_2(self, tmp_path, capsys,
                                       monkeypatch):
        monkeypatch.delenv("HVTPU_FLEET_DIR", raising=False)

        def body(r):
            spec = _write_spec(r.root)
            rec = r.cli("submit", "--spec", spec)
            assert rec["rc"] == ["SystemExit", 2]
            assert "HVTPU_FLEET_DIR" in rec["err"]

        twin(tmp_path, body, capsys)

    def test_submit_appends_journal_record(self, tmp_path, capsys):
        def body(r):
            fd = r.fleet_dir()
            spec = _write_spec(r.root, name="good", priority=4)
            rec = r.cli("--fleet-dir", fd, "submit", "--spec", spec,
                        files=fd)
            assert rec["rc"] == 0
            assert "submitted 'good'" in rec["out"]
            lines = (fd / "journal.jsonl").read_text().splitlines()
            j = json.loads(lines[-1])
            assert j["op"] == "submit" and j["seq"] == 1
            assert j["spec"]["priority"] == 4
            assert os.listdir(fd / "submit") == []

        twin(tmp_path, body, capsys)

    def test_submit_backpressured_when_queue_full(self, tmp_path, capsys,
                                                  monkeypatch):
        monkeypatch.setenv("HVTPU_FLEET_QUEUE_LIMIT", "2")

        def body(r):
            fd = r.fleet_dir()
            for i in range(2):
                spec = _write_spec(r.root, name=f"j{i}")
                assert r.cli("--fleet-dir", fd, "submit", "--spec",
                             spec)["rc"] == 0
            spec = _write_spec(r.root, name="overflow")
            rec = r.cli("--fleet-dir", fd, "submit", "--spec", spec,
                        files=fd)
            assert rec["rc"] == 75
            assert "queue full" in rec["err"]
            assert "retry after" in rec["err"]
            lines = (fd / "journal.jsonl").read_text().splitlines()
            assert len(lines) == 2

        twin(tmp_path, body, capsys)

    def test_list_without_server_exits_1(self, tmp_path, capsys):
        def body(r):
            fd = r.fleet_dir()
            rec = r.cli("--fleet-dir", fd, "list")
            assert rec["rc"] == 1
            assert "no state" in rec["err"]
            rec = r.cli("--fleet-dir", fd, "top")
            assert rec["rc"] == 1

        twin(tmp_path, body, capsys)

    def test_list_renders_published_state(self, tmp_path, capsys):
        def body(r):
            fd = r.fleet_dir()
            arb = r.arbiter({"h1": 4}, fleet_dir=fd)
            arb.submit(r.spec("shown", min_np=2, max_np=2, priority=7))
            arb.tick()
            rec = r.cli("--fleet-dir", fd, "list")
            assert rec["rc"] == 0
            assert "4 slots" in rec["out"] and "2 free" in rec["out"]
            assert re.search(r"shown\s+RUNNING\s+7\s+2", rec["out"])
            rec = r.cli("--fleet-dir", fd, "list", "--json")
            assert rec["rc"] == 0
            assert json.loads(rec["out"])["jobs"][0]["name"] == "shown"

        twin(tmp_path, body, capsys)

    def test_top_renders_health(self, tmp_path, capsys):
        def body(r):
            fd = r.fleet_dir()
            arb = r.arbiter({"h1": 4}, fleet_dir=fd)
            job = arb.submit(r.spec("shown", min_np=2, max_np=2))
            arb.tick()
            job.health = {"step_rate": 3.25, "incidents_total": 1,
                          "restarts": 2, "stall_age_s": 7.0,
                          "stale": True}
            arb.tick()
            rec = r.cli("--fleet-dir", fd, "top")
            assert rec["rc"] == 0
            assert re.search(r"shown\s+RUNNING\s+2\s+3\.25 \*\s+1\s+2\s+7",
                             rec["out"])

        twin(tmp_path, body, capsys)

    def test_cancel_appends_journal_record(self, tmp_path, capsys):
        def body(r):
            fd = r.fleet_dir()
            rec = r.cli("--fleet-dir", fd, "cancel", "byejob", files=fd)
            assert rec["rc"] == 0
            last = json.loads(
                (fd / "journal.jsonl").read_text().splitlines()[-1])
            assert last == {"op": "cancel", "name": "byejob", "seq": 1}

        twin(tmp_path, body, capsys)

    def test_serve_until_idle(self, tmp_path, capsys):
        """``serve --until-idle`` over a discovery script: a job whose
        command exits 0 ends DONE (exit 0), one that exits 3 FAILED
        (exit 1, the job named); the runner is the package's own."""
        disc = tmp_path / "discover.sh"
        disc.write_text("#!/bin/sh\necho localhost:1\n")
        disc.chmod(0o755)
        got = {}
        for pkg in (REF, PORT):
            fd = tmp_path / f"serve-{pkg.name}"
            for name, code in (("ok", 0), ("bad", 3)):
                spec = tmp_path / f"{pkg.name}-{name}.json"
                spec.write_text(json.dumps({
                    "name": name, "min_np": 1, "max_np": 1,
                    "max_restarts": 0,
                    "command": [sys.executable, "-c",
                                f"import sys; sys.exit({code})"],
                    "env": {"HVTPU_ELASTIC_DISCOVERY_INTERVAL": "0.1"}}))
                assert pkg.cli_main(["--fleet-dir", str(fd), "submit",
                                       "--spec", str(spec)]) == 0
            capsys.readouterr()
            rc = pkg.cli_main(["--fleet-dir", str(fd), "serve",
                                 "--host-discovery-script", str(disc),
                                 "--tick", "0.1", "--until-idle",
                                 "--quiet"])
            err = capsys.readouterr().err
            state = json.loads((fd / "state.json").read_text())
            got[pkg.name] = (rc, [(j["name"], j["state"], j["reason"],
                                   j["exit_code"])
                                  for j in state["jobs"]])
            assert "jobs failed: bad" in err
        assert got["port"] == got["ref"]
        assert got["port"] == (1, [("ok", "DONE", None, 0),
                                   ("bad", "FAILED", "exit 1", 1)])

    def test_module_entry_point(self, tmp_path):
        """``python -m horovod_tpu_torch.fleet`` in a process of its own:
        the same exit code and stderr as the reference's module."""
        spec = tmp_path / "bad.json"
        spec.write_text(json.dumps({"name": "x", "command": ["run"],
                                    "min_np": 0}))
        outs = []
        for mod in ("tools.hvtpufleet", "horovod_tpu_torch.fleet"):
            env = dict(os.environ, PYTHONPATH=_REPO)
            p = subprocess.run(
                [sys.executable, "-m", mod, "--fleet-dir", str(tmp_path),
                 "submit", "--spec", str(spec)], capture_output=True,
                text=True, env=env, cwd=_REPO, timeout=120)
            outs.append((p.returncode, p.stderr.strip().splitlines()[-1]))
        assert outs[1] == outs[0]
        assert outs[1][0] == 2 and "field 'min_np'" in outs[1][1]


# ---------------------------------------------------------------------------
# indexed intake: the journal protocol
# ---------------------------------------------------------------------------


class TestIndexedIntake:
    @staticmethod
    def _arbiter(r, fd):
        return r.arbiter({"h1": 4, "h2": 4}, fleet_dir=fd, tick_s=0.5)

    def test_intake_bounded_by_budget_per_tick(self, tmp_path,
                                               monkeypatch):
        monkeypatch.setenv("HVTPU_FLEET_INTAKE_BUDGET", "3")

        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            for i in range(8):
                jr.append_submit(
                    r.spec(f"j{i}", min_np=8, max_np=8).to_dict())
            arb.tick()
            assert len(arb.jobs) == 3
            arb.tick()
            assert len(arb.jobs) == 6
            arb.tick()
            assert len(arb.jobs) == 8
            assert jr.depth() == 0

        twin(tmp_path, body)

    def test_crash_between_apply_and_commit_is_exactly_once(self,
                                                            tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb1 = self._arbiter(r, fd)
            jr = r.journal(fd)
            for i in range(3):
                jr.append_submit(r.spec(f"j{i}").to_dict())
            arb1.tick()
            assert len(arb1.jobs) == 3
            (fd / "journal.cursor").unlink()
            arb2 = self._arbiter(r, fd)
            assert arb2.recover() == 3
            arb2.tick()
            assert sorted(arb2.jobs) == ["j0", "j1", "j2"]
            kinds = _kinds(arb2)
            assert kinds.count("journal_duplicate") == 3
            assert "submit_rejected" not in kinds
            assert not (fd / "rejected").exists()

        twin(tmp_path, body)

    def test_torn_tail_left_for_next_tick(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("whole").to_dict())
            torn = json.dumps({"op": "submit", "seq": 2,
                               "spec": r.spec("torn").to_dict()})
            with open(fd / "journal.jsonl", "ab") as f:
                f.write(torn[:20].encode())
            arb.tick()
            assert sorted(arb.jobs) == ["whole"]
            with open(fd / "journal.jsonl", "ab") as f:
                f.write(torn[20:].encode() + b"\n")
            arb.tick()
            assert sorted(arb.jobs) == ["torn", "whole"]

        twin(tmp_path, body)

    def test_corrupt_line_surfaced_not_fatal(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("before").to_dict())
            with open(fd / "journal.jsonl", "ab") as f:
                f.write(b"{this is not json}\n")
            jr.append_submit(r.spec("after").to_dict())
            arb.tick()
            assert sorted(arb.jobs) == ["after", "before"]
            assert "journal_corrupt" in _kinds(arb)

        twin(tmp_path, body)

    def test_backpressure_truthful_retry_after(self, tmp_path,
                                               monkeypatch):
        monkeypatch.setenv("HVTPU_FLEET_QUEUE_LIMIT", "2")

        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("a").to_dict())
            jr.append_submit(r.spec("b").to_dict())
            with pytest.raises(r.F.QueueFullError) as ei:
                jr.append_submit(r.spec("c").to_dict())
            assert ei.value.depth == 2 and ei.value.limit == 2
            assert ei.value.retry_after_s > 0
            assert "retry after" in str(ei.value)
            arb.tick()
            jr.append_submit(r.spec("c").to_dict())
            arb.tick()
            assert "c" in arb.jobs
            return str(ei.value)

        twin(tmp_path, body)

    def test_quiet_tick_reads_nothing(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            r.journal(fd).append_submit(r.spec("only").to_dict())
            arb.tick()
            cursor = json.loads((fd / "journal.cursor").read_text())
            assert r.journal(fd).read_batch(256) == []
            assert cursor["seq"] == 1 and cursor["budget"] > 0
            return cursor

        twin(tmp_path, body)

    def test_idle_tick_does_not_rewrite_cursor(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            r.journal(fd).append_submit(r.spec("only").to_dict())
            arb.tick()
            st = os.stat(fd / "journal.cursor")
            arb.tick()
            assert os.stat(fd / "journal.cursor").st_ino == st.st_ino

        twin(tmp_path, body)

    def test_cursor_commits_only_after_state_persists(self, tmp_path,
                                                      monkeypatch):
        def body(r):
            fd = r.fleet_dir()
            arb1 = self._arbiter(r, fd)
            jr = r.journal(fd)
            for i in range(3):
                jr.append_submit(r.spec(f"j{i}").to_dict())

            def crash():
                raise RuntimeError("injected crash before state persist")

            monkeypatch.setattr(arb1, "_write_state_json", crash)
            with pytest.raises(RuntimeError):
                arb1.tick()
            assert r.journal(fd).read_cursor()["seq"] == 0
            arb2 = self._arbiter(r, fd)
            assert arb2.recover() == 0
            arb2.tick()
            assert sorted(arb2.jobs) == ["j0", "j1", "j2"]

        twin(tmp_path, body)

    def test_dead_writer_torn_tail_repaired_on_next_append(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("first").to_dict())
            with open(fd / "journal.jsonl", "ab") as f:
                f.write(b'{"op": "submit", "seq": 2, "spec"')
            jr.append_submit(r.spec("second").to_dict())
            arb.tick()
            assert sorted(arb.jobs) == ["first", "second"]
            assert "journal_corrupt" in _kinds(arb)

        twin(tmp_path, body)

    def test_tail_seq_survives_oversized_record(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            jr = r.journal(fd)
            big = r.spec("big", env={"BLOB": "x" * 200_000}).to_dict()
            assert jr.append_submit(big) == 1
            assert jr.append_submit(r.spec("next").to_dict()) == 2
            assert jr.depth() == 2
            return _files(fd)

        twin(tmp_path, body)

    def test_journal_written_by_one_package_is_read_by_the_other(
            self, tmp_path):
        """Clients and server may differ: the reference's CLI journal
        feeds the port's arbiter, and back, to the same jobs."""
        got = {}
        for writer, reader in ((REF, PORT), (PORT, REF)):
            fd = tmp_path / f"{writer.name}-{reader.name}"
            fd.mkdir()
            jr = writer.fleet.SubmitJournal(str(fd))
            for i in range(3):
                jr.append_submit(writer.fleet.JobSpec(
                    f"j{i}", ["job-cmd"]).to_dict())
            jr.append_cancel("j1")
            with Run(reader, tmp_path / f"r-{writer.name}") as r:
                arb = r.arbiter({"h1": 4}, fleet_dir=fd, tick_s=0.5)
                arb.tick()
                got[writer.name] = sorted(
                    (n, j.state, j.reason) for n, j in arb.jobs.items())
        assert got["ref"] == got["port"]
        assert got["port"] == [("j0", "RUNNING", ""),
                               ("j1", "FAILED", "cancelled"),
                               ("j2", "RUNNING", "")]


# ---------------------------------------------------------------------------
# cancel race: spooled-but-not-intaken jobs
# ---------------------------------------------------------------------------


class TestCancelRace:
    @staticmethod
    def _arbiter(r, fd):
        return r.arbiter({"h1": 4}, fleet_dir=fd, tick_s=0.5)

    def test_journal_cancel_lands_before_schedule(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("doomed").to_dict())
            jr.append_cancel("doomed")
            arb.tick()
            j = arb.jobs["doomed"]
            assert j.state == r.F.FAILED and j.reason == "cancelled"
            assert j.handle is None
            assert "job_start" not in _kinds(arb)

        twin(tmp_path, body)

    def test_journal_cancel_tombstones_legacy_spool(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            _write_spec(fd / "submit", name="spooled")
            r.journal(fd).append_cancel("spooled")
            arb.tick()
            assert "spooled" not in arb.jobs
            assert not os.path.exists(fd / "submit" / "spooled.json")
            kinds = _kinds(arb)
            assert "cancel_spooled" in kinds and "job_start" not in kinds

        twin(tmp_path, body)

    def test_legacy_marker_tombstones_same_tick_spool(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            _write_spec(fd / "submit", name="racer")
            (fd / "cancel" / "racer").write_text("cancel\n")
            arb.tick()
            assert "racer" not in arb.jobs
            assert "cancel_spooled" in _kinds(arb)

        twin(tmp_path, body)

    def test_cancel_for_unknown_job_reports_once(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            arb = self._arbiter(r, fd)
            r.journal(fd).append_cancel("ghost")
            arb.tick()
            assert _kinds(arb).count("cancel_unknown") == 1

        twin(tmp_path, body)


# ---------------------------------------------------------------------------
# admission control: tenant quota edge matrix
# ---------------------------------------------------------------------------


def _tenants(fd, table, mtime=None):
    p = fd / "tenants.json"
    p.write_text(json.dumps(table))
    if mtime is not None:
        os.utime(p, (mtime, mtime))


class TestAdmissionQuotas:
    @staticmethod
    def _arbiter(r, fd, hosts=None):
        return r.arbiter(hosts or {"h1": 4, "h2": 4}, fleet_dir=fd,
                         tick_s=0.5)

    def test_queued_quota_rejects_naming_tenant_and_limit(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            _tenants(fd, {"acme": {"max_queued": 1}}, mtime=1)
            arb = self._arbiter(r, fd, hosts={"h1": 1})
            jr = r.journal(fd)
            for i in range(3):
                jr.append_submit(
                    r.spec(f"q{i}", min_np=1, tenant="acme").to_dict())
            arb.tick()
            rejects = [f for k, f in arb.events if k == "submit_rejected"]
            assert len(rejects) == 2
            for f in rejects:
                assert "tenant 'acme'" in f["error"]
                assert "max_queued=1" in f["error"]
            errs = sorted(os.listdir(fd / "rejected"))
            assert errs == ["journal-2.error", "journal-3.error"]

        twin(tmp_path, body)

    def test_max_ranks_quota_defers_start_without_blocking_pool(
            self, tmp_path):
        def body(r):
            F = r.F
            fd = r.fleet_dir()
            _tenants(fd, {"acme": {"max_ranks": 4}}, mtime=1)
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("a", min_np=4, tenant="acme").to_dict())
            jr.append_submit(r.spec("b", min_np=2, tenant="acme").to_dict())
            jr.append_submit(r.spec("c", min_np=2,
                                    tenant="other").to_dict())
            arb.tick()
            assert arb.jobs["a"].state == F.RUNNING
            assert arb.jobs["b"].state == F.PENDING
            assert arb.jobs["c"].state == F.RUNNING
            waits = [f for k, f in arb.events if k == "quota_wait"]
            assert len(waits) == 1 and waits[0]["job"] == "b"
            assert "max_ranks=4" in waits[0]["detail"]

        twin(tmp_path, body)

    def test_quota_shrink_below_usage_never_kills_running(self, tmp_path):
        def body(r):
            F = r.F
            fd = r.fleet_dir()
            _tenants(fd, {"acme": {"max_ranks": 8}}, mtime=1)
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("big", min_np=6,
                                    tenant="acme").to_dict())
            arb.tick()
            assert arb.jobs["big"].state == F.RUNNING
            _tenants(fd, {"acme": {"max_ranks": 2}}, mtime=2)
            jr.append_submit(r.spec("next", min_np=1,
                                    tenant="acme").to_dict())
            arb.tick()
            assert arb.jobs["big"].state == F.RUNNING
            assert arb.jobs["next"].state == F.PENDING
            assert "tenants_reload" in _kinds(arb)
            arb.jobs["big"].handle.exit(0)
            arb.tick()
            assert arb.jobs["next"].state == F.RUNNING

        twin(tmp_path, body)

    def test_malformed_tenants_json_keeps_previous_table(self, tmp_path):
        def body(r):
            fd = r.fleet_dir()
            _tenants(fd, {"acme": {"max_queued": 0}}, mtime=1)
            arb = self._arbiter(r, fd)
            jr = r.journal(fd)
            jr.append_submit(r.spec("x", tenant="acme").to_dict())
            arb.tick()
            assert "x" not in arb.jobs
            (fd / "tenants.json").write_text("{broken")
            os.utime(fd / "tenants.json", (3, 3))
            jr.append_submit(r.spec("y", tenant="acme").to_dict())
            arb.tick()
            assert "y" not in arb.jobs
            bad = [f for k, f in arb.events if k == "tenants_rejected"]
            assert bad and "previous table kept" in bad[0]["error"]

        twin(tmp_path, body)

    def test_tenant_field_errors_are_named(self):
        msgs = {}
        for pkg in (REF, PORT):
            F = pkg.fleet
            ac = F.AdmissionController(None)
            with pytest.raises(F.TenantConfigError) as e1:
                ac.load_dict({"acme": {"weight": -1}})
            assert "tenant 'acme'" in str(e1.value)
            assert "weight" in str(e1.value)
            with pytest.raises(F.TenantConfigError,
                               match="unknown field") as e2:
                ac.load_dict({"acme": {"max_rank": 4}})
            with pytest.raises(F.TenantConfigError,
                               match="must be an object") as e3:
                ac.load_dict({"acme": "not-an-object"})
            msgs[pkg.name] = [str(e.value) for e in (e1, e2, e3)]
        assert msgs["port"] == msgs["ref"]

    def test_spec_tenant_validation(self):
        for pkg in (REF, PORT):
            F = pkg.fleet
            with pytest.raises(F.FleetSpecError, match="tenant"):
                F.JobSpec("j", ["cmd"], tenant="bad tenant!")
            assert F.JobSpec("j", ["cmd"]).tenant_key == "default"
            assert F.JobSpec("j", ["cmd"],
                             tenant="acme").tenant_key == "acme"
            assert F.JobSpec("j", ["cmd"],
                             tenant="acme").to_dict()["tenant"] == "acme"
            assert "tenant" not in F.JobSpec("j", ["cmd"]).to_dict()

    def test_fair_share_deficits(self):
        got = []
        for pkg in (REF, PORT):
            ac = pkg.fleet.AdmissionController(None)
            ac.load_dict({"acme": {"weight": 3}, "*": {"weight": 1}})
            got.append(ac.deficits({"acme": 2, "guest": 4}, 16))
        assert got[1] == got[0] == {"acme": 10.0, "guest": 0.0}


# ---------------------------------------------------------------------------
# starvation guard
# ---------------------------------------------------------------------------


class TestStarvationGuard:
    def test_aged_job_boosts_over_every_tier(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVTPU_FLEET_STARVATION_SECONDS", "100")

        def body(r):
            F = r.F
            arb = r.std()
            hog = arb.submit(r.spec("hog", min_np=2, max_np=8,
                                    priority=9))
            arb.tick()
            assert sum(hog.allocation.values()) == 8
            lo = arb.submit(r.spec("lo", min_np=4, priority=0))
            arb.tick()
            assert hog.state == F.RUNNING and lo.state == F.PENDING
            assert hog.handle.shrink_requests == []
            r.clock.t += 101.0
            arb.tick()
            aged = [f for k, f in arb.events if k == "job_aged"]
            assert len(aged) == 1 and aged[0]["job"] == "lo"
            assert aged[0]["waited_s"] >= 100.0
            assert hog.state == F.DRAINING
            assert hog.handle.shrink_requests == [4]
            pre = [f for k, f in arb.events if k == "preempt"]
            assert pre and pre[0]["reason"] == "preempted for lo"
            hog.handle.drain_lands()
            hog.handle.relaunch()
            arb.tick()
            assert lo.state == F.RUNNING
            assert lo.queue_wait_s <= 101.0 + 1.0

        twin(tmp_path, body)

    def test_aging_disabled_at_zero(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVTPU_FLEET_STARVATION_SECONDS", "0")

        def body(r):
            arb = r.std()
            hog = arb.submit(r.spec("hog", min_np=2, max_np=8,
                                    priority=9))
            arb.tick()
            lo = arb.submit(r.spec("lo", min_np=4, priority=0))
            r.clock.t += 100000.0
            arb.tick()
            assert lo.state == r.F.PENDING and hog.state == r.F.RUNNING
            assert "job_aged" not in _kinds(arb)

        twin(tmp_path, body)

    def test_aged_event_fires_once(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVTPU_FLEET_STARVATION_SECONDS", "50")

        def body(r):
            arb = r.std()
            arb.submit(r.spec("hog", min_np=2, max_np=8, priority=9))
            arb.tick()
            arb.submit(r.spec("lo", min_np=8, priority=0))
            r.clock.t += 51.0
            arb.tick()
            arb.tick()
            arb.tick()
            assert _kinds(arb).count("job_aged") == 1

        twin(tmp_path, body)


# ---------------------------------------------------------------------------
# topology-aware placement
# ---------------------------------------------------------------------------


class TestPlacement:
    def test_torus_grid_shape_and_distance(self):
        for pkg in (REF, PORT):
            g = pkg.fleet.TorusGrid(["h0", "h1", "h2", "h3", "h4", "h5"])
            assert g.cols == 3 and g.rows == 2
            assert g.distance("h0", "h1") == 1
            assert g.distance("h0", "h2") == 1
            assert g.distance("h0", "h3") == 1
            assert set(g.neighbors("h0")) <= {"h1", "h2", "h3"}

    @pytest.mark.parametrize("n", [3, 5, 7, 10, 13, 32])
    def test_partial_grid_neighbors_agree_with_distance(self, n):
        names = [f"h{i:02d}" for i in range(n)]
        views = []
        for pkg in (REF, PORT):
            g = pkg.fleet.TorusGrid(names)
            for h in g.names:
                nbs = g.neighbors(h)
                assert h not in nbs and len(nbs) == len(set(nbs))
                assert nbs, f"n={n}: {h} isolated"
                for nb in nbs:
                    assert g.distance(h, nb) == 1, (n, h, nb)
            p = pkg.fleet.PlacementPolicy()
            assert p.fragmentation({h: 1 for h in names}, names) == 0.0
            views.append(({h: g.neighbors(h) for h in names},
                          {(a, b): g.distance(a, b)
                           for a in names for b in names}))
        assert views[1] == views[0]

    def test_best_fit_picks_tightest_single_host(self):
        for pkg in (REF, PORT):
            p = pkg.fleet.PlacementPolicy()
            free = {"h1": 4, "h2": 8, "h3": 3}
            alloc = p.carve(free, 3, {"h1": 8, "h2": 8, "h3": 8})
            assert alloc == {"h3": 3}
            assert free == {"h1": 4, "h2": 8, "h3": 0}

    def test_multi_host_gang_stays_contiguous(self):
        hosts = [f"h{i:02d}" for i in range(16)]
        allocs = []
        for pkg in (REF, PORT):
            p = pkg.fleet.PlacementPolicy()
            pool = {h: 8 for h in hosts}
            alloc = p.carve({h: 8 for h in hosts}, 24, pool)
            g = p.grid_for(pool)
            names = sorted(alloc)
            assert len(names) == 3
            assert max(g.distance(names[0], h) for h in names) <= 2
            allocs.append(alloc)
        assert allocs[1] == allocs[0]

    def test_expansion_carves_near_existing_allocation(self):
        hosts = [f"h{i:02d}" for i in range(9)]
        picks = []
        for pkg in (REF, PORT):
            p = pkg.fleet.PlacementPolicy()
            pool = {h: 8 for h in hosts}
            free = {h: 8 for h in hosts}
            free.pop("h04")
            grown = p.carve(free, 8, pool, near={"h04": 8})
            (picked,) = grown
            assert p.grid_for(pool).distance("h04", picked) == 1
            picks.append(grown)
        assert picks[1] == picks[0]

    def test_fragmentation_metric(self):
        got = []
        for pkg in (REF, PORT):
            p = pkg.fleet.PlacementPolicy()
            hosts = [f"h{i:02d}" for i in range(4)]
            pool = {h: 4 for h in hosts}
            assert p.fragmentation({h: 4 for h in hosts}, pool) == 0.0
            assert p.fragmentation({}, pool) == 0.0
            hosts6 = [f"g{i}" for i in range(6)]
            pool6 = {h: 4 for h in hosts6}
            g6 = p.grid_for(pool6)
            a = hosts6[0]
            far = max(hosts6, key=lambda h: g6.distance(a, h))
            frag = p.fragmentation({a: 4, far: 4}, pool6)
            assert 0.0 < frag <= 0.5
            got.append(frag)
        assert got[1] == got[0]

    def test_fragmentation_gauge_published_by_tick(self, tmp_path):
        def body(r):
            arb = r.std()
            arb.submit(r.spec("j", min_np=3))
            arb.tick()
            v = r.pkg.metrics.gauge("hvtpu_fleet_fragmentation").value()
            assert 0.0 <= v <= 1.0
            return v

        twin(tmp_path, body)


# ---------------------------------------------------------------------------
# the health rollup: summarize, the file and store channels, both ways
# ---------------------------------------------------------------------------


def _same_registry_values():
    """Give both registries the same step count, step rate and elastic
    generation (counters only grow: each is raised to a common value)."""
    steps = [pkg.metrics.REGISTRY.counter("hvtpu_optimizer_steps_total")
             for pkg in (REF, PORT)]
    target = max(c.value() for c in steps) + 5.0
    for c in steps:
        c.inc(target - c.value())
    for pkg in (REF, PORT):
        pkg.metrics.REGISTRY.gauge("hvtpu_steps_per_second").set(2.5)
        pkg.metrics.REGISTRY.gauge("hvtpu_elastic_generation").set(3)
    return target


class TestHealth:
    def test_summarize_same_dict_from_same_registry(self, monkeypatch):
        monkeypatch.setenv("HVTPU_HEALTH_INTERVAL_S", "2")
        target = _same_registry_values()
        got = []
        for pkg in (REF, PORT):
            pkg.clock.install(_FakeClock(t=500.0))
            try:
                got.append(pkg.health.summarize(rank=0))
            finally:
                pkg.clock.install(None)
        assert got[1] == got[0]
        assert got[1]["steps"] == target and got[1]["step_rate"] == 2.5
        assert got[1]["generation"] == 3 and got[1]["interval_s"] == 2.0

    @pytest.mark.parametrize("writer,reader", [(PORT, REF), (REF, PORT)],
                             ids=["port-to-ref", "ref-to-port"])
    def test_read_file_reads_the_other_package(self, tmp_path, writer,
                                               reader):
        _same_registry_values()
        rep = writer.health.HealthReporter(None, "job-a", interval_s=5.0,
                                           file_dir=str(tmp_path))
        published = rep.publish_once()
        assert published is not None and published["job"] == "job-a"
        got = reader.health.read_file(str(tmp_path),
                                      now_wall=published["t_wall"] + 1.0)
        assert got == dict(published, stale=False)
        # stale past 3 intervals of the summary's own cadence
        stale = reader.health.read_file(
            str(tmp_path), now_wall=published["t_wall"]
            + 3 * published["interval_s"] + 1.0)
        assert stale["stale"] is True
        assert reader.health.read_file(str(tmp_path / "absent")) is None

    def test_store_channel_fenced_writer_stamp_tolerant_reader(self):
        """The port's reporter writes through a fenced client of its
        store (``init()``'s setup); the reference's reader unstamps."""
        import torch.distributed as dist

        from horovod_tpu_torch.core.kv import StoreKV
        from horovod_tpu_torch.core.retry import fenced_kv

        _same_registry_values()
        kv = StoreKV(dist.HashStore(), 1)
        rep = PORT.health.HealthReporter(fenced_kv(kv, rank=0), "job-b",
                                         interval_s=5.0, file_dir="")
        published = rep.publish_once()
        assert published is not None
        raw = kv.key_value_try_get("fleet/job-b/health")
        assert raw != json.dumps(published, sort_keys=True)  # stamped
        for pkg in (REF, PORT):
            got = pkg.health.read(kv, "job-b",
                                  now_wall=published["t_wall"])
            assert got == dict(published, stale=False)
            assert pkg.health.read(kv, "absent") is None

    def test_arbiter_polls_the_handle_health_dir(self, tmp_path):
        """``_poll_health`` folds the file channel's summary into the
        job row of ``state.json``, in both packages alike."""
        class _HealthRunner(_FakeRunner):
            def __init__(self, job):
                super().__init__(job)
                self.health_dir = str(tmp_path / "health" / job.name)
                os.makedirs(self.health_dir, exist_ok=True)
                with open(os.path.join(self.health_dir, "health.json"),
                          "w") as f:
                    json.dump({"t_wall": 999.0, "interval_s": 1.0,
                               "steps": 7, "step_rate": 1.5,
                               "incidents_total": 0,
                               "stall_age_s": 0.0, "generation": 0}, f)

        def body(r):
            fd = r.fleet_dir()
            arb = r.arbiter({"h1": 2}, fleet_dir=fd, tick_s=0.5,
                            runner_factory=_HealthRunner)
            j = arb.submit(r.spec("w", min_np=1, max_np=1))
            arb.tick()
            arb.tick()
            assert j.health["steps"] == 7 and j.health["stale"] is False
            r.clock.t += 10.0
            arb.tick()
            assert j.health["stale"] is True
            rate = r.pkg.metrics.gauge("hvtpu_fleet_job_step_rate")
            return rate.value(job="w")

        out = twin(tmp_path, body)
        assert out["port"][1] == 1.5

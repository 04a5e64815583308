"""The fleet's seams in modules the port had before its fleet, and the
real runner, on the CPU.

* The elastic driver's fleet seams (``notice_dir``, ``extra_env``, the
  listener's ``launch`` and ``incarnation_end`` events, ``signal_ranks``)
  against the reference's driver on the same tiny worker (no framework
  in the worker: it records its env and waits).
* The one outcome the two drivers differ on: the incarnation a grow
  ends (every worker exits 73 at the SIGUSR1) is ``restart``, charged,
  in the reference's driver and ``reset``, uncharged, in the port's.
  Through each package's fleet (``FleetArbiter`` + ``ElasticJobRunner``)
  the job resizes either way; ``charged_restarts`` is 1 in the
  reference and 0 in the port.
* ``init()``'s health publisher: rank 0 of a 2-rank gloo world under
  ``HVTPU_FLEET_JOB`` publishes a summary the reference's ``read_file``
  accepts, rank 1 none, and ``shutdown()`` stops it.
* The planned shrink of ``chip_smoke.py``'s fleet phase at its smallest
  size: ``lo`` at 4 ranks is drained to 2 by ``hi`` through the notice
  files, no restart charged, every sample of every epoch delivered once.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

from horovod_tpu.elastic.driver import ElasticDriver as RefDriver  # noqa: E402,E501
from horovod_tpu.fleet import health as ref_health  # noqa: E402
import horovod_tpu.fleet as ref_fleet  # noqa: E402
import horovod_tpu_torch.fleet as port_fleet  # noqa: E402
from horovod_tpu_torch.elastic.driver import ElasticDriver as PortDriver  # noqa: E402,E501

from torch_port_util import no_leaked_reference  # noqa: E402,F401

# A worker of no framework: records the env the driver gave it in
# HVT_OUT_DIR/g<generation>r<rank>.json, then waits.  Under HVT_MODE=grow
# a SIGUSR1 makes it exit 73 (a reset at a commit boundary) and a later
# generation exits 0 at once; under HVT_MODE=hold it waits for a signal.
_WORKER = r"""
import json, os, signal, sys, time
flag = []
signal.signal(signal.SIGUSR1, lambda *a: flag.append(1))
gen = int(os.environ["HVTPU_ELASTIC_GENERATION"])
rank = int(os.environ["HVTPU_RANK"])
keys = ("HVTPU_RANK", "HVTPU_SIZE", "HVTPU_PREEMPT_NOTICE_FILE",
        "HVT_EXTRA", "HVTPU_ELASTIC", "HVTPU_ELASTIC_GENERATION",
        "HVTPU_FLEET_JOB", "HVTPU_FLEET_HEALTH_DIR")
out = os.environ["HVT_OUT_DIR"]
with open(os.path.join(out, "g%dr%d.json" % (gen, rank)), "w") as f:
    json.dump({k: os.environ.get(k) for k in keys}, f)
mode = os.environ["HVT_MODE"]
deadline = time.time() + 60
while time.time() < deadline:
    if flag:
        sys.exit(73)
    if mode == "grow" and gen >= 1:
        sys.exit(0)
    time.sleep(0.02)
sys.exit(5)
"""


class _Pool:
    def __init__(self, hosts):
        self.hosts = dict(hosts)

    def find_available_hosts_and_slots(self):
        return dict(self.hosts)


def _wait(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _norm(obj, root):
    return json.loads(json.dumps(obj).replace(str(root), "<root>"))


def _driver_seams(cls, root):
    """One 2-rank incarnation of the hold worker under ``cls``; rank 1
    is signalled through ``signal_ranks`` once both ranks recorded
    their env.  Returns the listener's events, the env files, the
    driver's exit and what ``signal_ranks`` returned."""
    out = root / "out"
    out.mkdir(parents=True)
    events = []
    drv = cls(command=[sys.executable, "-c", _WORKER],
              discovery=_Pool({"localhost": 2}), min_np=2, max_np=2,
              discovery_interval=0.1, elastic_timeout=30,
              state_dir=str(root / "state"), max_restarts=0,
              notice_dir=str(root / "notice"),
              extra_env={"HVT_EXTRA": "overlay", "HVT_MODE": "hold",
                         "HVT_OUT_DIR": str(out)})
    drv.listener = lambda event, info: events.append((event, dict(info)))
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("rc", drv.run()),
                         daemon=True)
    t.start()
    _wait(lambda: len(os.listdir(out)) == 2, 60, "both ranks' env")
    assert [s.rank for s in drv.current_slots] == [0, 1]
    assert drv.signal_ranks([7], signal.SIGTERM) == 0  # no such rank
    sent = drv.signal_ranks([1], signal.SIGTERM)
    t.join(60)
    assert not t.is_alive()
    envs = {f: json.loads((out / f).read_text())
            for f in sorted(os.listdir(out))}
    return _norm({"events": events, "envs": envs, "rc": res["rc"],
                  "sent": sent}, root)


def test_driver_seams_against_the_reference(tmp_path):
    ref = _driver_seams(RefDriver, tmp_path / "ref")
    port = _driver_seams(PortDriver, tmp_path / "port")
    assert port == ref
    assert port["events"] == [
        ["launch", {"generation": 0, "size": 2}],
        ["incarnation_end", {"generation": 0, "size": 2,
                             "outcome": "restart"}]]
    assert port["sent"] == 1 and port["rc"] == 1  # a crash, no budget
    for rank in (0, 1):
        env = port["envs"][f"g0r{rank}.json"]
        assert env["HVTPU_PREEMPT_NOTICE_FILE"] == \
            f"<root>/notice/rank{rank}"
        assert env["HVT_EXTRA"] == "overlay"
        assert env["HVTPU_ELASTIC"] == "1"


def _grow(fleet, root):
    """A fleet job that starts at 1 rank and is grown to 2 by an
    autoscaler: returns the job's record, the outcomes the driver gave
    the listener and the arbiter's event kinds."""
    out = root / "out"
    out.mkdir(parents=True)
    pool = _Pool({"localhost": 1})
    kinds = []
    arb = fleet.FleetArbiter(
        pool, fleet_dir=str(root / "fleet"), tick_s=0.1,
        event_fn=lambda kind, **f: kinds.append(kind),
        register_debug=False)
    job = arb.submit(fleet.JobSpec(
        "grower", [sys.executable, "-c", _WORKER], min_np=1, max_np=2,
        env={"HVT_MODE": "grow", "HVT_OUT_DIR": str(out)}))
    outcomes = []
    deadline = time.time() + 90
    try:
        arb.tick()
        handle = job.handle
        listener = handle._driver.listener

        def spy(event, info):
            if event == "incarnation_end":
                outcomes.append(info["outcome"])
            listener(event, info)

        handle._driver.listener = spy
        _wait(lambda: (out / "g0r0.json").exists(), 60, "generation 0")
        pool.hosts = {"localhost": 2}
        arb.attach_autoscaler("grower", fleet.Autoscaler(
            lambda: 10.0, high=1.0, low=0.5, debounce_s=0.0,
            cooldown_s=1e9))
        while time.time() < deadline and not arb.all_terminal():
            arb.tick()
            time.sleep(0.1)
    finally:
        arb.close()
    return {"state": job.state, "charged_restarts": job.charged_restarts,
            "outcomes": outcomes, "files": sorted(os.listdir(out)),
            "kinds": [k for k in kinds
                      if k in ("fleet.autoscale", "fleet.job_end")]}


def test_grow_charges_the_reference_once_and_the_port_never(tmp_path):
    ref = _grow(ref_fleet, tmp_path / "ref")
    port = _grow(port_fleet, tmp_path / "port")
    for got in (ref, port):
        assert got["state"] == "DONE"
        assert got["files"] == ["g0r0.json", "g1r0.json", "g1r1.json"]
        assert got["kinds"] == ["fleet.autoscale", "fleet.job_end"]
    # the pinned difference: the grow's reset
    assert ref["outcomes"] == ["restart", "done"]
    assert ref["charged_restarts"] == 1
    assert port["outcomes"] == ["reset", "done"]
    assert port["charged_restarts"] == 0


def test_runner_counts_a_reset_as_a_resize_not_a_charge(tmp_path):
    """The handle's view of each outcome, driven through its listener."""
    job = port_fleet.Job(port_fleet.JobSpec("j", ["true"], min_np=1,
                                            max_np=2), 1)
    h = port_fleet.ElasticJobRunner(job, str(tmp_path))
    h._on_driver_event("launch", {"generation": 0, "size": 2})
    assert (h.phase(), h.current_np()) == ("running", 2)
    for outcome, charged, drains in (("reset", 0, 0), ("drain", 0, 1),
                                     ("restart", 1, 1)):
        h._on_driver_event("incarnation_end", {"outcome": outcome})
        assert h.phase() == "resizing"
        assert (h.charged_restarts, h.drains) == (charged, drains)
        h._on_driver_event("launch", {"generation": 1, "size": 1})
    assert h.info()["state_dir"] == str(tmp_path / "j" / "state")
    env = h._driver.extra_env
    assert env["HVTPU_FLEET_JOB"] == "j"
    assert env["HVTPU_FLEET_HEALTH_DIR"] == str(tmp_path / "j" / "health")
    assert h._driver.notice_dir == str(tmp_path / "j" / "notice")


_INIT_CHILD = r"""
import json, os, time
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import state as st
from horovod_tpu_torch.fleet import health
hvd.init()
rep = st.global_state().health_reporter
facts = {"rank": hvd.rank(), "reporter": rep is not None}
if rep is not None:
    deadline = time.time() + 20
    path = os.path.join(os.environ["HVTPU_FLEET_HEALTH_DIR"], "health.json")
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    facts["store"] = health.read(st.global_state().kv, "fleetjob")
    thread = rep._thread
hvd.barrier()
hvd.shutdown()
if rep is not None:
    facts["stopped"] = rep._stop.is_set()
    facts["cleared"] = st.global_state().health_reporter is None
    thread.join(5)
    facts["thread_alive"] = thread.is_alive()
print("FACTS " + json.dumps(facts), flush=True)
"""


def test_init_publishes_rank0_health_and_shutdown_stops_it(tmp_path):
    hdir = tmp_path / "health"
    env = dict(os.environ, HVTPU_FLEET_JOB="fleetjob",
               HVTPU_FLEET_HEALTH_DIR=str(hdir),
               HVTPU_HEALTH_INTERVAL_S="1", HVTPU_FLIGHT_DIR=str(tmp_path),
               PYTHONPATH=_REPO)
    env.pop("MASTER_ADDR", None)
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--cpu-devices", "1", "--", sys.executable, "-c", _INIT_CHILD],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    facts = sorted((json.loads(m) for m in re.findall(
        r"FACTS (\{.*\})", p.stdout)), key=lambda f: f["rank"])
    assert [f["reporter"] for f in facts] == [True, False]
    r0 = facts[0]
    assert r0["stopped"] and r0["cleared"] and not r0["thread_alive"]
    # one file, rank 0's, which the reference's reader accepts
    assert os.listdir(hdir) == ["health.json"]
    summary = ref_health.read_file(str(hdir))
    assert summary["job"] == "fleetjob" and summary["rank"] == 0
    assert summary["generation"] == 0 and summary["interval_s"] == 1.0
    assert r0["store"]["job"] == "fleetjob"


_DELIVER_RE = re.compile(
    r"DELIVER rank=(\d+) size=(\d+) gen=(\d+) epoch=(\d+) "
    r"idx=\[([0-9, ]*)\]")


def _job_env(log, epochs, samples, batch, sleep):
    return {"PYTHONPATH": _REPO + os.pathsep + os.path.join(_REPO, "tests"),
            "HVTPU_CPU_DEVICES": "1", "ELASTIC_EPOCHS": str(epochs),
            "DATA_SAMPLES": str(samples), "DATA_BATCH": str(batch),
            "EPOCH_SLEEP": sleep, "FLEET_DELIVER_LOG": log,
            "HVTPU_CKPT_FSYNC": "0"}


def _exactly_once(log, epochs, samples):
    per_epoch = {e: [] for e in range(epochs)}
    sizes = set()
    with open(log) as f:
        text = f.read()
    for m in _DELIVER_RE.finditer(text):
        per_epoch[int(m.group(4))].extend(
            int(v) for v in m.group(5).split(",") if v.strip())
        sizes.add(int(m.group(2)))
    for e in range(epochs):
        assert sorted(per_epoch[e]) == list(range(samples)), (
            f"{log} epoch {e}: exactly-once violated")
    return sizes


def test_planned_shrink_four_to_two(tmp_path):
    """``lo`` (2-4 ranks) holds the whole ``localhost:4`` pool; ``hi`` (2
    ranks, priority 10) arrives mid-training and the arbiter drains
    ``lo``'s ranks 2 and 3 through their notice files: they exit 79, the
    job relaunches at 2 with no charged restart (``max_restarts=0``
    would fail it), and both jobs deliver every sample once."""
    script = os.path.join(_REPO, "tests", "torch_port_fleet_data_script.py")
    lo_log, hi_log = str(tmp_path / "lo.deliver"), str(tmp_path / "hi.deliver")
    events = []
    arb = port_fleet.FleetArbiter(
        _Pool({"localhost": 4}), fleet_dir=str(tmp_path / "fleet"),
        tick_s=0.2, drain_grace_s=60.0,
        event_fn=lambda kind, **f: events.append(
            (kind.replace("fleet.", "", 1), f)),
        register_debug=False)
    lo = arb.submit(port_fleet.JobSpec(
        "lo", [sys.executable, script], priority=0, min_np=2, max_np=4,
        max_restarts=0, env=_job_env(lo_log, 2, 32, 2, "0.4")))
    hi = None
    deadline = time.time() + 150
    try:
        while time.time() < deadline:
            arb.tick()
            if hi is None and os.path.exists(lo_log) and \
                    os.path.getsize(lo_log) > 0:
                hi = arb.submit(port_fleet.JobSpec(
                    "hi", [sys.executable, script], priority=10, min_np=2,
                    max_np=2, max_restarts=0,
                    env=_job_env(hi_log, 1, 8, 2, "0.1")))
            if arb.all_terminal():
                break
            time.sleep(0.2)
    finally:
        arb.close()
        for j in arb.jobs.values():
            if j.handle is not None and j.handle.poll() is None:
                j.handle._driver.signal_ranks(range(8), signal.SIGKILL)
    assert hi is not None, "lo never delivered a batch"
    assert lo.state == "DONE", (lo.state, lo.reason, events)
    assert hi.state == "DONE", (hi.state, hi.reason, events)
    assert lo.preemptions == 1 and lo.handle.drains >= 1
    assert lo.charged_restarts == 0 and hi.charged_restarts == 0
    kinds = [k for k, _ in events]
    assert "preempt" in kinds and "resized" in kinds
    assert [f["to_np"] for k, f in events if k == "preempt"] == [2]
    assert _exactly_once(lo_log, 2, 32) == {2, 4}
    assert _exactly_once(hi_log, 1, 8) == {2}

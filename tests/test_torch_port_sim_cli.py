"""``python -m horovod_tpu_torch.sim`` beside ``python -m tools.hvtpusim``.

``list`` prints the same catalog, and ``run`` the same report JSON
(``event_log_sha256`` among its keys) at 16 ranks and at 64, whose
digest is the pinned table's (``chip_smoke.py``'s ``SIM_DIGESTS``;
``tests/test_torch_port_sim_digests.py`` holds every row): each a
subprocess of each CLI, all started at once, re-execing itself once
under ``PYTHONHASHSEED=0``.  Each ``bench*`` subcommand prints the
reference's rows at one small rank count: every subcommand of one CLI
through its ``main`` in one subprocess under ``PYTHONHASHSEED=0``.
``--update`` writes its key into a copy of ``BENCH_SCALING.json`` and
leaves the rest of it as it was.  Without a card the port's controller
scenarios refuse to run unless ``--device cpu`` is given.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke  # noqa: E402
from torch_port_sim_util import run_cli_calls, stats_digest  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

pytestmark = pytest.mark.sim

PORT = ("-m", "horovod_tpu_torch.sim")
REF = ("-m", "tools.hvtpusim")

#: name -> (arguments of both CLIs, extra arguments of the port's)
CALLS = {
    "list": (["list"], []),
    "run-stream-matrix": (["run", "stream-matrix", "--ranks", "16",
                           "--seed", "7"], ["--device", "cpu"]),
    "run-steady-drain-set": (["run", "steady-drain", "--ranks", "16",
                              "--seed", "3", "--set", "steps=4",
                              "--set", "durable_every=2"], []),
    "run-kill-blacklist-64": (["run", "kill-blacklist", "--ranks", "64",
                               "--seed", "7"], []),
}
BENCHES = {
    "bench": (["bench", "--ranks", "8"], ["--device", "cpu"]),
    "bench-fleet": (["bench-fleet", "--ranks", "16"], []),
    "bench-ckpt": (["bench-ckpt", "--ranks", "8"], []),
    "bench-anomaly": (["bench-anomaly", "--ranks", "8"], []),
    "bench-service": (["bench-service", "--ranks", "64"], []),
    "bench-lossy": (["bench-lossy", "--ranks", "8"], []),
}
MODULES = {"port": "horovod_tpu_torch.sim.__main__",
           "ref": "tools.hvtpusim.__main__"}


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return env


def _argv(table, name, pkg):
    argv, extra = table[name]
    return argv + (extra if pkg == "port" else [])


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every call's (exit code, stdout) on both CLIs, the ``bench*``
    calls' stdout by package."""
    out_dir = str(tmp_path_factory.mktemp("sim_cli"))
    procs = {}
    for name in CALLS:
        for pkg, cli in (("port", PORT), ("ref", REF)):
            with open(os.path.join(out_dir, f"{pkg}.{name}.err"),
                      "w") as err:
                procs[(name, pkg)] = subprocess.Popen(
                    [sys.executable, *cli, *_argv(CALLS, name, pkg)],
                    cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                    stderr=err, text=True)
    benches = {pkg: run_cli_calls(
        MODULES[pkg], {n: _argv(BENCHES, n, pkg) for n in BENCHES},
        os.path.join(out_dir, pkg)) for pkg in MODULES}
    results = {}
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        results[key] = (proc.returncode, out)
    for pkg, proc in benches.items():
        assert proc.wait(timeout=600) == 0, pkg
        for name in BENCHES:
            with open(os.path.join(out_dir, pkg, f"{name}.out")) as f:
                results[(name, pkg)] = (0, f.read())
    return results


@pytest.mark.parametrize("name", sorted(CALLS) + sorted(BENCHES))
def test_output_is_the_references(outputs, name):
    port_rc, port_out = outputs[(name, "port")]
    ref_rc, ref_out = outputs[(name, "ref")]
    assert port_rc == ref_rc == 0
    assert port_out == ref_out
    if name.startswith(("run", "bench")):
        assert json.loads(port_out) == json.loads(ref_out)


def test_run_digest_is_the_pinned_tables(outputs):
    rep = json.loads(outputs[("run-kill-blacklist-64", "port")][1])
    assert (rep["event_log_sha256"], stats_digest(rep["stats"])) == \
        chip_smoke.SIM_DIGESTS["kill-blacklist@64"]


def test_run_report_keeps_the_references_keys(outputs):
    rep = json.loads(outputs[("run-stream-matrix", "port")][1])
    assert sorted(rep) == ["event_log_sha256", "events", "ranks",
                           "scenario", "seed", "stats"]


def test_update_writes_its_key_into_a_copy(tmp_path):
    path = tmp_path / "BENCH_SCALING.json"
    shutil.copy(os.path.join(REPO, "BENCH_SCALING.json"), path)
    with open(path) as f:
        before = json.load(f)
    proc = subprocess.run(
        [sys.executable, *PORT, "bench-ckpt", "--ranks", "8", "--update",
         str(path)], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(path) as f:
        after = json.load(f)
    rows = json.loads(proc.stdout)["checkpoint_storm_sim"]
    assert after["checkpoint_storm_sim"]["rows"] == rows
    assert "horovod_tpu_torch" in after["checkpoint_storm_sim"]["note"]
    assert {k: v for k, v in after.items() if k != "checkpoint_storm_sim"} \
        == {k: v for k, v in before.items() if k != "checkpoint_storm_sim"}


def test_controller_scenario_without_a_card_names_the_flag():
    proc = subprocess.run(
        [sys.executable, *PORT, "run", "straggler-tail", "--ranks", "8"],
        cwd=REPO, env=dict(_env(), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "--device cpu" in proc.stderr

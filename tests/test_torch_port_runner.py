"""The port's launcher held against the JAX package's on the same inputs,
with no spawn of a worker (``horovod_tpu_torch/runner`` against
``horovod_tpu/runner``).

* ``parse_host_spec`` / ``get_host_assignments`` give equal ``SlotInfo``
  lists (a full host, two hosts, a partial fill, an oversubscribed spec
  with the same error), and ``uniform_local_size`` the same certificate;
* ``parse_args`` gives equal Namespaces over the flag matrix of
  ``tests/test_runner.py`` and refuses the same bad command lines;
* ``build_worker_env`` gives equal dicts, except ``PYTHONPATH``, whose
  first entry is each package's root;
* ``build_ssh_command`` gives equal argv under ``HVTPU_SSH_COMMAND``,
  except the exported namespaces: the port forwards ``NCCL_``,
  ``CUDA_`` and ``TORCH_`` where the reference forwards ``JAX_``,
  ``XLA_`` and ``TPU_`` (both: ``HVTPU_``, ``HOROVOD_``, ``PYTHONPATH``
  and the ``-x`` names);
* a blob signed by one package's ``secret`` verifies in the other, and a
  tampered one is refused by both;
* ``nic`` selects the same interfaces;
* a bad fault spec is refused at launch with exit 2, ``--check-build``
  and ``--version`` run, and the worker pumps prefix each line with its
  rank in both packages;
* the settings the launcher parses but the port does not apply yet (a
  job-wide codec, the non-finite action) are refused before any spawn
  with exit 2 naming their ROADMAP item (the autotuner's are accepted:
  ``tests/test_torch_port_autotune.py``), and
  ``--log-level`` sets the level of the port's loggers at ``init()``.

Cases whose assertion is the same for both packages are parametrized
over the two.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from pathlib import Path

import pytest

from horovod_tpu.runner import hosts as ref_hosts
from horovod_tpu.runner import launch as ref_launch
from horovod_tpu.runner import nic as ref_nic
from horovod_tpu.runner import safe_shell_exec as ref_exec
from horovod_tpu.runner import secret as ref_secret
from horovod_tpu_torch.runner import hosts as port_hosts
from horovod_tpu_torch.runner import launch as port_launch
from horovod_tpu_torch.runner import nic as port_nic
from horovod_tpu_torch.runner import safe_shell_exec as port_exec
from horovod_tpu_torch.runner import secret as port_secret
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PKGS = {"ref": (ref_hosts, ref_launch, ref_nic, ref_exec, ref_secret),
        "port": (port_hosts, port_launch, port_nic, port_exec, port_secret)}
both = pytest.mark.parametrize("pkg", ["ref", "port"])


def _slots(hosts_mod, spec, np_):
    return [dataclasses.asdict(s) for s in
            hosts_mod.get_host_assignments(hosts_mod.parse_host_spec(spec),
                                           np_)]


# -- host assignment -----------------------------------------------------------

@pytest.mark.parametrize("spec,np_", [
    ("localhost:4", 4),
    ("localhost:2,127.0.0.1:2", 4),
    ("a:4,b:4", 5),                 # a partial fill
    ("h1,h2:3,h3:2", 6),
    ("localhost:3,127.0.0.1:1", 4),  # not uniform
])
def test_host_assignments_equal(spec, np_):
    port, ref = _slots(port_hosts, spec, np_), _slots(ref_hosts, spec, np_)
    assert port == ref
    as_port = port_hosts.get_host_assignments(
        port_hosts.parse_host_spec(spec), np_)
    as_ref = ref_hosts.get_host_assignments(
        ref_hosts.parse_host_spec(spec), np_)
    assert (port_launch.uniform_local_size(as_port)
            == ref_launch.uniform_local_size(as_ref))


def test_oversubscription_same_error():
    with pytest.raises(ValueError) as want:
        ref_hosts.get_host_assignments(ref_hosts.parse_host_spec("a:2"), 3)
    with pytest.raises(ValueError) as got:
        port_hosts.get_host_assignments(port_hosts.parse_host_spec("a:2"),
                                        3)
    assert str(got.value) == str(want.value)
    assert "exceeds available slots" in str(got.value)


@both
@pytest.mark.parametrize("spec", ["h1:0", "", "h1:-2"])
def test_bad_host_spec_raises(pkg, spec):
    with pytest.raises(ValueError):
        PKGS[pkg][0].parse_host_spec(spec)


def test_hierarchical_layout_follows_the_certificate():
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.core.topology import hierarchical_layout

    for spec, np_, want in (("localhost:2,127.0.0.1:2", 4, True),
                            ("localhost:4", 4, False),      # one host
                            ("localhost:3,127.0.0.1:1", 4, False),
                            ("a:1,b:1", 2, False)):         # 1 a host
        slots = port_hosts.get_host_assignments(
            port_hosts.parse_host_spec(spec), np_)
        cfg = Config(hierarchical_allreduce=True,
                     uniform_local_size=port_launch.uniform_local_size(slots))
        got = {hierarchical_layout(cfg, np_, s.local_size, s.cross_size)
               for s in slots}
        assert got == {want}, spec
        cfg.hierarchical_allreduce = False
        assert not any(hierarchical_layout(cfg, np_, s.local_size,
                                           s.cross_size) for s in slots)


# -- parse_args ----------------------------------------------------------------

ARGV = [
    ["-np", "2", "python", "train.py"],
    ["-np", "4", "--fusion-threshold-mb", "32", "--cycle-time-ms", "2.5",
     "--timeline-filename", "/tmp/t.json", "--autotune", "--compression",
     "fp16", "--cpu-devices", "1", "--", "python", "-m", "mymod"],
    ["-np", "4", "--fusion-threshold-mb", "32", "--cycle-time-ms", "2.5",
     "--autotune", "--stall-check-time", "5", "--log-level", "debug",
     "--cpu-devices", "2", "python", "x.py"],
    ["-np", "2", "--audit-every", "16", "--audit-action", "warn",
     "--nonfinite-action", "zero", "python", "x.py"],
    ["-np", "2", "--disable-cache", "--", "python", "x.py"],
    ["-np", "2", "--no-stall-check", "--", "python", "x.py"],
    ["-np", "2", "--hierarchical-allreduce", "--", "python", "x.py"],
    ["-np", "2", "--metrics-port", "9090", "--", "python", "x.py"],
    ["-np", "2", "--trace-dir", "/tmp/tr", "--", "python", "x.py"],
    ["-np", "2", "--flight-dir", "/tmp/fl", "--flight-window", "512", "--",
     "python", "x.py"],
    ["-np", "2", "-x", "FOO=bar", "-x", "INHERITED", "--", "python", "x.py"],
    ["-np", "2", "--autotune", "--autotune-warmup-samples", "5",
     "--autotune-bayes-opt-max-samples", "20", "--", "python", "x.py"],
    ["-np", "4", "-H", "a:2,b:2", "-p", "2222", "-i", "/k/id", "--",
     "python", "x.py"],
    ["--host-discovery-script", "./d.sh", "--min-np", "2", "--max-np", "8",
     "--max-restarts", "3", "--restart-window", "60",
     "--blacklist-cooldown", "10", "--elastic-timeout", "30", "--",
     "python", "x.py"],
    ["-np", "2", "--drain-grace", "5", "--preempt-notice-file", "/tmp/n",
     "--fault-spec", "worker.step:kill@count=3", "--fault-seed", "7", "--",
     "python", "x.py"],
    ["-np", "2", "--stall-check-mode", "strict", "--stall-heartbeat", "0.2",
     "--stall-shutdown-time", "30", "--start-timeout", "60",
     "--job-timeout", "100", "--coordinator-port", "1234", "--verbose",
     "--", "python", "x.py"],
    ["-cb"],
    ["--version"],
]


@pytest.mark.parametrize("argv", ARGV, ids=range(len(ARGV)))
def test_parse_args_equal(argv):
    assert vars(port_launch.parse_args(argv)) == vars(
        ref_launch.parse_args(argv))


@both
@pytest.mark.parametrize("argv", [
    ["python", "x.py"],                                  # no -np
    ["-np", "2"],                                        # no command
    ["-np", "2", "--nonfinite-action", "explode", "python", "x.py"],
    ["-np", "2", "--compression", "zstd", "python", "x.py"],
])
def test_parse_args_refuses(pkg, argv):
    with pytest.raises(SystemExit):
        PKGS[pkg][1].parse_args(argv)


@both
def test_hostfile(pkg, tmp_path):
    launch = PKGS[pkg][1]
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\nnode1 slots=4\nnode2:2\ngpu-slots-01:8\n\n")
    assert launch.parse_hostfile(str(hf)) == "node1:4,node2:2,gpu-slots-01:8"
    args = launch.parse_args(["-np", "6", "--hostfile", str(hf), "--",
                              "python", "x.py"])
    assert args.hosts == "node1:4,node2:2,gpu-slots-01:8"
    with pytest.raises(SystemExit):
        launch.parse_args(["-np", "2", "--hostfile", str(hf), "-H", "a:2",
                           "--", "python", "x.py"])


# -- the env block -------------------------------------------------------------

def _env(launch, hosts_mod, argv, spec="localhost:2,127.0.0.1:2", np_=4):
    args = launch.parse_args(argv)
    slots = hosts_mod.get_host_assignments(hosts_mod.parse_host_spec(spec),
                                           np_)
    base = {"INHERITED": "yes", "PATH": "/bin", "PYTHONPATH": "/site"}
    return [launch.build_worker_env(base, s, "10.0.0.1", 4321, args,
                                    uniform_local=launch.uniform_local_size(
                                        slots)) for s in slots]


@pytest.mark.parametrize("argv", [a for a in ARGV if a[0] == "-np"],
                         ids=range(sum(a[0] == "-np" for a in ARGV)))
def test_worker_env_equal_but_pythonpath(argv, capsys):
    port = _env(port_launch, port_hosts, argv)
    ref = _env(ref_launch, ref_hosts, argv)
    port_root = str(REPO)
    for p, r in zip(port, ref):
        pp, rp = p.pop("PYTHONPATH"), r.pop("PYTHONPATH")
        assert pp.split(os.pathsep) == [port_root, "/site"]
        assert rp.split(os.pathsep)[1:] == ["/site"]
        assert p == r
    assert [e["HVTPU_RANK"] for e in port] == ["0", "1", "2", "3"]
    assert port[0]["HVTPU_UNIFORM_LOCAL_SIZE"] == "2"


def test_worker_env_without_args():
    slot = port_hosts.SlotInfo("localhost", 1, 4, 1, 4, 0, 1)
    ref_slot = ref_hosts.SlotInfo("localhost", 1, 4, 1, 4, 0, 1)
    p = port_launch.build_worker_env({"PATH": "/bin"}, slot, "h", 9)
    r = ref_launch.build_worker_env({"PATH": "/bin"}, ref_slot, "h", 9)
    p.pop("PYTHONPATH"), r.pop("PYTHONPATH")
    assert p == r and "HVTPU_CPU_DEVICES" not in p


# -- the ssh argv --------------------------------------------------------------

_COMMON_ENV = {"HVTPU_RANK": "3", "HOROVOD_X": "y z", "PYTHONPATH": "/r",
               "MY_FLAG": "on", "PATH": "/bin", "SECRET": "s",
               "HVTPU_SECRET_KEY": "k"}
_OWN_ENV = {"JAX_PLATFORMS": "tpu", "XLA_FLAGS": "--x", "TPU_NAME": "t",
            "NCCL_DEBUG": "INFO", "CUDA_VISIBLE_DEVICES": "0",
            "TORCH_HOME": "/th"}


def _ssh(launch, env, monkeypatch, **kw):
    monkeypatch.setenv("HVTPU_SSH_COMMAND", "python /x/fake_ssh.py -q")
    return launch.build_ssh_command("h1", ["python", "train.py", "--lr",
                                           "0.1"], env, cwd="/job",
                                    extra_env_keys=["MY_FLAG"], **kw)


def test_ssh_argv_equal_on_the_common_namespace(monkeypatch):
    assert _ssh(port_launch, _COMMON_ENV, monkeypatch) == _ssh(
        ref_launch, _COMMON_ENV, monkeypatch)
    cmd = _ssh(port_launch, _COMMON_ENV, monkeypatch)
    assert cmd[:4] == ["python", "/x/fake_ssh.py", "-q", "h1"]
    assert "HVTPU_SECRET_KEY" not in cmd[-1] and "SECRET" not in cmd[-1]
    assert "MY_FLAG=on" in cmd[-1] and "PATH=/bin" not in cmd[-1]


def test_ssh_argv_differs_only_in_the_stated_prefixes(monkeypatch):
    env = dict(_COMMON_ENV, **_OWN_ENV)
    port = _ssh(port_launch, env, monkeypatch)[-1]
    ref = _ssh(ref_launch, env, monkeypatch)[-1]
    for k in ("NCCL_DEBUG", "CUDA_VISIBLE_DEVICES", "TORCH_HOME"):
        assert f"{k}=" in port and f"{k}=" not in ref
    for k in ("JAX_PLATFORMS", "XLA_FLAGS", "TPU_NAME"):
        assert f"{k}=" in ref and f"{k}=" not in port
    # each package's own namespace left out, the argv are equal
    ref_own = ("JAX_PLATFORMS", "XLA_FLAGS", "TPU_NAME")
    port_env = {k: v for k, v in env.items()
                if k in ref_own or k not in _OWN_ENV}
    ref_env = {k: v for k, v in env.items() if k not in ref_own}
    assert _ssh(port_launch, port_env, monkeypatch) == _ssh(
        ref_launch, ref_env, monkeypatch)


@both
def test_ssh_port_and_identity(pkg, monkeypatch):
    monkeypatch.delenv("HVTPU_SSH_COMMAND", raising=False)
    cmd = PKGS[pkg][1].build_ssh_command(
        "h1", ["python", "t.py"], {"HVTPU_RANK": "0"}, ssh_port=2222,
        ssh_identity_file="/k/id_ed25519")
    prefix = cmd[:cmd.index("h1")]
    assert prefix[0] == "ssh" and "2222" in prefix and "/k/id_ed25519" \
        in prefix


# -- the signed channel ---------------------------------------------------------

@pytest.mark.parametrize("signer,verifier", [("ref", "port"),
                                             ("port", "ref"),
                                             ("port", "port")])
def test_signed_blob_crosses_packages(signer, verifier):
    sign, verify = PKGS[signer][4], PKGS[verifier][4]
    key = sign.make_secret_key()
    blob = b"\x80\x04payload"
    assert verify.verify(key, sign.sign(key, blob)) == blob


@both
@pytest.mark.parametrize("signer", ["ref", "port"])
def test_tampered_blob_refused(pkg, signer):
    key = PKGS[signer][4].make_secret_key()
    signed = bytearray(PKGS[signer][4].sign(key, b"payload"))
    signed[-1] ^= 1
    with pytest.raises(PKGS[pkg][4].SignatureError):
        PKGS[pkg][4].verify(key, bytes(signed))
    with pytest.raises(PKGS[pkg][4].SignatureError):
        PKGS[pkg][4].verify(PKGS[pkg][4].make_secret_key(),
                            PKGS[signer][4].sign(key, b"payload"))


@both
def test_key_file_round_trip(pkg, tmp_path, monkeypatch):
    secret = PKGS[pkg][4]
    key = secret.make_secret_key()
    path = tmp_path / "job.key"
    secret.write_key_file(key, str(path))
    assert oct(path.stat().st_mode & 0o777) == "0o600"
    monkeypatch.setenv(secret.ENV_KEY_FILE, str(path))
    assert secret.require_env_key() == key


# -- nic -----------------------------------------------------------------------

def test_nic_same_interfaces():
    assert port_nic.local_interfaces() == ref_nic.local_interfaces()
    assert port_nic.local_interfaces(usable_only=True) == \
        ref_nic.local_interfaces(usable_only=True)
    name, addr = port_nic.local_interfaces()[0]
    assert port_nic.resolve_interface(name) == \
        ref_nic.resolve_interface(name) == addr
    assert port_nic.resolve_interface("10.1.2.3") == "10.1.2.3"


@both
def test_nic_typo_raises(pkg):
    with pytest.raises(ValueError, match="neither a local interface"):
        PKGS[pkg][2].resolve_interface("eth00-definitely-not-real")


@both
@pytest.mark.parametrize("egress,want", [("10.0.0.5", "10.0.0.5"),
                                         (None, "172.17.0.1")])
def test_nic_probe_prefers_the_route(pkg, egress, want, monkeypatch):
    nic = PKGS[pkg][2]
    monkeypatch.setattr(nic, "local_interfaces",
                        lambda usable_only=False: [("docker0", "172.17.0.1"),
                                                   ("eth0", "10.0.0.5")])
    monkeypatch.setattr(nic, "_egress_addr", lambda target: egress)
    assert nic.probe_coordinator_addr("remote1") == want


@both
def test_mixed_spec_probes_toward_the_remote(pkg, monkeypatch):
    launch, nic = PKGS[pkg][1], PKGS[pkg][2]
    seen = {}

    def fake_probe(remote_host=None):
        seen["remote"] = remote_host
        return "10.9.8.7"

    monkeypatch.setattr(nic, "probe_coordinator_addr", fake_probe)
    hosts_mod = PKGS[pkg][0]
    slots = hosts_mod.get_host_assignments(
        hosts_mod.parse_host_spec("localhost:1,remote1:1"), 2)
    assert launch._default_coordinator_addr(slots) == "10.9.8.7"
    assert seen["remote"] == "remote1"
    local = hosts_mod.get_host_assignments(
        hosts_mod.parse_host_spec("localhost:2"), 2)
    assert launch._default_coordinator_addr(local) == "127.0.0.1"


# -- launch-time checks and informational modes --------------------------------

@both
@pytest.mark.parametrize("where", ["flag", "env"])
def test_bad_fault_spec_refused_at_launch(pkg, where, monkeypatch, capsys):
    launch = PKGS[pkg][1]
    argv = ["-np", "1", "--", "true"]
    if where == "flag":
        argv = ["--fault-spec", "wire.send:torn"] + argv
    else:
        monkeypatch.setenv("HVTPU_FAULT_SPEC", "wire.send:torn")
    assert launch.main(argv) == 2
    assert "wire.send" in capsys.readouterr().err


# ids as they were when the autotuner's six settings stood first in
# this list and the messages cited ROADMAP "item 3a"; the test names
# stay
UNPORTED = [
    pytest.param(["--compression", "int8"], None, "stay refused",
                 id="flags6-None-item 3a"),
    pytest.param([], ("HOROVOD_COMPRESSION", "fp16"), "stay refused",
                 id="flags7-env7-item 3a"),
    pytest.param(["--nonfinite-action", "abort"], None, "stay refused",
                 id="flags8-None-item 3a"),
    pytest.param([], ("HVTPU_NONFINITE_ACTION", "skip"), "stay refused",
                 id="flags9-env9-item 3a"),
]


@pytest.mark.parametrize("flags,env,item", UNPORTED)
def test_unported_settings_refused_before_any_spawn(flags, env, item,
                                                    monkeypatch, capsys):
    """A setting the launcher parses as the JAX package's does but that
    no module of the port applies: exit 2 naming the ROADMAP item, with
    no worker started (the command would fail the test if it ran)."""
    monkeypatch.setattr(port_launch, "launch_workers", _no_spawn)
    if env is not None:
        monkeypatch.setenv(*env)
    assert port_launch.main(flags + ["-np", "1", "--", "false"]) == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flags,env", [
    (["--compression", "none", "--nonfinite-action", "off"], None),
    ([], ("HVTPU_AUTOTUNE", "0")),
    ([], ("HVTPU_COMPRESSION", "none")),
])
def test_idle_values_of_unported_settings_launch(flags, env, monkeypatch):
    """The values that ask for nothing the port lacks pass through."""
    seen = []
    monkeypatch.setattr(port_launch, "launch_workers",
                        lambda *a, **k: seen.append(a) or 0)
    if env is not None:
        monkeypatch.setenv(*env)
    assert port_launch.main(flags + ["-np", "1", "--", "true"]) == 0
    assert len(seen) == 1


def test_run_refuses_unported_settings(monkeypatch):
    from horovod_tpu_torch import runner

    monkeypatch.setattr(runner, "launch_workers", _no_spawn)
    with pytest.raises(ValueError, match="stay refused"):
        runner.run(abs, args=(1,), np=1,
                   extra_flags=["--autotune", "--compression", "int8"])
    with pytest.raises(ValueError, match="stay refused"):
        runner.run_elastic(abs, args=(1,), num_proc=1,
                           env={"HVTPU_COMPRESSION": "int8"})


@pytest.mark.parametrize("name,level", [
    ("trace", logging.DEBUG), ("debug", logging.DEBUG),
    ("info", logging.INFO), ("warning", logging.WARNING),
    ("error", logging.ERROR), ("fatal", logging.CRITICAL)])
def test_log_level_reaches_the_package_logger(name, level, monkeypatch):
    import horovod_tpu_torch as hvd

    env = port_launch.build_worker_env(
        {}, port_hosts.get_host_assignments(
            port_hosts.parse_host_spec("localhost:1"), 1)[0],
        "127.0.0.1", 1, port_launch.parse_args(
            ["--log-level", name, "-np", "1", "--", "true"]))
    assert env["HVTPU_LOG_LEVEL"] == name
    monkeypatch.setenv("HVTPU_LOG_LEVEL", name)
    logger = logging.getLogger("horovod_tpu_torch")
    saved = logger.level
    hvd.init(device="cpu")
    try:
        assert logger.level == level
    finally:
        hvd.shutdown()
        logger.setLevel(saved)


def _no_spawn(*args, **kwargs):
    raise AssertionError("a worker was spawned")


def test_check_build_reports_the_port(capsys):
    assert port_launch.main(["-cb"]) == 0
    out = capsys.readouterr().out
    assert "horovod_tpu_torch" in out and "[X] PyTorch" in out
    assert "[X] native C++ core" in out and "[X] Python controller" in out
    for name in ("NCCL", "gloo", "CUDA", "MPI", "scale_cast",
                 "quantize_int8", "ring", "ring_cluster"):
        assert name in out
    assert "JAX" not in out and "XLA" not in out
    assert port_launch.kernels_built().keys() == {
        "scale_cast", "quantize_int8", "ring", "ring_cluster"}


@both
def test_version(pkg, capsys):
    assert PKGS[pkg][1].main(["--version"]) == 0
    assert capsys.readouterr().out.strip() == "0.5.0"


# -- the worker pumps ------------------------------------------------------------

@both
def test_worker_pumps_prefix_and_first_failure(pkg, capfd):
    exe = PKGS[pkg][3]
    ok = exe.WorkerProcess(0, [sys.executable, "-c", "print('hello')"],
                           dict(os.environ))
    # ``bad`` starts once ``ok`` has exited: a failure terminates every
    # worker still running, and on a loaded machine ``ok`` could be
    # killed before its interpreter prints
    assert ok.proc.wait(timeout=30) == 0
    bad = exe.WorkerProcess(1, [sys.executable, "-c",
                                "import sys; print('oops', file=sys.stderr);"
                                " sys.exit(5)"], dict(os.environ))
    assert exe.wait_for_any_failure_or_all_done([ok, bad]) == 5
    out, err = capfd.readouterr()
    assert "[0]<stdout>:hello" in out
    assert "[1]<stderr>:oops" in err


@both
def test_terminate_ends_a_sleeping_worker(pkg):
    exe = PKGS[pkg][3]
    w = exe.WorkerProcess(0, [sys.executable, "-c",
                              "import time; time.sleep(60)"],
                          dict(os.environ), prefix_output=False)
    w.terminate(grace_s=1.0)
    assert w.wait(timeout=10) != 0

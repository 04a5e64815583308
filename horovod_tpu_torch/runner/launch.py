"""``python -m horovod_tpu_torch.runner`` — the port's launcher CLI.

Counterpart of ``horovod_tpu/runner/launch.py``, with the same flags and
the same env block; the settings no module of the port applies yet
(:data:`UNPORTED`) are refused before any spawn.  Parity surface:
``horovod/runner/launch.py`` (``parse_args``, ``_run``) and ``horovod/runner/gloo_run.py``
(``launch_gloo``): compute rank assignments from the host spec, build
each worker's environment (``HVTPU_RANK/SIZE/LOCAL_RANK/...`` — the
HOROVOD_RANK/SIZE analog), spawn workers with rank-prefixed output
piping, and propagate the first non-zero exit code after terminating
survivors.

Like the reference there is no launcher-hosted HTTP rendezvous server
(``runner/http/http_server.py``): rank 0's worker serves a ``TCPStore``
on the coordinator port (``core/state.py``), which becomes the default
group's store; the launcher only picks the port and points every worker
at it via ``HVTPU_COORDINATOR_ADDR/PORT``.  Each worker binds
``cuda:{local_rank}``; ``--cpu-devices 1`` runs them on the CPU over
gloo.  ``--host-discovery-script`` hands the job to the elastic driver
(``elastic/driver.py``).
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import sys
import threading
from typing import Dict, List, Optional, Sequence

from . import hosts as hosts_mod
from . import safe_shell_exec
from .hosts import SlotInfo

PROG = "horovod_tpu_torch.runner"
# the env the ssh path forwards to a remote worker (besides -x names):
# the framework's namespace, PyTorch's, CUDA's and NCCL's
SSH_EXPORT_PREFIXES = ("HVTPU_", "HOROVOD_", "PYTHONPATH", "NCCL_",
                       "CUDA_", "TORCH_")


def find_free_port(bind_addr: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((bind_addr, 0))
        return s.getsockname()[1]


def _default_coordinator_addr(slots: List[SlotInfo]) -> str:
    """Address workers use to reach rank 0's coordination service.

    Loopback is only usable when EVERY worker is local; a mixed spec
    probes this host's NICs for a routable address (parity:
    driver_service.py's interface discovery), with --network-interface
    as the explicit override when the probe picks a wrong one.
    """
    host0 = slots[0].hostname
    if hosts_mod.is_local_host(host0):
        remotes = [s.hostname for s in slots
                   if not hosts_mod.is_local_host(s.hostname)]
        if remotes:
            from . import nic

            addr = nic.probe_coordinator_addr(remote_host=remotes[0])
            # always announce the auto-chosen address: a wrong guess is
            # otherwise a silent rendezvous hang with nothing to debug
            print(f"{PROG}: coordinator address auto-selected: {addr} "
                  "(override with --network-interface)", file=sys.stderr)
            return addr
        return "127.0.0.1"
    return host0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parity: horovod/runner/launch.py parse_args — flags mirror the
    HVTPU_*/HOROVOD_* env namespace, as the JAX package's do."""
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Launch a horovod_tpu_torch job on N worker "
                    "processes.",
    )
    p.add_argument("-v", "--version", action="store_true",
                   dest="show_version",
                   help="print the horovod_tpu_torch version and exit")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print build capabilities (framework, "
                        "controllers, collectives, CUDA kernels) and "
                        "exit")
    p.add_argument("-np", "--num-proc", type=int, dest="np", default=None,
                   help="number of worker processes (ranks)")
    p.add_argument("-H", "--hosts", dest="hosts", default=None,
                   help='host spec "h1:2,h2:2" (default: localhost:np)')
    p.add_argument("-hostfile", "--hostfile", dest="hostfile",
                   default=None,
                   help="file of hosts, one per line: 'host slots=N' "
                        "(reference format) or 'host:N'")
    p.add_argument("-p", "--ssh-port", type=int, dest="ssh_port",
                   default=None,
                   help="ssh port for remote workers (parity: "
                        "horovodrun -p)")
    p.add_argument("-i", "--ssh-identity-file", dest="ssh_identity_file",
                   default=None,
                   help="ssh identity (private key) file for remote "
                        "workers (parity: horovodrun -i)")
    p.add_argument("-x", dest="env_passthrough", action="append",
                   default=[], metavar="VAR[=VAL]",
                   help="pass an environment variable to every worker "
                        "(repeatable); VAR alone copies the launcher's "
                        "value, VAR=VAL sets it explicitly")
    p.add_argument("--network-interface", dest="nic", default=None,
                   help="address workers use to reach the coordinator "
                        "(default: first host, or 127.0.0.1 if local)")
    p.add_argument("--coordinator-port", type=int, default=0,
                   help="coordination-service port (0 = pick a free one)")
    p.add_argument("--start-timeout", type=float, default=600.0,
                   help="seconds workers get to rendezvous at startup "
                        "(exported as HVTPU_START_TIMEOUT; does NOT "
                        "bound job duration)")
    p.add_argument("--job-timeout", type=float, default=None,
                   help="optional hard deadline for the WHOLE job; "
                        "default: unlimited")
    p.add_argument("--output-filename", default=None,
                   help="directory for per-rank output files instead of "
                        "prefixed piping (parity: horovodrun flag)")
    p.add_argument("--verbose", action="store_true")
    # engine knobs mirrored into env (layer-2 of the config scheme)
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--disable-cache", action="store_true",
                   help="disable the response cache (parity: "
                        "horovodrun --disable-cache; equals "
                        "--cache-capacity 0)")
    p.add_argument("--hierarchical-allreduce", action="store_true",
                   help="two-stage allreduce (the local group, then the "
                        "cross group) on uniform layouts")
    p.add_argument("--autotune-warmup-samples", type=int, default=None)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   default=None,
                   help="max Bayesian-optimization samples (maps to "
                        "HVTPU_AUTOTUNE_GP_SAMPLES)")
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--trace-dir", default=None,
                   help="enable cross-rank distributed tracing: each "
                        "worker writes DIR/rank<N>.trace.json (exported "
                        "as HVTPU_TRACE; merge/report with "
                        "python -m tools.hvtputrace)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus text-format metrics from each "
                        "worker at http://host:(PORT+local_rank)/metrics "
                        "(exported as HVTPU_METRICS_PORT)")
    p.add_argument("--flight-dir", default=None,
                   help="directory for flight-recorder postmortem dumps "
                        "(postmortem-<rank>-<gen>.json, written on fatal "
                        "paths or SIGUSR2; exported as HVTPU_FLIGHT_DIR; "
                        "merge with python -m tools.hvtputrace "
                        "postmortem)")
    p.add_argument("--flight-window", type=int, default=None,
                   help="flight-recorder ring capacity in events "
                        "(exported as HVTPU_FLIGHT_WINDOW; default 2048)")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log", default=None)
    p.add_argument("--compression", default=None,
                   choices=["none", "fp16", "bf16", "int8"])
    p.add_argument("--stall-check-time", type=float, default=None,
                   help="seconds before warning about a stalled collective")
    p.add_argument("--stall-shutdown-time", type=float, default=None,
                   help="seconds before aborting a stalled collective")
    p.add_argument("--no-stall-check", action="store_true",
                   help="disable stall detection entirely (parity: "
                        "horovodrun --no-stall-check)")
    p.add_argument("--stall-check-mode", default=None,
                   choices=["amortized", "strict"],
                   help="amortized (default: local bookkeeping + KV "
                        "heartbeat, ~zero per-op cost) or strict "
                        "(per-op pre-dispatch rendezvous: nothing "
                        "dispatches until all members confirm)")
    p.add_argument("--stall-heartbeat", type=float, default=None,
                   help="amortized-mode heartbeat interval seconds "
                        "(default 0.5; detection latency is one beat)")
    p.add_argument("--log-level", default=None,
                   choices=["trace", "debug", "info", "warning", "error",
                            "fatal"])
    # elastic (driven by runner.elastic once --host-discovery-script set)
    p.add_argument("--host-discovery-script", default=None,
                   help="script printing current 'host:slots' lines; "
                        "enables elastic mode")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--elastic-timeout", type=float, default=None)
    p.add_argument("--max-restarts", type=int, default=None,
                   help="elastic restart budget: relaunches allowed "
                        "before the driver declares the workload "
                        "crash-looping and exits with a diagnostic; "
                        "also bounds relaunches after resets in a row "
                        "that no membership change explains "
                        "(default: unlimited; HVTPU_MAX_RESTARTS)")
    p.add_argument("--restart-window", type=float, default=None,
                   help="seconds: apply --max-restarts to a sliding "
                        "window instead of the whole job "
                        "(HVTPU_RESTART_WINDOW_SECONDS)")
    p.add_argument("--blacklist-cooldown", type=float, default=None,
                   help="seconds a host stays blacklisted after its "
                        "first strike; doubles per strike "
                        "(HVTPU_BLACKLIST_COOLDOWN_SECONDS, default 300)")
    # graceful preemption / drain (core/preempt.py; docs/robustness.md)
    p.add_argument("--drain-grace", type=float, default=None,
                   dest="drain_grace",
                   help="seconds a preempted worker may spend reaching "
                        "a drain commit before it force-exits; also how "
                        "long the driver waits after forwarding a drain "
                        "(HVTPU_DRAIN_GRACE_SECONDS, default 30)")
    p.add_argument("--preempt-notice-file", default=None,
                   dest="preempt_notice_file",
                   help="path workers poll for a preemption notice; "
                        "creating it triggers a coordinated drain, for "
                        "platforms that announce preemption via files "
                        "or metadata probes instead of signals "
                        "(HVTPU_PREEMPT_NOTICE_FILE)")
    # fault injection (core/faults.py; docs/robustness.md)
    p.add_argument("--fault-spec", default=None,
                   help="deterministic fault-injection spec exported "
                        "to workers as HVTPU_FAULT_SPEC, e.g. "
                        "'worker.step:kill@rank=1,count=3' "
                        "(docs/robustness.md for the grammar)")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="seed for prob= fault selectors "
                        "(HVTPU_FAULT_SEED; per-rank streams derive "
                        "from it, so a seed reproduces a schedule)")
    # data-plane integrity (core/audit.py + api/optimizer.py;
    # docs/robustness.md "Integrity")
    p.add_argument("--audit-every", type=int, default=None,
                   help="run the parameter divergence audit every N "
                        "steps (0 = off; HVTPU_AUDIT_EVERY)")
    p.add_argument("--audit-action", default=None,
                   choices=["abort", "warn"],
                   help="what to do when the audit finds divergent "
                        "replicas (HVTPU_AUDIT_ACTION, default abort: "
                        "elastic jobs roll back to the last commit "
                        "and relaunch verified-identical)")
    p.add_argument("--nonfinite-action", default=None,
                   choices=["skip", "zero", "abort", "off"],
                   help="coordinated optimizer action when the reduced "
                        "gradients carry NaN/inf — every rank acts "
                        "together (HVTPU_NONFINITE_ACTION, default "
                        "skip)")
    # CPU mode (CI: N ranks on localhost CPUs, over gloo)
    p.add_argument("--cpu-devices", type=int, default=None,
                   help="run every worker on the CPU over gloo "
                        "(HVTPU_CPU_DEVICES; the port takes 1: one "
                        "device a process)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="worker command, e.g. python train.py")
    args = p.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.show_version or args.check_build:
        return args  # informational modes need no command/np
    if args.hostfile:
        if args.hosts:
            p.error("--hosts and --hostfile are mutually exclusive")
        try:
            args.hosts = parse_hostfile(args.hostfile)
        except (OSError, ValueError) as e:
            p.error(f"--hostfile {args.hostfile}: {e}")
    if not args.host_discovery_script:
        if args.np is None:
            p.error("-np is required (unless --host-discovery-script)")
    elif args.np is None:
        args.np = args.min_np or 1
    if not args.command:
        p.error("no worker command given")
    return args


def parse_hostfile(path: str) -> str:
    """Hostfile → host-spec string.  Accepts the reference's format
    ('hostname slots=N', horovod/runner/launch.py parse_host_files)
    and the compact 'hostname:N'; blank lines and # comments skipped."""
    specs = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if ":" in parts[0]:
                # compact 'host:N' — one entry per line, no mixing
                # with slots= (a 'node1:4 slots=8' line is ambiguous)
                if len(parts) > 1:
                    raise ValueError(
                        f"malformed hostfile line {line!r}: compact "
                        "'host:N' lines take one entry per line")
                specs.append(parts[0])
                continue
            host = parts[0]
            slots = 1
            for tok in parts[1:]:
                if tok.startswith("slots="):
                    slots = int(tok[len("slots="):])
            specs.append(f"{host}:{slots}")
    if not specs:
        raise ValueError(f"hostfile {path!r} contains no hosts")
    return ",".join(specs)


def uniform_local_size(slots: List[SlotInfo]) -> int:
    """The common per-host slot count when the layout is uniform (every
    host has the same local_size), else 0.  Hierarchical collectives
    require a uniform grid; the launcher is the one place that can see
    the whole layout, so it certifies uniformity to the workers."""
    sizes = {s.local_size for s in slots}
    return slots[0].local_size if len(sizes) == 1 else 0


def build_worker_env(
    base_env: Dict[str, str],
    slot: SlotInfo,
    coordinator_addr: str,
    coordinator_port: int,
    args: Optional[argparse.Namespace] = None,
    uniform_local: Optional[int] = None,
) -> Dict[str, str]:
    """Per-rank environment (parity: the env block launch_gloo exports —
    HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/CROSS_SIZE plus
    rendezvous address/port)."""
    env = dict(base_env)
    env.update(
        HVTPU_RANK=str(slot.rank),
        HVTPU_SIZE=str(slot.size),
        HVTPU_LOCAL_RANK=str(slot.local_rank),
        HVTPU_LOCAL_SIZE=str(slot.local_size),
        HVTPU_CROSS_RANK=str(slot.cross_rank),
        HVTPU_CROSS_SIZE=str(slot.cross_size),
        HVTPU_COORDINATOR_ADDR=coordinator_addr,
        HVTPU_COORDINATOR_PORT=str(coordinator_port),
    )
    if uniform_local is not None:
        env["HVTPU_UNIFORM_LOCAL_SIZE"] = str(uniform_local)
    # Source-checkout robustness: make the horovod_tpu_torch package
    # the launcher itself is running from importable in workers even when
    # it is not pip-installed and the script lives elsewhere (the
    # reference assumes an installed horovod; worker scripts here are
    # run by absolute path, so cwd is not on sys.path).
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if pkg_root not in parts:
        env["PYTHONPATH"] = os.pathsep.join([pkg_root] + parts)
    if args is not None:
        flag_env = {
            "HVTPU_FUSION_THRESHOLD_MB": args.fusion_threshold_mb,
            "HVTPU_CYCLE_TIME": args.cycle_time_ms,
            "HVTPU_CACHE_CAPACITY": args.cache_capacity,
            "HVTPU_TIMELINE": args.timeline_filename,
            "HVTPU_TRACE": args.trace_dir,
            "HVTPU_METRICS_PORT": args.metrics_port,
            "HVTPU_FLIGHT_DIR": getattr(args, "flight_dir", None),
            "HVTPU_FLIGHT_WINDOW": getattr(args, "flight_window", None),
            "HVTPU_AUTOTUNE_LOG": args.autotune_log,
            "HVTPU_COMPRESSION": args.compression,
            "HVTPU_STALL_CHECK_TIME_SECONDS": args.stall_check_time,
            "HVTPU_STALL_SHUTDOWN_TIME_SECONDS": args.stall_shutdown_time,
            "HVTPU_STALL_CHECK_MODE": args.stall_check_mode,
            "HVTPU_STALL_HEARTBEAT_SECONDS": args.stall_heartbeat,
            "HVTPU_LOG_LEVEL": args.log_level,
            "HVTPU_CPU_DEVICES": args.cpu_devices,
            "HVTPU_FAULT_SPEC": getattr(args, "fault_spec", None),
            "HVTPU_FAULT_SEED": getattr(args, "fault_seed", None),
            "HVTPU_AUDIT_EVERY": getattr(args, "audit_every", None),
            "HVTPU_AUDIT_ACTION": getattr(args, "audit_action", None),
            "HVTPU_NONFINITE_ACTION":
                getattr(args, "nonfinite_action", None),
            "HVTPU_ELASTIC_TIMEOUT": args.elastic_timeout,
            "HVTPU_DRAIN_GRACE_SECONDS": getattr(args, "drain_grace", None),
            "HVTPU_PREEMPT_NOTICE_FILE":
                getattr(args, "preempt_notice_file", None),
            "HVTPU_START_TIMEOUT": args.start_timeout,
            "HVTPU_AUTOTUNE_WARMUP_SAMPLES": args.autotune_warmup_samples,
            "HVTPU_AUTOTUNE_STEPS_PER_SAMPLE":
                args.autotune_steps_per_sample,
            "HVTPU_AUTOTUNE_GP_SAMPLES":
                args.autotune_bayes_opt_max_samples,
        }
        for k, v in flag_env.items():
            if v is not None:
                env[k] = str(v)
        if args.autotune:
            env["HVTPU_AUTOTUNE"] = "1"
        if args.timeline_mark_cycles:
            env["HVTPU_TIMELINE_MARK_CYCLES"] = "1"
        if args.disable_cache:
            env["HVTPU_CACHE_CAPACITY"] = "0"
        if args.no_stall_check:
            env["HVTPU_STALL_CHECK_DISABLE"] = "1"
        if args.hierarchical_allreduce:
            env["HVTPU_HIERARCHICAL_ALLREDUCE"] = "1"
        # -x VAR[=VAL]: explicit per-worker env passthrough (parity:
        # mpirun -x, which horovodrun users reach via --mpi-args; the
        # ssh path forwards only SSH_EXPORT_PREFIXES, so -x
        # is how arbitrary app variables cross hosts)
        for spec in args.env_passthrough:
            if "=" in spec:
                k, v = spec.split("=", 1)
                env[k] = v
            elif spec in base_env:
                env[spec] = base_env[spec]
            else:
                # mpirun parity: -x of an unset variable warns instead
                # of silently launching workers without it
                print(f"{PROG}: warning: -x {spec}: variable not "
                      "found in the launcher environment",
                      file=sys.stderr)
    return env


def ssh_options_from_args(args: Optional[argparse.Namespace]) -> Dict:
    """The launcher-flag subset build_ssh_command consumes — one
    derivation shared by the static and elastic spawn paths so `-p`,
    `-i`, and `-x` can never apply in one mode and not the other."""
    if args is None:
        return {}
    return {
        "ssh_port": args.ssh_port,
        "ssh_identity_file": args.ssh_identity_file,
        "extra_env_keys": [s.split("=", 1)[0]
                           for s in args.env_passthrough],
    }


def build_ssh_command(
    hostname: str,
    command: Sequence[str],
    env: Dict[str, str],
    cwd: Optional[str] = None,
    ssh_port: Optional[int] = None,
    ssh_identity_file: Optional[str] = None,
    extra_env_keys: Sequence[str] = (),
) -> List[str]:
    """Remote worker command line (parity: get_remote_command /
    get_ssh_command in horovod/runner/util/remote.py).  Only the
    HVTPU_*/HOROVOD_*/NCCL_*/CUDA_*/TORCH_* env subset and PYTHONPATH
    are forwarded — plus any ``-x`` passthrough names in
    ``extra_env_keys`` — like the reference forwarding its own namespace
    with ``env`` on the remote shell.
    """
    extra = set(extra_env_keys)
    exports = " ".join(
        f"{k}={shlex.quote(v)}"
        for k, v in sorted(env.items())
        if (k.startswith(SSH_EXPORT_PREFIXES) or k in extra)
        # never serialize the HMAC key itself into argv — it would be
        # world-readable via /proc/*/cmdline on both ends; the key
        # rides a 0600 file (HVTPU_SECRET_FILE) instead
        and k != "HVTPU_SECRET_KEY"
    )
    inner = " ".join(shlex.quote(c) for c in command)
    if cwd:
        inner = f"cd {shlex.quote(cwd)} && env {exports} {inner}"
    else:
        inner = f"env {exports} {inner}"
    # HVTPU_SSH_COMMAND swaps the transport binary (integration tests
    # use a local shim so the REAL remote code path — env export
    # serialization, quoting, cwd, piping, exit propagation — executes
    # on machines without sshd; parity: the reference's ssh command is
    # also centrally constructed and test-substituted).
    override = os.environ.get("HVTPU_SSH_COMMAND")
    if override:
        ssh = shlex.split(override)
    else:
        ssh = ["ssh", "-o", "PasswordAuthentication=no",
               "-o", "StrictHostKeyChecking=no"]
        if ssh_port:
            ssh += ["-p", str(ssh_port)]
        if ssh_identity_file:
            ssh += ["-i", ssh_identity_file]
    return ssh + [hostname, inner]


def launch_workers(
    command: Sequence[str],
    slots: List[SlotInfo],
    coordinator_addr: str,
    coordinator_port: int,
    args: Optional[argparse.Namespace] = None,
    base_env: Optional[Dict[str, str]] = None,
    job_timeout: Optional[float] = None,
    output_dir: Optional[str] = None,
) -> int:
    """Spawn one worker per slot and wait (parity: launch_gloo).

    ``job_timeout`` is an optional hard deadline for the whole job;
    startup/rendezvous timeouts are the workers' business
    (HVTPU_START_TIMEOUT -> the TCPStore's timeout at init()).
    """
    base_env = dict(base_env if base_env is not None else os.environ)
    stdout_lock = threading.Lock()
    uniform = uniform_local_size(slots)
    ssh_opts = ssh_options_from_args(args)
    workers: List[safe_shell_exec.WorkerProcess] = []
    try:
        for slot in slots:
            env = build_worker_env(
                base_env, slot, coordinator_addr, coordinator_port, args,
                uniform_local=uniform,
            )
            if hosts_mod.is_local_host(slot.hostname):
                cmd = list(command)
            else:
                cmd = build_ssh_command(
                    slot.hostname, command, env, cwd=os.getcwd(),
                    **ssh_opts,
                )
            workers.append(
                safe_shell_exec.WorkerProcess(
                    slot.rank, cmd, env,
                    output_dir=output_dir,
                    stdout_lock=stdout_lock,
                )
            )
    except Exception:
        for w in workers:
            w.terminate()
        raise

    def _on_failure(w, code):
        print(
            f"{PROG}: rank {w.rank} exited with code {code}; "
            "terminating remaining workers",
            file=sys.stderr,
        )

    # Launcher SIGTERM (scheduler preemption of the launcher itself)
    # forwards the configured preemption signal to every live worker
    # so they run the coordinated drain protocol (core/preempt.py)
    # instead of dying to the escalation path's killpg — the workers'
    # own SIGTERM handler publishes the drain notice; the escalation
    # timer only starts after this wait returns.
    def _forward_preempt(signum, frame):
        from ..core.preempt import configured_signal

        fwd = configured_signal()
        for w in workers:
            if w.poll() is None and fwd is not None:
                try:
                    os.kill(w.proc.pid, fwd)
                except (ProcessLookupError, OSError):
                    pass
        print(f"{PROG}: SIGTERM received; forwarded preemption "
              "notice to workers (coordinated drain)", file=sys.stderr)

    prev_term = None
    try:
        prev_term = signal.signal(signal.SIGTERM, _forward_preempt)
    except ValueError:
        pass  # non-main thread: no forwarding, escalation path only
    try:
        return safe_shell_exec.wait_for_any_failure_or_all_done(
            workers, timeout=job_timeout, on_failure=_on_failure
        )
    finally:
        if prev_term is not None:
            try:
                signal.signal(signal.SIGTERM, prev_term)
            except ValueError:
                pass


# Settings the launcher parses and exports as the JAX package's
# launcher does, but which no module of the port reads yet: a job
# launched with one would silently run without it, so the launcher
# refuses it before any spawn.  (flag attribute, env name after the
# HVTPU_ / HOROVOD_ prefix, values that ask for nothing, why it stays
# refused)
UNPORTED = (
    ("compression", "COMPRESSION", ("", "none"),
     "a job-wide codec is not applied by the port: pass compression= "
     "to DistributedOptimizer or the op (ROADMAP Queue C, --compression "
     "and --nonfinite-action stay refused)"),
    ("nonfinite_action", "NONFINITE_ACTION", ("", "off"),
     "the port's DistributedOptimizer has no non-finite check (ROADMAP "
     "Queue C, --compression and --nonfinite-action stay refused)"),
)


def unported_settings(args: argparse.Namespace,
                      environ: Dict[str, str]) -> List[str]:
    """What in ``args`` or ``environ`` (the env the workers inherit)
    asks for a setting of :data:`UNPORTED`: one message each."""
    found = []
    for attr, env_name, idle, why in UNPORTED:
        value = getattr(args, attr, None)
        if (value not in (None, False)
                and str(value).strip().lower() not in idle):
            flag = "--" + attr.replace("_", "-")
            found.append(f"{flag}: {why}")
            continue
        for prefix in ("HVTPU_", "HOROVOD_"):
            value = environ.get(prefix + env_name) if env_name else None
            if value is not None and value.strip().lower() not in idle:
                found.append(f"{prefix}{env_name}={value}: {why}")
                break
    return found


def kernels_built() -> Dict[str, bool]:
    """Whether each of the port's CUDA kernels (``csrc/*.cu``) has a
    library built from its current source (``ops/_build.py``)."""
    from ..ops import _build

    return {src.stem: _build.lib_path(src).exists()
            for src in _build.sources()}


def _check_build() -> int:
    """Parity: horovodrun -cb (check_build in the reference's
    launch.py): print version + available capabilities and exit.  The
    native core is marked when it builds (``native/_build.py``) and
    loads."""
    from .. import version as _version
    from ..core import basics
    from ..native import native_available

    print(f"{PROG} (horovod_tpu_torch) v{_version.__version__}")

    def mark(flag):
        return "[X]" if flag else "[ ]"

    print("Available frameworks:")
    print(f"    {mark(True)} PyTorch")
    print("Available controllers:")
    print(f"    {mark(native_available())} native C++ core")
    print(f"    {mark(True)} Python controller")
    print("Available tensor operations:")
    print(f"    {mark(bool(basics.nccl_built()))} NCCL")
    print(f"    {mark(basics.gloo_built())} gloo")
    print(f"    {mark(basics.cuda_built())} CUDA")
    print(f"    {mark(basics.mpi_built())} MPI")
    print("CUDA kernels (built from horovod_tpu_torch/csrc):")
    for stem, built in kernels_built().items():
        print(f"    {mark(built)} {stem}")
    return 0


def _run(args: argparse.Namespace) -> int:
    """Parity: horovod/runner/launch.py _run — static vs elastic split."""
    if args.show_version:
        from .. import version as _version

        print(_version.__version__)
        return 0
    if args.check_build:
        return _check_build()
    # Workers inherit a fault spec from either the flag or a
    # pre-existing HVTPU_FAULT_SPEC in the launcher's environment
    # (launch_workers forwards both).  Validate every source here,
    # before any spawn: a malformed clause would otherwise kill each
    # worker at fault-registry init, which at scale reads as a
    # mysterious whole-job crash instead of one launcher-side error
    # naming the bad clause.
    for origin, spec in (("--fault-spec", args.fault_spec),
                         ("HVTPU_FAULT_SPEC",
                          os.environ.get("HVTPU_FAULT_SPEC"))):
        if not spec:
            continue
        from ..core.faults import FaultSpecError, parse_spec

        try:
            parse_spec(spec)  # fail fast, before any spawn
        except FaultSpecError as e:
            print(f"{PROG}: {origin}: {e}", file=sys.stderr)
            return 2
    unported = unported_settings(args, os.environ)
    for msg in unported:
        print(f"{PROG}: {msg}", file=sys.stderr)
    if unported:
        return 2
    if args.host_discovery_script:
        from ..elastic.driver import run_elastic

        return run_elastic(args)
    host_spec = args.hosts or f"localhost:{args.np}"
    slots = hosts_mod.get_host_assignments(
        hosts_mod.parse_host_spec(host_spec), args.np
    )
    if args.nic:
        from . import nic as nic_mod

        coordinator_addr = nic_mod.resolve_interface(args.nic)
    else:
        coordinator_addr = _default_coordinator_addr(slots)
    port = args.coordinator_port or find_free_port()
    if args.verbose:
        print(
            f"{PROG}: {args.np} ranks on {host_spec}, "
            f"coordinator {coordinator_addr}:{port}",
            file=sys.stderr,
        )
    return launch_workers(
        args.command,
        slots,
        coordinator_addr,
        port,
        args=args,
        job_timeout=args.job_timeout,
        output_dir=args.output_filename,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    return _run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())

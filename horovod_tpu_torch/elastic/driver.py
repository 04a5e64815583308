"""Launcher-side elastic driver (counterpart of
``horovod_tpu/elastic/driver.py``).

Parity surface: ``horovod/runner/elastic/driver.py`` (``ElasticDriver``)
+ ``horovod/runner/launch.py`` (``_run_elastic``): poll a host-discovery
script on an interval, keep min_np ≤ world ≤ max_np workers running,
notify workers on membership change, blacklist repeatedly-failing
hosts, and restart the job from committed state.

Restart-based elasticity (see elastic/state.py), as the JAX package's:
instead of the reference's in-process Gloo re-rendezvous, the driver
relaunches the whole worker set on a fresh coordinator port (each
incarnation's rank 0 serves a new ``TCPStore`` there, so every
incarnation starts an empty store); workers resume from the durable
commit (``HVTPU_ELASTIC_STATE_DIR``) with ``HVTPU_ELASTIC_GENERATION``
counting up.
Driver→worker "hosts updated" notification is SIGUSR1 (the analog of
``WorkerNotificationClient``); workers exit with ``RESET_EXIT_CODE`` at
the next commit boundary and the driver rebuilds the world.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
from typing import Dict, List, Optional

from ..obs import flight
from ..obs import metrics as obs_metrics
from ..runner import hosts as hosts_mod
from ..runner import safe_shell_exec
from ..runner.launch import (
    _default_coordinator_addr,
    build_ssh_command,
    build_worker_env,
    find_free_port,
    ssh_options_from_args,
    uniform_local_size,
)
from ..core import clock
from ..core.config import Config
from ..core.preempt import DRAIN_EXIT_CODE, configured_signal
from .discovery import HostDiscoveryScript, HostManager
from .worker import FENCE_EXIT_CODE, RESET_EXIT_CODE

# A host is blacklisted after this many consecutive crashed (not
# reset-requested) workers (parity: registration.py blacklist policy).
# Blacklisting is a COOLDOWN, not a life sentence: see
# discovery.HostManager (exponential re-admission) — upstream Horovod
# never re-admits a blacklisted host; we probe it again after the
# cooldown and decay strikes on successful incarnations.
BLACKLIST_THRESHOLD = 3

# Driver-side telemetry (obs/metrics.py): the driver process keeps its
# own registry — workers each publish theirs (HVTPU_METRICS_PORT; the
# driver deliberately does not bind a port, it would collide with the
# rank-0 worker on the same host).
_M_WORKERS = obs_metrics.gauge(
    "hvtpu_elastic_workers",
    "Live worker (rank) count of this incarnation's world as seen by "
    "this rank.")
_M_RESTARTS = obs_metrics.counter(
    "hvtpu_elastic_restarts_total",
    "Worker-set relaunches performed by the elastic driver.")
_M_RENDEZVOUS_S = obs_metrics.histogram(
    "hvtpu_elastic_rendezvous_seconds",
    "Driver-side rendezvous: discovery reaching min_np through a "
    "launched worker set, per incarnation.")
_M_BLACKLISTED = obs_metrics.gauge(
    "hvtpu_elastic_blacklisted_hosts",
    "Hosts currently sidelined by the cooldown blacklist.")
_M_BUDGET_LEFT = obs_metrics.gauge(
    "hvtpu_elastic_restart_budget_remaining",
    "Relaunches left before the driver declares the workload "
    "crash-looping and fails fast (-1 = unlimited).")
_M_DRAINS = obs_metrics.counter(
    "hvtpu_elastic_drains_total",
    "Planned departures (DRAIN_EXIT_CODE exits after a graceful drain, "
    "core/preempt.py) the driver resized around WITHOUT charging the "
    "restart budget or a blacklist strike.")

_TERM_CODES = (-signal.SIGTERM, 128 + signal.SIGTERM)
# SIGUSR1 arriving before the worker installed its handler kills the
# process with the default disposition; classify that as a reset
# request, not a crash, so healthy hosts don't collect strikes.
_USR1_CODES = (-signal.SIGUSR1, 128 + signal.SIGUSR1)


class ElasticDriver:
    """One elastic job: discovery loop + worker lifecycle + restarts."""

    def __init__(
        self,
        command: List[str],
        discovery: HostDiscoveryScript,
        min_np: int,
        max_np: Optional[int] = None,
        discovery_interval: float = 1.0,
        elastic_timeout: float = 600.0,
        args: Optional[argparse.Namespace] = None,
        state_dir: Optional[str] = None,
        verbose: bool = False,
        max_restarts: int = -1,
        restart_window: float = 0.0,
        blacklist_cooldown: Optional[float] = None,
        drain_grace: Optional[float] = None,
    ):
        self.command = command
        self.hosts = HostManager(discovery,
                                 cooldown_base_s=blacklist_cooldown)
        self.min_np = min_np
        self.max_np = max_np
        self.interval = discovery_interval
        self.elastic_timeout = elastic_timeout
        self.args = args
        # restart budget: total relaunches allowed (-1 = unlimited);
        # with restart_window > 0 only relaunches inside the trailing
        # window count, so a long job survives occasional preemptions
        # while a tight crash loop still trips the budget.
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self._restart_times: List[float] = []
        # a pure reset is not charged (_run_loop), so the same bound
        # holds relaunches after resets that changed nothing: the world
        # (host spec, size) the last reset ended, and how many resets in
        # a row were relaunched into that same world
        self._reset_world: Optional[tuple] = None
        self._idle_resets = 0
        self._last_crash_summary = ""
        # drain grace: how long workers get to reach the coordinated
        # drain commit after the driver forwards a preemption notice
        # (SIGTERM to the launcher) — always applied BEFORE terminate()'s
        # SIGTERM/SIGKILL escalation, so the kill grace can never
        # undercut the drain grace.
        if drain_grace is None:
            drain_grace = float(
                os.environ.get("HVTPU_DRAIN_GRACE_SECONDS", "30")
                or 30)
        self.drain_grace = drain_grace
        self._drain_requested = False
        self._drain_forwarded = False
        # durable-commit location: explicit arg > caller's env (a user
        # pointing commits at a persistent/shared filesystem) > fresh
        # temp dir owned — and cleaned up on success — by this driver
        env_dir = os.environ.get("HVTPU_ELASTIC_STATE_DIR")
        self.state_dir = state_dir or env_dir or tempfile.mkdtemp(
            prefix="hvtpu_elastic_"
        )
        self._owns_state_dir = state_dir is None and env_dir is None
        self.verbose = verbose
        self._crash_counts: Dict[str, int] = {}
        # blacklist hints survive a driver restart (and therefore a
        # coordinator-loss relaunch cycle) via the elastic state dir —
        # without them a relaunched driver would happily re-elect the
        # host it just struck out as the new coordinator.
        self._hints_path = os.path.join(self.state_dir,
                                        "host_hints.json")
        hinted = self.hosts.load_hints(self._hints_path)
        if hinted and verbose:
            print(f"hvtpu.elastic.driver: restored blacklist hints "
                  f"for {hinted} host(s) from {self._hints_path}",
                  file=sys.stderr, flush=True)
        # coordinator address of the previous incarnation: a change
        # across relaunches IS a coordinator re-election.
        self._last_coordinator_addr: Optional[str] = None
        # world size of the last-launched incarnation; after a clean
        # run() this is the FINAL world (result collection filters
        # stale rank files from larger earlier incarnations with it)
        self.final_world_size: Optional[int] = None
        # incarnation counter: 0 for the first launch, +1 per
        # relaunch; workers use it to run reset callbacks after a
        # world reconfiguration (HVTPU_ELASTIC_GENERATION)
        self._generation = 0
        # the JAX driver's fleet seams (per-job env, per-rank notice
        # files, a lifecycle listener, signal_ranks) come with the fleet
        # runner (ROADMAP Queue A item 11)

    def _log(self, msg: str):
        if self.verbose:
            print(f"hvtpu.elastic.driver: {msg}", file=sys.stderr,
                  flush=True)

    def _refresh_hosts(self) -> bool:
        """Poll discovery, swallowing transient script failures (a slow
        or briefly-failing discovery script must not kill a healthy
        job — the whole point of elasticity)."""
        try:
            return self.hosts.refresh()
        except Exception as e:  # noqa: BLE001 — includes TimeoutExpired
            self._log(f"discovery error (ignored): {e}")
            return False

    def _wait_for_min_hosts(self) -> bool:
        deadline = clock.monotonic() + self.elastic_timeout
        while clock.monotonic() < deadline:
            self._refresh_hosts()
            _M_BLACKLISTED.set(len(self.hosts.blacklisted_now()))
            if self.hosts.available_slots() >= self.min_np:
                return True
            if self.hosts.exhausted(self.min_np):
                # every discovered host is cooling down; wait out the
                # soonest re-admission when it fits the deadline,
                # otherwise fail fast instead of burning the timeout
                readmit = self.hosts.next_readmission_s()
                remaining = deadline - clock.monotonic()
                if readmit is None:
                    pass  # raced with an expiry: re-poll immediately
                elif readmit >= remaining:
                    self._log(
                        "all discovered hosts blacklisted and the "
                        f"soonest re-admission is {readmit:.0f}s away "
                        f"(> {remaining:.0f}s left); giving up")
                    return False
                else:
                    self._log(
                        "all discovered hosts blacklisted; probing "
                        f"again in {readmit:.0f}s")
                    clock.sleep(min(readmit + 0.05, remaining))
                continue
            clock.sleep(self.interval)
        return False

    def _elect_coordinator(self, slots: List[hosts_mod.SlotInfo]) -> str:
        """One coordinator address for the whole world (rank 0's host),
        exactly like the static launch path.  host_spec() already
        excludes cooling (blacklisted) hosts, so when the previous
        coordinator's host struck out, slots[0] — and therefore this
        address — lands on a SURVIVING host: that is the re-election."""
        coordinator_addr = _default_coordinator_addr(slots)
        if (self._last_coordinator_addr is not None
                and coordinator_addr != self._last_coordinator_addr):
            self._log(
                f"coordinator re-elected: {self._last_coordinator_addr}"
                f" -> {coordinator_addr} (generation "
                f"{self._generation - 1})")
            flight.note("coordinator_reelected",
                        old=self._last_coordinator_addr,
                        new=coordinator_addr,
                        generation=self._generation - 1)
        self._last_coordinator_addr = coordinator_addr
        return coordinator_addr

    def _spawn(self, slots: List[hosts_mod.SlotInfo], port: int
               ) -> List[safe_shell_exec.WorkerProcess]:
        base_env = dict(os.environ)
        base_env["HVTPU_ELASTIC"] = "1"
        base_env["HVTPU_ELASTIC_STATE_DIR"] = self.state_dir
        base_env["HVTPU_ELASTIC_GENERATION"] = str(self._generation)
        self._generation += 1
        coordinator_addr = self._elect_coordinator(slots)
        workers = []
        import threading

        lock = threading.Lock()
        uniform = uniform_local_size(slots)
        for slot in slots:
            env = build_worker_env(
                base_env, slot, coordinator_addr, port, self.args,
                uniform_local=uniform,
            )
            if hosts_mod.is_local_host(slot.hostname):
                cmd = list(self.command)
            else:
                cmd = build_ssh_command(
                    slot.hostname, self.command, env, cwd=os.getcwd(),
                    **ssh_options_from_args(self.args),
                )
            workers.append(
                safe_shell_exec.WorkerProcess(
                    slot.rank, cmd, env, stdout_lock=lock
                )
            )
        return workers

    def _notify_hosts_updated(self, workers):
        self._log("hosts updated; signalling workers (SIGUSR1)")
        for w in workers:
            if w.poll() is None:
                try:
                    os.kill(w.proc.pid, signal.SIGUSR1)
                except ProcessLookupError:
                    pass

    def run(self) -> int:
        """Main loop (parity: ElasticDriver.start + _run_elastic)."""
        # Driver-level preemption: a SIGTERM to the launcher itself means
        # the WHOLE job is being reclaimed — flag it and let
        # _supervise forward a drain to the workers first (handler is
        # flag-only: no locks, no I/O).
        prev_term = None

        def _term_handler(signum, frame):
            self._drain_requested = True

        try:
            prev_term = signal.signal(signal.SIGTERM, _term_handler)
        except ValueError:
            pass  # non-main thread (tests): no driver-side drain
        try:
            return self._run_loop()
        finally:
            if prev_term is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_term)
                except ValueError:
                    pass

    def _run_loop(self) -> int:
        _M_BUDGET_LEFT.set(self.max_restarts
                           if self.max_restarts >= 0 else -1)
        while True:
            t_rdv = clock.monotonic()
            if not self._wait_for_min_hosts():
                print(
                    f"hvtpu.elastic: fewer than min_np={self.min_np} "
                    f"slots available for {self.elastic_timeout}s; "
                    "giving up",
                    file=sys.stderr,
                )
                return 1
            np_now = self.hosts.available_slots()
            if self.max_np is not None:
                np_now = min(np_now, self.max_np)
            spec = self.hosts.host_spec()
            slots = hosts_mod.get_host_assignments(
                hosts_mod.parse_host_spec(spec), np_now
            )
            if not self._reset_bound_ok(spec, np_now):
                return 1
            port = find_free_port()
            self._log(
                f"launching {np_now} workers on {spec} (port {port})"
            )
            self.final_world_size = np_now
            workers = self._spawn(slots, port)
            _M_RENDEZVOUS_S.observe(clock.monotonic() - t_rdv)
            _M_WORKERS.set(np_now)
            outcome = self._supervise(workers, slots)
            # what ended the incarnation, for --verbose readers: the
            # workers' exits and the wall time the driver saw them
            self._log(
                f"generation {self._generation - 1} ended: {outcome}, "
                f"exits {[w.poll() for w in workers]}, at wall "
                f"{clock.wall():.3f}")
            _M_WORKERS.set(0)
            if outcome == "done":
                if self._owns_state_dir:
                    import shutil

                    shutil.rmtree(self.state_dir, ignore_errors=True)
                return 0
            if outcome == "failed":
                return 1
            if outcome == "term":
                # whole-job preemption (driver got SIGTERM): workers
                # drained; propagate the conventional signal code
                return 128 + int(signal.SIGTERM)
            if outcome == "drain":
                # planned departure: resize immediately with NO
                # restart-budget charge — that budget exists to catch
                # crash loops, and a graceful drain is the opposite of
                # a crash.
                _M_DRAINS.inc()
                continue
            if outcome == "reset":
                # a reset request (exit 73) with no crash and no fence
                # beside it: relaunch without a charge, as the
                # exit-code table of docs/robustness.md says ("only if
                # accompanied by a crash"); the JAX package's driver
                # charges it (ROADMAP Queue C)
                self._log("reset without a crash: relaunch not charged")
                self._reset_world = (spec, np_now)
                continue
            # outcome == "restart": loop around, re-discover, relaunch
            # — unless the restart budget says this workload is
            # crash-looping and relaunching forever helps nobody.
            _M_RESTARTS.inc()
            if flight.ACTIVE:
                flight.note("elastic_restart",
                            generation=self._generation - 1,
                            size=np_now)
            ok = self._restart_budget_ok()
            self._log(f"relaunch charged to the restart budget "
                      f"({len(self._restart_times)} charged)")
            if not ok:
                # The job is dead for good: flush a driver-side black
                # box (ring may be empty — the snapshots matter here;
                # per-rank rings live in the workers' own postmortems).
                flight.dump_postmortem(
                    "restart_budget_exhausted",
                    generation=self._generation - 1,
                    crashes=self._last_crash_summary or "")
                return 1

    def _reset_bound_ok(self, spec: str, np_now: int) -> bool:
        """Before a launch: count a relaunch after a pure reset into the
        same world the reset ended (no membership change explains it);
        False (with a diagnostic) when more than ``--max-restarts`` such
        relaunches come in a row."""
        if self._reset_world == (spec, np_now):
            self._idle_resets += 1
        else:
            self._idle_resets = 0
        self._reset_world = None
        if not 0 <= self.max_restarts < self._idle_resets:
            return True
        print(
            f"hvtpu.elastic: {self._idle_resets} resets in a row (exit "
            f"{RESET_EXIT_CODE}) would relaunch the same world ({np_now} "
            f"on {spec}) > --max-restarts={self.max_restarts}; no "
            "membership change explains them. Fix what makes the "
            "workers ask for a reset (or raise --max-restarts / "
            "HVTPU_MAX_RESTARTS) and relaunch.",
            file=sys.stderr, flush=True)
        return False

    def _restart_budget_ok(self) -> bool:
        """Charge one relaunch against the budget; False (with a
        diagnostic) when it is exhausted."""
        now = clock.monotonic()
        self._restart_times.append(now)
        if self.restart_window > 0:
            self._restart_times = [
                t for t in self._restart_times
                if now - t <= self.restart_window]
        used = len(self._restart_times)
        if self.max_restarts < 0:
            _M_BUDGET_LEFT.set(-1)
            return True
        remaining = self.max_restarts - used
        _M_BUDGET_LEFT.set(max(remaining, 0))
        if remaining >= 0:
            return True
        window = (f" within {self.restart_window:.0f}s"
                  if self.restart_window > 0 else "")
        crashes = self._last_crash_summary or "no crash details recorded"
        print(
            f"hvtpu.elastic: restart budget exhausted — {used} "
            f"relaunches{window} > --max-restarts={self.max_restarts}; "
            "the workload is crash-looping, not recovering. "
            f"Last incarnation: {crashes}. Fix the failing rank (or "
            "raise --max-restarts / HVTPU_MAX_RESTARTS) and relaunch.",
            file=sys.stderr, flush=True,
        )
        return False

    def _forward_drain(self, workers):
        """Forward the preemption notice to every live worker (pid,
        not pgid: the worker's own handler starts the drain; its
        children follow at terminate())."""
        sig = configured_signal()
        self._log(
            f"driver preempted (SIGTERM); forwarding {sig.name} drain "
            f"to workers with {self.drain_grace:.0f}s grace before "
            "terminate escalation")
        for w in workers:
            if w.poll() is None:
                try:
                    os.kill(w.proc.pid, sig)
                except ProcessLookupError:
                    pass

    def _supervise(self, workers, slots) -> str:
        """Watch one incarnation.
        Returns 'done' | 'restart' | 'reset' | 'drain' | 'term' |
        'failed'."""
        notified = False
        drain_deadline = None
        while True:
            clock.sleep(self.interval)
            # 0. driver-level preemption: forward the drain FIRST and
            # give workers the full drain grace to reach the commit;
            # only then escalate through terminate()'s SIGTERM/SIGKILL
            # — the kill grace can never undercut the drain grace.
            if self._drain_requested and not self._drain_forwarded:
                self._drain_forwarded = True
                drain_deadline = clock.monotonic() + self.drain_grace
                self._forward_drain(workers)
            # 1. check worker exits
            running, done_ok, reset_req, crashed, drained = \
                [], [], [], [], []
            fenced = []
            for w in workers:
                code = w.poll()
                if code is None:
                    running.append(w)
                elif code == 0:
                    done_ok.append(w)
                elif code == DRAIN_EXIT_CODE:
                    # graceful drain after a preemption notice: a
                    # PLANNED departure, never a crash
                    drained.append(w)
                elif code == FENCE_EXIT_CODE:
                    # self-fenced (generation superseded / KV lease
                    # expired): the rank PROTECTED the job by dying —
                    # rebuild the world, but never charge its host a
                    # blacklist strike (core/retry.py FencedKV)
                    fenced.append(w)
                elif code == RESET_EXIT_CODE or code in _USR1_CODES:
                    reset_req.append(w)
                elif code in _TERM_CODES and (notified
                                              or self._drain_forwarded):
                    reset_req.append(w)
                else:
                    crashed.append((w, code))
            if fenced:
                for w in fenced:
                    self._log(f"rank {w.rank} self-fenced "
                              f"(exit {FENCE_EXIT_CODE}); relaunching "
                              "without a blacklist strike")
                flight.note("worker_fenced",
                            ranks=sorted(w.rank for w in fenced),
                            generation=self._generation - 1)
                reset_req.extend(fenced)
            _M_WORKERS.set(len(running))
            if self._drain_forwarded:
                # whole-job preemption: wait out the drain, then stop
                if not running:
                    return "term"
                if clock.monotonic() >= drain_deadline:
                    for w in workers:
                        w.terminate()
                    for w in workers:
                        try:
                            w.wait(timeout=10)
                        except Exception:
                            pass
                    return "term"
                continue
            if not running:
                if crashed or reset_req or drained:
                    return self._finish_incarnation(workers, slots, crashed)
                return "done"
            if crashed or reset_req or drained:
                # A peer is gone: remaining workers would stall in
                # collectives. Tell them to reset at the commit
                # boundary, then escalate to SIGTERM.
                return self._finish_incarnation(workers, slots, crashed)
            # 2. poll discovery for membership changes.  Compare the
            # EFFECTIVE world (capped at max_np) to the running one —
            # comparing raw discovered slots would restart-thrash
            # forever when discovery grows past --max-np.
            if self._refresh_hosts() and not notified:
                cur = self.hosts.available_slots()
                if self.max_np is not None:
                    cur = min(cur, self.max_np)
                if cur != len(slots) and cur >= 1:
                    self._notify_hosts_updated(workers)
                    notified = True

    def _finish_incarnation(self, workers, slots, crashed) -> str:
        by_rank_host = {s.rank: s.hostname for s in slots}
        self._last_crash_summary = "; ".join(
            f"rank {w.rank} on {by_rank_host.get(w.rank, '?')} exited "
            f"{code}" for w, code in crashed) or "no crashes (reset)"
        crashed_hosts = {by_rank_host.get(w.rank, "?")
                         for w, _code in crashed}
        for w, code in crashed:
            host = by_rank_host.get(w.rank, "?")
            self._crash_counts[host] = self._crash_counts.get(host, 0) + 1
            self._log(
                f"rank {w.rank} on {host} crashed with {code} "
                f"({self._crash_counts[host]} strikes)"
            )
            if self._crash_counts[host] >= BLACKLIST_THRESHOLD:
                cooldown = self.hosts.blacklist_host(host)
                self._log(
                    f"blacklisting {host} for {cooldown:.0f}s "
                    f"(strike {self.hosts.strikes(host)})")
                # a fresh threshold applies after re-admission; the
                # cooldown's own strike count carries the history
                self._crash_counts[host] = 0
        # decay: hosts whose workers all exited cleanly this
        # incarnation earn back a crash count and a blacklist strike —
        # a recovered host must not stay one crash from the blacklist
        # forever.
        for host in {s.hostname for s in slots} - crashed_hosts:
            if self._crash_counts.get(host, 0) > 0:
                self._crash_counts[host] -= 1
            self.hosts.record_success(host)
        _M_BLACKLISTED.set(len(self.hosts.blacklisted_now()))
        self.hosts.save_hints(self._hints_path)
        # grace period for the rest to exit at a commit boundary
        self._notify_hosts_updated(workers)
        deadline = clock.monotonic() + 30.0
        while clock.monotonic() < deadline:
            if all(w.poll() is not None for w in workers):
                break
            clock.sleep(0.2)
        for w in workers:
            w.terminate()
        for w in workers:
            try:
                w.wait(timeout=10)
            except Exception:
                pass
        # Classify AFTER the grace wait: the drain exit (the departing
        # rank's DRAIN_EXIT_CODE) often lands a poll tick after its
        # peers' reset exits, and a poll-time snapshot would misfile
        # the planned departure as a budget-charged restart.
        fenced = [w for w in workers if w.poll() == FENCE_EXIT_CODE]
        if fenced:
            print(
                f"hvtpu.elastic: rank(s) "
                f"{sorted(w.rank for w in fenced)} self-fenced (exit "
                f"{FENCE_EXIT_CODE}); relaunching without a blacklist "
                "strike", file=sys.stderr, flush=True)
        drained = [w for w in workers if w.poll() == DRAIN_EXIT_CODE]
        if drained and not crashed:
            ranks = sorted(w.rank for w in drained)
            print(
                f"hvtpu.elastic: planned departure: rank(s) {ranks} "
                f"drained (exit {DRAIN_EXIT_CODE}); resizing without "
                "a restart-budget or blacklist strike",
                file=sys.stderr, flush=True)
            return "drain"
        # every worker exited at a commit boundary (or cleanly): a reset
        # the budget does not pay for; a fence, a crash, or a worker the
        # escalation had to kill is charged
        clean = (0, RESET_EXIT_CODE, DRAIN_EXIT_CODE) + _USR1_CODES
        if not crashed and all(w.poll() in clean for w in workers):
            return "reset"
        return "restart"


def run_elastic_driver(args: argparse.Namespace
                       ) -> "tuple[int, ElasticDriver]":
    """Build + run the elastic driver, returning (exit_code, driver) —
    callers needing post-run facts (final world size for result
    collection) use this; the CLI wrapper below keeps the int
    contract."""
    discovery = HostDiscoveryScript(args.host_discovery_script)
    max_restarts = getattr(args, "max_restarts", None)
    if max_restarts is None:
        max_restarts = int(os.environ.get("HVTPU_MAX_RESTARTS", "-1"))
    restart_window = getattr(args, "restart_window", None)
    if restart_window is None:
        restart_window = float(
            os.environ.get("HVTPU_RESTART_WINDOW_SECONDS", "0"))
    blacklist_cooldown = getattr(args, "blacklist_cooldown", None)
    drain_grace = getattr(args, "drain_grace", None)
    driver = ElasticDriver(
        command=args.command,
        discovery=discovery,
        min_np=args.min_np or args.np or 1,
        max_np=args.max_np,
        discovery_interval=(
            float(os.environ.get("HVTPU_ELASTIC_DISCOVERY_INTERVAL", 0)
                  or 1.0)
        ),
        elastic_timeout=(args.elastic_timeout
                         or Config.from_env().elastic_timeout),
        args=args,
        verbose=args.verbose,
        max_restarts=max_restarts,
        restart_window=restart_window,
        blacklist_cooldown=blacklist_cooldown,
        drain_grace=drain_grace,
    )
    return driver.run(), driver


def run_elastic(args: argparse.Namespace) -> int:
    """Entry from ``python -m horovod_tpu_torch.runner
    --host-discovery-script ...`` (parity:
    launch.py _run_elastic)."""
    return run_elastic_driver(args)[0]

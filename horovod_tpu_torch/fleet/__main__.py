"""``python -m horovod_tpu_torch.fleet``: the operator CLI of the port's
fleet arbiter (the counterpart of the reference's ``hvtpufleet``: the
same subcommands, flags, exit codes and messages).

Five subcommands against one fleet directory (``--fleet-dir`` /
``HVTPU_FLEET_DIR``):

- ``serve``   run a :class:`~.arbiter.FleetArbiter` over a discovery
  script (the port's ``HostDiscoveryScript``), ticking until interrupted
  (or ``--until-idle``; exit 1 when a job FAILED).
- ``submit``  validate a job-spec JSON client-side (a malformed spec
  exits 2 naming the first bad field; nothing reaches the arbiter) and
  append it to the submit journal (exit 75 when the queue is full).
- ``list``    print the arbiter's last published ``state.json``.
- ``top``     per-job health from ``state.json``: step rate, incidents,
  restarts, stall age.
- ``cancel``  append a cancel record for a named job.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _fleet_dir(args) -> str:
    d = args.fleet_dir or os.environ.get("HVTPU_FLEET_DIR")
    if not d:
        print("hvtpufleet: --fleet-dir (or HVTPU_FLEET_DIR) is required",
              file=sys.stderr)
        raise SystemExit(2)
    return d


def _cmd_serve(args) -> int:
    from ..elastic.discovery import HostDiscoveryScript
    from .arbiter import FleetArbiter

    d = _fleet_dir(args)
    os.makedirs(os.path.join(d, "submit"), exist_ok=True)
    os.makedirs(os.path.join(d, "cancel"), exist_ok=True)
    arbiter = FleetArbiter(
        HostDiscoveryScript(args.host_discovery_script),
        fleet_dir=d,
        tick_s=args.tick,
        drain_grace_s=args.drain_grace,
        verbose=not args.quiet,
    )
    try:
        recovered = arbiter.recover()
        if recovered and not args.quiet:
            print(f"hvtpufleet: recovered {recovered} job(s) from "
                  "state.json", file=sys.stderr)
        arbiter.run(until_idle=args.until_idle)
    except KeyboardInterrupt:
        pass
    finally:
        arbiter.close()
    if args.until_idle:
        state = arbiter.debug_state()
        failed = [j["name"] for j in state["jobs"]
                  if j["state"] == "FAILED"]
        if failed:
            print(f"hvtpufleet: jobs failed: {', '.join(failed)}",
                  file=sys.stderr)
            return 1
    return 0


def _cmd_submit(args) -> int:
    from .intake import QueueFullError, SubmitJournal
    from .job import FleetSpecError, JobSpec

    # client-side validation: a malformed spec never reaches the
    # journal
    try:
        spec = JobSpec.load(args.spec)
    except FleetSpecError as e:
        print(f"hvtpufleet: --spec: {e}", file=sys.stderr)
        return 2
    d = _fleet_dir(args)
    journal = SubmitJournal(d)
    try:
        seq = journal.append_submit(spec.to_dict())
    except QueueFullError as e:
        # truthful backpressure: the arbiter's published drain rate
        # says when the backlog will be below the limit again
        print(f"hvtpufleet: {e}", file=sys.stderr)
        return 75  # EX_TEMPFAIL: retry later, nothing was queued
    print(f"hvtpufleet: submitted {spec.name!r} as journal #{seq} "
          f"(priority={spec.priority}, min_np={spec.min_np})")
    return 0


def _cmd_list(args) -> int:
    d = _fleet_dir(args)
    path = os.path.join(d, "state.json")
    try:
        with open(path) as f:
            state = json.load(f)
    except OSError:
        print(f"hvtpufleet: no state at {path} — is an arbiter "
              f"serving this fleet dir?", file=sys.stderr)
        return 1
    if args.json:
        json.dump(state, sys.stdout, sort_keys=True, indent=1)
        print()
        return 0
    pool = state.get("pool", {})
    print(f"pool: {pool.get('slots_total', 0)} slots "
          f"({pool.get('slots_free', 0)} free) across "
          f"{len(pool.get('hosts', {}))} hosts")
    rows = [("JOB", "STATE", "PRI", "NP", "WAIT_S", "REASON")]
    for j in state.get("jobs", []):
        rows.append((
            j.get("name", "?"), j.get("state", "?"),
            str(j.get("priority", 0)),
            str(sum((j.get("allocation") or {}).values())),
            f"{j.get('queue_wait_s') or 0:.1f}",
            (j.get("reason") or "")[:40],
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return 0


def _fmt_health(j):
    """One `top` row's health columns from a job's attached summary
    (written by the arbiter's health poll into state.json)."""
    h = j.get("health")
    if not isinstance(h, dict):
        return "-", "-", "-", "-"
    rate = h.get("step_rate")
    incid = h.get("incidents_total", 0)
    restarts = h.get("restarts", 0)
    stall = h.get("stall_age_s") or 0.0
    stale = " *" if h.get("stale") else ""
    return (f"{rate:.2f}{stale}" if isinstance(rate, (int, float))
            else "-",
            str(incid), str(restarts),
            f"{stall:.0f}" if stall else "-")


def _cmd_top(args) -> int:
    d = _fleet_dir(args)
    path = os.path.join(d, "state.json")
    try:
        with open(path) as f:
            state = json.load(f)
    except OSError:
        print(f"hvtpufleet: no state at {path} — is an arbiter "
              f"serving this fleet dir?", file=sys.stderr)
        return 1
    pool = state.get("pool", {})
    print(f"pool: {pool.get('slots_total', 0)} slots "
          f"({pool.get('slots_free', 0)} free); "
          f"as of t={state.get('t_wall', 0)}")
    rows = [("JOB", "STATE", "NP", "STEP/S", "INCID", "RESTARTS",
             "STALL_S")]
    for j in state.get("jobs", []):
        rate, incid, restarts, stall = _fmt_health(j)
        rows.append((
            j.get("name", "?"), j.get("state", "?"),
            str(sum((j.get("allocation") or {}).values())),
            rate, incid, restarts, stall,
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    print("(* = stale health summary; job stopped publishing)")
    return 0


def _cmd_cancel(args) -> int:
    from .intake import SubmitJournal

    d = _fleet_dir(args)
    # journal, not a marker file: the cancel record is ordered AFTER
    # the job's submit record, so a spooled-but-not-yet-intaken job is
    # tombstoned before it can ever go PENDING
    seq = SubmitJournal(d).append_cancel(args.name)
    print(f"hvtpufleet: cancel requested for {args.name!r} "
          f"(journal #{seq})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.fleet",
        description="Operate a multi-job fleet arbiter of the PyTorch "
        "port.")
    ap.add_argument("--fleet-dir", default=None,
                    help="Fleet spool/state directory "
                    "(default: $HVTPU_FLEET_DIR).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="Run the arbiter loop.")
    s.add_argument("--host-discovery-script", required=True,
                   help="Script printing 'host:slots' lines for the "
                   "shared pool.")
    s.add_argument("--tick", type=float, default=None,
                   help="Arbiter tick period in seconds "
                   "(default: $HVTPU_FLEET_TICK_SECONDS or 1).")
    s.add_argument("--drain-grace", type=float, default=None,
                   help="Seconds a preemption victim gets to drain "
                   "before SIGTERM escalation (default: "
                   "$HVTPU_FLEET_DRAIN_GRACE_SECONDS or 30).")
    s.add_argument("--until-idle", action="store_true",
                   help="Exit once every submitted job is terminal "
                   "(nonzero if any FAILED).")
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=_cmd_serve)

    s = sub.add_parser("submit", help="Validate and spool a job spec.")
    s.add_argument("--spec", required=True,
                   help="Path to the job-spec JSON.")
    s.set_defaults(fn=_cmd_submit)

    s = sub.add_parser("list", help="Show pool and job states.")
    s.add_argument("--json", action="store_true",
                   help="Raw state.json instead of the table.")
    s.set_defaults(fn=_cmd_list)

    s = sub.add_parser(
        "top", help="Per-job health: step rate, incidents, restarts, "
        "stall age.")
    s.set_defaults(fn=_cmd_top)

    s = sub.add_parser("cancel", help="Request cancellation of a job.")
    s.add_argument("name", help="Job name to cancel.")
    s.set_defaults(fn=_cmd_cancel)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""CLI for the port's fabric simulator: ``python -m horovod_tpu_torch.sim``.

The counterpart of ``python -m tools.hvtpusim``, with the same
subcommands and reports:

- ``list``: the scenario catalog;
- ``run <scenario> --ranks N --seed S [--out LOG] [--set K=V]
  [--device cuda|cpu]``: one scenario; prints its per-phase
  virtual-time stats, the number of events and the event log's sha256
  (``event_log_sha256``), and writes the log (JSONL) with ``--out``;
- ``bench``, ``bench-fleet``, ``bench-ckpt``, ``bench-anomaly``,
  ``bench-service``, ``bench-lossy``: measured virtual-time rows vs
  world size (``--ranks 64,256``), printed as JSON under the
  reference's keys (``control_plane_sim``, ``fleet_arbiter_sim``, ...);
  ``--update FILE`` writes them into that JSON file.

The controller scenarios (and ``bench``'s negotiation rows) put their
payloads and controllers on ``--device`` (default ``cuda``); without a
card they raise unless ``--device cpu`` is given.  The process re-execs
itself once under ``PYTHONHASHSEED=0``, so no hash-order iteration can
change a log.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import sys


def _ensure_deterministic_interpreter() -> None:
    """Re-exec once with PYTHONHASHSEED=0 so any hash-order-dependent
    iteration inside the interpreter is identical across runs."""
    if os.environ.get("PYTHONHASHSEED") == "0":
        return
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = "0"
    os.execve(sys.executable,
              [sys.executable, "-m", "horovod_tpu_torch.sim"]
              + sys.argv[1:], env)


def _parse_kv(pairs):
    """--set key=value scenario kwargs (ints/floats/bools parsed)."""
    out = {}
    for p in pairs or ():
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        k = k.strip().replace("-", "_")
        v = v.strip()
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def _dump(result, out_path):
    lines = "".join(
        json.dumps(rec, sort_keys=True) + "\n" for rec in result["events"])
    digest = hashlib.sha256(lines.encode()).hexdigest()
    if out_path:
        with open(out_path, "w") as f:
            f.write(lines)
    return digest, len(result["events"])


def _cmd_list(_args) -> int:
    from .scenarios import SCENARIOS

    width = max(len(n) for n in SCENARIOS)
    for name, fn in sorted(SCENARIOS.items()):
        doc = (fn.__doc__ or "").strip().split("\n")[0]
        print(f"{name:<{width}}  {doc}")
    return 0


def _cmd_run(args) -> int:
    from .scenarios import run_scenario

    kwargs = _parse_kv(args.set)
    result = run_scenario(args.scenario, args.ranks, args.seed,
                          device=args.device, **kwargs)
    digest, n_events = _dump(result, args.out)
    report = {
        "scenario": result["scenario"],
        "ranks": result["ranks"],
        "seed": result["seed"],
        "stats": result["stats"],
        "events": n_events,
        "event_log_sha256": digest,
    }
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0


#: World sizes for the measured control-plane rows.
_BENCH_RANKS = (64, 256, 1024)
#: World sizes for the fleet-service front-door rows.
_SERVICE_BENCH_RANKS = (256, 4096, 16384)


def _method(seed: int) -> str:
    return "fabric-sim virtual time, seed %d" % seed


def _quiet(fn, *args):
    """Run ``fn`` with the package logger at ERROR: every simulated rank
    shares this process's logger, so per-peer warnings would be
    O(ranks x victims) lines for a bench that reports a few numbers."""
    log = logging.getLogger("horovod_tpu_torch")
    prior = log.level
    log.setLevel(logging.ERROR)
    try:
        return fn(*args)
    finally:
        log.setLevel(prior)


def bench_rows(ranks_list, seed: int = 0, device=None):
    """Negotiation cycle (lockstep exchange), rendezvous (audit digest
    allgather) and drain commit (notice -> agreed durable commit) vs
    world size, in virtual time on the default link model (50 us
    latency, 1 GbE, 10% jitter)."""
    from .scenarios import (bench_negotiation, steady_drain,
                            thundering_rendezvous)

    rows = []
    for ranks in ranks_list:
        neg = bench_negotiation(ranks, seed, device=device)[
            "stats"]["phases"]["negotiate"]
        rdv = thundering_rendezvous(ranks, seed)["stats"]["phases"][
            "rendezvous"]
        drn = steady_drain(ranks, seed)["stats"]["phases"]["drain"]
        rows.append({
            "ranks": ranks,
            "negotiation_cycle_p50_s": neg["cycle_p50_s"],
            "negotiation_cycle_max_s": neg["cycle_max_s"],
            "rendezvous_s": round(rdv["virtual_s"], 6),
            "rendezvous_p50_s": round(rdv["p50_s"], 6),
            "drain_notice_to_commit_s": drn["notice_to_commit_s"],
            "measured": True,
            "method": _method(seed),
        })
        print(f"ranks={ranks}: negotiation p50 "
              f"{neg['cycle_p50_s'] * 1000:.2f} ms, rendezvous "
              f"{rdv['virtual_s']:.3f} s, drain notice→commit "
              f"{drn['notice_to_commit_s']:.3f} s", file=sys.stderr)
    return rows


def _fleet_bench_rows(ranks_list, seed):
    from .scenarios import multi_job_arbiter

    rows = []
    for ranks in ranks_list:
        pre = multi_job_arbiter(ranks, seed)["stats"]["phases"]["preempt"]
        rows.append({
            "ranks": ranks,
            "queue_wait_s": round(pre["queue_wait_s"], 6),
            "preempt_notice_to_commit_s": round(
                pre["notice_to_commit_s"], 6),
            "resize_s": round(pre["resize_s"], 6),
            "victims": pre["victims"],
            "measured": True,
            "method": _method(seed),
        })
        print(f"ranks={ranks}: queue wait {pre['queue_wait_s']:.3f} s, "
              f"preempt notice→commit {pre['notice_to_commit_s']:.3f} s, "
              f"resize {pre['resize_s']:.3f} s "
              f"({pre['victims']} victims)", file=sys.stderr)
    return rows


def fleet_bench_rows(ranks_list, seed: int = 0):
    """Multi-job arbiter rows vs pool size: queue wait of a
    gang-scheduled high-priority arrival, preemption notice -> agreed
    durable commit on the victim, and the victim's resize latency."""
    return _quiet(_fleet_bench_rows, ranks_list, seed)


def _ckpt_bench_rows(ranks_list, seed):
    from .scenarios import checkpoint_storm

    rows = []
    for ranks in ranks_list:
        ph = checkpoint_storm(ranks, seed)["stats"]["phases"]
        cm, rq = ph["commit"], ph["restore_quorum"]
        rows.append({
            "ranks": ranks,
            "commit_p50_s": cm["commit_p50_s"],
            "commit_p99_s": cm["commit_p99_s"],
            "quorum_p50_s": rq["quorum_p50_s"],
            "quorum_max_s": rq["quorum_max_s"],
            "agreed_seq": rq["agreed_seq"],
            "measured": True,
            "method": _method(seed),
        })
        print(f"ranks={ranks}: commit p50 "
              f"{cm['commit_p50_s'] * 1000:.2f} ms, restore quorum p50 "
              f"{rq['quorum_p50_s'] * 1000:.2f} ms / max "
              f"{rq['quorum_max_s'] * 1000:.2f} ms", file=sys.stderr)
    return rows


def ckpt_bench_rows(ranks_list, seed: int = 0):
    """Durable-state rows vs world size: snapshot commit latency and the
    restore-quorum agreement time under injected torn/bitflip damage."""
    return _quiet(_ckpt_bench_rows, ranks_list, seed)


def anomaly_bench_rows(ranks_list, seed: int = 0, seeds: int = 5):
    """Straggler-detection latency vs world size: virtual seconds from
    one rank's mid-run link degradation to the first straggler incident
    naming it; p50/max over ``seeds`` seeds a world size."""
    from .scenarios import anomaly_detection

    rows = []
    for ranks in ranks_list:
        lats = []
        for s in range(seed, seed + seeds):
            ph = anomaly_detection(ranks, s)["stats"]["phases"]["detect"]
            lats.append(ph["detection_latency_s"])
        lats.sort()
        rows.append({
            "ranks": ranks,
            "detection_latency_p50_s": round(lats[len(lats) // 2], 6),
            "detection_latency_max_s": round(lats[-1], 6),
            "seeds": seeds,
            "measured": True,
            "method": "fabric-sim virtual time, seeds %d..%d" % (
                seed, seed + seeds - 1),
        })
        print(f"ranks={ranks}: detection latency p50 "
              f"{lats[len(lats) // 2]:.3f} s, max {lats[-1]:.3f} s "
              f"({seeds} seeds)", file=sys.stderr)
    return rows


def service_bench_rows(ranks_list, seed: int = 0):
    """Fleet front-door rows vs pool size from the fleet-service storm:
    queue-wait percentiles by tier, submit -> intake latency,
    fragmentation, preemptions and the starvation guard's bound."""
    from .scenarios import fleet_service

    rows = []
    for ranks in ranks_list:
        ph = fleet_service(ranks, seed)["stats"]["phases"]
        svc = ph["service"]
        rows.append({
            "ranks": ranks,
            "jobs": ph["pool"]["jobs"],
            "queue_wait_p50_s": svc["queue_wait_p50_s"],
            "queue_wait_p99_s": svc["queue_wait_p99_s"],
            "intake_p50_s": ph["intake"]["intake_p50_s"],
            "intake_p99_s": ph["intake"]["intake_p99_s"],
            "max_batch": ph["intake"]["max_batch"],
            "queue_full_rejections": ph["intake"][
                "queue_full_rejections"],
            "quota_rejections": ph["admission"]["rejected"],
            "replayed_duplicates": ph["crash"]["replayed_duplicates"],
            "frag_mean": ph["placement"]["frag_mean"],
            "preemptions": svc["preemptions"],
            "aged_jobs": svc["aged_jobs"],
            "starvation_gap_max_s": svc["aged_gap_max_s"],
            "measured": True,
            "method": _method(seed),
        })
        print(f"ranks={ranks}: {ph['pool']['jobs']} jobs, "
              f"tier-0 wait p99 "
              f"{svc['queue_wait_p99_s']['0']:.1f} s, intake p99 "
              f"{ph['intake']['intake_p99_s']:.3f} s, frag "
              f"{ph['placement']['frag_mean']:.3f}, "
              f"{svc['preemptions']} preemptions", file=sys.stderr)
    return rows


def _lossy_bench_rows(ranks_list, seed):
    from .scenarios import lossy_link

    rows = []
    for ranks in ranks_list:
        ll = lossy_link(ranks, seed)["stats"]["phases"]["lossy_link"]
        base = lossy_link(ranks, seed, baseline=True)[
            "stats"]["phases"]["lossy_link"]
        rows.append({
            "ranks": ranks,
            "steps": ll["steps"],
            "retry_rounds": ll["retry_rounds"],
            "recovered_collectives": ll["recovered_collectives"],
            "consensus_p50_s": ll["consensus_p50_s"],
            "consensus_max_s": ll["consensus_max_s"],
            "reroutes": ll["reroutes"],
            "torn": ll["torn"],
            "steps_lost_with_retries": ll["steps_lost"],
            "baseline_restarts": base["restarts"],
            "baseline_steps_lost": base["steps_lost"],
            "measured": True,
            "method": _method(seed),
        })
        print(f"ranks={ranks}: {ll['recovered_collectives']} collectives "
              f"recovered over {ll['retry_rounds']} consensus rounds "
              f"(p50 {ll['consensus_p50_s'] * 1000:.1f} ms), "
              f"{ll['reroutes']} reroutes, {ll['torn']} torn; baseline "
              f"loses {base['steps_lost']}/{ll['steps']} steps to the "
              f"restart", file=sys.stderr)
    return rows


def lossy_bench_rows(ranks_list, seed: int = 7):
    """Wire-plane recovery rows vs world size: lossy-link with consensus
    abort-and-retry against the same seed with retries disabled."""
    return _quiet(_lossy_bench_rows, ranks_list, seed)


#: subcommand -> (JSON key, --update note, default ranks, default seed)
_BENCHES = {
    "bench": (
        "control_plane_sim",
        "MEASURED on the port's fabric simulator (horovod_tpu_torch/sim): "
        "the async controller's negotiation, the audit exchange and the "
        "drain protocol over the virtual-time KV with the default link "
        "model (50us, 1GbE, 10% jitter); virtual seconds.",
        _BENCH_RANKS, 0),
    "bench-fleet": (
        "fleet_arbiter_sim",
        "MEASURED on the port's fabric simulator: the FleetArbiter "
        "(horovod_tpu_torch/fleet) arbitrating two jobs over one virtual "
        "pool; queue_wait_s is submit -> gang placement for the arrival, "
        "preempt_notice_to_commit_s drain notice -> agreed durable "
        "commit, resize_s notice -> relaunch at the smaller world.",
        _BENCH_RANKS, 0),
    "bench-ckpt": (
        "checkpoint_storm_sim",
        "MEASURED on the port's fabric simulator: the durable commit "
        "protocol (horovod_tpu_torch/core/durable.py) with injected "
        "ckpt.write torn/bitflip damage on two victims' final commit; "
        "commit_*_s one snapshot commit, quorum_*_s one restore-quorum "
        "round.",
        _BENCH_RANKS, 0),
    "bench-anomaly": (
        "anomaly_detection_sim",
        "MEASURED on the port's fabric simulator: the AnomalyEngine fed "
        "per-cycle arrival skew while one rank's link degrades 400x; "
        "detection_latency_*_s is degradation -> first straggler "
        "incident.",
        (256, 1024), 0),
    "bench-service": (
        "fleet_service_sim",
        "MEASURED on the port's fabric simulator: a seeded multi-tenant "
        "submission storm through the indexed journal into the arbiter, "
        "with quotas, fair share, the starvation guard, placement, "
        "queue-full backpressure and an injected arbiter crash.",
        _SERVICE_BENCH_RANKS, 0),
    "bench-lossy": (
        "lossy_link_sim",
        "MEASURED on the port's fabric simulator: the wire plane under "
        "seeded per-edge drops, a link flap and wire.send drops, "
        "recovered by the consensus abort-and-retry; baseline_* rows "
        "rerun the same seed with retries disabled.",
        _BENCH_RANKS, 7),
}


def _cmd_bench(args) -> int:
    key, note, _ranks, _seed = _BENCHES[args.cmd]
    ranks_list = [int(r) for r in args.ranks.split(",") if r.strip()]
    if args.cmd == "bench":
        rows = bench_rows(ranks_list, args.seed, device=args.device)
    else:
        rows = {"bench-fleet": fleet_bench_rows,
                "bench-ckpt": ckpt_bench_rows,
                "bench-anomaly": anomaly_bench_rows,
                "bench-service": service_bench_rows,
                "bench-lossy": lossy_bench_rows}[args.cmd](
                    ranks_list, args.seed)
    print(json.dumps({key: rows}, indent=1, sort_keys=True))
    if args.update:
        with open(args.update) as f:
            doc = json.load(f)
        doc[key] = {"note": note, "rows": rows}
        with open(args.update, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"updated {args.update}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    _ensure_deterministic_interpreter()
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.sim",
        description="run the port's control plane at virtual scale")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="run one named scenario")
    p_run.add_argument("scenario")
    p_run.add_argument("--ranks", type=int, default=256)
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--out", help="write the event log (JSONL) here")
    p_run.add_argument("--set", action="append", metavar="KEY=VAL",
                       help="scenario keyword override (repeatable)")
    p_run.add_argument("--device", default="cuda",
                       help="device of the controller scenarios' payloads "
                            "(default cuda; cpu to run them on the CPU)")
    p_run.set_defaults(fn=_cmd_run)
    p_list = sub.add_parser("list", help="list scenarios")
    p_list.set_defaults(fn=_cmd_list)
    helps = {
        "bench": "measured control-plane scaling rows",
        "bench-fleet": "measured multi-job arbiter scaling rows",
        "bench-ckpt": "measured durable-state-plane scaling rows",
        "bench-anomaly": "measured straggler-detection latency rows",
        "bench-service": "measured fleet front-door (service) rows",
        "bench-lossy": "measured wire-plane recovery-vs-restart rows",
    }
    for cmd, (key, _note, ranks, seed) in _BENCHES.items():
        p = sub.add_parser(cmd, help=helps[cmd])
        p.add_argument("--ranks", default=",".join(str(r) for r in ranks))
        p.add_argument("--seed", type=int, default=seed)
        p.add_argument("--update", metavar="FILE.json",
                       help=f"write the rows into this JSON under {key!r}")
        if cmd == "bench":
            p.add_argument("--device", default="cuda",
                           help="device of the negotiation rows' payloads")
        p.set_defaults(fn=_cmd_bench)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

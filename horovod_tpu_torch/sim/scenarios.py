"""Named chaos scenarios: the real control plane at virtual scale.

Each scenario builds a :class:`~.kernel.SimKernel` + \
:class:`~.fabric.SimFabric`, spawns one task per virtual rank running
REAL framework code (``State.commit`` / ``_DrainCoordinator`` /
``core.audit.verify`` / ``AmortizedStallInspector`` /
``EagerController`` over the simulated coordination client), injects
chaos through
``core/faults.py`` clauses bound to virtual ranks, runs to quiescence,
asserts the protocol's invariants, and returns
``{"scenario", "ranks", "seed", "stats", "events"}`` where ``stats``
carries per-phase virtual-time numbers and ``events`` is the
deterministic replay log (same seed ⇒ byte-identical).

Catalog (also ``python -m horovod_tpu_torch.sim list``):

========================  =============================================
steady-drain              one rank preempted mid-run (fault action
                          ``preempt``); full notice → plan → agreed
                          drain commit → exit-79/DrainInterrupt cycle,
                          with a per-commit audit allgather as the
                          lockstep barrier.  Asserts exactly-once
                          drain-commit accounting on every rank.
thundering-rendezvous     every rank calls the audit digest-allgather
                          simultaneously — the post-restart rendezvous
                          verification storm.  Asserts zero divergence
                          (or pinpointed divergence for a planted one).
rolling-preemption        repeated waves: preempt → drain → survivor
                          re-election (dense rank renumbering over the
                          KV) → next generation, shrinking the world
                          each wave.
kill-blacklist            a rank dies hard (fault action ``kill``);
                          a virtual driver records the failure in the
                          REAL HostManager: strike, cooldown exclusion,
                          then cooldown-expiry readmission on the
                          virtual clock.
kv-brownout               a window of injected ``kv.get``/``kv.put``
                          UNAVAILABLE faults plus dropped heartbeats
                          under live audits and heartbeat evaluation.
                          Asserts the retry plane absorbs the brownout:
                          no false stall failure, all audits complete.
straggler-tail            lockstep negotiation (manual controllers over
                          the coordination client) with one rank's link
                          20× slower;
                          the cycle-time distribution shows the tail.
stream-matrix             the streamed (barrier-free) plane with
                          schedule prediction warmed up, then the
                          split-burst × mispredict-recovery ×
                          membership-change (staggered shutdown)
                          interleavings.  Asserts every future
                          resolves and post-recovery cycles are clean.
multi-job-arbiter         the REAL FleetArbiter sharing one pool
                          between a low- and a high-priority job:
                          injected preemption, then a priority
                          preemption via the graceful-drain channel
                          (exit-79 victims, zero charged restarts),
                          gang start of the high job, and per-job
                          exactly-once sample accounting.
checkpoint-storm          every rank runs the real durable commit
                          protocol (core/durable.py) with injected
                          ``ckpt.write`` torn/bitflip damage on two
                          victims' final commit, then storms the
                          restore path: manifest verification + the
                          KV restore quorum.  Asserts the agreed
                          restore point is the min over per-rank
                          maxima, durable everywhere, and damage only
                          ever lowers the pick.
anomaly-detection         one rank's link degraded mid-run via
                          ``set_link``; the real AnomalyEngine, fed
                          per-cycle arrival skew, must raise a
                          straggler incident naming exactly that rank.
                          Measures detection latency (virtual s).
coordinator-loss          the coordination service's host dies: every
                          rank's KV lease expires (real FencedKV
                          self-fencing, virtual exit 89), the virtual
                          driver blacklists the host and re-elects the
                          coordinator over surviving slots, and gen 1
                          replays each rank's journaled durable keys
                          into the fresh fabric.  Measures detect and
                          fence-to-recover latency.
partition-storm           a burst of ``partition(MS)`` fault windows
                          silences several ranks' coordination
                          traffic; peers classify them partition
                          SUSPECTS (stall blame held), most recover,
                          and the one leased victim self-fences.
                          Asserts no false stall failure.
fleet-service             the production front door: a seeded
                          multi-tenant submission storm through the
                          REAL indexed journal into the REAL arbiter
                          (quotas, fair share, starvation guard,
                          torus placement, truthful backpressure)
                          with an injected arbiter crash that rolls
                          the intake cursor back mid-storm.  Asserts
                          exactly-once intake, budget-bounded per-tick
                          cost, named quota rejections, and a bounded
                          post-aging wait for the starved probe gang.
lossy-link                the wire plane under seeded per-send loss,
                          deterministic ``wire.send:drop`` faults and
                          a link flap window: every failed ring
                          collective runs the REAL consensus
                          abort-and-retry (comm/wirefault.py) under
                          attempt-tagged wire keys, and the link-
                          health map reroutes the ring around the
                          flapping rank.  Asserts zero restarts, zero
                          torn collectives, and bitwise-clean retried
                          results; ``baseline=True`` disables retries
                          and must poison the job instead.
compression-negotiation   mixed-precision negotiation through the
                          real controller: a dense fp32 allreduce
                          plus an int8-compressed sidecar per cycle.
                          Asserts every rank sees the identical
                          negotiated schedule with the sidecar at the
                          int8 wire dtype, never fused into the fp32
                          burst.
========================  =============================================
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, Iterator, List, Optional

from .context import RankContext
from .fabric import SimFabric
from .kernel import SimKernel, VirtualExit
from .transport import ClientTransport
from .workers import (SimElasticState, WorldView, elect_and_assign,
                      patch_data_plane)

__all__ = ["SCENARIOS", "run_scenario"]

_DEF_BUDGET_S = 36000.0  # virtual-time ceiling: livelock tripwire


@contextlib.contextmanager
def _env(**overrides: Optional[str]) -> Iterator[None]:
    """Scoped os.environ overrides (None deletes)."""
    saved = {k: os.environ.get(k) for k in overrides}
    for k, v in overrides.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fresh(ranks: int, seed: int) -> tuple:
    from ..core import audit as core_audit

    core_audit.reset_sequences()
    kernel = SimKernel(seed=seed)
    fabric = SimFabric(kernel)
    return kernel, fabric


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


def _result(name: str, ranks: int, seed: int, kernel: SimKernel,
            stats: Dict, devices: Optional[set] = None) -> Dict:
    # virtual_s: the kernel's clock at the end of the run
    out = {"scenario": name, "ranks": ranks, "seed": seed,
           "stats": stats, "events": kernel.events,
           "virtual_s": kernel.now}
    if devices is not None:
        # where the controllers' payloads and executors lived
        out["devices"] = sorted(devices)
    return out


def resolve_device(device=None):
    """The device of a controller scenario's payloads and controllers:
    the card unless the caller asks for the CPU (``device="cpu"``, the
    CLI's ``--device cpu``).  With no card it raises, naming the flag:
    nothing falls back to the CPU without a word."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"controller scenarios run their payloads on {dev} but "
                "torch sees no CUDA device; pass device='cpu' "
                "(CLI: --device cpu) to run them on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _payload(values: List[float], device):
    """One rank's float32 tensor of ``values`` on ``device`` (the
    reference enqueues ``jnp.asarray`` of the same list)."""
    import torch

    return torch.tensor(values, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# thundering-rendezvous
# ---------------------------------------------------------------------------

def thundering_rendezvous(ranks: int, seed: int = 0, *,
                          diverge_rank: Optional[int] = None) -> Dict:
    """Every rank runs the REAL audit digest-allgather at once — the
    restart-rendezvous verification storm.  ``diverge_rank`` plants one
    divergent payload and asserts the audit names exactly that rank."""
    from ..core import audit as core_audit

    kernel, fabric = _fresh(ranks, seed)
    done_t: Dict[int, float] = {}
    reports: Dict[int, dict] = {}

    def make(rank: int):
        def body():
            world = WorldView(rank, ranks, 0)
            client = fabric.client(rank, caps="str")
            value = 41.0 if rank == diverge_rank else 7.0
            tree = {"epoch": 3, "w": [value, float(ranks)]}
            reports[rank] = core_audit.verify(
                tree, label="rendezvous", action="warn",
                timeout_s=600.0, client=client, world=world)
            done_t[rank] = kernel.now
            kernel.log("rendezvous_done", rank=rank)
        return body

    for r in range(ranks):
        kernel.spawn(f"rank{r}", make(r))
    kernel.run(max_virtual_s=_DEF_BUDGET_S)

    assert len(done_t) == ranks, "some ranks never finished rendezvous"
    for rank, report in reports.items():
        if diverge_rank is None:
            assert not report["divergent"], (
                f"false divergence on rank {rank}: {report}")
        else:
            assert report["ranks"] == [diverge_rank], (
                f"rank {rank} blamed {report['ranks']}, "
                f"expected [{diverge_rank}]")
    times = sorted(done_t.values())
    stats = {"phases": {"rendezvous": {
        "virtual_s": times[-1],
        "p50_s": _pct(times, 0.50),
        "p99_s": _pct(times, 0.99),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("thundering-rendezvous", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# steady-drain
# ---------------------------------------------------------------------------

def steady_drain(ranks: int, seed: int = 0, *, steps: int = 6,
                 depart_rank: Optional[int] = None,
                 grace_s: float = 60.0, compute_s: float = 0.05,
                 durable_every: int = 3) -> Dict:
    """One rank preempted (fault action ``preempt`` at the
    ``worker.step`` site): the full drain protocol over the simulated
    KV, with the per-commit audit allgather acting as the lockstep
    barrier real training gets from its collectives."""
    from ..core.exceptions import DrainInterrupt
    from ..core.preempt import DRAIN_EXIT_CODE
    from ..core import retry as core_retry

    if depart_rank is None:
        depart_rank = max(1, ranks // 3)
    spec = f"worker.step:preempt@rank={depart_rank},times=1"
    kernel, fabric = _fresh(ranks, seed)
    records: Dict[int, dict] = {}
    notice_t: List[float] = []
    drain_t: List[float] = []

    def make(rank: int):
        def body():
            client = fabric.client(rank, caps="dir")
            kv = core_retry.resilient_kv(client, rank=rank)
            ctx = RankContext(
                kernel, rank, ranks, fault_spec=spec, generation=0,
                drain_client=kv, drain_grace_s=grace_s, with_drain=True)
            state = SimElasticState(
                client=client, world=WorldView(rank, ranks, 0), step=0)
            state.set_commit_policy(durable_every)
            rec = records[rank] = {"outcome": "finished"}
            with ctx.activate():
                try:
                    for _ in range(steps):
                        ctx.check_exit()
                        ctx.coordinator._poll_once()
                        kernel.sleep(compute_s)
                        state.step += 1
                        state.commit()
                except DrainInterrupt as e:
                    rec["outcome"] = "drain_interrupt"
                    rec["peer"] = e.rank
                    drain_t.append(kernel.now)
                    kernel.log("drain_interrupt", rank=rank,
                               commit=state._commit_count)
                except VirtualExit:
                    rec["outcome"] = "virtual_exit"
                    drain_t.append(kernel.now)
                    kernel.log("drain_exit", rank=rank,
                               commit=state._commit_count)
                    raise
                finally:
                    rec["commits"] = state._commit_count
                    rec["durable"] = state.durable_commits
                    if rank == depart_rank and ctx.coordinator._notice_t:
                        notice_t.append(ctx.coordinator._notice_t)
        return body

    with _env(HVTPU_AUDIT_EVERY="1", HVTPU_AUDIT_ACTION="abort",
              HVTPU_ELASTIC_STATE_DIR=None):
        tasks = {r: kernel.spawn(f"rank{r}", make(r))
                 for r in range(ranks)}
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    departed = tasks[depart_rank]
    assert departed.exit_code == DRAIN_EXIT_CODE, (
        f"departing rank exited {departed.exit_code}, "
        f"expected {DRAIN_EXIT_CODE}")
    survivor_commits = {records[r]["commits"]
                        for r in range(ranks) if r != depart_rank}
    assert len(survivor_commits) == 1, (
        f"survivors drained at different commits: {survivor_commits}")
    drain_commit = survivor_commits.pop()
    assert records[depart_rank]["commits"] == drain_commit, (
        "departing rank's drain commit disagrees with the survivors'")
    # exactly-once durable accounting: every rank wrote the periodic
    # durable commits PLUS the promoted drain commit, exactly once
    expected_durable = sum(
        1 for c in range(1, drain_commit + 1)
        if c % durable_every == 0 or c == drain_commit)
    for r in range(ranks):
        assert records[r]["durable"] == expected_durable, (
            f"rank {r} wrote {records[r]['durable']} durable commits, "
            f"expected {expected_durable}")
        assert records[r]["outcome"] == (
            "virtual_exit" if r == depart_rank else "drain_interrupt")
    latency = (max(drain_t) - notice_t[0]) if notice_t and drain_t else 0.0
    stats = {"phases": {
        "steady": {"virtual_s": round(notice_t[0], 6) if notice_t else 0.0},
        "drain": {
            "drain_commit": drain_commit,
            "notice_to_commit_s": round(latency, 6),
            "grace_s": grace_s,
            "virtual_s": round(max(drain_t) if drain_t else 0.0, 6),
        }}, "kv_ops": dict(fabric.ops)}
    return _result("steady-drain", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# rolling-preemption
# ---------------------------------------------------------------------------

def rolling_preemption(ranks: int, seed: int = 0, *, waves: int = 2,
                       steps_per_gen: int = 4, grace_s: float = 60.0,
                       compute_s: float = 0.02) -> Dict:
    """``waves`` preemption waves: each generation one rank is
    preempted at its first commit, the world drains, survivors
    re-elect dense ranks over the KV, and the next generation resumes
    from the drain commit — the restart-based elastic resize at
    protocol level."""
    from ..core.exceptions import DrainInterrupt
    from ..core.preempt import DRAIN_EXIT_CODE
    from ..core import retry as core_retry

    kernel, fabric = _fresh(ranks, seed)
    # deterministic victim schedule over PHYSICAL ids (never phys 0 —
    # keeping one stable observer makes the log easier to read)
    pool = list(range(1, ranks))
    rng = kernel.rng("victims")
    victims = [pool.pop(rng.randrange(len(pool))) for _ in range(waves)]
    records: Dict[int, dict] = {}
    wave_stats: List[dict] = []
    gen_members: Dict[int, set] = {0: set(range(ranks))}

    def make(phys: int):
        def body():
            rec = records[phys] = {"gens": 0, "final_rank": phys,
                                   "resumed_step": 0}
            rank, size = phys, ranks
            step_base = 0
            for gen in range(waves + 1):
                victim_here = gen < waves and phys == victims[gen]
                spec = (f"worker.step:preempt@rank={rank},times=1"
                        if victim_here else "")
                client = fabric.client(phys, caps="dir")
                kv = core_retry.resilient_kv(client, rank=rank)
                ctx = RankContext(
                    kernel, rank, size, fault_spec=spec, generation=gen,
                    drain_client=kv, drain_grace_s=grace_s,
                    with_drain=True)
                state = SimElasticState(
                    client=client, world=WorldView(rank, size, gen),
                    step=step_base)
                state.set_commit_policy(2)
                drained_peer = None
                with ctx.activate():
                    try:
                        for _ in range(steps_per_gen):
                            ctx.check_exit()
                            ctx.coordinator._poll_once()
                            kernel.sleep(compute_s)
                            state.step += 1
                            state.commit()
                    except DrainInterrupt as e:
                        drained_peer = e.rank
                    except VirtualExit:
                        kernel.log("departed", gen=gen, phys=phys,
                                   rank=rank,
                                   commit=state._commit_count)
                        raise
                rec["gens"] = gen + 1
                step_base = state._saved["step"]
                rec["resumed_step"] = step_base
                if drained_peer is None:
                    # final generation ran to completion
                    rec["final_rank"] = rank
                    continue
                kernel.log("drain_observed", gen=gen, phys=phys,
                           rank=rank, peer=drained_peer,
                           commit=state._commit_count)
                survivors = [r for r in range(size) if r != drained_peer]
                assignment = elect_and_assign(
                    kv, rank, survivors, generation=gen + 1)
                rank = assignment[rank]
                size = len(survivors)
                rec["final_rank"] = rank
        return body

    with _env(HVTPU_AUDIT_EVERY="1", HVTPU_AUDIT_ACTION="abort",
              HVTPU_ELASTIC_STATE_DIR=None):
        tasks = {p: kernel.spawn(f"phys{p}", make(p))
                 for p in range(ranks)}
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    for w, victim in enumerate(victims):
        assert tasks[victim].exit_code == DRAIN_EXIT_CODE, (
            f"wave-{w} victim phys{victim} exited "
            f"{tasks[victim].exit_code}, expected {DRAIN_EXIT_CODE}")
    survivors_phys = [p for p in range(ranks) if p not in victims]
    final_size = ranks - waves
    final_ranks = sorted(records[p]["final_rank"] for p in survivors_phys)
    assert final_ranks == list(range(final_size)), (
        f"survivor renumbering not dense: {final_ranks}")
    for p in survivors_phys:
        assert records[p]["gens"] == waves + 1, (
            f"phys{p} completed {records[p]['gens']} generations, "
            f"expected {waves + 1}")
    resumed = {records[p]["resumed_step"] for p in survivors_phys}
    assert len(resumed) == 1, (
        f"survivors resumed from different steps: {resumed}")
    stats = {"phases": {
        "waves": {"count": waves, "victims_phys": victims},
        "final": {"world_size": final_size,
                  "virtual_s": round(kernel.now, 6),
                  "resumed_step": resumed.pop()},
    }, "kv_ops": dict(fabric.ops)}
    return _result("rolling-preemption", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# kill-blacklist
# ---------------------------------------------------------------------------

class _StaticDiscovery:
    """Discovery stub for the virtual driver: a fixed host->slots map
    (the HostManager under test is real; only the shell-out is fake)."""

    def __init__(self, hosts: Dict[str, int]):
        self.hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self.hosts)


def kill_blacklist(ranks: int, seed: int = 0, *, steps: int = 6,
                   kill_rank: Optional[int] = None,
                   slots_per_host: int = 8,
                   cooldown_s: float = 30.0,
                   compute_s: float = 0.02) -> Dict:
    """A rank dies hard (``kill`` fault): a virtual driver task feeds
    the failure to the REAL HostManager and asserts strike → cooldown
    exclusion → cooldown-expiry readmission, all on the virtual
    clock."""
    from ..elastic.discovery import HostManager

    if kill_rank is None:
        kill_rank = max(1, ranks // 2)
    spec = f"worker.step:kill@rank={kill_rank},times=1"
    kernel, fabric = _fresh(ranks, seed)
    hosts = {f"host{h}": slots_per_host
             for h in range((ranks + slots_per_host - 1)
                            // slots_per_host)}
    kill_host = f"host{kill_rank // slots_per_host}"
    records: Dict[int, dict] = {}
    driver_log: List[dict] = []

    def make(rank: int):
        def body():
            client = fabric.client(rank, caps="dir")
            ctx = RankContext(kernel, rank, ranks, fault_spec=spec,
                              generation=0)
            state = SimElasticState(
                client=client, world=WorldView(rank, ranks, 0), step=0)
            rec = records[rank] = {}
            with ctx.activate():
                try:
                    for _ in range(steps):
                        ctx.check_exit()
                        kernel.sleep(compute_s)
                        state.step += 1
                        state.commit()
                finally:
                    rec["commits"] = state._commit_count
                    rec["durable"] = state.durable_commits
        return body

    def driver():
        hm = HostManager(_StaticDiscovery(hosts),
                         cooldown_base_s=cooldown_s,
                         cooldown_max_s=8 * cooldown_s)
        hm.refresh()
        full_slots = hm.available_slots()
        # wait for the kill
        while not (tasks[kill_rank].done
                   and tasks[kill_rank].exit_code == 1):
            kernel.sleep(0.5)
        cooldown = hm.blacklist_host(kill_host)
        hm.refresh()
        driver_log.append({
            "t": kernel.now, "event": "blacklisted",
            "host": kill_host, "cooldown_s": cooldown,
            "strikes": hm.strikes(kill_host),
            "slots": hm.available_slots(),
        })
        assert kill_host in hm.blacklisted_now()
        assert hm.available_slots() == full_slots - hosts[kill_host]
        if len(hosts) > 1:
            assert not hm.exhausted(min_np=1)
        # cooldown expiry on the virtual clock: the host is probed and
        # readmitted
        wait = hm.next_readmission_s()
        assert wait is not None and wait <= cooldown
        kernel.sleep(wait + 0.001)
        changed = hm.refresh()
        driver_log.append({
            "t": kernel.now, "event": "readmitted", "host": kill_host,
            "changed": changed, "slots": hm.available_slots(),
        })
        assert changed and hm.available_slots() == full_slots
        assert hm.blacklisted_now() == []
        assert hm.strikes(kill_host) == 1  # strike persists past cooldown
        hm.record_success(kill_host)
        assert hm.strikes(kill_host) == 0
        kernel.log("driver_done", blacklist_events=len(driver_log))

    with _env(HVTPU_AUDIT_EVERY="0", HVTPU_ELASTIC_STATE_DIR=None):
        tasks = {r: kernel.spawn(f"rank{r}", make(r))
                 for r in range(ranks)}
        kernel.spawn("driver", driver)
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    assert tasks[kill_rank].exit_code == 1, (
        f"killed rank exited {tasks[kill_rank].exit_code}, expected 1")
    for r in range(ranks):
        if r == kill_rank:
            continue
        assert records[r]["commits"] == steps, (
            f"survivor rank {r} committed {records[r]['commits']}, "
            f"expected {steps}")
        assert records[r]["durable"] == steps  # default policy: every commit
    stats = {"phases": {
        "kill": {"rank": kill_rank, "host": kill_host},
        "blacklist": driver_log[0] if driver_log else {},
        "readmission": driver_log[1] if len(driver_log) > 1 else {},
    }, "kv_ops": dict(fabric.ops)}
    return _result("kill-blacklist", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# kv-brownout
# ---------------------------------------------------------------------------

def kv_brownout(ranks: int, seed: int = 0, *, steps: int = 5,
                error_prob: float = 0.25, error_budget: int = 60,
                heartbeat_s: float = 0.5,
                compute_s: float = 0.1) -> Dict:
    """A coordination-service brownout: every rank's ``kv.get`` /
    ``kv.put`` ops fail with UNAVAILABLE at ``error_prob`` for a
    bounded budget, and heartbeats are dropped too — while audits and
    the heartbeat stall inspector keep running.  Asserts the retry
    plane absorbs it: every audit completes, no rank latches a stall
    failure, and retries actually happened."""
    from ..comm.stall import AmortizedStallInspector
    from ..core import audit as core_audit
    from ..core import retry as core_retry
    from ..obs import metrics as obs_metrics

    spec = (f"kv.put:error@prob={error_prob},times={error_budget};"
            f"kv.get:error@prob={error_prob},times={error_budget};"
            f"heartbeat:drop@prob=0.3,times={error_budget}")
    kernel, fabric = _fresh(ranks, seed)
    # The invariant under test is "the retry plane absorbs the
    # brownout", not "4 attempts always suffice": at prob=0.25 a
    # single op exhausts the default 4-attempt budget with p~0.4%,
    # which at 256 ranks x ~1e5 KV ops is a near-certainty.  Give the
    # policy enough headroom that exhaustion probability is
    # negligible (0.25^16 ~ 2e-10 per op) so the assertion holds at
    # every world size.
    retry_env = _env(HVTPU_KV_RETRY_ATTEMPTS="16",
                     HVTPU_KV_RETRY_DEADLINE_S="600")
    inspectors: Dict[int, AmortizedStallInspector] = {}
    audits_done: Dict[int, int] = {}
    retries_before = obs_metrics.counter("hvtpu_kv_retries_total").value()

    def make(rank: int):
        def body():
            client = fabric.client(rank, caps="dir")
            kv = core_retry.resilient_kv(client, rank=rank)
            ctx = RankContext(kernel, rank, ranks, fault_spec=spec,
                              generation=0)
            insp = AmortizedStallInspector(
                kv, rank, warn_s=60.0, abort_s=600.0,
                heartbeat_s=heartbeat_s, generation=0,
                start_heartbeat=False)
            inspectors[rank] = insp
            world = WorldView(rank, ranks, 0)
            audits_done[rank] = 0
            with ctx.activate():
                for step in range(steps):
                    desc = insp.pre_op(0, range(ranks), f"step{step}")
                    # virtual compute, heartbeats pumped on cadence
                    beats = max(1, int(compute_s / heartbeat_s))
                    for _ in range(beats):
                        kernel.sleep(compute_s / beats)
                        insp._beat_once()
                    insp._clear_inflight(0)
                    report = core_audit.verify(
                        {"step": step, "w": [1.0, 2.0]},
                        label="brownout", action="abort",
                        timeout_s=1200.0, client=client, world=world)
                    assert not report["divergent"]
                    audits_done[rank] += 1
                insp.stop()
                kernel.log("brownout.rank_done", rank=rank,
                           audits=audits_done[rank],
                           t=round(kernel.now, 9))
        return body

    with retry_env:
        for r in range(ranks):
            kernel.spawn(f"rank{r}", make(r))
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    for rank, insp in inspectors.items():
        assert insp.failure is None, (
            f"rank {rank} latched a false stall failure during the "
            f"brownout: {insp.failure}")
        assert audits_done[rank] == steps
    retries = (obs_metrics.counter("hvtpu_kv_retries_total").value()
               - retries_before)
    assert retries > 0, "brownout injected no retried KV op"
    stats = {"phases": {"brownout": {
        "virtual_s": round(kernel.now, 6),
        "kv_retries": retries,
        "audits": steps * ranks,
    }}, "kv_ops": dict(fabric.ops)}
    return _result("kv-brownout", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# straggler-tail / lockstep negotiation bench
# ---------------------------------------------------------------------------

def _lockstep_world(kernel: SimKernel, fabric: SimFabric, ranks: int,
                    cycles: int, cycle_times: Dict[int, List[float]],
                    device, devices: set, fault_spec: str = ""):
    """Task bodies for a manual lockstep EagerController world over the
    simulated coordination client; every rank enqueues one allreduce
    per cycle on ``device`` and drives run_cycle_once (a real all-rank
    barrier).  Each controller's device lands in ``devices``."""
    from ..eager.controller import EagerController

    def make(rank: int):
        def body():
            ctx = RankContext(kernel, rank, ranks, fault_spec=fault_spec,
                              generation=0)
            transport = ClientTransport(
                rank, ranks, client=fabric.client(rank, caps="bytes"),
                timeout_s=600.0, poll_s=1.0)
            ctrl = EagerController(rank, ranks, transport=transport,
                                   cycle_time_ms=1.0, manual=True,
                                   device=device)
            devices.add(str(ctrl.device))
            times = cycle_times.setdefault(rank, [])
            with ctx.activate():
                for cycle in range(cycles):
                    t0 = kernel.now
                    fut = ctrl.enqueue(
                        "allreduce", _payload([1.0, float(rank)], device),
                        name=f"grad.{cycle}")
                    ctrl.run_cycle_once()
                    assert fut.done(), (
                        f"rank {rank} cycle {cycle}: future unresolved "
                        "after the lockstep cycle")
                    fut.result(timeout=0)
                    times.append(kernel.now - t0)
                ctrl.request_shutdown()
                while not ctrl._shutdown_seen.is_set():
                    ctrl.run_cycle_once()
                ctrl.stop()
        return body

    return make


def straggler_tail(ranks: int, seed: int = 0, *, cycles: int = 8,
                   straggler: Optional[int] = None,
                   slowdown: float = 20.0, device=None) -> Dict:
    """Lockstep negotiation with one rank's KV link ``slowdown``×
    slower: the per-cycle barrier makes every rank pay the straggler's
    latency — the distribution's tail IS the diagnosis."""
    device = resolve_device(device)
    kernel, fabric = _fresh(ranks, seed)
    if straggler is None:
        straggler = max(1, ranks - 1)
    base = fabric.link(straggler)
    fabric.set_link(straggler,
                    latency_s=base.latency_s * slowdown,
                    bandwidth_bps=base.bandwidth_bps / slowdown)
    cycle_times: Dict[int, List[float]] = {}
    devices: set = set()
    make = _lockstep_world(kernel, fabric, ranks, cycles, cycle_times,
                           device, devices)
    with patch_data_plane(), _env(HVTPU_EAGER_STREAM=None):
        for r in range(ranks):
            kernel.spawn(f"rank{r}", make(r))
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    all_times = sorted(t for ts in cycle_times.values() for t in ts)
    stats = {"phases": {"negotiate": {
        "cycles": cycles,
        "straggler_rank": straggler,
        "slowdown": slowdown,
        "cycle_p50_s": round(_pct(all_times, 0.50), 9),
        "cycle_p99_s": round(_pct(all_times, 0.99), 9),
        "cycle_max_s": round(all_times[-1], 9) if all_times else 0.0,
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("straggler-tail", ranks, seed, kernel, stats, devices)


def bench_negotiation(ranks: int, seed: int = 0, *, cycles: int = 6,
                      warmup: int = 2, device=None) -> Dict:
    """Healthy-network lockstep negotiation: the measured
    negotiation-cycle time vs world size (the CLI's ``bench`` rows)."""
    device = resolve_device(device)
    kernel, fabric = _fresh(ranks, seed)
    cycle_times: Dict[int, List[float]] = {}
    devices: set = set()
    make = _lockstep_world(kernel, fabric, ranks, warmup + cycles,
                           cycle_times, device, devices)
    with patch_data_plane(), _env(HVTPU_EAGER_STREAM=None):
        for r in range(ranks):
            kernel.spawn(f"rank{r}", make(r))
        kernel.run(max_virtual_s=_DEF_BUDGET_S)
    steady = sorted(t for ts in cycle_times.values()
                    for t in ts[warmup:])
    stats = {"phases": {"negotiate": {
        "cycles": cycles,
        "cycle_p50_s": round(_pct(steady, 0.50), 9),
        "cycle_mean_s": round(sum(steady) / max(1, len(steady)), 9),
        "cycle_max_s": round(steady[-1], 9) if steady else 0.0,
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("bench-negotiation", ranks, seed, kernel, stats,
                   devices)


# ---------------------------------------------------------------------------
# stream-matrix: streamed plane under split-burst / mispredict /
# membership-change interleavings
# ---------------------------------------------------------------------------

def stream_matrix(ranks: int, seed: int = 0, *, burst: int = 2,
                  warmup_steps: int = 4, post_steps: int = 2,
                  device=None) -> Dict:
    """The streamed (barrier-free) control plane with schedule
    prediction warmed up, then the interleavings that historically
    break prediction-class protocols:

    - **split-burst**: one rank drains its burst in two halves (a
      virtual-time gap wider than the gate deadline) — atomic burst
      units must HOLD the release, never diverge it;
    - **mispredict-recovery**: a rank is forced through
      ``_on_mispredict`` mid-stream — the resync re-anchor must
      converge and subsequent cycles run clean;
    - **membership-change**: every rank announces shutdown at a
      different virtual time — agreement must still be reached with
      request blobs carrying flags mid-flight.

    Asserts every enqueued future resolves, the predictor actually
    engaged during warmup, and all ranks observe shutdown agreement.
    """
    from ..eager.controller import EagerController
    from ..obs import metrics as obs_metrics

    device = resolve_device(device)
    devices: set = set()
    kernel, fabric = _fresh(ranks, seed)
    split_rank = max(1, ranks // 3)
    mispredict_rank = max(1, (2 * ranks) // 3)
    predicted_before = obs_metrics.counter(
        "hvtpu_controller_predicted_cycles_total").value()
    steps_total = warmup_steps + 2 + post_steps
    resolved: Dict[int, int] = {}
    shutdown_seen: Dict[int, bool] = {}

    def pump(ctrl, rank: int) -> bool:
        """One round of the real drainer/servicer/fetcher work, inline
        on this rank's task (mirrors _drain_loop/_fetch_loop without
        their threads)."""
        active = False
        if ctrl._undrained or ctrl._post_needed:
            active = ctrl._drain_once() or active
        if rank == 0:
            active = ctrl._service_once() or active
            while ctrl._local_resp:
                ctrl._fetch_once(wait_s=0)
                active = True
        else:
            active = ctrl._fetch_once(wait_s=0) or active
        return active

    def one():
        return _payload([1.0], device)

    def make(rank: int):
        def body():
            transport = ClientTransport(
                rank, ranks, client=fabric.client(rank, caps="bytes"),
                timeout_s=600.0, poll_s=0.02)
            ctrl = EagerController(rank, ranks, transport=transport,
                                   cycle_time_ms=1.0, manual=True,
                                   device=device)
            devices.add(str(ctrl.device))
            ctrl._stream = True  # streamed plane, scenario-pumped
            resolved[rank] = 0
            # training-loop shape: the SAME named collectives re-issued
            # every step (what lets the bit-set verify and the
            # predictor engage)
            names = [f"g{i}" for i in range(burst)]
            for step in range(steps_total):
                if step == warmup_steps and rank == split_rank:
                    # split-burst: half now, half after a gap wider
                    # than the steady-state gate deadline
                    half = burst // 2 or 1
                    futs = [ctrl.enqueue("allreduce", one(), name=n)
                            for n in names[:half]]
                    deadline = kernel.now + 0.3
                    while kernel.now < deadline:
                        if not pump(ctrl, rank):
                            kernel.sleep(0.01)
                    futs += [ctrl.enqueue("allreduce", one(), name=n)
                             for n in names[half:]]
                else:
                    futs = [ctrl.enqueue("allreduce", one(), name=n)
                            for n in names]
                if (step == warmup_steps + 1
                        and rank == mispredict_rank):
                    with ctrl._lock:
                        ctrl._on_mispredict("sim-forced divergence")
                while not all(f.done() for f in futs):
                    if not pump(ctrl, rank):
                        kernel.sleep(0.005)
                for f in futs:
                    f.result(timeout=0)
                resolved[rank] += len(futs)
                kernel.log("step_done", rank=rank, step=step)
            # membership-change: staggered shutdown announcements
            kernel.sleep(0.001 * rank)
            ctrl.request_shutdown()
            while not ctrl._shutdown_seen.is_set():
                if not pump(ctrl, rank):
                    kernel.sleep(0.005)
            shutdown_seen[rank] = True
            # drain any post-agreement confirmations so quiesce needn't
            # spin; leftovers roll back inside quiesce (its contract)
            tail = kernel.now + 1.0
            while ctrl._predicted and kernel.now < tail:
                if not pump(ctrl, rank):
                    kernel.sleep(0.005)
            quiesced = ctrl.quiesce(timeout=10.0)
            assert quiesced, f"rank {rank} did not quiesce post-shutdown"
            ctrl.stop()
        return body

    with patch_data_plane(), _env(HVTPU_EAGER_PREDICT="auto",
                                  HVTPU_EAGER_BURST_CAP="1"):
        for r in range(ranks):
            kernel.spawn(f"rank{r}", make(r))
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    for r in range(ranks):
        assert resolved[r] == steps_total * burst, (
            f"rank {r} resolved {resolved[r]} futures, expected "
            f"{steps_total * burst}")
        assert shutdown_seen.get(r), f"rank {r} missed shutdown agreement"
    predicted = (obs_metrics.counter(
        "hvtpu_controller_predicted_cycles_total").value()
                 - predicted_before)
    assert predicted > 0, (
        "the schedule predictor never engaged — the warmup phase is "
        "not exercising the fast path")
    stats = {"phases": {
        "warmup": {"steps": warmup_steps,
                   "predicted_bursts": predicted},
        "perturb": {"split_rank": split_rank,
                    "mispredict_rank": mispredict_rank},
        "shutdown": {"virtual_s": round(kernel.now, 6)},
    }, "kv_ops": dict(fabric.ops)}
    return _result("stream-matrix", ranks, seed, kernel, stats, devices)


# ---------------------------------------------------------------------------
# multi-job-arbiter: the fleet arbiter sharing one pool between jobs
# ---------------------------------------------------------------------------

class _SimJobRunner:
    """Handle-protocol job runner over virtual rank tasks: the sim
    counterpart of ``fleet/runner.py``'s ElasticJobRunner.  Each
    generation spawns ``np`` rank tasks running the REAL elastic-commit
    + drain-coordination code over a job-prefixed KV namespace; a
    supervisor task classifies each incarnation (done / drain /
    restart) exactly like the production driver and relaunches.

    All mutation happens on kernel task threads serialised by the run
    token, so no locks are needed (the sim invariant)."""

    def __init__(self, job, kernel, fabric, *, steps: int,
                 compute_s: float, durable_every: int, grace_s: float,
                 perm, account: Dict[int, int],
                 fault_spec: str = "", launch_hook=None):
        self.job = job
        self.name = job.spec.name
        self.kernel = kernel
        self.fabric = fabric
        self.steps = steps
        self.compute_s = compute_s
        self.durable_every = durable_every
        self.grace_s = grace_s
        self.perm = perm
        self.account = account
        self.fault_spec = fault_spec  # generation 0 only
        self.launch_hook = launch_hook
        # disjoint generation space per job: audit sequence counters
        # are keyed (generation, rank, label) process-wide, and two
        # jobs sharing rank ids at different commit cadences would
        # otherwise desynchronise each other's audit rounds
        self.ns_base = job.submit_seq * 1000
        self.charged_restarts = 0
        self.drains = 0
        self.np_history: List[int] = []
        self.exit79_per_gen: List[int] = []
        self.shrink_req_t: Optional[float] = None
        self.notice_to_commit_s: Optional[float] = None
        self.resize_s: Optional[float] = None
        self._alloc: Dict[str, int] = {}
        self._pending_alloc: Optional[Dict[str, int]] = None
        self._victims: set = set()
        self._notices: set = set()
        self._kills: set = set()
        self._target_np: Optional[int] = None
        self._phase = "pending"
        self._np = 0
        self._exit: Optional[int] = None
        self._gen = 0
        self._resume = {"step": 0, "cursor": 0}
        self._drain_t = 0.0
        self._measure_resize = False

    # -- handle protocol (called from the arbiter's task) ---------------
    def start(self, allocation: Dict[str, int]) -> None:
        self._alloc = dict(allocation)
        self._phase = "running"
        self.kernel.spawn(f"{self.name}.driver", self._supervise)

    def poll(self) -> Optional[int]:
        return self._exit

    def stop(self) -> None:
        self._kills.update(range(self._np))

    def request_shrink(self, new_np: int) -> bool:
        if self._phase != "running" or self._np <= new_np:
            return False
        keep: Dict[str, int] = {}
        remaining = new_np
        for h in sorted(self._alloc):
            take = min(self._alloc[h], remaining)
            if take > 0:
                keep[h] = take
                remaining -= take
        self._pending_alloc = keep
        self._victims = set(range(new_np, self._np))
        self._target_np = new_np
        self._phase = "draining"
        self.shrink_req_t = self.kernel.now
        self._measure_resize = True
        self._notices.update(self._victims)
        self.kernel.log("fleet_sim.shrink_notice", job=self.name,
                        to_np=new_np, victims=self._np - new_np)
        return True

    def escalate(self) -> int:
        victims = set(self._victims)
        self._kills |= victims
        return len(victims)

    def update_allocation(self, allocation: Dict[str, int]) -> None:
        self._alloc = dict(allocation)

    def phase(self) -> str:
        return self._phase

    def current_np(self) -> int:
        return self._np

    def target_np(self) -> Optional[int]:
        return self._target_np

    def allocation(self) -> Dict[str, int]:
        return dict(self._alloc)

    # -- supervisor (one kernel task per job) ---------------------------
    def _supervise(self) -> None:
        from ..core.preempt import DRAIN_EXIT_CODE

        while True:
            gen = self._gen
            size = sum(self._alloc.values())
            self._np = size
            self._phase = "running"
            self.np_history.append(size)
            if self._measure_resize and len(self.np_history) > 1 \
                    and self.shrink_req_t is not None \
                    and self._pending_alloc is None:
                self._measure_resize = False
                self.resize_s = self.kernel.now - self.shrink_req_t
            self.kernel.log("fleet_sim.launch", job=self.name, gen=gen,
                            np=size)
            if self.launch_hook is not None:
                self.launch_hook(self, gen, size)
            outcomes: Dict[int, str] = {}
            tasks = [self.kernel.spawn(
                f"{self.name}.g{gen}.r{r}",
                self._make_rank(r, size, gen, outcomes))
                for r in range(size)]
            while not all(t.done for t in tasks):
                self.kernel.sleep(0.05)
            drained = [r for r, t in enumerate(tasks)
                       if t.exit_code == DRAIN_EXIT_CODE]
            crashed = [r for r, t in enumerate(tasks)
                       if t.exit_code not in (None, DRAIN_EXIT_CODE)]
            if all(outcomes.get(r) == "finished" for r in range(size)):
                self._phase = "done"
                self._exit = 0
                self.kernel.log("fleet_sim.done", job=self.name,
                                gen=gen, np=size,
                                step=self._resume["step"])
                return
            if drained and not crashed:
                self.drains += 1
                self.exit79_per_gen.append(len(drained))
                if self._victims and self.shrink_req_t is not None \
                        and self.notice_to_commit_s is None:
                    self.notice_to_commit_s = (self._drain_t
                                               - self.shrink_req_t)
            else:
                self.charged_restarts += 1
            # the incarnation_end moment: apply the pending grant
            # BEFORE the relaunch (the anti-race contract the real
            # driver gets from its synchronous listener)
            if self._pending_alloc is not None:
                self._alloc = self._pending_alloc
                self._pending_alloc = None
                self._victims = set()
                self._notices = set()
                self._kills = set()
                self._target_np = None
            self._phase = "resizing"
            self._gen += 1
            self.kernel.log("fleet_sim.incarnation_end", job=self.name,
                            gen=gen, drained=len(drained),
                            crashed=len(crashed))
            self.kernel.sleep(0.1)  # modelled relaunch latency

    def _make_rank(self, rank: int, size: int, gen: int,
                   outcomes: Dict[int, str]):
        job_gen = self.ns_base + gen

        def body():
            from ..core.exceptions import DrainInterrupt
            from ..core.preempt import DRAIN_EXIT_CODE
            from ..core import retry as core_retry
            from ..data import sharder
            from ..fleet.job import prefixed_client

            client = prefixed_client(
                self.fabric.client(self.ns_base + rank, caps="dir"),
                self.name)
            kv = core_retry.resilient_kv(client, rank=rank)
            ctx = RankContext(
                self.kernel, rank, size,
                fault_spec=(self.fault_spec if gen == 0 else ""),
                generation=job_gen, drain_client=kv,
                drain_grace_s=self.grace_s, with_drain=True)
            state = SimElasticState(
                client=client, world=WorldView(rank, size, job_gen),
                step=self._resume["step"],
                cursor=self._resume["cursor"])
            state.set_commit_policy(self.durable_every)
            pending: List[int] = []
            flushed = 0
            outcomes[rank] = "running"

            def flush_durable():
                nonlocal flushed
                if state.durable_commits > flushed:
                    flushed = state.durable_commits
                    for i in pending:
                        self.account[i] = self.account.get(i, 0) + 1
                    del pending[:]

            with ctx.activate():
                try:
                    while state.step < self.steps:
                        ctx.check_exit()
                        if rank in self._kills:
                            raise VirtualExit(1)
                        if rank in self._notices:
                            self._notices.discard(rank)
                            ctx.coordinator.notice("fleet")
                        ctx.coordinator._poll_once()
                        self.kernel.sleep(self.compute_s)
                        idx, new_cursor = sharder.shard_window(
                            self.perm, state.cursor, rank, size, 1)
                        pending.extend(int(i) for i in idx)
                        state.step += 1
                        state.cursor = int(new_cursor)
                        try:
                            state.commit()
                        finally:
                            # deliveries become accountable only when
                            # a DURABLE commit captured their cursor —
                            # uncommitted batches are re-fetched by the
                            # next incarnation (exactly-once contract)
                            flush_durable()
                    # end-of-job durable save (what a real training
                    # loop does before exiting clean), so the final
                    # partial window is accounted too
                    state.save()
                    flush_durable()
                    outcomes[rank] = "finished"
                except DrainInterrupt:
                    outcomes[rank] = "drain_peer"
                except VirtualExit as e:
                    outcomes[rank] = ("drain_exit"
                                      if e.code == DRAIN_EXIT_CODE
                                      else "killed")
                    if e.code == DRAIN_EXIT_CODE:
                        self._drain_t = self.kernel.now
                    raise
                finally:
                    self._resume = {
                        "step": int(state._saved.get("step", 0)),
                        "cursor": int(state._saved.get("cursor", 0))}

        return body


def multi_job_arbiter(ranks: int, seed: int = 0, *, lo_steps: int = 8,
                      hi_steps: int = 4, slots_per_host: int = 8,
                      tick_s: float = 0.25, hi_arrival_s: float = 1.0,
                      grace_s: float = 120.0, compute_s: float = 0.4,
                      durable_every: int = 2) -> Dict:
    """Two jobs, one pool, under the REAL FleetArbiter: a low-priority
    job expands to the whole pool, survives an injected mid-run
    preemption (planned drain, relaunch at full size), then a
    high-priority job arrives and the arbiter reclaims half the pool
    through the graceful-drain channel — the victims exit
    DRAIN_EXIT_CODE at an agreed commit, the low job relaunches
    smaller with ZERO charged restarts, and the high job gang-starts
    only once its full min-world allocation is free.  Both jobs finish
    with per-job exactly-once sample accounting."""
    from ..core.preempt import DRAIN_EXIT_CODE
    from ..data import sharder
    from ..fleet import FleetArbiter, JobSpec

    kernel, fabric = _fresh(ranks, seed)
    n_hosts = (ranks + slots_per_host - 1) // slots_per_host
    hosts = {f"host{h:04d}": slots_per_host for h in range(n_hosts)}
    pool_slots = n_hosts * slots_per_host
    hi_min = ranks // 2
    lo_min = max(1, ranks // 4)
    fault_rank = max(1, ranks // 3)
    num_samples = (lo_steps + hi_steps) * pool_slots
    perms = {
        "lo": sharder.epoch_permutation(num_samples, seed * 131 + 1, 0),
        "hi": sharder.epoch_permutation(num_samples, seed * 131 + 2, 0),
    }
    accounts: Dict[str, Dict[int, int]] = {"lo": {}, "hi": {}}
    runners: Dict[str, _SimJobRunner] = {}
    gang_snapshots: List[dict] = []

    def launch_hook(runner, gen, size):
        # gang-disjointness evidence: at every launch, per-host usage
        # across ALL live jobs must fit the host
        usage: Dict[str, int] = {}
        for r in runners.values():
            if r._exit is None:
                for h, n in r._alloc.items():
                    usage[h] = usage.get(h, 0) + n
        gang_snapshots.append(
            {"t": kernel.now, "job": runner.name, "gen": gen,
             "np": size, "usage": usage})

    def make_runner(job):
        name = job.spec.name
        cfg = {
            "lo": dict(steps=lo_steps,
                       fault_spec=(f"worker.step:preempt@"
                                   f"rank={fault_rank},times=1")),
            "hi": dict(steps=hi_steps, fault_spec=""),
        }[name]
        runner = _SimJobRunner(
            job, kernel, fabric, compute_s=compute_s,
            durable_every=durable_every, grace_s=grace_s,
            perm=perms[name], account=accounts[name],
            launch_hook=launch_hook, **cfg)
        runners[name] = runner
        return runner

    arb = FleetArbiter(
        _StaticDiscovery(hosts), fleet_dir=None, tick_s=tick_s,
        drain_grace_s=grace_s, runner_factory=make_runner,
        event_fn=kernel.log, register_debug=False)

    def arbiter_task():
        arb.submit(JobSpec("lo", ["sim"], priority=0,
                           min_np=lo_min, max_np=pool_slots))
        while not arb.all_terminal():
            arb.tick()
            kernel.sleep(tick_s)
        arb.tick()  # final reap/publish
        kernel.log("fleet_sim.arbiter_done",
                   states={n: arb.jobs[n].state
                           for n in sorted(arb.jobs)})

    def hi_submitter():
        kernel.sleep(hi_arrival_s)
        # the arrival must preempt a healthy post-drain world, not
        # merge into the injected gen-0 drain (whose commit lands
        # after hi_arrival_s at large rank counts): wait for lo's
        # second incarnation to be running
        lo_runner = runners["lo"]
        while not (lo_runner._gen >= 1
                   and lo_runner.phase() == "running"):
            kernel.sleep(tick_s)
        arb.submit(JobSpec("hi", ["sim"], priority=10, min_np=hi_min))

    with _env(HVTPU_AUDIT_EVERY="1", HVTPU_AUDIT_ACTION="abort",
              HVTPU_ELASTIC_STATE_DIR=None, HVTPU_FLEET_DIR=None):
        kernel.spawn("arbiter", arbiter_task)
        kernel.spawn("hi-submitter", hi_submitter)
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    lo_r, hi_r = runners["lo"], runners["hi"]
    lo_job, hi_job = arb.jobs["lo"], arb.jobs["hi"]
    # both jobs finished clean under the arbiter
    assert lo_job.state == "DONE" and lo_r._exit == 0, (
        f"lo ended {lo_job.state} (exit {lo_r._exit}): {lo_job.reason}")
    assert hi_job.state == "DONE" and hi_r._exit == 0, (
        f"hi ended {hi_job.state} (exit {hi_r._exit}): {hi_job.reason}")
    # incarnation history: full pool → full pool (after the injected
    # preemption's planned drain) → shrunk for the high-priority gang
    assert lo_r.np_history[0] == pool_slots, (
        f"lo did not expand to the pool at start: {lo_r.np_history}")
    assert lo_r.np_history[-1] == pool_slots - hi_min, (
        f"lo final size {lo_r.np_history[-1]}, expected "
        f"{pool_slots - hi_min}: {lo_r.np_history}")
    assert hi_r.np_history == [hi_min], (
        f"hi must gang-launch exactly once at min_np: {hi_r.np_history}")
    # planned drains only: exit-79 departures, zero charged restarts
    assert lo_r.drains == 2 and lo_r.exit79_per_gen == [1, hi_min], (
        f"drains={lo_r.drains} exit79={lo_r.exit79_per_gen}")
    assert lo_r.charged_restarts == 0 and hi_r.charged_restarts == 0, (
        f"planned preemption charged the restart budget: "
        f"lo={lo_r.charged_restarts} hi={hi_r.charged_restarts}")
    assert lo_job.preemptions == 1 and lo_job.charged_restarts == 0
    # gang scheduling: at every launch the per-host usage fits
    for snap in gang_snapshots:
        for h, used in snap["usage"].items():
            assert used <= hosts[h], (
                f"host {h} over-committed ({used}/{hosts[h]}) at "
                f"{snap}")
    # the high job waited for the drain, then got its FULL gang
    assert hi_job.queue_wait_s is not None and hi_job.queue_wait_s > 0
    assert gang_snapshots[-1]["job"] in ("hi", "lo")
    # per-job exactly-once accounting against the committed cursor
    for name in ("lo", "hi"):
        acct = accounts[name]
        cursor = runners[name]._resume["cursor"]
        assert cursor > 0, f"{name} committed no data progress"
        dupes = {i: c for i, c in acct.items() if c != 1}
        assert not dupes, (
            f"{name}: samples delivered more than once: "
            f"{sorted(dupes)[:10]}")
        expect = sorted(int(i) for i in perms[name][:cursor])
        assert sorted(acct) == expect, (
            f"{name}: delivered set != committed window "
            f"({len(acct)} vs {cursor})")
    assert lo_r.notice_to_commit_s is not None
    assert 0 < lo_r.notice_to_commit_s < grace_s
    assert lo_r.resize_s is not None and lo_r.resize_s > 0
    stats = {"phases": {
        "pool": {"hosts": n_hosts, "slots": pool_slots},
        "inject": {"fault_rank": fault_rank,
                   "lo_incarnations": lo_r.np_history},
        "preempt": {
            "victims": hi_min,
            "queue_wait_s": round(hi_job.queue_wait_s, 6),
            "notice_to_commit_s": round(lo_r.notice_to_commit_s, 6),
            "resize_s": round(lo_r.resize_s, 6),
        },
        "done": {
            "lo_final_np": lo_r.np_history[-1],
            "hi_np": hi_min,
            "lo_samples": len(accounts["lo"]),
            "hi_samples": len(accounts["hi"]),
            "virtual_s": round(kernel.now, 6),
        }}, "kv_ops": dict(fabric.ops)}
    _ = DRAIN_EXIT_CODE
    return _result("multi-job-arbiter", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# checkpoint-storm: the durable state plane under storage chaos
# ---------------------------------------------------------------------------

def checkpoint_storm(ranks: int, seed: int = 0, *, commits: int = 4,
                     payload_kb: int = 8, compute_s: float = 0.05,
                     disk_base_s: float = 0.002,
                     disk_bps: float = 200e6,
                     torn_rank: Optional[int] = None,
                     bitflip_rank: Optional[int] = None) -> Dict:
    """Every rank runs the REAL durable commit protocol
    (core/durable.py) against its own state directory, with injected
    storage damage on two victims' FINAL commit: one torn write (the
    commit never lands — its manifest is truncated) and one bit flip
    (the commit LOOKS landed and only hash verification can reject
    it).  Then all ranks storm the restore path at once: verify local
    snapshots, publish the highest verified seq, and run the
    restore quorum over the simulated KV.  Asserts the agreed restore
    point is the min over per-rank maxima, is durable on EVERY rank,
    and that neither damaged snapshot is ever picked — a victim's
    damage lowers the pick, never diverges it."""
    import shutil as _shutil
    import tempfile

    from ..core import durable as core_durable

    if torn_rank is None:
        torn_rank = max(1, ranks // 4)
    if bitflip_rank is None:
        bitflip_rank = max(2, ranks // 2)
    assert torn_rank != bitflip_rank, "victims must differ"
    kernel, fabric = _fresh(ranks, seed)
    # each commit is two atomic_writes (payload, then manifest); the
    # final commit's payload is ckpt.write invocation 2*commits-1
    last_payload = 2 * commits - 1
    root = tempfile.mkdtemp(prefix="hvtpu-ckpt-storm-")
    commit_t: List[float] = []
    quorum_t: List[float] = []
    best: Dict[int, Optional[int]] = {}
    agreed: Dict[int, Optional[int]] = {}

    def make(rank: int):
        if rank == torn_rank:
            # torn payload AND (via unlimited times) torn manifest of
            # the final commit: the commit point is never reached
            spec = f"ckpt.write:torn@rank={rank},count={last_payload}"
        elif rank == bitflip_rank:
            # one flipped bit in the final payload, manifest intact:
            # the snapshot parses as committed, verification rejects it
            spec = (f"ckpt.write:bitflip@rank={rank},"
                    f"count={last_payload},times=1")
        else:
            spec = ""

        def body():
            d = os.path.join(root, f"rank{rank}")
            ctx = RankContext(kernel, rank, ranks, fault_spec=spec)
            size_b = payload_kb * 1024
            with ctx.activate():
                for seq in range(1, commits + 1):
                    kernel.sleep(compute_s)
                    stamp = f"{seed}/{rank}/{seq}/".encode()
                    data = (stamp * (size_b // len(stamp) + 1))[:size_b]
                    t0 = kernel.now
                    # modeled disk latency (real writes land on tmpfs
                    # in zero virtual time)
                    kernel.sleep(disk_base_s + len(data) / disk_bps)
                    core_durable.write_snapshot(
                        d, seq, {"state.pkl": data}, fsync=False)
                    commit_t.append(kernel.now - t0)
                    kernel.log("ckpt_commit", rank=rank, seq=seq)
                # the restore storm: every rank verifies its local
                # snapshots and votes; min over votes is the pick
                lb = core_durable.latest_verified(d)
                best[rank] = lb
                kernel.log("ckpt_local_best", rank=rank,
                           best=-1 if lb is None else lb)
                t1 = kernel.now
                a = core_durable.restore_quorum(
                    fabric.client(rank, caps="str"), rank=rank,
                    size=ranks, local_best=lb,
                    namespace="hvtpu/ckpt/quorum/0/0", timeout_s=600.0)
                agreed[rank] = a
                quorum_t.append(kernel.now - t1)
                kernel.log("ckpt_quorum", rank=rank,
                           agreed=-1 if a is None else a)
        return body

    try:
        with _env(HVTPU_CKPT_KEEP="2", HVTPU_CKPT_FSYNC="0"):
            for r in range(ranks):
                kernel.spawn(f"rank{r}", make(r))
            kernel.run(max_virtual_s=_DEF_BUDGET_S)

        assert len(agreed) == ranks, "some ranks never finished"
        # undamaged ranks verified their final commit; both victims
        # fell back to the previous one
        for r in range(ranks):
            want = commits - 1 if r in (torn_rank, bitflip_rank) \
                else commits
            assert best[r] == want, (
                f"rank {r} local best {best[r]}, expected {want}")
        # the torn victim's final attempt is visibly UNcommitted; the
        # bitflip victim's is committed-but-rejected (hash mismatch)
        torn_d = core_durable.snapshot_path(
            os.path.join(root, f"rank{torn_rank}"), commits)
        assert core_durable._committed(torn_d) is None, (
            "torn final commit must not reach the commit point")
        flip_d = core_durable.snapshot_path(
            os.path.join(root, f"rank{bitflip_rank}"), commits)
        assert core_durable._committed(flip_d) is not None, (
            "bitflip leaves the manifest intact")
        assert not core_durable.verify_snapshot(flip_d), (
            "bit-flipped payload must fail hash verification")
        # agreement: one value, the min over per-rank maxima, durable
        # (verified) on every rank — the damage delayed the pick, it
        # never diverged it
        picks = set(agreed.values())
        assert picks == {commits - 1}, (
            f"ranks disagree on the restore point: {sorted(picks)}")
        for r in range(ranks):
            p = core_durable.snapshot_path(
                os.path.join(root, f"rank{r}"), commits - 1)
            assert core_durable.verify_snapshot(p), (
                f"agreed commit {commits - 1} not durable on rank {r}")
    finally:
        _shutil.rmtree(root, ignore_errors=True)

    commit_s = sorted(commit_t)
    quorum_s = sorted(quorum_t)
    stats = {"phases": {
        "commit": {
            "commits": len(commit_t),
            "payload_kb": payload_kb,
            "commit_p50_s": round(_pct(commit_s, 0.50), 9),
            "commit_p99_s": round(_pct(commit_s, 0.99), 9),
            "commit_max_s": round(commit_s[-1], 9) if commit_s else 0.0,
        },
        "restore_quorum": {
            "agreed_seq": commits - 1,
            "torn_rank": torn_rank,
            "bitflip_rank": bitflip_rank,
            "quorum_p50_s": round(_pct(quorum_s, 0.50), 9),
            "quorum_max_s": round(quorum_s[-1], 9) if quorum_s else 0.0,
            "virtual_s": round(kernel.now, 6),
        }}, "kv_ops": dict(fabric.ops)}
    return _result("checkpoint-storm", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# compression-negotiation: int8-sidecar agreement through the real
# controller
# ---------------------------------------------------------------------------

def compression_negotiation(ranks: int, seed: int = 0, *,
                            cycles: int = 4, device=None) -> Dict:
    """Mixed-precision negotiation through the REAL EagerController
    over the simulated coordination client: every rank enqueues a dense fp32
    allreduce AND an int8-compressed sidecar (EQuARX-style) each
    cycle.  The wire dtype is the fusion/caching signature, so the
    coordinator must keep the two streams apart and every rank must
    see the SAME negotiated response schedule — int8 ops at the int8
    wire dtype, never fused into the fp32 burst.  Asserts identical
    per-rank schedules and that every future resolves."""
    from ..comm.compression import Int8Compressor
    from ..eager.controller import EagerController
    from ..native import wire

    device = resolve_device(device)
    devices: set = set()
    kernel, fabric = _fresh(ranks, seed)
    int8_id = wire.DTYPE_IDS["int8"]
    schedules: Dict[int, List] = {}
    cycle_times: Dict[int, List[float]] = {}

    def make(rank: int):
        def body():
            ctx = RankContext(kernel, rank, ranks)
            transport = ClientTransport(
                rank, ranks, client=fabric.client(rank, caps="bytes"),
                timeout_s=600.0, poll_s=1.0)
            ctrl = EagerController(rank, ranks, transport=transport,
                                   cycle_time_ms=1.0, manual=True,
                                   device=device)
            devices.add(str(ctrl.device))
            sched = schedules[rank] = []
            times = cycle_times.setdefault(rank, [])
            # spy on the execution dispatch: the one choke point every
            # released ResponseList passes through on BOTH the manual
            # lockstep and the streamed plane — what lands here IS the
            # schedule this rank will execute
            orig = ctrl._dispatch_execution

            def spy(rl):
                for rs in rl.responses:
                    if rs.type == wire.ALLREDUCE:
                        sched.append((tuple(rs.tensor_names), rs.dtype))
                return orig(rl)

            ctrl._dispatch_execution = spy
            with ctx.activate():
                for cycle in range(cycles):
                    t0 = kernel.now
                    dense = ctrl.enqueue(
                        "allreduce", _payload([1.0, float(rank)], device),
                        name=f"dense.{cycle}")
                    sidecar = ctrl.enqueue(
                        "allreduce",
                        _payload([0.5, float(rank), -1.0, 2.0], device),
                        name=f"sidecar.{cycle}",
                        compression=Int8Compressor)
                    ctrl.run_cycle_once()
                    for fut in (dense, sidecar):
                        assert fut.done(), (
                            f"rank {rank} cycle {cycle}: future "
                            "unresolved after the lockstep cycle")
                        fut.result(timeout=0)
                    times.append(kernel.now - t0)
                    kernel.log("negotiated", rank=rank, cycle=cycle)
                ctrl.request_shutdown()
                while not ctrl._shutdown_seen.is_set():
                    ctrl.run_cycle_once()
                ctrl.stop()
        return body

    with patch_data_plane(), _env(HVTPU_EAGER_STREAM=None):
        for r in range(ranks):
            kernel.spawn(f"rank{r}", make(r))
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    assert len(schedules) == ranks, "some ranks never negotiated"
    # agreement: byte-identical negotiated schedule on every rank
    base = schedules[0]
    for r in range(1, ranks):
        assert schedules[r] == base, (
            f"rank {r} negotiated a different schedule:\n"
            f"  rank 0: {base}\n  rank {r}: {schedules[r]}")
    # the int8 sidecars crossed the wire at the int8 dtype, one
    # response per cycle, and never shared a response with fp32 ops
    sidecars = [s for s in base
                if any(n.startswith("sidecar.") for n in s[0])]
    assert len(sidecars) == cycles, (
        f"expected {cycles} sidecar responses, got {sidecars}")
    for names, dtype in sidecars:
        assert dtype == int8_id, (
            f"sidecar response {names} at wire dtype {dtype}, "
            f"expected int8 ({int8_id})")
        assert all(n.startswith("sidecar.") for n in names), (
            f"int8 sidecar fused with non-int8 ops: {names}")
    dense = [s for s in base
             if any(n.startswith("dense.") for n in s[0])]
    assert len(dense) == cycles and all(
        d != int8_id for _, d in dense), (
        f"dense fp32 stream polluted by the sidecar: {dense}")

    all_times = sorted(t for ts in cycle_times.values() for t in ts)
    stats = {"phases": {"negotiate": {
        "cycles": cycles,
        "sidecar_responses": len(sidecars),
        "cycle_p50_s": round(_pct(all_times, 0.50), 9),
        "cycle_max_s": round(all_times[-1], 9) if all_times else 0.0,
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("compression-negotiation", ranks, seed, kernel,
                   stats, devices)


# ---------------------------------------------------------------------------
# anomaly-detection
# ---------------------------------------------------------------------------

def anomaly_detection(ranks: int, seed: int = 0, *, cycles: int = 32,
                      degrade_after: int = 12,
                      straggler: Optional[int] = None,
                      slowdown: float = 400.0) -> Dict:
    """One virtual rank's link degrades mid-run; the REAL
    :class:`~..obs.anomaly.AnomalyEngine`, fed per-cycle arrival skew
    exactly as rank 0's controller drain feeds it, must raise a
    ``straggler`` incident *naming that rank*.  Detection latency =
    virtual seconds from the ``set_link`` degradation to the first
    incident.

    Mechanics: every rank runs ``cycles`` barrier-ish steps — sleep
    (compute), one KV round trip (paying its own link), then posting
    its arrival time.  An aggregator task (the rank-0 role) gathers
    each cycle's arrivals with a single ``dir_get``, computes
    skew/last-arriver, and feeds the engine.  After the aggregator has
    scored ``degrade_after`` healthy cycles it degrades ``straggler``'s
    link ``slowdown``× (latency and bandwidth) via ``set_link``."""
    from ..obs.anomaly import AnomalyConfig, AnomalyEngine

    kernel, fabric = _fresh(ranks, seed)
    if straggler is None:
        straggler = max(1, ranks // 2)
    step_s = 0.25
    engine = AnomalyEngine(
        rank=0, size=ranks,
        config=AnomalyConfig(window=16, warmup=8, threshold=6.0,
                             min_rel=0.5, cooldown_s=0.0))
    degrade_t: List[float] = []
    detect_t: List[float] = []
    skews: List[float] = []

    def worker(rank: int):
        client = fabric.client(rank, caps="str")

        def body():
            ctx = RankContext(kernel, rank, ranks, generation=0)
            with ctx.activate():
                for c in range(cycles):
                    kernel.sleep(step_s)
                    # one round trip on this rank's own link — the
                    # degraded straggler pays its inflated latency
                    # here, so its posted arrival time drifts late.
                    try:
                        client.key_value_try_get("go")
                    except KeyError:
                        pass
                    client.key_value_set(
                        f"arr/{c}/{rank:05d}", repr(kernel.now))
        return body

    def aggregator():
        client = fabric.client(0, caps="dir")
        ctx = RankContext(kernel, 0, ranks, generation=0)
        with ctx.activate():
            for c in range(cycles):
                while True:
                    items = client.key_value_dir_get(f"arr/{c}/")
                    if len(items) >= ranks:
                        break
                    kernel.sleep(0.01)
                arrivals = {int(k.rsplit("/", 1)[1]): float(v)
                            for k, v in items}
                last = max(arrivals, key=lambda r: arrivals[r])
                skew = max(arrivals.values()) - min(arrivals.values())
                skews.append(skew)
                fired = engine.on_arrival_skew(
                    f"grad.{c}", skew, last)
                if fired and not detect_t and any(
                        i["kind"] == "straggler" for i in fired):
                    detect_t.append(kernel.now)
                    kernel.log("straggler_detected", cycle=c,
                               ranks=fired[0]["ranks"])
                client.key_value_delete(f"arr/{c}/")
                if c + 1 == degrade_after:
                    base = fabric.link(straggler)
                    fabric.set_link(
                        straggler,
                        latency_s=base.latency_s * slowdown,
                        bandwidth_bps=base.bandwidth_bps / slowdown)
                    degrade_t.append(kernel.now)
                    kernel.log("link_degraded", rank=straggler,
                               slowdown=slowdown)

    for r in range(ranks):
        kernel.spawn(f"rank{r}", worker(r))
    kernel.spawn("aggregator", aggregator)
    kernel.run(max_virtual_s=_DEF_BUDGET_S)

    incidents = [i for i in engine.incidents()
                 if i["kind"] == "straggler"]
    assert degrade_t, "degradation never happened"
    assert incidents, (
        f"no straggler incident after a {slowdown}x link degradation "
        f"of rank {straggler}")
    first = incidents[0]
    assert first["ranks"] == [straggler], (
        f"incident blamed ranks {first['ranks']}, expected "
        f"[{straggler}]")
    assert detect_t and detect_t[0] >= degrade_t[0], (
        "incident fired before the degradation")
    healthy = sorted(skews[:degrade_after])
    stats = {"phases": {"detect": {
        "cycles": cycles,
        "straggler_rank": straggler,
        "blamed_ranks": first["ranks"],
        "slowdown": slowdown,
        "incidents": len(incidents),
        "first_zscore": first["zscore"],
        "healthy_skew_p50_s": round(_pct(healthy, 0.50), 9),
        "degrade_t_s": round(degrade_t[0], 6),
        "detect_t_s": round(detect_t[0], 6),
        "detection_latency_s": round(detect_t[0] - degrade_t[0], 6),
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("anomaly-detection", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# coordinator-loss
# ---------------------------------------------------------------------------

def coordinator_loss(ranks: int, seed: int = 0, *, steps_before: int = 2,
                     steps_after: int = 2, lease_s: float = 2.0,
                     hb_s: float = 0.25, slots_per_host: int = 8,
                     cooldown_s: float = 60.0) -> Dict:
    """The coordination service's HOST dies mid-run: every rank's KV
    lease expires (real FencedKV self-fencing over a downed fabric →
    virtual exit 89), the virtual driver blacklists the coordinator
    host in the REAL HostManager and re-elects the coordinator address
    via the REAL ``_default_coordinator_addr`` over the surviving
    slots, and the relaunched generation replays each rank's journaled
    durable keys (real KeyJournal) into the fresh, EMPTY fabric.
    Asserts: every rank fences (no zombies), the re-elected address
    moves off the dead host, every journaled key is visible to every
    gen-1 rank, and per-rank commit accounting is exactly-once across
    the restart."""
    import shutil
    import tempfile

    from ..core.journal import KeyJournal
    from ..core.retry import FENCE_EXIT_CODE, FencedKV
    from ..elastic.discovery import HostManager
    from ..obs import metrics as obs_metrics
    from ..runner.hosts import HostSlots, get_host_assignments
    from ..runner.launch import _default_coordinator_addr

    kernel, fabric0 = _fresh(ranks, seed)
    # one SPARE host beyond what the ranks need: losing the coordinator
    # host must leave enough slots to re-place the world
    n_hosts = (ranks + slots_per_host - 1) // slots_per_host + 1
    hosts = {f"host{h}": slots_per_host for h in range(n_hosts)}
    down_at_s = steps_before * hb_s + 0.2
    jdir = tempfile.mkdtemp(prefix="hvtsim-kvjournal-")
    fabrics: Dict[str, SimFabric] = {"gen0": fabric0}
    down_t: List[float] = []
    fence_t: Dict[int, float] = {}
    recover_t: Dict[int, float] = {}
    committed0: Dict[int, int] = {}
    committed1: Dict[int, int] = {}
    replayed: Dict[int, int] = {}
    votes_seen: Dict[int, int] = {}
    gen1_tasks: Dict[int, object] = {}
    election: Dict[str, str] = {}
    fence_exits_before = obs_metrics.counter(
        "hvtpu_fence_exits_total").value()

    def make_gen0(rank: int):
        def body():
            ctx = RankContext(kernel, rank, ranks, generation=0)
            client = fabric0.client(rank, caps="dir")

            def exit_fn(code):
                fence_t[rank] = kernel.now
                ctx.request_exit(code)

            with ctx.activate():
                kv = FencedKV(client, rank=rank, job_epoch=0,
                              generation=0, lease_s=lease_s,
                              check_every=10_000, exit_fn=exit_fn,
                              journal=KeyJournal(jdir, rank=rank))
                kv.add_journal_prefix("hvtdur/")
                # one durable key per rank (a restore-quorum-style
                # vote) — the history the fresh coordinator cannot
                # recompute
                kv.key_value_set(f"hvtdur/vote/{rank}", str(100 + rank))
                committed0[rank] = 0
                for step in range(steps_before):
                    kernel.sleep(hb_s)
                    kv.key_value_set(f"hb/{rank}", str(step))
                    committed0[rank] += 1
                # the outage begins: keep heartbeating until the lease
                # fences us (retry exhaustion raises; the lease check
                # in FencedKV._guarded eventually calls exit_fn)
                while True:
                    kernel.sleep(hb_s)
                    try:
                        kv.key_value_set(f"hb/{rank}", "outage")
                        committed0[rank] += 1
                    except Exception:
                        pass
        return body

    def chaos():
        kernel.sleep(down_at_s)
        fabric0.set_down(True)
        down_t.append(kernel.now)
        kernel.log("coordinator_down", host="host0",
                   t=round(kernel.now, 9))

    def make_gen1(rank: int):
        def body():
            ctx = RankContext(kernel, rank, ranks, generation=1)
            client = fabrics["gen1"].client(rank, caps="dir")
            with ctx.activate():
                journal = KeyJournal(jdir, rank=rank)
                kv = FencedKV(client, rank=rank, job_epoch=0,
                              generation=1, lease_s=lease_s,
                              exit_fn=ctx.request_exit,
                              journal=journal)
                kv.add_journal_prefix("hvtdur/")
                replayed[rank] = journal.replay(kv)
                committed1[rank] = 0
                for step in range(steps_after):
                    kernel.sleep(hb_s)
                    kv.key_value_set(f"hb/{rank}", str(step))
                    committed1[rank] += 1
                # every rank's journaled vote must be visible again
                while len(kv.key_value_dir_get("hvtdur/vote/")) < ranks:
                    kernel.sleep(0.1)
                votes_seen[rank] = len(
                    kv.key_value_dir_get("hvtdur/vote/"))
                recover_t[rank] = kernel.now
        return body

    def driver():
        hm = HostManager(_StaticDiscovery(hosts),
                         cooldown_base_s=cooldown_s,
                         cooldown_max_s=8 * cooldown_s)
        hm.refresh()
        all_slots = [HostSlots(h, s) for h, s in sorted(hosts.items())]
        election["old"] = _default_coordinator_addr(
            get_host_assignments(all_slots, ranks))
        # wait for every gen-0 rank to fence itself
        while not all(t.done for t in gen0_tasks.values()):
            kernel.sleep(0.2)
        hm.blacklist_host("host0")
        hm.refresh()
        surviving = [HostSlots(h, s)
                     for h, s in sorted(hm.current.items())]
        election["new"] = _default_coordinator_addr(
            get_host_assignments(surviving, ranks))
        kernel.log("coordinator_reelected", old=election["old"],
                   new=election["new"], t=round(kernel.now, 9))
        # relaunch everyone against a FRESH fabric (the relaunched
        # coordination service starts empty — the split this scenario
        # measures journal replay against)
        fabrics["gen1"] = SimFabric(kernel)
        for r in range(ranks):
            gen1_tasks[r] = kernel.spawn(f"gen1-rank{r}", make_gen1(r))
        kernel.log("relaunched", generation=1, ranks=ranks)

    try:
        with _env(HVTPU_AUDIT_EVERY="0", HVTPU_ELASTIC_STATE_DIR=None,
                  HVTPU_KV_FENCE_DISABLE=None, HVTPU_JOB_EPOCH=None):
            gen0_tasks = {r: kernel.spawn(f"rank{r}", make_gen0(r))
                          for r in range(ranks)}
            kernel.spawn("chaos", chaos)
            kernel.spawn("driver", driver)
            kernel.run(max_virtual_s=_DEF_BUDGET_S)
    finally:
        shutil.rmtree(jdir, ignore_errors=True)

    # every gen-0 rank self-fenced (closed split brain: no zombies)
    for r, t in gen0_tasks.items():
        assert t.exit_code == FENCE_EXIT_CODE, (
            f"gen-0 rank {r} exited {t.exit_code}, expected "
            f"{FENCE_EXIT_CODE}")
    fence_exits = (obs_metrics.counter("hvtpu_fence_exits_total").value()
                   - fence_exits_before)
    assert fence_exits >= ranks
    assert election["new"] != election["old"], election
    assert election["new"] != "host0"
    detect = sorted(fence_t[r] - down_t[0] for r in range(ranks))
    assert detect[0] >= 0.0
    assert detect[-1] <= lease_s + 10.0, (
        f"slowest fence took {detect[-1]}s past the outage")
    for r in range(ranks):
        assert committed0[r] == steps_before, (
            f"rank {r} gen-0 committed {committed0[r]} (outage writes "
            f"must not count)")
        assert committed1[r] == steps_after
        assert replayed[r] == 1, (
            f"rank {r} replayed {replayed[r]} keys, expected its vote")
        assert votes_seen[r] == ranks
    fence_to_recover = max(recover_t.values()) - max(fence_t.values())
    stats = {"phases": {"coordinator_loss": {
        "hosts": n_hosts,
        "down_t_s": round(down_t[0], 6),
        "detect_p50_s": round(_pct(detect, 0.50), 6),
        "detect_max_s": round(detect[-1], 6),
        "fence_exits": ranks,
        "old_coordinator": election["old"],
        "new_coordinator": election["new"],
        "replayed_keys": sum(replayed.values()),
        "fence_to_recover_s": round(fence_to_recover, 6),
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": {"gen0": dict(fabric0.ops),
                   "gen1": dict(fabrics["gen1"].ops)}}
    return _result("coordinator-loss", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# partition-storm
# ---------------------------------------------------------------------------

def partition_storm(ranks: int, seed: int = 0, *,
                    window_ms: float = 3000.0, hb_s: float = 0.5,
                    stale_s: float = 2.0, suspect_s: float = 3.0,
                    lease_s: float = 1.5, n_victims: int = 3,
                    total_s: float = 10.0) -> Dict:
    """A burst of network partitions under live heartbeat evaluation:
    ``n_victims`` ranks each get a first-class ``partition(MS)`` fault
    clause (core/faults.py) that silently drops their kv.get/kv.put/
    heartbeat traffic for a seeded window.  Peers running the REAL
    AmortizedStallInspector classify them as partition SUSPECTS (blame
    held) and then see them either recover (window < stale+suspect) or
    — for the one victim carrying a KV lease — self-fence via the real
    FencedKV lease check (virtual exit 89).  Asserts: suspects are
    detected and resolved, no surviving rank latches a false stall
    failure, the leased victim fences, and the suspect-seconds
    histogram observed the episode."""
    from ..comm.stall import AmortizedStallInspector
    from ..core import faults as core_faults
    from ..core.retry import FENCE_EXIT_CODE, FencedKV
    from ..obs import metrics as obs_metrics

    n_victims = max(1, min(n_victims, max(1, ranks // 2)))
    # victims spread across the world; the LAST one carries the lease
    victims = [1 + i * max(1, (ranks - 1) // (n_victims + 1))
               for i in range(n_victims)]
    victims = sorted(set(min(v, ranks - 1) for v in victims))
    fence_victim = victims[-1]
    # the leased victim's window outlasts stale+suspect (it would be
    # classified dead) — but its lease fences it first
    fence_window_ms = (stale_s + suspect_s + 4.0) * 1000.0
    kernel, fabric = _fresh(ranks, seed)
    observer_rank = 0
    assert observer_rank not in victims
    window_open_t: Dict[int, float] = {}
    fence_t: List[float] = []
    suspect_seen_t: Dict[int, float] = {}
    suspect_gone_t: Dict[int, float] = {}
    inspectors: Dict[int, AmortizedStallInspector] = {}
    steps_done: Dict[int, int] = {}
    hist = obs_metrics.histogram("hvtpu_partition_suspect_seconds")

    def _hist_count() -> int:
        return sum(cell[2] for cell in hist._values.values())

    hist_before = _hist_count()
    fence_exits_before = obs_metrics.counter(
        "hvtpu_fence_exits_total").value()

    def make(rank: int):
        # window opens at this victim's 4th beat (count=4): peers have
        # a healthy baseline before the silence starts
        if rank == fence_victim:
            spec = (f"heartbeat:partition({fence_window_ms:g})"
                    f"@rank={rank},count=4,times=1")
        elif rank in victims:
            spec = (f"heartbeat:partition({window_ms:g})"
                    f"@rank={rank},count=4,times=1")
        else:
            spec = ""

        def body():
            ctx = RankContext(kernel, rank, ranks, fault_spec=spec,
                              generation=0)
            client = fabric.client(rank, caps="dir")

            def exit_fn(code):
                fence_t.append(kernel.now)
                ctx.request_exit(code)

            with ctx.activate():
                kv = FencedKV(
                    client, rank=rank, job_epoch=0, generation=0,
                    lease_s=(lease_s if rank == fence_victim else 0.0),
                    check_every=10_000, exit_fn=exit_fn)
                insp = AmortizedStallInspector(
                    kv, rank, warn_s=60.0, abort_s=600.0,
                    heartbeat_s=hb_s, generation=0, stale_s=stale_s,
                    suspect_s=suspect_s, start_heartbeat=False)
                inspectors[rank] = insp
                steps_done[rank] = 0
                beats = int(total_s / hb_s)
                for step in range(beats):
                    ctx.check_exit()
                    kernel.sleep(hb_s)
                    insp._beat_once()
                    # work-plane KV op: dropped inside the victim's
                    # partition window — what starves the lease
                    kv.key_value_set(f"work/{rank}", str(step))
                    steps_done[rank] += 1
                    if (rank in victims and rank not in window_open_t
                            and core_faults.partition_remaining() > 0):
                        window_open_t[rank] = kernel.now
                        kernel.log("partition_window_open", rank=rank)
                insp.stop()
        return body

    def observer():
        # watch the observer rank's inspector classify the silence
        while observer_rank not in inspectors:
            kernel.sleep(0.05)
        insp = inspectors[observer_rank]
        end = total_s + 5.0
        while kernel.now < end:
            suspects = set(insp.debug_state()["partition_suspects"])
            for v in victims:
                if v in suspects and v not in suspect_seen_t:
                    suspect_seen_t[v] = kernel.now
                if (v in suspect_seen_t and v not in suspects
                        and v not in suspect_gone_t):
                    suspect_gone_t[v] = kernel.now
            kernel.sleep(0.1)

    with _env(HVTPU_AUDIT_EVERY="0", HVTPU_PARTITION_SUSPECT_S=None,
              HVTPU_KV_FENCE_DISABLE=None, HVTPU_JOB_EPOCH=None):
        tasks = {r: kernel.spawn(f"rank{r}", make(r))
                 for r in range(ranks)}
        kernel.spawn("observer", observer)
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    assert tasks[fence_victim].exit_code == FENCE_EXIT_CODE, (
        f"leased victim exited {tasks[fence_victim].exit_code}, "
        f"expected {FENCE_EXIT_CODE}")
    fence_exits = (obs_metrics.counter("hvtpu_fence_exits_total").value()
                   - fence_exits_before)
    assert fence_exits >= 1
    for r, insp in inspectors.items():
        if r == fence_victim:
            continue
        assert insp.failure is None, (
            f"rank {r} latched a false stall failure during the "
            f"partition storm: {insp.failure}")
    recovered = [v for v in victims if v != fence_victim]
    for v in recovered:
        assert steps_done[v] == int(total_s / hb_s), (
            f"recovered victim {v} finished {steps_done[v]} steps")
        assert v in suspect_seen_t, (
            f"victim {v} was never classified a partition suspect")
        assert v in suspect_gone_t, (
            f"victim {v} never left the suspect state")
    assert _hist_count() - hist_before >= 1, (
        "the suspect-seconds histogram observed nothing")
    detect = sorted(suspect_seen_t[v] - window_open_t[v]
                    for v in victims if v in suspect_seen_t
                    and v in window_open_t)
    fence_latency = (fence_t[0] - window_open_t[fence_victim]
                     if fence_t and fence_victim in window_open_t
                     else 0.0)
    stats = {"phases": {"partition_storm": {
        "victims": victims,
        "fence_victim": fence_victim,
        "window_ms": window_ms,
        "detect_p50_s": round(_pct(detect, 0.50), 6),
        "detect_max_s": round(detect[-1], 6) if detect else 0.0,
        "fence_latency_s": round(fence_latency, 6),
        "recovered": len(recovered),
        "suspect_observations": _hist_count() - hist_before,
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("partition-storm", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# fleet-service: the production front door under a submission storm
# ---------------------------------------------------------------------------

class _ServiceJobRunner:
    """Fleet-service job handle in pure virtual time: no per-job
    kernel task, so a 5000-job storm costs O(jobs) small objects, not
    O(jobs) threads.  The REAL arbiter drives it entirely through the
    runner protocol (start/poll/phase/request_shrink/escalate/stop);
    progress, drain landings and whole-job stops are lazy functions of
    ``kernel.now`` evaluated at each reap."""

    def __init__(self, job, kernel: SimKernel, duration_s: float,
                 drain_s: float, on_start=None):
        self.name = job.spec.name
        self.kernel = kernel
        self.duration_s = duration_s
        self.drain_s = drain_s
        self.charged_restarts = 0
        self.health_dir = None
        self._on_start = on_start
        self._alloc: Dict[str, int] = {}
        self._start_t: Optional[float] = None
        self._stop_t: Optional[float] = None  # whole-job drain lands
        self._shrink: Optional[tuple] = None  # (new_np, land_t)
        self._exit: Optional[int] = None

    def start(self, alloc: Dict[str, int]) -> None:
        self._alloc = dict(alloc)
        self._start_t = self.kernel.now
        if self._on_start is not None:
            self._on_start(self)

    def _land_shrink(self) -> None:
        new_np, _land_t = self._shrink
        self._shrink = None
        # the drained gang leaves name-largest hosts first: a unique,
        # replayable trim order
        cur = sum(self._alloc.values())
        for h in sorted(self._alloc, reverse=True):
            if cur <= new_np:
                break
            drop = min(self._alloc[h], cur - new_np)
            self._alloc[h] -= drop
            cur -= drop
            if self._alloc[h] <= 0:
                del self._alloc[h]

    def _advance(self) -> None:
        now = self.kernel.now
        if self._exit is not None:
            return
        if self._shrink is not None and now >= self._shrink[1]:
            self._land_shrink()
        if self._stop_t is not None:
            if now >= self._stop_t:
                self._exit = 0
        elif (self._start_t is not None
              and now >= self._start_t + self.duration_s):
            self._exit = 0

    def poll(self) -> Optional[int]:
        self._advance()
        return self._exit

    def phase(self) -> str:
        self._advance()
        return "resizing" if self._shrink is not None else "running"

    def target_np(self) -> Optional[int]:
        return self._shrink[0] if self._shrink is not None else None

    def current_np(self) -> int:
        return sum(self._alloc.values())

    def allocation(self) -> Dict[str, int]:
        return dict(self._alloc)

    def update_allocation(self, alloc: Dict[str, int]) -> None:
        self._alloc = dict(alloc)

    def request_shrink(self, new_np: int) -> bool:
        if self._start_t is None or self._exit is not None:
            return False
        self._shrink = (new_np, self.kernel.now + self.drain_s)
        return True

    def escalate(self) -> int:
        if self._shrink is None:
            return 0
        lag = max(0, self.current_np() - self._shrink[0])
        self._land_shrink()
        return lag

    def stop(self) -> None:
        if self._exit is None and self._stop_t is None:
            self._stop_t = self.kernel.now + self.drain_s


def fleet_service(ranks: int, seed: int = 0, *,
                  n_jobs: Optional[int] = None,
                  slots_per_host: int = 8, tick_s: float = 0.5,
                  grace_s: float = 20.0, intake_budget: int = 256,
                  queue_limit: Optional[int] = None,
                  starvation_s: float = 60.0,
                  aging_slack_s: float = 150.0,
                  window_s: Optional[float] = None,
                  restart_delay_s: float = 3.0) -> Dict:
    """The production front door end to end: a seeded storm of mixed
    tenants/tiers/sizes submitted through the REAL indexed journal
    (``fleet/intake.py``) into the REAL arbiter, with per-tenant
    quotas from a real ``tenants.json``, the weighted fair-share and
    starvation-guard scheduling order, torus-aware placement, truthful
    queue-full backpressure (clients retry after the advertised
    delay), random cancels, and an injected arbiter crash that rolls
    the intake cursor back several batches mid-storm.  Asserts
    exactly-once intake across the crash (replays dedupe, nothing runs
    twice, nothing is lost), a per-tick intake cost bounded by the
    budget (O(new-entries), zero on quiet ticks), quota rejections
    that name tenant and limit, a bounded post-aging wait for the
    starved min-priority probe gang, and gang placements that never
    overcommit a host."""
    import shutil as _shutil
    import tempfile

    from ..fleet import (FleetArbiter, JobSpec, QueueFullError,
                         SubmitJournal)

    kernel, fabric = _fresh(ranks, seed)
    n_hosts = max(1, (ranks + slots_per_host - 1) // slots_per_host)
    hosts = {f"host{h:04d}": slots_per_host for h in range(n_hosts)}
    pool_slots = n_hosts * slots_per_host
    if n_jobs is None:
        # ~2.5 jobs per pool slot keeps utilisation (and therefore
        # contention) scale-invariant, capped at the 5000-submission
        # storm the intake protocol is sized for
        n_jobs = max(120, min(5000, pool_slots * 5 // 2))
    if queue_limit is None:
        queue_limit = max(64, n_jobs // 3)
    if window_s is None:
        # sized for ~0.85 pool utilisation at the mean job (3 slots x
        # 30 virtual s), floored so small pools still see a real storm
        window_s = max(240.0, n_jobs * 90.0 / (0.85 * pool_slots))
    # the journal/cursor/state.json are REAL files with real fsyncs;
    # tmpfs keeps the per-tick fsync from dominating the run (the
    # protocol under test is unchanged — same checkpoint-storm trick)
    fleet_dir = tempfile.mkdtemp(
        prefix="hvtpu-fleet-service-",
        dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    with open(os.path.join(fleet_dir, "tenants.json"), "w") as f:
        json.dump({
            "prod": {"weight": 3.0},
            "batch": {"weight": 1.0},
            "guest": {"weight": 1.0,
                      "max_ranks": max(8, pool_slots // 8),
                      "max_queued": 4},
            "*": {"weight": 1.0},
        }, f)

    # -- the seeded arrival plan (all randomness drawn up front) -------
    r = kernel.rng("fleet-service")
    tier_of = {"prod": 10, "guest": 5, "batch": 0}
    storm_t = round(window_s * 0.4, 3)
    n_storm = int(n_jobs * 0.4)
    plan: List[tuple] = []  # (t, op, payload)
    meta: Dict[str, dict] = {}  # name -> tenant/priority/duration
    for i in range(n_jobs):
        name = f"job{i:05d}"
        tenant = r.choice(("prod", "prod", "batch", "batch", "batch",
                           "guest"))
        size = r.choice((1, 1, 2, 2, 2, 4, 4, 8))
        elastic = r.random() < 0.3
        dur = round(r.uniform(15.0, 45.0), 3)
        t = (storm_t if i < n_storm
             else round(r.uniform(0.0, window_s), 3))
        spec = JobSpec(name, ["sim"], priority=tier_of[tenant],
                       min_np=size,
                       max_np=(2 * size if elastic else size),
                       tenant=tenant).to_dict()
        meta[name] = {"tenant": tenant, "priority": tier_of[tenant],
                      "duration": dur}
        plan.append((t, "submit", spec))
        if r.random() < 0.06:
            plan.append((round(t + r.uniform(0.05, 20.0), 3),
                         "cancel", name))
    # the starvation probe: a min-priority HALF-POOL gang submitted
    # right into the storm — backfill keeps eating its capacity until
    # the aging guard boosts it over every tier
    probe_np = max(2, pool_slots // 2)
    probe = JobSpec("probe-batch", ["sim"], priority=0,
                    min_np=probe_np, tenant="batch").to_dict()
    meta["probe-batch"] = {"tenant": "batch", "priority": 0,
                           "duration": 30.0}
    plan.append((storm_t, "submit", probe))
    plan.sort(key=lambda e: e[0])

    journal = SubmitJournal(fleet_dir)
    submit_t: Dict[str, float] = {}
    seq_name: Dict[int, str] = {}
    intake_c = {"queue_full": 0, "max_attempts": 0}
    submit_done: List[bool] = []
    runners: Dict[str, _ServiceJobRunner] = {}
    overcommit: List[str] = []
    gang_spread: List[int] = []

    def on_start(runner: _ServiceJobRunner) -> None:
        usage: Dict[str, int] = {}
        for rn in runners.values():
            if rn._exit is None:
                for h, n in rn._alloc.items():
                    usage[h] = usage.get(h, 0) + n
        for h, used in usage.items():
            if used > hosts[h]:
                overcommit.append(
                    f"{h}: {used}/{hosts[h]} at {runner.name}")
        gang_spread.append(len(runner._alloc))

    def hash0(name: str) -> int:
        # a tiny deterministic per-name hash (builtin hash() is
        # salted per process and would break replay)
        v = 0
        for ch in name:
            v = (v * 131 + ord(ch)) % 100003
        return v

    def make_runner(job):
        rn = _ServiceJobRunner(
            job, kernel,
            duration_s=meta[job.spec.name]["duration"],
            drain_s=round(2.0 + (hash0(job.spec.name) % 60) / 10.0, 1),
            on_start=on_start)
        runners[job.spec.name] = rn
        return rn

    def submitter():
        for t, op, payload in plan:
            if kernel.now < t:
                kernel.sleep(t - kernel.now)
            if op == "cancel":
                journal.append_cancel(payload)
                continue
            attempts = 0
            while True:
                attempts += 1
                try:
                    seq = journal.append_submit(payload)
                    break
                except QueueFullError as e:
                    # the advertised retry-after is truthful: wait it
                    # out (plus one tick of margin) and try again
                    intake_c["queue_full"] += 1
                    kernel.sleep(e.retry_after_s + tick_s)
            intake_c["max_attempts"] = max(intake_c["max_attempts"],
                                           attempts)
            submit_t[payload["name"]] = kernel.now
            seq_name[seq] = payload["name"]
        submit_done.append(True)
        kernel.log("fleet_service.submitted", jobs=len(submit_t),
                   queue_full=intake_c["queue_full"])

    arbiters: List[FleetArbiter] = []
    cursor_hist: List[bytes] = []
    crashed: List[bool] = []
    batch_sizes: List[int] = []
    frag_samples: List[float] = []
    crash_t = storm_t + 4 * tick_s

    def make_arbiter() -> FleetArbiter:
        return FleetArbiter(
            _StaticDiscovery(hosts), fleet_dir=fleet_dir,
            tick_s=tick_s, drain_grace_s=grace_s,
            runner_factory=make_runner, event_fn=kernel.log,
            register_debug=False)

    def arbiter_task():
        arb = make_arbiter()
        arbiters.append(arb)
        last_seq = 0
        ticks = 0
        while True:
            if not crashed and kernel.now >= crash_t:
                crashed.append(True)
                # injected crash BETWEEN batch-apply and cursor
                # commit: the dead incarnation's runners vanish with
                # it and the cursor wakes up several batches stale —
                # the replay must dedupe, not double-run
                for rn in runners.values():
                    if rn._exit is None:
                        rn._exit = -1
                if len(cursor_hist) >= 3:
                    with open(journal.cursor_path, "wb") as f:
                        f.write(cursor_hist[-3])
                kernel.log("fleet_service.crash",
                           live=sum(1 for j in arb.jobs.values()
                                    if not j.terminal))
                kernel.sleep(restart_delay_s)
                arb = make_arbiter()
                arbiters.append(arb)
                n = arb.recover()
                kernel.log("fleet_service.recover", jobs=n)
                last_seq = int(
                    journal.read_cursor().get("seq", 0) or 0)
            arb.tick()
            ticks += 1
            cur_seq = int(journal.read_cursor().get("seq", 0) or 0)
            batch_sizes.append(cur_seq - last_seq)
            last_seq = cur_seq
            try:
                with open(journal.cursor_path, "rb") as f:
                    cursor_hist.append(f.read())
            except OSError:
                cursor_hist.append(b"")
            del cursor_hist[:-8]
            if ticks % 16 == 0:
                with arb._lock:
                    frag_samples.append(arb._placement.fragmentation(
                        arb._free_map(), arb.hosts.current))
            if (submit_done and journal.depth() == 0
                    and arb.all_terminal()):
                break
            kernel.sleep(tick_s)
        kernel.log("fleet_service.arbiter_done", ticks=ticks,
                   jobs=len(arb.jobs))

    with _env(HVTPU_FLEET_INTAKE_BUDGET=str(intake_budget),
              HVTPU_FLEET_QUEUE_LIMIT=str(queue_limit),
              HVTPU_FLEET_STARVATION_SECONDS=str(starvation_s),
              HVTPU_ELASTIC_STATE_DIR=None, HVTPU_FLEET_DIR=None):
        kernel.spawn("submitter", submitter)
        kernel.spawn("arbiter", arbiter_task)
        try:
            kernel.run(max_virtual_s=_DEF_BUDGET_S)
        finally:
            _shutil.rmtree(fleet_dir, ignore_errors=True)

    # -- fold the event log --------------------------------------------
    first_submit: Dict[str, float] = {}
    waits: Dict[int, List[float]] = {0: [], 5: [], 10: []}
    done_counts: Dict[str, int] = {}
    rejected: Dict[str, List[str]] = {}
    aged_t: Dict[str, float] = {}
    start_t: Dict[str, float] = {}
    quota_waited: set = set()
    dup_replays = 0
    preempts = 0
    for ev in kernel.events:
        kind = ev["kind"]
        if kind == "fleet.submit":
            first_submit.setdefault(ev["job"], ev["t"])
        elif kind == "fleet.job_start":
            start_t.setdefault(ev["job"], ev["t"])
            m = meta.get(ev["job"])
            if m is not None:
                waits[m["priority"]].append(ev["queue_wait_s"])
            # the aging guard's contract: NOTHING waits past the
            # threshold without being boosted (a job_aged event)
            if ev["queue_wait_s"] > starvation_s + 2 * tick_s:
                assert ev["job"] in aged_t, (
                    f"{ev['job']} waited {ev['queue_wait_s']:.1f}s "
                    f"(> {starvation_s}s guard) without aging")
        elif kind == "fleet.job_end":
            if ev["state"] == "DONE":
                done_counts[ev["job"]] = (
                    done_counts.get(ev["job"], 0) + 1)
        elif kind == "fleet.submit_rejected":
            sq = ev["spool"]
            if sq.startswith("journal-"):
                nm = seq_name.get(int(sq[len("journal-"):]), sq)
                rejected.setdefault(nm, []).append(ev["error"])
        elif kind == "fleet.journal_duplicate":
            dup_replays += 1
        elif kind == "fleet.job_aged":
            aged_t.setdefault(ev["job"], ev["t"])
        elif kind == "fleet.quota_wait":
            quota_waited.add(ev["job"])
        elif kind == "fleet.preempt":
            preempts += 1

    # exactly-once across the crash: every accepted submission is
    # terminal in exactly one incarnation's ledger, nothing ran twice,
    # nothing was lost
    arb1 = arbiters[0]
    arb2 = arbiters[-1]
    lost = []
    for name in submit_t:
        j = arb2.jobs.get(name) or arb1.jobs.get(name)
        if j is not None and j.terminal:
            continue
        if name in rejected:
            continue  # refused with a durable, named error
        lost.append(name)
    assert not lost, f"{len(lost)} submissions lost: {lost[:5]}"
    twice = {n: c for n, c in done_counts.items() if c > 1}
    assert not twice, f"jobs completed more than once: {twice}"
    dup_rejects = [e for msgs in rejected.values() for e in msgs
                   if "already exists" in e]
    assert not dup_rejects, (
        f"replay surfaced as duplicate-name rejection: "
        f"{dup_rejects[:3]}")
    assert len(arbiters) == 2 and crashed, "crash was never injected"
    assert dup_replays >= 1, (
        "the rolled-back cursor replayed no batch — the crash window "
        "closed without exercising dedupe")
    # intake is O(new-entries): every tick applies at most the budget,
    # and quiet ticks touch zero records
    assert batch_sizes and max(batch_sizes) <= intake_budget, (
        f"a tick applied {max(batch_sizes)} records "
        f"(budget {intake_budget})")
    assert intake_c["queue_full"] >= 1, (
        "the storm never hit the queue limit — backpressure untested")
    # quota rejections are actionable: tenant and limit named
    guest_rejects = [e for msgs in rejected.values() for e in msgs
                     if "tenant 'guest'" in e and "max_queued" in e]
    assert guest_rejects, "no quota rejection named tenant 'guest'"
    # the starvation guard bounds the probe's post-aging wait: boosted
    # over every tier, it starts within the aging slack + one drain
    probe_j = (arb2.jobs.get("probe-batch")
               or arb1.jobs.get("probe-batch"))
    assert probe_j is not None and probe_j.state == "DONE", (
        f"probe ended {probe_j and probe_j.state}")
    assert ("probe-batch" in aged_t
            or (probe_j.queue_wait_s or 0.0)
            <= starvation_s + 2 * tick_s), (
        f"probe waited {probe_j.queue_wait_s}s without aging")
    if "probe-batch" in aged_t:
        gap = start_t["probe-batch"] - aged_t["probe-batch"]
        assert gap <= aging_slack_s + grace_s, (
            f"aged probe waited {gap:.1f}s past the guard "
            f"(slack {aging_slack_s}+{grace_s})")
    assert not overcommit, f"host overcommit: {overcommit[:3]}"

    lat = sorted(first_submit[n] - submit_t[n]
                 for n in submit_t if n in first_submit)
    aged_gaps = sorted(start_t[n] - aged_t[n] for n in aged_t
                       if n in start_t and n not in quota_waited)
    for w in waits.values():
        w.sort()
    frag_samples.sort()
    n_cancelled = sum(
        1 for n in submit_t
        if ((arb2.jobs.get(n) or arb1.jobs.get(n)) is not None
            and (arb2.jobs.get(n) or arb1.jobs.get(n)).cancelled))
    stats = {"phases": {
        "pool": {"hosts": n_hosts, "slots": pool_slots,
                 "jobs": n_jobs, "storm": n_storm,
                 "queue_limit": queue_limit},
        "intake": {
            "appended": len(submit_t),
            "queue_full_rejections": intake_c["queue_full"],
            "max_attempts": intake_c["max_attempts"],
            "max_batch": max(batch_sizes),
            "budget": intake_budget,
            "idle_ticks": sum(1 for b in batch_sizes if b == 0),
            "intake_p50_s": round(_pct(lat, 0.50), 6),
            "intake_p99_s": round(_pct(lat, 0.99), 6),
        },
        "admission": {
            "rejected": len(rejected),
            "quota_waits": len(quota_waited),
        },
        "crash": {"incarnations": len(arbiters),
                  "recovered": sum(
                      1 for e in kernel.events
                      if e["kind"] == "fleet.recover"),
                  "replayed_duplicates": dup_replays},
        "service": {
            "queue_wait_p50_s": {
                str(p): round(_pct(w, 0.50), 6)
                for p, w in sorted(waits.items())},
            "queue_wait_p99_s": {
                str(p): round(_pct(w, 0.99), 6)
                for p, w in sorted(waits.items())},
            "preemptions": preempts,
            "aged_jobs": len(aged_t),
            "aged_gap_max_s": (round(aged_gaps[-1], 6)
                               if aged_gaps else 0.0),
            "probe_wait_s": round(
                probe_j.queue_wait_s or 0.0, 6),
        },
        "placement": {
            "frag_mean": (round(sum(frag_samples)
                                / len(frag_samples), 6)
                          if frag_samples else 0.0),
            "frag_max": (round(frag_samples[-1], 6)
                         if frag_samples else 0.0),
            "single_host_gangs": (
                round(sum(1 for g in gang_spread if g == 1)
                      / len(gang_spread), 6) if gang_spread else 0.0),
        },
        "done": {
            "done": sum(done_counts.values()),
            "cancelled": n_cancelled,
            "virtual_s": round(kernel.now, 6),
        },
    }, "kv_ops": dict(fabric.ops)}
    return _result("fleet-service", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# lossy-link: wire-plane consensus abort-and-retry + route-around
# ---------------------------------------------------------------------------

def lossy_link(ranks: int, seed: int = 0, *, steps: int = 10,
               retries: int = 3, loss_prob: float = 0.2,
               flap_down_s: float = 3.0, hop_timeout_s: float = 2.0,
               consensus_s: float = 30.0, baseline: bool = False) -> Dict:
    """The wire plane under a lossy fabric: each step is one ring
    exchange (every rank sends a deterministic payload to its ring
    successor over a :class:`~.fabric.EdgeModel` data edge and blocks
    on its predecessor's, then a done-gather + commit barrier seals the
    step).  Three victims shape the chaos: ``va`` gets two
    deterministic ``wire.send:drop`` fault firings (core/faults.py,
    the new parser-gated wire site), ``vb``'s outgoing edge FLAPS for
    ``flap_down_s`` mid-run (``SimFabric.flap``), and ``vc``'s
    outgoing edge drops each send with seeded probability
    ``loss_prob``.

    Every failure runs the REAL :class:`~..comm.wirefault.WireConsensus`
    over the fabric KV — all member ranks vote attempt *k* dead before
    anyone reissues attempt *k+1* under attempt-tagged keys
    (``native/wire.py::attempt_tag``) — and rank 0 folds per-hop loss
    reports into the REAL :class:`~..comm.wirefault.LinkHealth` map,
    re-ordering the ring to demote a degraded rank to the tail.
    Asserts: zero restarts, zero torn steps (every rank delivers the
    SAME attempt), every delivered value bitwise-equal to the clean
    result for the ring in effect, ≥2 consensus retries and ≥1
    reroute.  ``baseline=True`` disables retries: the same seed must
    then poison the job, and the result records the steps lost to the
    restart-the-world recovery."""
    from ..comm import wirefault
    from ..core import faults as core_faults
    from ..native.wire import attempt_tag
    from ..obs import metrics as obs_metrics

    assert ranks >= 8, "lossy-link needs >= 8 ranks for distinct victims"
    va, vb, vc = ranks // 4, ranks // 2, (3 * ranks) // 4
    budget = 0 if baseline else max(0, retries)
    drop_step, flap_step = 1, max(3, steps // 2)
    kernel, fabric = _fresh(ranks, seed)
    fabric.set_edge(vc, (vc + 1) % ranks, loss_prob=loss_prob)
    # rank 0's view of link health, fed from the steps' loss reports
    lh = wirefault.LinkHealth(expect_s=0.5, alpha=0.3)

    retries_before = obs_metrics.counter(
        "hvtpu_collective_retries_total").value()
    reroutes_before = obs_metrics.counter(
        "hvtpu_ring_reroutes_total").value()

    members = list(range(ranks))
    delivered: Dict[int, Dict[int, tuple]] = {}  # rank -> step -> (att, v)
    orders: List[List[int]] = []                 # ring in effect per step
    retry_rounds: Dict[int, int] = {}            # step -> consensus rounds
    cons_lat: List[float] = []
    poison_box: List[dict] = []
    completed: Dict[int, int] = {}

    def value(r: int, s: int) -> int:
        # attempt-independent: a retried delivery is bitwise-equal to
        # the clean one by construction, so equality PROVES the job
        # never consumed bytes from an aborted attempt
        return (r * 1315423911 + s * 2654435761) % (2 ** 31)

    class _Lost(Exception):
        def __init__(self, why: str, frm: Optional[int] = None):
            super().__init__(why)
            self.frm = frm  # rank whose link dropped it, when known

    def make(rank: int):
        spec = (f"wire.send:drop@rank={va},count={drop_step + 1},times=2"
                if rank == va else "")

        def body():
            ctx = RankContext(kernel, rank, ranks, fault_spec=spec,
                              generation=0)
            client = fabric.client(rank, caps="dir")
            wc = wirefault.WireConsensus(
                client, rank, generation=0, deadline_s=consensus_s)
            delivered[rank] = {}
            completed[rank] = 0

            def ring_hop(step: int, attempt: int, order: List[int]):
                i = order.index(rank)
                succ = order[(i + 1) % ranks]
                pred = order[(i - 1) % ranks]
                if core_faults.ACTIVE and core_faults.inject("wire.send"):
                    raise _Lost("wire.send dropped", frm=rank)
                if fabric.edge_lost(rank, succ):
                    raise _Lost("edge dropped the send", frm=rank)
                kernel.sleep(fabric.edge_delay(rank, succ, 64))
                client.key_value_set(
                    attempt_tag(f"ll/{step}/{rank}", attempt),
                    str(value(rank, step)))
                try:
                    got = client.blocking_key_value_get(
                        attempt_tag(f"ll/{step}/{pred}", attempt),
                        int(hop_timeout_s * 1000))
                except TimeoutError:
                    raise _Lost("recv timed out", frm=pred) from None
                if core_faults.ACTIVE and core_faults.inject("wire.recv"):
                    raise _Lost("wire.recv dropped", frm=pred)
                return int(got)

            def commit(step: int, attempt: int, order: List[int],
                       got: int, lost_from: List[int]) -> None:
                client.key_value_set(
                    attempt_tag(f"ll/done/{step}", attempt) + f"/{rank}",
                    json.dumps({"v": got, "lost": lost_from}))
                if rank != 0:
                    try:
                        client.blocking_key_value_get(
                            attempt_tag(f"ll/commit/{step}", attempt),
                            int((hop_timeout_s + 2.0) * 1000))
                    except TimeoutError:
                        raise _Lost("commit timed out") from None
                    return
                prefix = attempt_tag(f"ll/done/{step}", attempt) + "/"
                deadline = kernel.now + hop_timeout_s + 1.0
                while True:
                    entries = client.key_value_dir_get(prefix)
                    if len(entries) >= ranks:
                        break
                    if kernel.now >= deadline:
                        raise _Lost("done gather timed out")
                    kernel.sleep(0.05)
                # fold the step's loss reports into the health map; a
                # demoted (>= threshold) rank gets no healthy decay —
                # its sick edge is unused, so nothing proves it healed
                for _k, v in entries:
                    for frm in json.loads(v).get("lost", []):
                        lh.observe(frm, lost=True)
                for r2 in order:
                    if lh.score(r2) < lh.degraded_score:
                        lh.observe(r2, gap_s=0.5)
                client.key_value_set(
                    attempt_tag(f"ll/commit/{step}", attempt), "ok")
                if step + 1 < steps:
                    client.key_value_set(
                        f"ll/order/{step + 1}",
                        json.dumps(lh.ring_order(order)))

            def poison(step: int, why: str) -> None:
                if not poison_box:
                    poison_box.append(
                        {"rank": rank, "step": step, "why": why})
                kernel.log("wire_poison", rank=rank, step=step)

            with ctx.activate():
                for step in range(steps):
                    if poison_box:
                        break
                    if step == 0:
                        order = list(members)
                    else:
                        order = json.loads(client.blocking_key_value_get(
                            f"ll/order/{step}", 60_000))
                    if rank == 0:
                        orders.append(list(order))
                        if step == flap_step:
                            i0 = order.index(vb)
                            fabric.flap(vb, order[(i0 + 1) % ranks],
                                        period_s=1e9, down_s=flap_down_s,
                                        start_s=kernel.now)
                            kernel.log("flap_window_open", rank=vb)
                    attempt, fails = 0, 0
                    lost_from: List[int] = []
                    while True:
                        try:
                            got = ring_hop(step, attempt, order)
                            commit(step, attempt, order, got, lost_from)
                        except _Lost as lost:
                            if lost.frm is not None:
                                lost_from.append(lost.frm)
                            fails += 1
                            if fails > budget:
                                poison(step, str(lost))
                                break
                            t0 = kernel.now
                            decision = wc.vote_and_decide(
                                "ll", step, attempt, members,
                                f"ring:{step}", False)
                            if rank == 0:
                                cons_lat.append(kernel.now - t0)
                            if decision != wirefault.RETRY:
                                poison(step, f"consensus={decision}")
                                break
                            if rank == 0:
                                wirefault.record_retry(
                                    rank, "ll", step, attempt, decision)
                                retry_rounds[step] = (
                                    retry_rounds.get(step, 0) + 1)
                            attempt += 1
                            continue
                        delivered[rank][step] = (attempt, got)
                        completed[rank] = step + 1
                        wc.cleanup("ll", step, attempt)
                        for a in range(attempt + 1):
                            client.key_value_delete(
                                attempt_tag(f"ll/{step}/{rank}", a))
                            client.key_value_delete(
                                attempt_tag(f"ll/done/{step}", a)
                                + f"/{rank}")
                        break
        return body

    with _env(HVTPU_AUDIT_EVERY="0"):
        for r in range(ranks):
            kernel.spawn(f"rank{r}", make(r))
        kernel.run(max_virtual_s=_DEF_BUDGET_S)

    retries_total = int(obs_metrics.counter(
        "hvtpu_collective_retries_total").value() - retries_before)
    reroutes = int(obs_metrics.counter(
        "hvtpu_ring_reroutes_total").value() - reroutes_before)

    if baseline:
        assert poison_box, (
            "retries disabled: the first wire loss must poison the job")
        first_lost = min(completed.values())
        steps_lost = steps - first_lost
        assert steps_lost > 0
        stats = {"phases": {"lossy_link": {
            "mode": "baseline",
            "steps": steps,
            "restarts": 1,
            "steps_completed": first_lost,
            "steps_lost": steps_lost,
            "retry_rounds": 0,
            "reroutes": reroutes,
            "torn": 0,
            "virtual_s": round(kernel.now, 6),
        }}, "kv_ops": dict(fabric.ops)}
        return _result("lossy-link", ranks, seed, kernel, stats)

    assert not poison_box, (
        f"job poisoned despite retry budget {budget}: {poison_box}")
    for r in range(ranks):
        assert completed.get(r) == steps, (
            f"rank {r} finished {completed.get(r)}/{steps} steps")
    torn = 0
    for s in range(steps):
        if len({delivered[r][s][0] for r in range(ranks)}) != 1:
            torn += 1
    assert torn == 0, f"{torn} steps delivered a torn mix of attempts"
    # bitwise equality with the clean run: values depend only on
    # (predecessor, step) for the deterministic ring in effect
    assert len(orders) == steps
    for s in range(steps):
        order = orders[s]
        for i, r in enumerate(order):
            expect = value(order[(i - 1) % ranks], s)
            assert delivered[r][s][1] == expect, (
                f"rank {r} step {s}: delivered {delivered[r][s][1]}, "
                f"clean result is {expect}")
    assert retries_total >= 2, (
        f"expected >= 2 consensus retries, saw {retries_total}")
    assert reroutes >= 1, "the flapping rank was never rerouted around"
    cons_sorted = sorted(cons_lat)
    stats = {"phases": {"lossy_link": {
        "mode": "retries",
        "steps": steps,
        "restarts": 0,
        "steps_lost": 0,
        "recovered_collectives": len(retry_rounds),
        "retry_rounds": retries_total,
        "consensus_p50_s": round(_pct(cons_sorted, 0.50), 6),
        "consensus_max_s": (round(cons_sorted[-1], 6)
                            if cons_sorted else 0.0),
        "reroutes": reroutes,
        "torn": torn,
        "edge_losses": int(fabric.ops.get("edge_lost", 0)),
        "virtual_s": round(kernel.now, 6),
    }}, "kv_ops": dict(fabric.ops)}
    return _result("lossy-link", ranks, seed, kernel, stats)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SCENARIOS = {
    "thundering-rendezvous": thundering_rendezvous,
    "steady-drain": steady_drain,
    "rolling-preemption": rolling_preemption,
    "kill-blacklist": kill_blacklist,
    "kv-brownout": kv_brownout,
    "straggler-tail": straggler_tail,
    "stream-matrix": stream_matrix,
    "multi-job-arbiter": multi_job_arbiter,
    "checkpoint-storm": checkpoint_storm,
    "compression-negotiation": compression_negotiation,
    "anomaly-detection": anomaly_detection,
    "coordinator-loss": coordinator_loss,
    "partition-storm": partition_storm,
    "fleet-service": fleet_service,
    "lossy-link": lossy_link,
}


#: Scenarios whose ranks run the async controller over tensors: they
#: take ``device``; the others have no tensors and ignore it.
CONTROLLER_SCENARIOS = ("straggler-tail", "stream-matrix",
                        "compression-negotiation")


def run_scenario(name: str, ranks: int, seed: int = 0, *, device=None,
                 **kwargs) -> Dict:
    """Run one named scenario; raises KeyError with the catalog on an
    unknown name.  ``device``: where a controller scenario's payloads
    and controllers live (default the card, see :func:`resolve_device`);
    ignored by scenarios without tensors."""
    fn = SCENARIOS.get(name)
    if fn is None:
        raise KeyError(
            f"unknown scenario {name!r}; available: "
            f"{', '.join(sorted(SCENARIOS))}")
    if name in CONTROLLER_SCENARIOS:
        kwargs["device"] = device
    return fn(ranks, seed, **kwargs)

"""Wire-plane fault tolerance: consensus abort-and-retry + link health.

Counterpart of ``horovod_tpu/comm/wirefault.py``.  The first two rungs
of the reference's degradation ladder, over the same store client the
stall inspector holds (``core/kv.py`` under ``core/retry.py``'s
``FencedKV``):

**Rung 1 — consensus abort-and-retry** (:class:`WireConsensus`).
A collective ``(set_id, seq)`` that fails with a transport-shaped
error is not immediately job-fatal: the failing rank posts an abort
VOTE for attempt *k* under ``hvtwire/<gen>/<set>/<seq>/<k>/<rank>``,
then waits for the member ranks to agree attempt *k* is dead before
anyone reissues it.  The agreement has exactly three outcomes, chosen so
every collective delivers **exactly one result or none**:

- ``RETRY`` — every member voted failed.  Nobody holds a result of
  attempt *k*, so all members reissue attempt *k+1*.
- ``LATE_JOIN`` — this rank (and every other voter) failed BEFORE
  dispatch put bytes on the wire, and every non-voting member is
  observably parked *inside* attempt *k* (its stall-heartbeat
  snapshot shows the same in-flight descriptor at the same sequence
  number).  Re-dispatching attempt *k* completes the wedged peers'
  pending collective.  The late-joiner retracts its vote first
  (``rejoin``), so a peer that fails afterwards can never see "all
  voted" and tear off into attempt *k+1*.
- ``ESCALATE`` — any member already COMPLETED attempt *k*, a mid-flight
  failure mixed with rejoined peers, or the consensus deadline expired.
  The error surfaces as ``HorovodInternalError``.

**Rung 2 — link-health route-around** (:class:`LinkHealth`).
Per-peer EWMA latency/loss scores folded out of the stall inspector's
heartbeat stream.  Past ``HVTPU_LINK_DEGRADED_SCORE``,
:meth:`LinkHealth.ring_order` re-orders a ring to demote the sick rank
to the tail.  The order is advisory, as it is on the reference's XLA
data plane: NCCL and gloo own their rings.

Retries are OFF by default (``HVTPU_WIRE_RETRIES=0``).  All timing goes
through ``core/clock.py``.  Telemetry at the reference's sites:
``hvtpu_collective_retries_total``,
``hvtpu_collective_abort_consensus_seconds``, ``hvtpu_link_health`` and
``hvtpu_ring_reroutes_total``, with flight-recorder notes of retries,
consensus decisions and reroutes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import clock
from ..obs import flight
from ..obs import metrics as obs_metrics

logger = logging.getLogger("horovod_tpu_torch")

# Recovery telemetry (obs/metrics.py), the reference's families.
_M_RETRIES = obs_metrics.counter(
    "hvtpu_collective_retries_total",
    "Collective attempts reissued (or late-joined) after a consensus "
    "abort agreed the previous attempt was dead.")
_M_CONSENSUS_S = obs_metrics.histogram(
    "hvtpu_collective_abort_consensus_seconds",
    "Time from posting an abort vote for a failed collective attempt "
    "to the agreed decision (retry / late-join / escalate).")
_M_LINK_HEALTH = obs_metrics.gauge(
    "hvtpu_link_health",
    "Worst per-peer wire-link degradation score (0 = healthy, "
    "1 = dead), from heartbeat-derived EWMA latency/loss.")
_M_REROUTES = obs_metrics.counter(
    "hvtpu_ring_reroutes_total",
    "Ring-permutation reroutes taken to avoid a degraded link before "
    "escalating to an elastic reset.")

_NS = "hvtwire"  # abort-consensus vote namespace on the fenced KV

#: Consensus outcomes.
RETRY = "retry"
LATE_JOIN = "late_join"
ESCALATE = "escalate"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


def retry_limit() -> int:
    """Max reissue attempts per collective (``HVTPU_WIRE_RETRIES``,
    default 0 = the pre-existing fail-fast behavior)."""
    return int(_env_float("HVTPU_WIRE_RETRIES", 0))


def retry_backoff_s() -> float:
    """Base backoff between attempts (``HVTPU_WIRE_RETRY_BACKOFF_S``);
    attempt k sleeps k times this before reissuing."""
    return _env_float("HVTPU_WIRE_RETRY_BACKOFF_S", 0.05)


def consensus_deadline_s() -> float:
    """How long a failed rank waits for the member ranks to agree an
    attempt is dead before escalating (``HVTPU_WIRE_CONSENSUS_S``)."""
    return _env_float("HVTPU_WIRE_CONSENSUS_S", 5.0)


def record_retry(rank: int, set_id, seq: int, attempt: int,
                 decision: str) -> None:
    """Count a consensus-approved reissue (RETRY or LATE_JOIN) and
    leave the audit trail."""
    _M_RETRIES.inc()
    logger.warning(
        "collective (set %s, op #%s) attempt %d agreed dead by "
        "consensus: %s", set_id, seq, attempt, decision)
    if flight.ACTIVE:
        flight.note("collective_retry", rank=rank, process_set=set_id,
                    op_seq=seq, attempt=attempt, decision=decision)


class AttemptFailed(Exception):
    """One collective attempt failed with a transport-shaped error.

    ``predispatch`` is True when the failure provably happened BEFORE
    this rank put any bytes on the wire (an injected ``wire.send``
    drop, a refused connection) — the only class that may LATE_JOIN a
    still-pending attempt.  ``cause`` is the original backend error.
    """

    def __init__(self, predispatch: bool, cause: BaseException):
        super().__init__(str(cause))
        self.predispatch = predispatch
        self.cause = cause


class WireConsensus:
    """Abort-and-retry agreement for one rank's failed collectives.

    One instance per (KV client, rank, generation); the KV is expected
    to be the FENCED client the stall inspector already holds, so a
    superseded zombie's votes are invisible to live readers.  Peer
    classification reads the stall inspector's existing heartbeat
    snapshots (``hb_prefix``) — the protocol adds KV traffic only when
    a collective actually fails.
    """

    def __init__(self, kv, rank: int, generation: int = 0,
                 hb_prefix: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        self._kv = kv
        self.rank = rank
        self.gen = generation
        self._hb_prefix = hb_prefix
        self.deadline_s = (consensus_deadline_s()
                           if deadline_s is None else deadline_s)

    # -- keys ----------------------------------------------------------
    def _key(self, set_id, seq: int, attempt: int, rank: int) -> str:
        return f"{_NS}/{self.gen}/{set_id}/{seq}/{attempt}/{rank}"

    def _post(self, key: str, value: str) -> bool:
        """Write a vote, replacing any previous value.

        The JAX coordination service forbids overwriting a live key, so
        there a retraction (and a re-vote after a failed late-join
        re-entry) must delete-then-set; a ``torch.distributed`` store
        overwrites, and the first attempt succeeds.  The gap where
        neither value is visible is safe: a peer that reads during it
        sees a missing vote and falls back to heartbeat classification,
        which at worst ESCALATEs — never licenses a torn retry.
        """
        try:
            self._kv.key_value_set(key, value)
            return True
        except Exception:
            pass
        try:
            self._kv.key_value_delete(key)
            self._kv.key_value_set(key, value)
            return True
        except Exception:
            return False

    def _votes(self, set_id, seq: int, attempt: int,
               ranks: Sequence[int]) -> Dict[int, dict]:
        prefix = f"{_NS}/{self.gen}/{set_id}/{seq}/{attempt}/"
        dir_get = getattr(self._kv, "key_value_dir_get", None)
        out: Dict[int, dict] = {}
        if dir_get is not None:
            try:
                for k, v in dir_get(prefix):
                    try:
                        out[int(k.rsplit("/", 1)[-1])] = json.loads(v)
                    except (ValueError, TypeError):
                        continue
                return out
            except Exception:
                out = {}
        for r in ranks:
            try:
                val = self._kv.key_value_try_get(
                    self._key(set_id, seq, attempt, r))
            except Exception:
                val = None
            if val is not None:
                try:
                    out[r] = json.loads(val)
                except (ValueError, TypeError):
                    continue
        return out

    # -- peer classification from heartbeat snapshots ------------------
    def _peer_states(self, set_id, seq: int, desc: str,
                     ranks: Sequence[int]) -> Dict[int, str]:
        """``waiting`` (parked inside this op), ``done`` (completed it
        and moved on — or exited), or ``unknown`` (no usable snapshot
        yet / still lagging behind the op)."""
        states = {r: "unknown" for r in ranks}
        if not self._hb_prefix:
            return states
        dir_get = getattr(self._kv, "key_value_dir_get", None)
        if dir_get is None:
            return states
        try:
            entries = dir_get(self._hb_prefix)
        except Exception:
            return states
        latest: Dict[int, Tuple[int, str]] = {}
        for k, v in entries:
            parts = k.rsplit("/", 2)
            if len(parts) < 3:
                continue
            try:
                r, b = int(parts[-2]), int(parts[-1])
            except ValueError:
                continue
            if r in states and (r not in latest or b > latest[r][0]):
                latest[r] = (b, v)
        for r, (_b, v) in latest.items():
            try:
                snap = json.loads(v)
            except Exception:
                continue
            if snap.get("bye") or snap.get("fail"):
                # exited or already failing: retrying cannot help
                states[r] = "done"
                continue
            pset = snap.get("sets", {}).get(str(set_id))
            if not pset:
                continue
            pseq = int(pset.get("seq", 0))
            if pseq <= seq:
                continue  # not at this op yet — keep polling
            if pseq == seq + 1 and pset.get("inflight") == desc:
                states[r] = "waiting"
            else:
                states[r] = "done"
        return states

    # -- the agreement -------------------------------------------------
    def vote_and_decide(self, set_id, seq: int, attempt: int,
                        members: Sequence[int], desc: str,
                        predispatch: bool) -> str:
        """Post this rank's abort vote for (set, seq, attempt) and
        block until the outcome is decidable; returns ``RETRY``,
        ``LATE_JOIN`` or ``ESCALATE`` (see module docstring for the
        exactly-once argument)."""
        t0 = clock.monotonic()
        mine = {"st": "pre" if predispatch else "mid", "d": desc}
        if not self._post(self._key(set_id, seq, attempt, self.rank),
                          json.dumps(mine)):
            # can't even reach the KV: nothing to agree over
            return ESCALATE
        others = [r for r in members if r != self.rank]
        deadline = t0 + self.deadline_s
        decision = ESCALATE
        sleep = 0.0
        while True:
            votes = self._votes(set_id, seq, attempt, others)
            missing = [r for r in others if r not in votes]
            pure = all(v.get("st") in ("pre", "rejoin")
                       for v in votes.values()) and predispatch
            if not missing:
                if any(v.get("st") == "rejoin" for v in votes.values()):
                    # someone is back INSIDE attempt k: join it or die
                    decision = LATE_JOIN if pure else ESCALATE
                else:
                    # every member agreed attempt k is dead; nobody
                    # holds its result — all reissue attempt k+1
                    decision = RETRY
                break
            states = self._peer_states(set_id, seq, desc, missing)
            if any(states[r] == "done" for r in missing):
                # a peer completed attempt k while we failed it: a
                # retry would deliver a second, different attempt
                decision = ESCALATE
                break
            if pure and all(states[r] == "waiting" for r in missing):
                decision = LATE_JOIN
                break
            if clock.monotonic() >= deadline:
                decision = ESCALATE
                break
            sleep = min(0.05, sleep * 2 if sleep else 0.002)
            clock.sleep(sleep)
        if decision == LATE_JOIN:
            # Retract the failure vote BEFORE re-entering attempt k: a
            # member that fails after this must see this rank as back
            # inside the attempt (rejoin), never as a completed vote
            # set that licenses attempt k+1 while we wedge in k.
            if not self._post(self._key(set_id, seq, attempt, self.rank),
                              json.dumps({"st": "rejoin", "d": desc})):
                decision = ESCALATE
        waited = clock.monotonic() - t0
        _M_CONSENSUS_S.observe(waited)
        if flight.ACTIVE:
            flight.note("collective_abort_consensus", rank=self.rank,
                        process_set=set_id, op_seq=seq, attempt=attempt,
                        decision=decision, waited_s=round(waited, 6))
        return decision

    def cleanup(self, set_id, seq: int, attempts: int) -> None:
        """Drop this rank's own votes for a delivered collective (each
        rank deletes only its own keys; best-effort)."""
        for a in range(attempts + 1):
            try:
                self._kv.key_value_delete(
                    self._key(set_id, seq, a, self.rank))
            except Exception:
                pass


class LinkHealth:
    """Per-peer wire-link scores from heartbeat arrival gaps.

    ``observe`` is fed by the stall inspector's beat loop: a beat that
    arrives after ``gap_s`` updates the latency EWMA (as a ratio of
    the expected cadence), a skipped/overdue beat counts as a loss.
    ``score`` folds both into [0, 1]; past ``degraded_score`` the peer
    is considered to sit behind a sick link and :meth:`ring_order`
    demotes it to the ring tail (counting a reroute when the order
    actually changes).  Thread-safe: the beat thread writes, the data
    plane and /debug read.
    """

    def __init__(self, expect_s: float, alpha: float = 0.25,
                 degraded_score: Optional[float] = None):
        self.expect_s = max(float(expect_s), 1e-6)
        self.alpha = alpha
        self.degraded_score = (
            _env_float("HVTPU_LINK_DEGRADED_SCORE", 0.5)
            if degraded_score is None else degraded_score)
        self._lock = threading.Lock()
        self._lat: Dict[int, float] = {}    # EWMA gap/expected ratio
        self._loss: Dict[int, float] = {}   # EWMA loss indicator
        self._last_order: Dict[tuple, tuple] = {}

    def observe(self, peer: int, gap_s: Optional[float] = None,
                lost: bool = False) -> None:
        a = self.alpha
        with self._lock:
            if lost:
                prev = self._loss.get(peer, 0.0)
                self._loss[peer] = prev + a * (1.0 - prev)
            else:
                prev = self._loss.get(peer, 0.0)
                self._loss[peer] = prev * (1.0 - a)
                if gap_s is not None:
                    ratio = max(0.0, gap_s) / self.expect_s
                    prevl = self._lat.get(peer, 1.0)
                    self._lat[peer] = prevl + a * (ratio - prevl)

    def _score_locked(self, peer: int) -> float:
        loss = self._loss.get(peer, 0.0)
        lat = self._lat.get(peer, 1.0)
        # latency starts penalizing at 2x the expected cadence and
        # saturates at 10x; loss dominates (a flapping link loses
        # beats long before it slows them)
        lat_pen = min(1.0, max(0.0, (lat - 2.0) / 8.0))
        return min(1.0, loss + 0.5 * lat_pen)

    def score(self, peer: int) -> float:
        with self._lock:
            return self._score_locked(peer)

    def worst(self) -> float:
        with self._lock:
            peers = set(self._lat) | set(self._loss)
            return max((self._score_locked(r) for r in peers),
                       default=0.0)

    def degraded(self) -> List[int]:
        with self._lock:
            peers = sorted(set(self._lat) | set(self._loss))
            return [r for r in peers
                    if self._score_locked(r) >= self.degraded_score]

    def publish(self) -> None:
        """Export the worst score to the ``hvtpu_link_health`` gauge."""
        _M_LINK_HEALTH.set(self.worst())

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            peers = sorted(set(self._lat) | set(self._loss))
            return {str(r): {
                "score": round(self._score_locked(r), 4),
                "lat_ratio": round(self._lat.get(r, 1.0), 4),
                "loss": round(self._loss.get(r, 0.0), 4),
            } for r in peers}

    def ring_order(self, members: Sequence[int]) -> List[int]:
        """``members`` re-ordered so degraded peers sit at the ring
        tail (healthiest first among the sick; relative order of
        healthy members preserved).  Counts a reroute + flight event
        when the order for this member set actually changes."""
        with self._lock:
            scored = [(self._score_locked(r), i, r)
                      for i, r in enumerate(members)]
            healthy = [r for s, _i, r in scored
                       if s < self.degraded_score]
            sick = [r for s, _i, r in sorted(scored)
                    if s >= self.degraded_score]
            order = healthy + sick
            key = tuple(sorted(members))
            prev = self._last_order.get(key)
            changed = prev is not None and prev != tuple(order)
            self._last_order[key] = tuple(order)
        if changed:
            _M_REROUTES.inc()
            logger.warning(
                "wire link degraded: ring rerouted to demote ranks %s "
                "to the tail", sick)
            if flight.ACTIVE:
                flight.note("ring_reroute", demoted=list(sick),
                            order=list(order))
        return order

"""The port's stall watchdog and wire abort-and-retry
(``horovod_tpu_torch/comm/{stall,wirefault}.py``) against the JAX
package's (``horovod_tpu/comm/{stall,wirefault}.py``), on the CPU.

* Parity: the amortized inspector's diagnoses (failure texts and
  warnings) over the same op sequences and peer snapshots on a fake
  clock, its heartbeat payloads and beat-driven evaluation over the same
  store contents, ``WireConsensus`` decisions over the same vote sets and
  heartbeats, ``LinkHealth.ring_order``, and ``_map_backend_error`` over
  the reference's transport markers (plus the port's typed
  ``torch.distributed`` errors and NCCL texts).
* The reference's unit cases (``tests/test_stall.py``), ported onto the
  port's store client (``core/kv.py`` over a ``HashStore``).
* 2 ranks over gloo: a skipped collective, diverged collectives
  (amortized and strict), a rank that stops stepping in
  ``DistributedOptimizer``, and an async op one rank never enqueues (the
  controller's inspection on the lockstep and the streamed plane) are
  each diagnosed with a ``HorovodInternalError`` naming the rank or both
  ops within the abort time plus two heartbeats; the healthy op matrix
  is bitwise the unguarded one; a dropped wire send under
  ``HVTPU_WIRE_RETRIES=1`` gives the fault-free result bitwise.
"""

import json
import logging
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.comm import stall as ref_stall
from horovod_tpu.comm import wirefault as ref_wirefault
from horovod_tpu.core import clock as ref_clock
from horovod_tpu.core import faults as ref_faults
from horovod_tpu_torch.comm import stall, wirefault
from horovod_tpu_torch.comm.stall import (
    AmortizedStallInspector,
    SyncStallInspector,
)
from horovod_tpu_torch.core import clock, faults
from horovod_tpu_torch.core.exceptions import HorovodInternalError
from horovod_tpu_torch.core.kv import StoreKV
from torch_port_util import spawn_world, stall_worker


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.uninstall()
    ref_faults.uninstall()
    stall._reset_poison()
    ref_stall._reset_poison()
    clock.install(None)
    ref_clock.install(None)


class FakeKV:
    """The reference tests' dict-backed client (with directory get)."""

    def __init__(self):
        self.d = {}
        self.lock = threading.Lock()

    def key_value_set(self, k, v):
        with self.lock:
            self.d[k] = v

    def key_value_try_get(self, k):
        with self.lock:
            if k not in self.d:
                raise KeyError(k)
            return self.d[k]

    def key_value_dir_get(self, prefix):
        with self.lock:
            return sorted((k, v) for k, v in self.d.items()
                          if k.startswith(prefix))

    def key_value_delete(self, k):
        with self.lock:
            self.d.pop(k, None)


def store_kv(ranks=3):
    return StoreKV(dist.HashStore(), ranks)


def _present(kv, key) -> bool:
    try:
        kv.key_value_try_get(key)
        return True
    except KeyError:
        return False


class FakeClock:
    def __init__(self, timer_cls):
        self.t = 500.0
        self.timer_cls = timer_cls

    def monotonic(self):
        return self.t

    def wall(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(0.0, seconds)

    def call_later(self, delay_s, fn):
        return self.timer_cls()


class Ready:
    """Complete, in both packages' probe spellings."""

    def is_ready(self):
        return True

    def query(self):
        return True


class NeverReady:
    def is_ready(self):
        return False

    def query(self):
        return False


class Warnings(logging.Handler):
    def __init__(self):
        super().__init__()
        self.msgs = []

    def emit(self, record):
        self.msgs.append(record.getMessage())


def _capture(logger_name):
    h = Warnings()
    lg = logging.getLogger(logger_name)
    lg.addHandler(h)
    return lg, h


# -- parity: the amortized inspector's diagnoses ------------------------------

_DESCS = ["allreduce:a:(4,):float32", "allreduce:b:(4,):float32",
          "broadcast:w:(2,):float32:root0", "jit_step:train",
          "bucket:0:4096:torch.float16"]


def _script(seed):
    """A seeded op/evaluation script: ops on three sets, clock advances,
    and evaluations against generated peer snapshots (rings that agree
    or diverge, lagging or caught-up counters, stale, exited and failing
    peers, partition suspects)."""
    rng = np.random.RandomState(seed)
    steps, seqs, history = [], {}, {}
    for _ in range(60):
        kind = rng.randint(4)
        sid = ["0", "1", "jit.0"][rng.randint(3)]
        if kind == 0:
            desc = _DESCS[rng.randint(len(_DESCS))]
            steps.append(("pre", sid, [0, 1, 2], desc))
            history.setdefault(sid, []).append(desc)
            seqs[sid] = seqs.get(sid, 0) + 1
        elif kind == 1:
            steps.append(("ready", sid))
        elif kind == 2:
            steps.append(("advance", float(rng.choice([0.05, 0.3, 1.1]))))
        else:
            peers, stale, bye, fails, suspect = {}, set(), set(), [], set()
            for r in (1, 2):
                c = rng.randint(8)
                if c == 0:
                    continue          # no snapshot yet
                sets = {}
                for s, hist in history.items():
                    n = len(hist) - rng.randint(0, 3)
                    ring = [[i, (hist[i] if rng.rand() > 0.08
                                 else _DESCS[rng.randint(len(_DESCS))])]
                            for i in range(max(0, n - 6), max(0, n))]
                    sets[s] = {"seq": max(0, n), "ring": ring}
                snap = {"sets": sets, "fail": None}
                if c == 1:
                    snap["fail"] = f"peer {r} failed at {rng.randint(99)}"
                if c == 2:
                    bye.add(r)
                    if rng.rand() > 0.5:
                        fails.append((r, f"bye failure {r}"))
                    continue
                if c == 3:
                    stale.add(r)
                if c == 4:
                    suspect.add(r)
                peers[r] = snap
            steps.append(("eval", peers, stale, bye, fails, suspect))
    return steps


def _run_script(mod, clock_mod, logger_name, steps):
    fc = FakeClock(clock_mod.Timer)
    clock_mod.install(fc)
    lg, h = _capture(logger_name)
    insp = mod.AmortizedStallInspector(
        FakeKV(), 0, warn_s=0.25, abort_s=2.0, heartbeat_s=1.0,
        generation=1, start_heartbeat=False)
    out = []
    try:
        for step in steps:
            if step[0] == "pre":
                try:
                    insp.pre_op(step[1], step[2], step[3])
                    out.append("pre")
                except Exception as e:  # noqa: BLE001
                    out.append(f"{type(e).__name__}: {e}")
            elif step[0] == "ready":
                try:
                    insp.wait_ready(step[1], Ready())
                    out.append("ready")
                except Exception as e:  # noqa: BLE001
                    out.append(f"{type(e).__name__}: {e}")
            elif step[0] == "advance":
                fc.t += step[1]
            else:
                insp._evaluate(*step[1:])
                out.append((insp.failure, list(h.msgs)))
                h.msgs.clear()
    finally:
        lg.removeHandler(h)
        clock_mod.install(None)
    return out


@pytest.mark.parametrize("seed", range(12))
def test_amortized_diagnoses_match_reference(seed):
    steps = _script(seed)
    want = _run_script(ref_stall, ref_clock, "horovod_tpu", steps)
    got = _run_script(stall, clock, "horovod_tpu_torch", steps)
    assert got == want
    assert any(isinstance(o, tuple) and (o[0] or o[1]) for o in got)


def _beats(mod, clock_mod, kv_factory, seed):
    """Both ranks' heartbeats over one client: payloads, evaluations and
    link health, beat by beat on a fake clock."""
    fc = FakeClock(clock_mod.Timer)
    clock_mod.install(fc)
    kv = kv_factory()
    rng = np.random.RandomState(seed)
    ins = [mod.AmortizedStallInspector(
        kv, r, warn_s=0.3, abort_s=1.5, heartbeat_s=0.1, generation=4,
        stale_s=0.5, suspect_s=0.3 * (seed % 2), start_heartbeat=False)
        for r in (0, 1)]
    out = []
    try:
        for i in range(40):
            r = rng.randint(2)
            try:
                if rng.rand() < 0.3:
                    ins[r].pre_op("0", [0, 1], _DESCS[rng.randint(2)])
                if rng.rand() < 0.2:
                    ins[r].wait_ready("0", Ready())
            except Exception as e:  # noqa: BLE001 — a latched failure
                out.append(str(e))
            fc.t += float(rng.choice([0.1, 0.1, 0.3]))
            if not (i > 25 and r == 1):       # rank 1's beats stop
                ins[r]._beat_once()
            out.append((r, ins[r].failure,
                        json.loads(kv.key_value_try_get(
                            f"hvtstallhb/4/{r}/{ins[r]._beat - 1}")),
                        ins[r].link_health.snapshot(),
                        sorted(ins[r]._suspected)))
    finally:
        clock_mod.install(None)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_beats_match_reference(seed):
    want = _beats(ref_stall, ref_clock, FakeKV, seed)
    got = _beats(stall, clock, lambda: store_kv(2), seed)
    assert got == want


# -- parity: wire consensus and link health ----------------------------------

_VOTES = [None, {"st": "pre", "d": "allreduce:x"},
          {"st": "mid", "d": "allreduce:x"},
          {"st": "rejoin", "d": "allreduce:x"}]
_HB = [None, ("waiting", 6, "allreduce:x"), ("done", 7, None),
       ("lagging", 5, None), ("bye", 6, "allreduce:x"),
       ("fail", 6, "allreduce:x")]


def _consensus(mod, clock_mod, kv, votes, hbs, predispatch, members):
    fc = FakeClock(clock_mod.Timer)
    clock_mod.install(fc)
    try:
        for r, v in votes.items():
            if v is not None:
                kv.key_value_set(f"hvtwire/1/0/5/0/{r}", json.dumps(v))
        for r, hb in hbs.items():
            if hb is None:
                continue
            state, seq, inflight = hb
            kv.key_value_set(f"hvtstallhb/1/{r}/3", json.dumps({
                "bye": state == "bye", "fail": "x" if state == "fail"
                else None, "sets": {"0": {"seq": seq,
                                          "inflight": inflight}}}))
        wc = mod.WireConsensus(kv, 0, generation=1,
                               hb_prefix="hvtstallhb/1/", deadline_s=0.2)
        decision = wc.vote_and_decide("0", 5, 0, members, "allreduce:x",
                                      predispatch=predispatch)
        mine = json.loads(kv.key_value_try_get("hvtwire/1/0/5/0/0"))
        wc.cleanup("0", 5, attempts=1)
        return decision, mine, _present(kv, "hvtwire/1/0/5/0/0")
    finally:
        clock_mod.install(None)


def _vote_cases():
    rng = np.random.RandomState(11)
    cases = []
    for _ in range(60):
        members = [0, 1, 2] if rng.rand() < 0.6 else [0, 1]
        votes = {r: _VOTES[rng.randint(len(_VOTES))] for r in members[1:]}
        hbs = {r: _HB[rng.randint(len(_HB))] for r in members[1:]}
        cases.append((votes, hbs, bool(rng.rand() < 0.6), members))
    return cases


@pytest.mark.parametrize("case", range(60))
def test_wire_consensus_decisions_match_reference(case):
    votes, hbs, pre, members = _vote_cases()[case]
    want = _consensus(ref_wirefault, ref_clock, FakeKV(), votes, hbs, pre,
                      members)
    got = _consensus(wirefault, clock, store_kv(3), votes, hbs, pre,
                     members)
    assert got == want


def test_wire_consensus_covers_every_outcome():
    seen = {_consensus(wirefault, clock, store_kv(3), *c)[0]
            for c in _vote_cases()}
    assert seen == {wirefault.RETRY, wirefault.LATE_JOIN,
                    wirefault.ESCALATE}


@pytest.mark.parametrize("seed", range(5))
def test_link_health_ring_order_matches_reference(seed):
    rng = np.random.RandomState(seed)
    obs = [(int(rng.randint(6)), float(rng.rand() * 0.5),
            bool(rng.rand() < 0.3)) for _ in range(200)]
    orders = []
    for mod in (ref_wirefault, wirefault):
        lh = mod.LinkHealth(expect_s=0.05, degraded_score=0.4)
        seq = []
        for i, (peer, gap, lost) in enumerate(obs):
            lh.observe(peer, gap_s=None if lost else gap, lost=lost)
            if i % 20 == 0:
                seq.append((lh.ring_order([0, 1, 2, 3, 4, 5]),
                            lh.ring_order([5, 3, 1]), lh.degraded(),
                            lh.worst(), lh.snapshot()))
        orders.append(seq)
    assert orders[1] == orders[0]


def test_retry_knobs_match_reference(monkeypatch):
    for env in ({}, {"HVTPU_WIRE_RETRIES": "3",
                     "HVTPU_WIRE_RETRY_BACKOFF_S": "0.2",
                     "HVTPU_WIRE_CONSENSUS_S": "7"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert (wirefault.retry_limit(), wirefault.retry_backoff_s(),
                wirefault.consensus_deadline_s()) == (
            ref_wirefault.retry_limit(), ref_wirefault.retry_backoff_s(),
            ref_wirefault.consensus_deadline_s())
    monkeypatch.setenv("HVTPU_WIRE_RETRIES", "x")
    with pytest.raises(ValueError, match="HVTPU_WIRE_RETRIES"):
        wirefault.retry_limit()


# -- parity: backend error mapping --------------------------------------------

_MARKER_ERRORS = [
    RuntimeError("Connection closed by peer [127.0.0.1]:1234"),
    RuntimeError("Socket closed"), ConnectionError("Connection reset"),
    OSError("connection reset by peer"), OSError("Broken pipe"),
    ConnectionRefusedError("Connection refused"),
    RuntimeError("UNAVAILABLE: x"), RuntimeError("DEADLINE_EXCEEDED"),
    RuntimeError("coordination service lost"),
    ValueError("a real bug"), KeyError("missing"),
]


@pytest.mark.parametrize("err", _MARKER_ERRORS, ids=lambda e: str(e)[:20])
@pytest.mark.parametrize("failure", [None, "rank 1 aborted the job: x"])
def test_map_backend_error_matches_reference(err, failure):
    outcomes = []
    for mod in (ref_stall, stall):
        insp = SimpleNamespace(failure=failure, heartbeat_s=0.01)
        try:
            mod._map_backend_error(insp, err)
        except Exception as e:  # noqa: BLE001
            outcomes.append((type(e).__name__, str(e), e.__cause__ is err))
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("err", [
    dist.DistBackendError("x"), dist.DistNetworkError("x"),
    dist.DistStoreError("x"),
    RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1, remote process "
                 "exited or there was a network error"),
    RuntimeError("[Rank 0] Watchdog caught collective operation timeout: "
                 "WorkNCCL(SeqNum=5, OpType=ALLREDUCE) ran for 600000 ms"),
    RuntimeError("NCCL communicator was aborted on rank 0"),
    RuntimeError("[../gloo/transport/tcp/pair.cc:534] Connection closed "
                 "by peer"),
    RuntimeError("Timed out waiting 1800000ms for recv operation"),
], ids=lambda e: type(e).__name__ + str(e)[:16])
def test_map_backend_error_maps_torch_and_nccl_failures(err):
    insp = SimpleNamespace(failure=None, heartbeat_s=0.01)
    with pytest.raises(HorovodInternalError,
                       match="collective transport failure") as ei:
        stall._map_backend_error(insp, err)
    assert ei.value.__cause__ is err
    assert stall._is_transport_error(err)


# -- the reference's unit cases on the port's store client -------------------

class TestStrictInspector:
    def test_completes_when_all_marks_present(self):
        kv = store_kv()
        kv.key_value_set("hvtstall/1/0/0/1", "allreduce:x")
        insp = SyncStallInspector(kv, rank=0, warn_s=60, abort_s=0,
                                  generation=1)
        insp.rendezvous(0, [0, 1], "allreduce:x")
        assert _present(kv, "hvtstall/1/0/0/0")
        assert insp.debug_state()["op_seq_per_set"] == {"0": 1}

    def test_abort_names_missing_ranks(self):
        insp = SyncStallInspector(store_kv(), rank=0, warn_s=0.05,
                                  abort_s=0.2, generation=1)
        t0 = time.monotonic()
        with pytest.raises(HorovodInternalError) as ei:
            insp.rendezvous(0, [0, 1, 2], "allreduce:y")
        assert time.monotonic() - t0 < 5.0
        assert "allreduce:y" in str(ei.value) and "[1, 2]" in str(ei.value)

    def test_descriptor_mismatch_raises_immediately(self):
        kv = store_kv()
        kv.key_value_set("hvtstall/1/0/0/1", "broadcast:z")
        insp = SyncStallInspector(kv, rank=0, warn_s=60, abort_s=0,
                                  generation=1)
        t0 = time.monotonic()
        with pytest.raises(HorovodInternalError, match="diverged"):
            insp.rendezvous(0, [0, 1], "allreduce:z")
        assert time.monotonic() - t0 < 1.0

    def test_warn_then_recover(self):
        kv = store_kv()
        insp = SyncStallInspector(kv, rank=0, warn_s=0.05, abort_s=0,
                                  generation=1)
        t = threading.Timer(0.3, kv.key_value_set,
                            ("hvtstall/1/0/0/1", "op"))
        lg, h = _capture("horovod_tpu_torch")
        t.start()
        try:
            insp.rendezvous(0, [0, 1], "op")
        finally:
            t.join()
            lg.removeHandler(h)
        stalls = [m for m in h.msgs if "stalled collective" in m]
        assert stalls and "[1]" in stalls[0]

    def test_rolling_cleanup_keeps_the_store_bounded(self):
        kv = store_kv()
        insp = SyncStallInspector(kv, rank=0, warn_s=60, abort_s=0,
                                  generation=1)
        for seq in range(3):
            kv.key_value_set(f"hvtstall/1/0/{seq}/1", "op")
            insp.rendezvous(0, [0, 1], "op")
        assert [s for s in range(3)
                if _present(kv, f"hvtstall/1/0/{s}/0")] == [2]

    def test_generation_namespacing_ignores_stale_marks(self):
        kv = store_kv()
        kv.key_value_set("hvtstall/1/0/0/1", "old-op")
        kv.key_value_set("hvtstall/2/0/0/1", "new-op")
        insp = SyncStallInspector(kv, rank=0, warn_s=60, abort_s=0,
                                  generation=2)
        insp.rendezvous(0, [0, 1], "new-op")


class TestAmortizedInspector:
    def _make(self, kv, rank, warn_s=0.05, abort_s=0.0, hb=0.03, **kw):
        return AmortizedStallInspector(kv, rank, warn_s=warn_s,
                                       abort_s=abort_s, heartbeat_s=hb,
                                       generation=1, **kw)

    def test_healthy_path_stays_clean(self):
        kv = store_kv(2)
        a, b = self._make(kv, 0), self._make(kv, 1)
        try:
            for i in range(5):
                for insp in (a, b):
                    insp.pre_op(0, [0, 1], f"allreduce:t{i}")
                    insp.wait_ready(0, Ready())
            time.sleep(0.2)
            assert a.failure is None and b.failure is None
        finally:
            a.stop()
            b.stop()

    def test_pre_op_is_rpc_free(self):
        class ExplodingKV(FakeKV):
            def key_value_set(self, k, v):
                raise AssertionError("hot path hit the store")

        insp = AmortizedStallInspector(ExplodingKV(), 0, warn_s=60,
                                       abort_s=0, heartbeat_s=30.0,
                                       generation=1)
        try:
            t0 = time.monotonic()
            for _ in range(10_000):
                insp.pre_op(0, [0, 1], "allreduce:x")
                insp.wait_ready(0, torch.ones(2))   # a CPU result: ready
            assert time.monotonic() - t0 < 0.5
        finally:
            insp.stop()

    def test_mismatch_diagnosed_within_a_beat(self):
        kv = store_kv(2)
        a, b = self._make(kv, 0), self._make(kv, 1)
        try:
            a.pre_op(0, [0, 1], "allreduce:grad:(2,):float32")
            b.pre_op(0, [0, 1], "broadcast:weights:(2,):float32")
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline and not (
                    a.failure and b.failure):
                time.sleep(0.02)
            for insp, mine, theirs in (
                    (a, "allreduce:grad", "broadcast:weights"),
                    (b, "broadcast:weights", "allreduce:grad")):
                msg = insp.failure or ""
                assert "diverged" in msg and mine in msg and theirs in msg
        finally:
            a.stop()
            b.stop()

    def test_stall_abort_names_missing_ranks(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=0.05, abort_s=0.25)
        b = self._make(kv, 1, warn_s=0.05, abort_s=0.25)
        try:
            a.pre_op(0, [0, 1], "allreduce:loss:(4,):float32")
            with pytest.raises(HorovodInternalError) as ei:
                a.wait_ready(0, NeverReady())
            msg = str(ei.value)
            assert "stalled collective" in msg and "allreduce:loss" in msg
            assert "[1]" in msg
        finally:
            a.stop()
            b.stop()

    def test_wait_ready_raises_after_peer_failure(self):
        kv = store_kv(2)
        a, b = self._make(kv, 0), self._make(kv, 1)
        try:
            with a._lock:
                a.failure = "synthetic failure on rank 0"
            with pytest.raises(HorovodInternalError, match="rank 0"):
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    b.pre_op(0, [0, 1], "allreduce:x")
                    b.wait_ready(0, Ready())
                    time.sleep(0.02)
                pytest.fail("peer failure never propagated")
        finally:
            a.stop()
            b.stop()

    def test_dead_peer_mid_collective_detected_via_staleness(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=0.1, abort_s=0.6, stale_s=0.2)
        b = self._make(kv, 1, warn_s=0.1, abort_s=0.6, stale_s=0.2)
        try:
            a.pre_op(0, [0, 1], "allreduce:w:(8,):float32")
            b.pre_op(0, [0, 1], "allreduce:w:(8,):float32")
            time.sleep(0.1)
            b._stopped.set()
            with pytest.raises(HorovodInternalError) as ei:
                a.wait_ready(0, NeverReady())
            assert "stalled collective" in str(ei.value)
            assert "[1]" in str(ei.value)
        finally:
            a.stop()
            b.stop()

    def test_rearm_names_outer_op_and_keeps_its_clock(self):
        insp = AmortizedStallInspector(store_kv(2), 0, warn_s=60, abort_s=0,
                                       heartbeat_s=30.0, generation=1)
        try:
            outer = insp.pre_op(0, [0, 1], "alltoall:x:(4,):float32")
            t_outer = insp._tracks["0"].t0
            time.sleep(0.02)
            insp.pre_op(0, [0, 1], "allgather:splits:(2,):int32")
            insp.wait_ready(0, Ready())
            assert insp._tracks["0"].inflight is None

            class ReadyAfter:
                n = 0

                def query(self):
                    self.n += 1
                    if self.n == 1:
                        tr = insp._tracks["0"]
                        assert tr.inflight == "alltoall:x:(4,):float32"
                        assert tr.t0 == t_outer
                    return self.n > 1

            insp.wait_ready(0, ReadyAfter(), outer)
            assert insp._tracks["0"].inflight is None
        finally:
            insp.stop()

    def test_slow_collective_everyone_present_no_warn(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=0.05, abort_s=0.0)
        b = self._make(kv, 1, warn_s=0.05, abort_s=0.0)
        lg, h = _capture("horovod_tpu_torch")
        try:
            a.pre_op(0, [0, 1], "allreduce:big")
            b.pre_op(0, [0, 1], "allreduce:big")
            time.sleep(0.3)
            assert a.failure is None and b.failure is None
            assert not [m for m in h.msgs if "stalled" in m]
        finally:
            lg.removeHandler(h)
            a.stop()
            b.stop()

    def test_guard_marks_and_diverged_names(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=60)
        b = self._make(kv, 1, warn_s=60)
        try:
            a.pre_op("jit.0", [0, 1], "jit_step:train")
            b.pre_op("jit.0", [0, 1], "jit_step:evaluate")
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline and not a.failure:
                time.sleep(0.02)
            assert a.failure and "jit_step:train" in a.failure
            assert "jit_step:evaluate" in a.failure
        finally:
            a.stop()
            b.stop()

    def test_stopped_ranks_tombstone_propagates_failure(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=60, hb=5.0)
        b = self._make(kv, 1, warn_s=60)
        try:
            with a._lock:
                a.failure = ("collective mismatch at process set 0 op "
                             "#3: ... diverged ...")
            a.stop()
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline and not b.failure:
                time.sleep(0.02)
            assert b.failure and "rank 0 aborted" in b.failure
            assert "diverged" in b.failure
        finally:
            a.stop()
            b.stop()

    def test_clean_exit_not_blamed(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=0.05, abort_s=0.3, stale_s=0.15)
        b = self._make(kv, 1, warn_s=0.05, abort_s=0.3, stale_s=0.15)
        try:
            a.pre_op("jit.0", [0, 1], "jit_step:s")
            b.pre_op("jit.0", [0, 1], "jit_step:s")
            time.sleep(0.1)
            b.stop()
            time.sleep(0.5)
            assert a.failure is None, a.failure
        finally:
            a.stop()
            b.stop()

    def test_debug_state_reports_ages_and_counters(self):
        kv = store_kv(2)
        a, b = self._make(kv, 0), self._make(kv, 1)
        try:
            time.sleep(0.15)
            state = a.debug_state()
            assert state["mode"] == "amortized" and state["failure"] is None
            assert "1" in state["peer_heartbeat_age_s"]
            assert set(state["counters"]) == {"stall_warnings",
                                              "stall_aborts"}
        finally:
            a.stop()
            b.stop()


class TestWaitReadyProbes:
    """What the completion wait polls in the port: a CUDA event's
    ``query``, a ``Work``'s ``is_completed`` (then ``wait``), a CPU
    result as ready, a list when every item is."""

    def _insp(self):
        return AmortizedStallInspector(store_kv(2), 0, warn_s=60, abort_s=0,
                                       heartbeat_s=30.0, generation=1)

    def test_work_is_polled_then_waited(self):
        class Work:
            polls = 0
            waited = False

            def is_completed(self):
                self.polls += 1
                return self.polls > 3

            def wait(self):
                self.waited = True
                return True

        insp = self._insp()
        try:
            insp.pre_op(0, [0, 1], "allreduce:x")
            w = Work()
            insp.wait_ready(0, w)
            assert w.polls == 4 and w.waited
            assert insp._tracks["0"].inflight is None
        finally:
            insp.stop()

    def test_failed_work_surfaces_through_the_mapping(self):
        class Failed:
            def is_completed(self):
                return True

            def wait(self):
                raise RuntimeError("Connection closed by peer")

        st = SimpleNamespace(sync_stall=self._insp())
        st.sync_stall.heartbeat_s = 0.01
        ps = SimpleNamespace(size=2, process_set_id=0)
        try:
            st.sync_stall.pre_op(0, [0, 1], "allreduce:x")
            with pytest.raises(HorovodInternalError,
                               match="transport failure"):
                stall.finish(st, ps, Failed(), "allreduce:x")
        finally:
            st.sync_stall.stop()

    def test_cpu_results_and_lists(self):
        insp = self._insp()
        try:
            insp.pre_op(0, [0, 1], "x")
            insp.wait_ready(0, [torch.ones(2), None, Ready()])
            assert stall._ready_probe(torch.ones(1)) is None
            assert stall._ready_probe([torch.ones(1)]) is None
            assert stall._ready_probe([NeverReady(), Ready()])() is False
            assert not stall._pending_leaf(torch.ones(1))
            assert stall._pending_leaf(NeverReady())
        finally:
            insp.stop()

    def test_dispatch_runs_on_the_executor_in_the_callers_grad_mode(self):
        insp = self._insp()
        try:
            insp.pre_op(0, [0, 1], "x")
            with torch.no_grad():
                (name, grad), pending = insp.dispatch(0, lambda: (
                    threading.current_thread().name,
                    torch.is_grad_enabled()), ())
            assert name == "hvt-stall-dispatch" and grad is False
            assert pending is False
        finally:
            insp.stop()


class TestPoisonLatch:
    @pytest.fixture()
    def latched(self, monkeypatch):
        from horovod_tpu_torch.core import state as core_state

        st = core_state.global_state()
        insp = AmortizedStallInspector(
            store_kv(1), rank=0, warn_s=10, abort_s=0, heartbeat_s=60,
            generation=st.init_generation)
        monkeypatch.setattr(st, "sync_stall", insp)
        stall._latch_poison(insp)
        yield st, insp
        insp.stop()
        stall._reset_poison()

    def test_latch_requires_installed_inspector(self):
        stray = AmortizedStallInspector(store_kv(1), rank=0, warn_s=10,
                                        abort_s=0, heartbeat_s=60)
        try:
            stall._latch_poison(stray)
            assert not stall.poisoned()
        finally:
            stray.stop()

    def test_same_generation_is_terminal(self, latched):
        assert stall.poisoned()
        assert stall.poison_exit_status() == 1

    def test_clears_only_past_poisoning_generation(self, latched,
                                                   monkeypatch):
        st, insp = latched
        assert stall.poison_exit_status() == 1
        monkeypatch.setattr(st, "init_generation", insp.gen + 1)
        assert stall.poison_exit_status() == 0


class TestInflightLeakRegression:
    def _make(self, kv, rank, warn_s=0.05, abort_s=0.0, hb=0.03):
        return AmortizedStallInspector(kv, rank, warn_s=warn_s,
                                       abort_s=abort_s, heartbeat_s=hb,
                                       generation=1)

    def test_dispatch_error_clears_inflight(self):
        insp = self._make(store_kv(2), 0, warn_s=60, hb=30.0)
        try:
            insp.pre_op(0, [0, 1], "allreduce:x")

            def boom():
                raise ValueError("backend exploded")

            with pytest.raises(ValueError, match="exploded"):
                insp.dispatch(0, boom, ())
            assert insp._tracks["0"].inflight is None
        finally:
            insp.stop()

    def test_wait_ready_error_clears_inflight(self):
        insp = self._make(store_kv(2), 0, warn_s=60, hb=30.0)
        try:
            insp.pre_op(0, [0, 1], "allreduce:y")

            class Explodes:
                def query(self):
                    raise RuntimeError("torn result")

            with pytest.raises(RuntimeError, match="torn result"):
                insp.wait_ready(0, Explodes())
            assert insp._tracks["0"].inflight is None
        finally:
            insp.stop()

    def test_failed_attempt_never_becomes_false_stall_abort(self):
        kv = store_kv(2)
        a = self._make(kv, 0, warn_s=0.05, abort_s=0.25)
        b = self._make(kv, 1, warn_s=0.05, abort_s=0.25)
        try:
            a.pre_op(0, [0, 1], "allreduce:z")

            def boom():
                raise ValueError("attempt died")

            with pytest.raises(ValueError):
                a.dispatch(0, boom, ())
            time.sleep(0.6)
            assert a.failure is None, a.failure
        finally:
            a.stop()
            b.stop()


class TestWireConsensusUnit:
    def _wc(self, kv, deadline_s=5.0):
        return wirefault.WireConsensus(kv, 0, generation=1,
                                       hb_prefix="hvtstallhb/1/",
                                       deadline_s=deadline_s)

    def _hb(self, kv, rank, seq, inflight, bye=False, fail=None):
        kv.key_value_set(f"hvtstallhb/1/{rank}/0", json.dumps(
            {"bye": bye, "fail": fail,
             "sets": {"0": {"seq": seq, "inflight": inflight}}}))

    def test_all_voted_means_retry(self):
        kv = store_kv()
        for r in (1, 2):
            kv.key_value_set(f"hvtwire/1/0/5/0/{r}",
                             json.dumps({"st": "mid", "d": "allreduce:x"}))
        got = self._wc(kv).vote_and_decide(
            "0", 5, 0, [0, 1, 2], "allreduce:x", predispatch=False)
        assert got == wirefault.RETRY
        assert _present(kv, "hvtwire/1/0/5/0/0")

    def test_completed_peer_escalates(self):
        kv = store_kv()
        kv.key_value_set("hvtwire/1/0/5/0/1",
                         json.dumps({"st": "pre", "d": "allreduce:x"}))
        self._hb(kv, 2, seq=7, inflight=None)
        assert self._wc(kv).vote_and_decide(
            "0", 5, 0, [0, 1, 2], "allreduce:x",
            predispatch=True) == wirefault.ESCALATE

    def test_exited_peer_escalates(self):
        kv = store_kv()
        kv.key_value_set("hvtwire/1/0/5/0/1",
                         json.dumps({"st": "pre", "d": "allreduce:x"}))
        self._hb(kv, 2, seq=6, inflight="allreduce:x", bye=True)
        assert self._wc(kv).vote_and_decide(
            "0", 5, 0, [0, 1, 2], "allreduce:x",
            predispatch=True) == wirefault.ESCALATE

    def test_wedged_peers_late_join_retracts_vote(self):
        kv = store_kv()
        kv.key_value_set("hvtwire/1/0/5/0/1",
                         json.dumps({"st": "pre", "d": "allreduce:x"}))
        self._hb(kv, 2, seq=6, inflight="allreduce:x")
        assert self._wc(kv).vote_and_decide(
            "0", 5, 0, [0, 1, 2], "allreduce:x",
            predispatch=True) == wirefault.LATE_JOIN
        assert json.loads(kv.key_value_try_get(
            "hvtwire/1/0/5/0/0"))["st"] == "rejoin"

    def test_midflight_failure_never_late_joins(self):
        kv = store_kv()
        self._hb(kv, 2, seq=6, inflight="allreduce:x")
        t0 = time.monotonic()
        assert self._wc(kv, deadline_s=0.3).vote_and_decide(
            "0", 5, 0, [0, 2], "allreduce:x",
            predispatch=False) == wirefault.ESCALATE
        assert time.monotonic() - t0 < 5.0

    def test_deadline_escalates_on_silent_peer(self):
        assert self._wc(store_kv(), deadline_s=0.2).vote_and_decide(
            "0", 5, 0, [0, 1], "allreduce:x",
            predispatch=True) == wirefault.ESCALATE

    def test_rejoin_vote_never_licenses_next_attempt(self):
        kv = store_kv()
        kv.key_value_set("hvtwire/1/0/5/0/1",
                         json.dumps({"st": "rejoin", "d": "allreduce:x"}))
        wc = self._wc(kv, deadline_s=0.3)
        assert wc.vote_and_decide("0", 5, 0, [0, 1], "allreduce:x",
                                  predispatch=True) == wirefault.LATE_JOIN
        assert wc.vote_and_decide("0", 5, 0, [0, 1], "allreduce:x",
                                  predispatch=False) == wirefault.ESCALATE

    def test_cleanup_deletes_only_own_votes(self):
        kv = store_kv()
        kv.key_value_set("hvtwire/1/0/5/0/1", json.dumps({"st": "mid"}))
        wc = self._wc(kv)
        wc.vote_and_decide("0", 5, 0, [0, 1], "op", predispatch=False)
        wc.cleanup("0", 5, attempts=1)
        assert not _present(kv, "hvtwire/1/0/5/0/0")
        assert _present(kv, "hvtwire/1/0/5/0/1")

    def test_attempt_tag_namespaces_are_disjoint(self):
        from horovod_tpu_torch.native.wire import attempt_tag, split_attempt

        assert attempt_tag("hvt/allreduce/x", 0) == "hvt/allreduce/x"
        tagged = attempt_tag("hvt/allreduce/x", 3)
        assert split_attempt(tagged) == ("hvt/allreduce/x", 3)
        assert len({attempt_tag("k", a) for a in range(5)}) == 5


class TestWireRetryLoop:
    def _harness(self, kv):
        insp = AmortizedStallInspector(kv, 0, warn_s=60, abort_s=0,
                                       heartbeat_s=0.05, generation=1)
        st = SimpleNamespace(sync_stall=insp)
        ps = SimpleNamespace(size=2, process_set_id=0)
        insp.pre_op(0, [0], "allreduce:r:(2,):float32")
        return insp, st, ps

    def test_consensus_retry_delivers_result(self, monkeypatch):
        monkeypatch.setenv("HVTPU_WIRE_RETRIES", "2")
        monkeypatch.setenv("HVTPU_WIRE_RETRY_BACKOFF_S", "0.01")
        faults.install("wire.send:drop@times=1", rank=0)
        kv = store_kv(1)
        insp, st, ps = self._harness(kv)
        before = wirefault._M_RETRIES.value()
        try:
            out = stall.dispatch(st, ps, lambda: 42, (),
                                 desc="allreduce:r:(2,):float32")
            assert out == 42
            assert wirefault._M_RETRIES.value() == before + 1
            assert not _present(kv, "hvtwire/1/0/0/0/0")
            insp.wait_ready(0, out)
            assert insp._tracks["0"].inflight is None
        finally:
            insp.stop()

    def test_retries_disabled_is_failfast(self, monkeypatch):
        monkeypatch.delenv("HVTPU_WIRE_RETRIES", raising=False)
        faults.install("wire.send:drop@times=1", rank=0)
        kv = store_kv(1)
        insp, st, ps = self._harness(kv)
        try:
            with pytest.raises(HorovodInternalError,
                               match="transport failure"):
                stall.dispatch(st, ps, lambda: 42, ())
            assert not _present(kv, "hvtwire/1/0/0/0/0")
        finally:
            insp.stop()

    def test_budget_exhaustion_escalates(self, monkeypatch):
        monkeypatch.setenv("HVTPU_WIRE_RETRIES", "2")
        monkeypatch.setenv("HVTPU_WIRE_RETRY_BACKOFF_S", "0.01")
        faults.install("wire.send:drop", rank=0)
        insp, st, ps = self._harness(store_kv(1))
        try:
            with pytest.raises(HorovodInternalError,
                               match="transport failure"):
                stall.dispatch(st, ps, lambda: 42, ())
        finally:
            insp.stop()

    def test_non_transport_error_is_not_retried(self, monkeypatch):
        monkeypatch.setenv("HVTPU_WIRE_RETRIES", "3")

        def boom():
            raise ValueError("a real bug, not the wire")

        insp, st, ps = self._harness(store_kv(1))
        try:
            with pytest.raises(ValueError, match="real bug"):
                stall.dispatch(st, ps, boom, ())
        finally:
            insp.stop()

    def test_exec_and_recv_sites_are_midflight(self, monkeypatch):
        monkeypatch.delenv("HVTPU_WIRE_RETRIES", raising=False)
        for spec in ("collective.exec:drop@times=1",
                     "wire.recv:drop@times=1"):
            faults.install(spec, rank=0)
            insp, st, ps = self._harness(store_kv(1))
            try:
                with pytest.raises(HorovodInternalError,
                                   match="injected"):
                    stall.dispatch(st, ps, lambda: 42, (), owner=spec)
                assert insp._tracks["0"].inflight is None
            finally:
                insp.stop()
                faults.uninstall()


# -- the engaged rule, the modes and the guard at one rank --------------------

def test_passthrough_at_one_rank_and_on_bypass_threads():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as core_state

    hvd.init(device="cpu")
    try:
        st = core_state.global_state()
        ps = st.process_set_table.get(0)
        assert stall.check(st, ps, "allreduce:x") is None
        assert not stall.engaged(st, ps)
        assert stall.dispatch(st, ps, lambda: 7, ()) == 7
        assert st.sync_stall is None            # never made at one rank
        calls = []

        @hvd.stall_guard(name="t")
        def step(x):
            calls.append(1)
            return x + 1

        assert float(step(torch.zeros(()))) == 1.0 and calls == [1]
        two = SimpleNamespace(size=2, process_set_id=0, ranks=[0, 1])
        seen = []

        def bypassed():
            stall.bypass_thread()
            seen.append((stall.bypass_active(),
                         stall.check(st, two, "x"), stall.engaged(st, two)))

        t = threading.Thread(target=bypassed)
        t.start()
        t.join()
        assert seen == [(True, None, False)]
        assert not stall.bypass_active()
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("mode,cls", [("amortized", AmortizedStallInspector),
                                      ("strict", SyncStallInspector)])
def test_make_inspector_modes(mode, cls):
    from horovod_tpu_torch.core.config import Config

    st = SimpleNamespace(kv=store_kv(2), rank=0, init_generation=3,
                         sync_stall=None)
    cfg = Config(stall_check_mode=mode, stall_heartbeat_seconds=30.0)
    insp = stall._make_inspector(st, cfg)
    try:
        assert type(insp) is cls and st.sync_stall is insp
        assert insp.gen == 3
        assert type(insp._kv).__name__ == "FencedKV"
    finally:
        stall.stop(st)
    assert st.sync_stall is None
    with pytest.raises(ValueError, match="amortized' or 'strict"):
        stall._make_inspector(st, Config(stall_check_mode="eager"))
    st.kv = None
    assert stall._make_inspector(st, cfg) is None and st.sync_stall is False


# -- 2 ranks over gloo --------------------------------------------------------

HB = "HVTPU_STALL_HEARTBEAT_SECONDS"
WARN = "HVTPU_STALL_CHECK_TIME_SECONDS"
ABORT = "HVTPU_STALL_SHUTDOWN_TIME_SECONDS"


def _run(tmp_path, scenario, env, timeout=60.0):
    return spawn_world(stall_worker, 2, tmp_path, scenario, env,
                       timeout=timeout)


def test_two_rank_healthy_path_transparent_and_wire_retry(tmp_path):
    codes, res = _run(tmp_path, "healthy", {
        WARN: "5", ABORT: "30", HB: "0.1", "HVTPU_WIRE_RETRIES": "1",
        "HVTPU_WIRE_CONSENSUS_S": "10", "HVTPU_FUSION_THRESHOLD": "20000"})
    assert codes == [0, 0], res
    for r in res:
        assert r["mode"] == "amortized"
        # the watchdog is transparent: bitwise the unguarded op matrix
        assert r["guarded"] == r["plain"]
        assert r["counters"] == {"stall_warnings": 0, "stall_aborts": 0}
        assert all(np.isfinite(r["losses"]))
        # the dropped send was recovered: bitwise the clean result
        assert r["faulted"] == r["clean"] and r["ok"] == 2.0
    assert res[0]["params"] == res[1]["params"]
    for op in ("allreduce", "average", "max", "int8", "adasum", "grouped",
               "allgather", "broadcast"):
        assert res[0]["guarded"][op] == res[1]["guarded"][op], op
    assert res[0]["retries"] >= 1 and res[1]["retries"] == 0


def test_two_rank_skipped_collective_aborts_naming_the_rank(tmp_path):
    abort, hb = 1.5, 0.1
    codes, res = _run(tmp_path, "skipped",
                      {WARN: "0.5", ABORT: str(abort), HB: str(hb)})
    r0, r1 = res
    assert r0["status"] == "aborted", res
    assert "stalled collective" in r0["msg"] and "allreduce" in r0["msg"]
    assert "[1]" in r0["msg"]
    assert r0["age"] < abort + 2 * hb
    assert r1["status"] == "skipped"
    # the abandoned collective poisoned rank 0: its exit hook hard-exits
    assert r0["poisoned"] and codes == [1, 0]
    # the warning and abort families counted it, and the flight recorder
    # left a postmortem whose ring names the op
    assert r0["counters"]["stall_warnings"] >= 1
    assert r0["counters"]["stall_aborts"] >= 1
    pm = r0["postmortem"]
    assert pm["reason"] == "stall_abort" and pm["rank"] == 0
    aborts = [e for e in pm["events"] if e["kind"] == "stall_abort"]
    assert aborts and "allreduce" in aborts[-1]["detail"]
    assert "stall" in pm["debug"]


@pytest.mark.parametrize("mode", ["amortized", "strict"])
def test_two_rank_diverged_collectives_name_both_ops(tmp_path, mode):
    abort, hb = 10.0, 0.2
    codes, res = _run(tmp_path, "diverged", {
        "HVTPU_STALL_CHECK_MODE": mode, WARN: "1", ABORT: str(abort),
        HB: str(hb)})
    assert all(r is not None for r in res), codes
    hits = [r for r in res if r["status"] == "mismatch"]
    assert hits, res
    for r in hits:
        assert "diverged" in r["msg"]
        assert "grads" in r["msg"] and "broadcast" in r["msg"]
        assert r["waited"] < abort + 2 * hb
        # the abort family counted it; the postmortem names the op
        assert r["counters"]["stall_aborts"] >= 1
        assert "grads" in json.dumps(r["postmortem"])


def test_two_rank_optimizer_names_the_rank_that_stopped(tmp_path):
    abort, hb = 1.5, 0.2
    codes, res = _run(tmp_path, "optimizer", {
        WARN: "0.5", ABORT: str(abort), HB: str(hb)})
    r0, r1 = res
    assert r1["status"] == "stopped" and r1["buckets"] == 1
    assert r0["status"] == "aborted", res
    # the bucket's descriptor: its index, byte count and wire dtype
    assert "bucket:0:" in r0["msg"] and "torch.float32" in r0["msg"]
    assert "[1]" in r0["msg"]
    assert r0["age"] < abort + 2 * hb


@pytest.mark.parametrize("stream", ["0", "1"], ids=["lockstep", "streamed"])
def test_two_rank_controller_warns_then_aborts(tmp_path, stream):
    warn, abort = 0.3, 1.2
    codes, res = _run(tmp_path, "controller", {
        "HVTPU_EAGER_STREAM": stream, WARN: str(warn), ABORT: str(abort),
        "HVTPU_CYCLE_TIME": "0.5"})
    r0, r1 = res
    assert r0["plane"] == ("lockstep" if stream == "0" else "streamed")
    assert r0["status"] == "aborted", res
    assert "'lonely'" in r0["msg"] and "missing ranks [1]" in r0["msg"]
    warned = [(t, m) for t, m in r0["warnings"]
              if m.startswith("stalled collective 'lonely'")]
    assert warned and "ranks missing [1]" in warned[0][1]
    assert warn <= warned[0][0] < r0["waited"]
    assert abort < r0["waited"] < abort + 1.0
    assert r1["status"] == "skipped"


@pytest.mark.parametrize("abort,disable,backend,want_s", [
    (0.0, False, "gloo", None),         # no abort: the backend's timeout
    (30.0, False, "gloo", None),        # well inside gloo's 30 min
    (3000.0, False, "gloo", 3060.0),    # raised: the abort comes first
    (3000.0, True, "gloo", None),       # watchdog off: nothing to keep
])
def test_group_timeout_keeps_the_stall_abort_first(abort, disable, backend,
                                                  want_s):
    from horovod_tpu_torch.core import state as core_state
    from horovod_tpu_torch.core.config import Config

    cfg = Config(stall_shutdown_time_seconds=abort,
                 stall_check_disable=disable)
    got = core_state._group_timeout(cfg, backend)
    assert (None if got is None else got.total_seconds()) == want_s

"""The streamed control plane, schedule prediction and the zero-copy
fusion plane of the port's async controller
(``horovod_tpu_torch/eager/controller.py``), on the CPU.

* In-process worlds of 2, 3 and 4 controllers over one ``HashStore``,
  built as the JAX package's ``tests/test_eager_controller.py``
  ``make_world`` builds them: N controllers in one process, their data
  plane in this process's world of one (so results are local values),
  which pins the coordination.  Ported from that file's prediction tests
  and its zero-copy lattice ({predicted, mispredicted} x {lockstep,
  streamed}): steady bursts predict and are confirmed with no
  mispredict; a mispredict, injected or made by a rank that deviates
  from the steady burst, forces a resync and the world converges;
  ``quiesce`` rolls back unconfirmed predictions and returns open
  exchange buffers; steady bursts learn a pack plan and go zero-copy; a
  stale grouping stages.  The reference's tests of tracing, preemption,
  faults and stall aborts have no counterpart: those planes are not
  ported.
* The coordinator's calls of a streamed world with predictions and a
  mispredict, replayed through the JAX package's core
  (``horovod_tpu.native.fallback.PyController``): every response blob
  byte for byte.
* The response stream is garbage-collected on a store that deletes.
* The in-process tests run on the default negotiation core (C++); those
  parametrized by size run on the Python core too (ids ``<size>-py``),
  and ``test_on_the_python_core`` runs the others there.
* A 2-process gloo world on the default plane (streamed) runs bursts of
  ``allreduce_async_`` and an fp16 grouped burst: bitwise the same run
  on the lockstep plane (``HVTPU_EAGER_STREAM=0``) and the plain
  composition, with predictions and zero-copy ops on the streamed run.
"""

import inspect
import multiprocessing
import os
import pickle
import threading
import time
import timeit

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.comm.compression import NoneCompressor
from horovod_tpu_torch.comm.reduce_ops import ReduceOp
from horovod_tpu_torch.eager.controller import (
    EagerController,
    KVTransport,
    _Payload,
)
from horovod_tpu_torch.native import wire
from torch_port_util import STREAM_STEPS, stream_inputs, stream_worker
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

SIZES = [2, 3, 4]
# the sizes on both negotiation cores: "<size>-py" runs the Python core
BOTH_CORES = SIZES + [pytest.param(s, id=f"{s}-py") for s in SIZES]


@pytest.fixture(autouse=True)
def _core(request, monkeypatch):
    """``HVTPU_FORCE_PY_CONTROLLER=1`` for the ``-py`` cases."""
    if request.node.name.endswith("-py]"):
        monkeypatch.setenv("HVTPU_FORCE_PY_CONTROLLER", "1")


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    """The data plane under the in-process controllers."""
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def make_world(size, store=None, **kw):
    store = dist.HashStore() if store is None else store
    ctrls = [EagerController(
        r, size, transport=KVTransport(r, size, client=store, timeout_s=20.0),
        cycle_time_ms=0.5, **kw) for r in range(size)]
    for c in ctrls:
        c.start()
    return ctrls


def stop_world(ctrls):
    # announce shutdown everywhere first so no controller lingers
    for c in ctrls:
        c.request_shutdown()
    for c in ctrls:
        c.stop()


def run_steady(ctrls, steps, start=0, names=2):
    for step in range(start, start + steps):
        futs = [c.enqueue("allreduce", torch.full((4,), float(step)),
                          name=f"ps/{i}", op=ReduceOp.AVERAGE)
                for c in ctrls for i in range(names)]
        for f in futs:
            assert torch.equal(f.result(timeout=20),
                               torch.full((4,), float(step)))


def quiesce_all(ctrls):
    for c in ctrls:
        assert c._thread_error is None
        assert c.quiesce(timeout=10) is True
        assert not c._predicted and not c._open_packs


# -- prediction (the reference's TestPredictedSchedules) ----------------------

@pytest.mark.parametrize("size", BOTH_CORES)
def test_streamed_plane_predicts_confirms_and_drains(size):
    ctrls = make_world(size)
    try:
        assert all(c.debug_state()["plane"] == "streamed" for c in ctrls)
        run_steady(ctrls, steps=30)
        for c in ctrls:
            assert c.predicted_bursts > 0
            assert c.mispredicts == 0
        t0 = time.monotonic()
        quiesce_all(ctrls)
        # the confirmations came: nothing waited for a rollback
        assert time.monotonic() - t0 < 5
    finally:
        stop_world(ctrls)


@pytest.mark.parametrize("size", BOTH_CORES)
def test_injected_mispredict_forces_resync_and_converges(size):
    ctrls = make_world(size)
    try:
        run_steady(ctrls, steps=30)
        assert ctrls[0].predicted_bursts > 0
        with ctrls[0]._lock:
            ctrls[0]._on_mispredict("test-injected disagreement")
        assert ctrls[0].mispredicts == 1
        assert ctrls[0]._pack_plan is None
        run_steady(ctrls, steps=10, start=30)
        quiesce_all(ctrls)
    finally:
        stop_world(ctrls)


@pytest.mark.parametrize("size", BOTH_CORES)
def test_a_deviating_rank_forces_a_mispredict_and_converges(size):
    """After a steady pattern, the last rank enqueues a new name before
    the steady pair: its capped drain is no bypass blob and splits the
    pair, so the coordinator releases one fused group of all three where
    rank 0 predicted the pair alone: a real mispredict, a resync, and the
    world goes on with correct results."""
    ctrls = make_world(size)
    try:
        run_steady(ctrls, steps=30)
        assert all(c.predicted_bursts > 0 for c in ctrls)
        futs = [ctrls[-1].enqueue("allreduce", torch.full((4,), 7.0),
                                  name="ps/x", op=ReduceOp.AVERAGE)]
        futs += [c.enqueue("allreduce", torch.full((4,), 7.0),
                           name=f"ps/{i}", op=ReduceOp.AVERAGE)
                 for c in ctrls for i in range(2)]
        time.sleep(0.05)
        futs += [c.enqueue("allreduce", torch.full((4,), 7.0),
                           name="ps/x", op=ReduceOp.AVERAGE)
                 for c in ctrls[:-1]]
        for f in futs:
            assert torch.equal(f.result(timeout=20), torch.full((4,), 7.0))
        deadline = time.monotonic() + 10
        while ctrls[0].mispredicts == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctrls[0].mispredicts >= 1
        run_steady(ctrls, steps=10, start=40)
        quiesce_all(ctrls)
    finally:
        stop_world(ctrls)


def test_reset_across_cache_resync_and_membership_change():
    """A coordinator-forced resync, a membership change and an error
    response reset the burst gate's steady size itself and everything
    the predictor learned; abandoned predicted names are tolerated if
    their real responses come later."""
    for rl in (wire.ResponseList(cache_resync_needed=True),
               wire.ResponseList(join_last_rank=1),
               wire.ResponseList(responses=[wire.Response(
                   tensor_names=["e"], tensor_shapes=[(2,)],
                   error="cross-rank mismatch")])):
        ctrl = EagerController(0, 1, manual=True)
        try:
            with ctrl._lock:
                ctrl._expected_burst = 4
                ctrl._burst_stable = 5
                ctrl._verified_bits.add((1, 2, 3))
                ctrl._observe.append(((1, 2), [], []))
                ctrl._predicted.append(
                    {"hash": 0x1234, "responses": [], "names": ["rx"]})
            ctrl._dispatch_execution(rl)
            assert ctrl._expected_burst == 0 and ctrl._burst_stable == 0
            assert not ctrl._verified_bits and not ctrl._observe
            assert not ctrl._predicted
            assert "rx" in ctrl._mispredict_names
        finally:
            ctrl.stop()


def test_quiesce_rolls_back_unconfirmed_predictions():
    ctrl = EagerController(0, 1, manual=True)
    try:
        with ctrl._lock:
            ctrl._predicted.append(
                {"hash": 0xDEAD, "responses": [], "names": ["q1"]})
        t0 = time.monotonic()
        assert ctrl.quiesce(timeout=0.4) is True
        # it waited for the confirmation before giving up on it
        assert time.monotonic() - t0 >= 0.35
        assert not ctrl._predicted
        assert "q1" in ctrl._mispredict_names
        # the rollback re-anchors: the next drain is a full resync frame
        assert wire.parse_request_list(
            ctrl._ctrl.drain_requests()).cache_resync
    finally:
        ctrl.stop()


def test_burst_hint_and_burst_cap_knob(monkeypatch):
    ctrl = EagerController(0, 1, manual=True)
    try:
        ctrl.hint_burst(4)
        blob = wire.serialize_request_list(wire.RequestList(rank=0))
        ctrl._note_drained(2, blob)  # a split burst keeps the hint
        assert ctrl._burst_hint == 4
        ctrl._note_drained(4, blob)  # the full burst consumes it
        assert ctrl._burst_hint == 0
        ctrl.hint_burst(-3)
        assert ctrl._burst_hint == 0
        assert ctrl._burst_cap_on is True
    finally:
        ctrl.stop()
    monkeypatch.setenv("HVTPU_EAGER_BURST_CAP", "0")
    monkeypatch.setenv("HVTPU_EAGER_PREDICT", "0")
    ctrl = EagerController(0, 1, manual=True)
    assert not ctrl._burst_cap_on and not ctrl._predict_on
    ctrl.stop()


def test_predict_off_and_lockstep_knobs(monkeypatch):
    monkeypatch.setenv("HVTPU_EAGER_PREDICT", "0")
    ctrls = make_world(2)
    try:
        run_steady(ctrls, steps=12)
        assert all(c.predicted_bursts == 0 for c in ctrls)
    finally:
        stop_world(ctrls)
    monkeypatch.setenv("HVTPU_EAGER_STREAM", "0")
    ctrls = make_world(2)
    try:
        run_steady(ctrls, steps=4)
        assert all(c.debug_state()["plane"] == "lockstep" for c in ctrls)
    finally:
        stop_world(ctrls)


# -- the zero-copy lattice ----------------------------------------------------

def steady_manual(ctrl, steps, start=0, names=2, out=False):
    """The lockstep analog of ``run_steady``: the same burst each cycle,
    driven by ``run_cycle_once``."""
    for step in range(start, start + steps):
        ts = [torch.full((4,), float(step)) for _ in range(names)]
        futs = [ctrl.enqueue("allreduce", t, name=f"zc/{i}",
                             op=ReduceOp.AVERAGE, out=t if out else None)
                for i, t in enumerate(ts)]
        ctrl.run_cycle_once()
        for t, f in zip(ts, futs):
            r = f.result(timeout=10)
            assert torch.equal(r, torch.full((4,), float(step)))


def test_predicted_lockstep_packs_at_enqueue():
    """Steady lockstep bursts learn a pack plan from the staged route,
    then every later burst is zero-copy; the in-place ops' tensors get
    their results straight from the group's unpack."""
    ctrl = EagerController(0, 1, manual=True)
    try:
        steady_manual(ctrl, steps=4)
        assert ctrl.staged_copies >= 4
        assert set(ctrl._pack_plan) == {"zc/0", "zc/1"}
        zc = ctrl.zero_copy_ops
        steady_manual(ctrl, steps=3, start=4)
        assert ctrl.zero_copy_ops - zc == 3 * 2
        assert not ctrl._open_packs
        assert ctrl._fusion_pool.stats()["pooled"] >= 1
        t = torch.full((4,), 9.0)
        f = ctrl.enqueue("allreduce", t, name="zc/0", op=ReduceOp.AVERAGE,
                         out=t)
        f2 = ctrl.enqueue("allreduce", torch.full((4,), 9.0), name="zc/1",
                          op=ReduceOp.AVERAGE)
        ctrl.run_cycle_once()
        assert f.result(timeout=10).data_ptr() == t.data_ptr()
        assert torch.equal(f2.result(timeout=10), t)
    finally:
        ctrl.stop()


def test_mispredicted_lockstep_falls_back_staged():
    ctrl = EagerController(0, 1, manual=True)
    try:
        steady_manual(ctrl, steps=4)
        assert ctrl._pack_plan is not None
        futs = [ctrl.enqueue("allreduce", torch.full((4,), 9.0),
                             name=f"zc/{i}", op=ReduceOp.AVERAGE)
                for i in range(2)]
        assert ctrl._open_packs  # the enqueue-time pack happened
        zc, st = ctrl.zero_copy_ops, ctrl.staged_copies
        with ctrl._lock:
            ctrl._on_mispredict("test-injected disagreement")
        assert not ctrl._open_packs and ctrl._pack_plan is None
        ctrl.run_cycle_once()
        for f in futs:
            assert torch.equal(f.result(timeout=10), torch.full((4,), 9.0))
        assert ctrl.staged_copies - st == 2 and ctrl.zero_copy_ops == zc
    finally:
        ctrl.stop()


def test_stale_grouping_releases_pack_and_stages():
    ctrl = EagerController(0, 1, manual=True)
    try:
        steady_manual(ctrl, steps=4)
        zc, st = ctrl.zero_copy_ops, ctrl.staged_copies
        futs = [ctrl.enqueue("allreduce", torch.full((4,), 5.0),
                             name=f"zc/{i}", op=ReduceOp.AVERAGE)
                for i in range(2)]
        futs.append(ctrl.enqueue("allreduce", torch.full((4,), 5.0),
                                 name="zc/extra", op=ReduceOp.AVERAGE))
        ctrl.run_cycle_once()
        for f in futs:
            assert torch.equal(f.result(timeout=10), torch.full((4,), 5.0))
        assert ctrl.staged_copies - st == 3 and ctrl.zero_copy_ops == zc
        assert ctrl.quiesce(timeout=5) is True
        assert not ctrl._open_packs
    finally:
        ctrl.stop()


@pytest.mark.parametrize("size", BOTH_CORES)
def test_predicted_streamed_goes_zero_copy(size):
    ctrls = make_world(size)
    try:
        run_steady(ctrls, steps=30)
        for c in ctrls:
            assert c.zero_copy_ops > 0 and c.mispredicts == 0
            assert c._pack_plan is not None
        quiesce_all(ctrls)
    finally:
        stop_world(ctrls)


def test_mispredicted_streamed_re_anchors_and_recovers():
    ctrls = make_world(2)
    try:
        run_steady(ctrls, steps=30)
        st = ctrls[0].staged_copies
        with ctrls[0]._lock:
            ctrls[0]._on_mispredict("test-injected disagreement")
        assert ctrls[0]._pack_plan is None
        run_steady(ctrls, steps=10, start=30)
        assert ctrls[0].staged_copies > st   # the next bursts staged
        zc = ctrls[0].zero_copy_ops
        run_steady(ctrls, steps=25, start=40)
        assert ctrls[0].zero_copy_ops > zc   # re-proven, zero-copy again
        quiesce_all(ctrls)
    finally:
        stop_world(ctrls)


def test_quiesce_returns_pooled_buffers():
    ctrl = EagerController(0, 1, manual=True)
    try:
        specs = [((4,), torch.float32, 16)]
        with ctrl._lock:
            ctrl._open_packs[(0, ("qa", "qb"))] = (
                ctrl._fusion_pool.acquire(0, specs))
        assert ctrl._fusion_pool.stats()["pooled"] == 0
        assert ctrl.quiesce(timeout=5) is True
        assert not ctrl._open_packs
        assert ctrl._fusion_pool.stats()["pooled"] == 1
    finally:
        ctrl.stop()


def test_nonsteady_enqueue_prepack_is_under_5us():
    ctrl = EagerController(0, 1, manual=True)
    try:
        assert ctrl._pack_plan is None
        p = _Payload(seq=1, name="t/0", future=None, tensor=torch.ones(4),
                     rop=ReduceOp.SUM, prescale=1.0, postscale=1.0,
                     compressor=NoneCompressor, splits=None,
                     kind="allreduce", process_set=None, psid=0,
                     root_rank=-1, t_enqueue=0.0)
        n = 100_000
        t = timeit.timeit(lambda: ctrl._maybe_prepack(p), number=n)
        assert t / n < 5e-6, f"prepack hook: {t / n * 1e9:.0f} ns/op"
    finally:
        ctrl.stop()


# -- replay through the reference core, and the stream's GC -------------------

@pytest.mark.parametrize("size", BOTH_CORES)
def test_coordinator_streamed_blobs_replay_through_the_reference_core(size):
    from horovod_tpu.native.fallback import PyController

    store = dist.HashStore()
    ctrls = [EagerController(
        r, size, transport=KVTransport(r, size, client=store, timeout_s=20.0),
        cycle_time_ms=0.5) for r in range(size)]
    log, lock = [], threading.Lock()
    core = ctrls[0]._ctrl
    for method in ("ingest", "compute_responses", "apply_responses"):
        orig = getattr(core, method)

        def wrapped(*args, _orig=orig, _m=method):
            with lock:
                out = _orig(*args)
                log.append((_m, args, out))
            return out
        setattr(core, method, wrapped)
    for c in ctrls:
        c.start()
    try:
        run_steady(ctrls, steps=20)
        with ctrls[0]._lock:
            ctrls[0]._on_mispredict("test-injected disagreement")
        run_steady(ctrls, steps=10, start=20)
        quiesce_all(ctrls)
    finally:
        stop_world(ctrls)
    ref = PyController(0, size, 64 * 1024 * 1024, 1024)
    computed = confirms = 0
    for method, args, result in log:
        got = getattr(ref, method)(*args)
        if method == "compute_responses":
            assert got == result
            computed += 1
            confirms += len(wire.parse_response_list(got).confirm_hashes)
    assert computed > 20 and confirms > 0
    assert any(wire.parse_request_list(a[0]).predicted
               for m, a, _ in log if m == "ingest")


def test_response_stream_is_garbage_collected():
    store = dist.HashStore()
    ctrls = make_world(2, store=store)
    try:
        for step in range(400):
            run_steady(ctrls, steps=1, start=step, names=1)
            if ctrls[0]._resp_gc > 0:
                break
        floor = ctrls[0]._resp_gc
        assert floor > 0, "no GC pass in 400 steps"
        kv = dist.PrefixStore("hvt_eager", store)
        assert not kv.check(["resp/0"])
        assert not kv.check([f"resp/{floor - 1}"])
        assert kv.check([f"resp/{ctrls[0]._resp_idx - 1}"])
        # the consumed request blobs are gone too
        assert not kv.check(["q/1/0"])
    finally:
        stop_world(ctrls)


# -- 2 processes over gloo: streamed vs lockstep ------------------------------

@pytest.fixture(scope="module")
def two_rank_planes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream2")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=stream_worker,
                         args=(r, 2, str(tmp / "store"), str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0, 0]
    out = []
    for r in range(2):
        with open(tmp / f"stream{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_two_rank_streamed_plane_is_bitwise_the_lockstep_plane(
        two_rank_planes):
    half = np.float32(0.5)
    for r, out in enumerate(two_rank_planes):
        streamed, lockstep = out["default"], out["lockstep"]
        assert streamed["state"]["plane"] == "streamed"
        assert lockstep["state"]["plane"] == "lockstep"
        assert streamed["state"]["predicted_bursts"] > 0
        assert streamed["state"]["mispredicts"] == 0
        assert lockstep["state"]["predicted_bursts"] == 0
        for run in (streamed, lockstep):
            assert run["state"]["zero_copy_ops"] > 0
        for step in range(STREAM_STEPS):
            xs = [stream_inputs(q, step) for q in range(2)]
            for i in range(len(xs[0])):
                key = f"s{step}/{i}"
                want = (xs[0][i] + xs[1][i]) * half
                assert streamed[key].tobytes() == lockstep[key].tobytes()
                assert streamed[key].tobytes() == want.tobytes(), key
        gs = [stream_inputs(q, 99) for q in range(2)]
        for i in range(len(gs[0])):
            f16 = [(g[i] * half).astype(np.float16) for g in gs]
            want = (f16[0] + f16[1]).astype(np.float32) * np.float32(2.0)
            assert streamed[f"g/{i}"].tobytes() == want.tobytes()
            assert lockstep[f"g/{i}"].tobytes() == want.tobytes()


# -- the Python core ------------------------------------------------------------

PY_CORE_TESTS = [
    test_reset_across_cache_resync_and_membership_change,
    test_quiesce_rolls_back_unconfirmed_predictions,
    test_burst_hint_and_burst_cap_knob,
    test_predict_off_and_lockstep_knobs,
    test_predicted_lockstep_packs_at_enqueue,
    test_mispredicted_lockstep_falls_back_staged,
    test_stale_grouping_releases_pack_and_stages,
    test_mispredicted_streamed_re_anchors_and_recovers,
    test_quiesce_returns_pooled_buffers,
    test_response_stream_is_garbage_collected,
]


@pytest.mark.parametrize("test", PY_CORE_TESTS, ids=lambda f: f.__name__)
def test_on_the_python_core(test, request, monkeypatch):
    """The in-process tests above that take no size, on the Python
    core."""
    from horovod_tpu_torch.native import fallback

    monkeypatch.setenv("HVTPU_FORCE_PY_CONTROLLER", "1")
    probe = EagerController(0, 1, manual=True)
    probe.stop()
    assert isinstance(probe._ctrl, fallback.PyController)
    test(**{name: request.getfixturevalue(name)
            for name in inspect.signature(test).parameters})


def test_default_core_is_the_native_core():
    from horovod_tpu_torch.native import core

    assert "HVTPU_FORCE_PY_CONTROLLER" not in os.environ
    ctrl = EagerController(0, 1, manual=True)
    ctrl.stop()
    assert isinstance(ctrl._ctrl, core.NativeController)

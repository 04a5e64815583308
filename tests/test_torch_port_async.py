"""The async plane of the port (``horovod_tpu_torch/eager``,
``api/handles.py``, the ``*_async`` ops of ``torch/mpi_ops.py``) and its
process sets, on the CPU.

* World size 1, against the JAX package's torch frontend
  (``horovod_tpu.torch``, its Pallas kernels in interpret mode), bitwise:
  every ``*_async`` op with ``synchronize`` / ``poll``, the in-place
  forms, ``grouped_allgather`` / ``grouped_reducescatter`` and their
  async forms, ``join``, ``sparse_allreduce_async``, the fused path
  (``grouped_allreduce_async`` under ``Compression.fp16`` with the
  predivide scales 1/2 and 2/1, float32 and bfloat16 in one group,
  against the reference controller's ``grouped_enqueue`` with the same
  arguments), the handle errors, and ``DistributedOptimizer`` with
  ``sparse_as_dense``, with sparse gradients and after
  ``set_backward_passes_per_step(2)``.
* 2 and 3 ranks over gloo (one spawn each and negotiation core,
  ``async_worker``: the default C++ core, and ``PyController`` in the
  ``-py`` cases; the default plane there is the streamed one): enqueue
  orders that differ across ranks resolve; a partial submission waits;
  the fused path, allgather, broadcast, reducescatter, alltoall, the
  grouped allgather and the sparse allreduce give the numpy results,
  bitwise (every sum is exact); a process set gives its members the sum
  and Average over its size, allgather's adjoint over the set, and
  ``DistributedOptimizer(process_set=...)`` with the predivide scales,
  and a non-member the reference's error;
  ``add_process_set`` / ``remove_process_set`` round trip; a shape that
  differs on one rank fails every rank with the coordinator's mismatch
  error; shutdown with an op in flight fails it and does not hang.  Rank 0's coordinator
  calls are replayed through the JAX package's ``PyController``: its
  response blobs are byte-identical.
"""

import multiprocessing
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.native import wire
from torch_port_util import (
    ASYNC_NAMES,
    async_inputs,
    async_process_set,
    async_weights,
    async_worker,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port and the JAX torch frontend, each in a world of one."""
    import horovod_tpu as hvt_mod
    import horovod_tpu.torch as ref_hvd

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVTPU_FLIGHT_DIR", str(tmp_path_factory.mktemp("flight")))
        mp.setenv("HVTPU_PALLAS_INTERPRET", "1")
        hvd.init(device="cpu")
        ref_hvd.init()
        try:
            yield hvd, ref_hvd
        finally:
            hvt_mod.shutdown()
            hvd.shutdown()


def _bits(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        t = t.numpy()
    a = np.asarray(t)
    if a.dtype.kind == "f":
        return a.view({8: np.int64, 4: np.int32, 2: np.int16}[a.itemsize])
    return a


def _same(got, want, what=""):
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    want = list(want) if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        if torch.is_tensor(g) and torch.is_tensor(w):
            assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=what)


def _tensors(seed: int):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * 3).astype(np.float32))
    return dict(x=f(6, 5), y=f(33), bf=f(17).to(torch.bfloat16),
                rs=f(5, 3), a2a=f(6, 2),
                ints=torch.from_numpy(rng.randint(-9, 9, (7,))))


# name: the call on the hvd module h, its handles synchronized in order
ASYNC_CASES = {
    "allreduce_sum": lambda h, t: [h.allreduce_async(t["x"], op=h.Sum)],
    "allreduce_average": lambda h, t: [h.allreduce_async(t["x"], name="av")],
    "allreduce_scaled_fp16": lambda h, t: [h.allreduce_async(
        t["y"], op=h.Sum, compression=h.Compression.fp16,
        prescale_factor=0.5, postscale_factor=4.0)],
    "allreduce_bf16_scaled": lambda h, t: [h.allreduce_async(
        t["bf"], op=h.Average, prescale_factor=3.0, postscale_factor=0.7)],
    "allreduce_positional": lambda h, t: [h.allreduce_async(
        t["x"], None, "n", h.Sum, h.Compression.bf16)],
    "allreduce_int_scaled": lambda h, t: [h.allreduce_async(
        t["ints"], op=h.Sum, prescale_factor=2.0)],
    "allgather": lambda h, t: [h.allgather_async(t["x"], "g")],
    "broadcast": lambda h, t: [h.broadcast_async(t["y"], 0, "b")],
    "alltoall_equal": lambda h, t: [h.alltoall_async(t["a2a"])],
    "reducescatter_sum": lambda h, t: [h.reducescatter_async(t["rs"],
                                                             h.Sum)],
    "reducescatter_average": lambda h, t: [h.reducescatter_async(t["rs"])],
    "grouped_allreduce": lambda h, t: h.grouped_allreduce_async(
        [t["x"], t["y"], t["ints"]], op=h.Sum),
    "grouped_allgather": lambda h, t: h.grouped_allgather_async(
        [t["x"], t["y"]]),
    "grouped_reducescatter": lambda h, t: h.grouped_reducescatter_async(
        [t["rs"], t["a2a"]], op=h.Sum),
}


@pytest.mark.parametrize("name", list(ASYNC_CASES))
def test_world_of_one_async_ops_match_jax_frontend(both, name):
    port, ref = both
    outs = []
    for h in both:
        t = _tensors(sum(map(ord, name)))
        handles = ASYNC_CASES[name](h, t)
        outs.append([h.synchronize(x) for x in handles])
        assert all(h.poll(x) for x in handles)
    _same(outs[0], outs[1], name)


def test_world_of_one_in_place_async_and_alltoall_splits(both):
    outs = []
    for h in both:
        t = _tensors(3)
        x = t["x"].clone()
        assert h.synchronize(h.allreduce_async_(x, op=h.Sum,
                                                prescale_factor=0.5)) is x
        y = t["y"].clone()
        assert h.synchronize(h.broadcast_async_(y, 0)) is y
        data, splits = h.synchronize(h.alltoall_async(
            t["a2a"], torch.tensor([6], dtype=torch.int32)))
        outs.append([x, y, data, splits.to(torch.int32)])
    _same(outs[0], outs[1])


def test_world_of_one_sync_grouped_ops_and_join(both):
    outs = []
    for h in both:
        t = _tensors(4)
        outs.append(h.grouped_allgather([t["x"], t["ints"]])
                    + h.grouped_reducescatter([t["rs"], t["a2a"]], h.Sum))
        assert h.join() == 0
    _same(outs[0], outs[1])


def test_world_of_one_fused_fp16_path_matches_reference_controller(
        both, monkeypatch):
    """One group of float32 and bfloat16 tensors under fp16 with the
    predivide scales: the grouped A1 passes (their plain versions here)
    against the reference's staged fused path, its A1 in interpret
    mode."""
    from horovod_tpu.comm.compression import Compression as RefCodec
    from horovod_tpu.comm.reduce_ops import ReduceOp as RefOp
    from horovod_tpu.eager import get_controller as ref_controller
    from horovod_tpu_torch.ops import scale_cast

    rng = np.random.RandomState(11)
    mag = 10.0 ** rng.uniform(-6, 5, size=(3, 400))
    arrays = [(rng.randn(400) * mag[i]).astype(np.float32) for i in range(3)]
    tensors = [torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1]),
               torch.from_numpy(arrays[2]).to(torch.bfloat16)]
    calls = []
    for name in ("scale_cast_pack_plain", "unpack_cast_scale_plain"):
        def counted(*args, _f=getattr(scale_cast, name), _n=name, **kw):
            calls.append(_n)
            return _f(*args, **kw)
        monkeypatch.setattr(scale_cast, name, counted)
    handles = hvd.grouped_allreduce_async(
        tensors, op=hvd.Sum, compression=hvd.Compression.fp16,
        prescale_factor=0.5, postscale_factor=2.0)
    got = [hvd.synchronize(h) for h in handles]
    # one pass a direction: the group took A1's grouped passes
    assert calls == ["scale_cast_pack_plain", "unpack_cast_scale_plain"]
    futs = ref_controller().grouped_enqueue(
        "allreduce", [jnp.asarray(arrays[0]), jnp.asarray(arrays[1]),
                      jnp.asarray(arrays[2], jnp.bfloat16)],
        op=RefOp.SUM, compression=RefCodec.fp16, prescale_factor=0.5,
        postscale_factor=2.0)
    want = [np.asarray(f.result()) for f in futs]
    for g, w in zip(got, want):
        assert str(g.dtype).endswith(str(w.dtype))
        np.testing.assert_array_equal(_bits(g.float()),
                                      _bits(w.astype(np.float32)))
    # the fp16 wire rounded: the results are not the inputs
    assert not torch.equal(got[0], tensors[0])


FUSED_BY_PAYLOAD = {
    # each payload its own scales, fp16 wire
    "scales_differ": ("SUM", "fp16", [(0.5, 1.0), (3.0, 0.25), (1.0, 1.0)]),
    # one scale a direction, but Min: no GroupReduction
    "min": ("MIN", "fp16", [(0.5, 2.0)] * 3),
}


@pytest.mark.parametrize("case", list(FUSED_BY_PAYLOAD))
def test_world_of_one_fused_group_payload_by_payload_matches_reference(
        both, case):
    """A fused group that ``GroupReduction`` does not take (scales that
    differ by payload; a Min group) runs the reference's steps payload
    by payload around one flat collective: against the reference
    controller's staged path, both driven cycle by cycle."""
    from horovod_tpu.comm.compression import Compression as RefCodec
    from horovod_tpu.comm.reduce_ops import ReduceOp as RefOp
    from horovod_tpu.eager.controller import EagerController as RefCtrl
    from horovod_tpu_torch.comm.compression import Compression as Codec
    from horovod_tpu_torch.comm.reduce_ops import ReduceOp
    from horovod_tpu_torch.eager import EagerController

    op, codec, scales = FUSED_BY_PAYLOAD[case]
    rng = np.random.RandomState(21)
    arrays = [(rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(
        np.float32) for n in (40, 17, 9)]
    ctrl = EagerController(0, 1, manual=True)
    seen = []
    orig = ctrl._execute_allreduce
    ctrl._execute_allreduce = lambda rs, ps: seen.append(
        len(ps)) or orig(rs, ps)
    futs = [ctrl.enqueue("allreduce", torch.from_numpy(a), name=f"f{i}",
                         op=getattr(ReduceOp, op),
                         compression=getattr(Codec, codec),
                         prescale_factor=pre, postscale_factor=post)
            for i, (a, (pre, post)) in enumerate(zip(arrays, scales))]
    assert ctrl.run_cycle_once()
    got = [f.result(timeout=5) for f in futs]
    ctrl.stop()
    assert seen == [3]                    # one fused group of three
    ref = RefCtrl(0, 1, manual=True)
    rfuts = [ref.enqueue("allreduce", jnp.asarray(a), name=f"f{i}",
                         op=getattr(RefOp, op),
                         compression=getattr(RefCodec, codec),
                         prescale_factor=pre, postscale_factor=post)
             for i, (a, (pre, post)) in enumerate(zip(arrays, scales))]
    assert ref.run_cycle_once()
    want = [np.asarray(f.result(timeout=5)) for f in rfuts]
    ref.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert not np.array_equal(_bits(got[1]), _bits(torch.from_numpy(
        arrays[1])))


def test_world_of_one_sparse_allreduce_matches(both):
    outs = []
    for h in both:
        rng = np.random.RandomState(5)
        rows = torch.from_numpy(rng.choice(30, size=12).astype(np.int64))
        vals = torch.from_numpy(rng.randn(12, 4).astype(np.float32))
        sp = torch.sparse_coo_tensor(rows[None], vals, (30, 4))
        handle = h.sparse_allreduce_async(sp, name="emb")
        assert h.poll(handle) in (True, False)
        out = h.synchronize(handle)
        assert out.is_sparse and out.is_coalesced()
        outs.append([out.indices(), out.values()])
    _same(outs[0], outs[1])
    for h in both:
        with pytest.raises(ValueError):
            h.sparse_allreduce_async(torch.ones(3))


def test_world_of_one_handle_errors_match(both):
    for h in both:
        handle = h.allreduce_async(torch.ones(3), op=h.Sum)
        h.synchronize(handle)
        with pytest.raises(ValueError, match="already-synchronized"):
            h.synchronize(handle)
        assert h.poll(handle)
        with pytest.raises(ValueError, match="unknown"):
            h.synchronize(10 ** 9)


def test_concurrent_enqueues_from_many_threads(both):
    """16 threads enqueue single and grouped allreduces at once, with a
    short switch interval: every op resolves to its own input (a world of
    one) and no enqueue is lost."""
    import sys
    import threading

    port, _ = both
    results, errors = {}, []

    def worker(k):
        try:
            for i in range(12):
                t = torch.full((5,), float(k * 100 + i))
                if i % 3:
                    h = port.allreduce_async(t, name=f"t{k}.{i}", op=port.Sum)
                    results[(k, i)] = (port.synchronize(h), t)
                else:
                    hs = port.grouped_allreduce_async(
                        [t, t * 2], names=[f"g{k}.{i}.0", f"g{k}.{i}.1"],
                        op=port.Sum)
                    results[(k, i)] = (torch.cat([port.synchronize(h)
                                                  for h in hs]),
                                       torch.cat([t, t * 2]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    assert errors == []
    assert len(results) == 16 * 12
    for got, want in results.values():
        _same(got, want)


def test_manual_cycles_resolve_futures_and_reject_duplicates(both):
    """A controller driven cycle by cycle (no threads), world of one:
    ``run_cycle_once`` negotiates and executes inline; a duplicate name
    fails its future, a grouped duplicate fails the whole group."""
    from horovod_tpu_torch.eager import EagerController

    ctrl = EagerController(0, 1, manual=True)
    xs = [torch.full((3,), float(i)) for i in range(3)]
    futs = [ctrl.enqueue("allreduce", x, name=f"m{i}")
            for i, x in enumerate(xs)]
    dup = ctrl.enqueue("allreduce", xs[0], name="m0")
    with pytest.raises(hvd.HorovodInternalError, match="duplicate"):
        dup.result(timeout=1)
    group = ctrl.grouped_enqueue("allreduce", xs[:2], names=["m1", "n"])
    for f in group:
        with pytest.raises(hvd.HorovodInternalError, match="duplicate"):
            f.result(timeout=1)
    assert not any(f.done() for f in futs)
    assert ctrl.run_cycle_once()
    for f, x in zip(futs, xs):
        _same(f.result(timeout=1), x)
    assert not ctrl.run_cycle_once()      # an idle cycle
    assert ctrl.quiesce(timeout=1)
    ctrl.stop()


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.emb = torch.nn.Embedding(40, 6, sparse=True)
        self.fc = torch.nn.Linear(6, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, ids):
        return self.fc(self.emb(ids).mean(1))


def _train(h, sparse_as_dense: bool, passes: int):
    net = _Net()
    opt = h.DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.1),
        named_parameters=net.named_parameters(),
        sparse_as_dense=sparse_as_dense)
    opt.set_backward_passes_per_step(passes)
    rng = np.random.RandomState(8)
    for _ in range(3):
        opt.zero_grad()
        for _ in range(passes):
            ids = torch.from_numpy(rng.randint(0, 40, (4, 5)))
            y = torch.from_numpy(rng.randint(0, 3, (4,)))
            torch.nn.functional.cross_entropy(net(ids), y).backward()
        opt.step()
    return [p.detach().clone() for p in net.parameters()]


@pytest.mark.parametrize("sparse_as_dense,passes",
                         [(True, 1), (False, 1), (False, 2), (True, 2)])
def test_world_of_one_optimizer_sparse_routes_match(both, sparse_as_dense,
                                                    passes):
    port, ref = both
    _same(_train(port, sparse_as_dense, passes),
          _train(ref, sparse_as_dense, passes))


def test_optimizer_refuses_predivide_with_sparse_gradients(both):
    for h in both:
        net = _Net()
        opt = h.DistributedOptimizer(
            torch.optim.SGD(net.parameters(), lr=0.1),
            named_parameters=net.named_parameters(),
            gradient_predivide_factor=2.0)
        with pytest.raises(ValueError, match="sparse"):
            net(torch.tensor([[1, 2]])).sum().backward()
            opt.synchronize()


# -- 2 and 3 ranks over gloo ---------------------------------------------------

@pytest.fixture(scope="module", params=[2, 3, "2-py", "3-py"])
def world(request, tmp_path_factory):
    """2 and 3 ranks on the default negotiation core (C++), and on the
    Python core ("-py")."""
    n = int(str(request.param).split("-")[0])
    python_core = str(request.param).endswith("-py")
    tmp = tmp_path_factory.mktemp(f"async{request.param}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=async_worker,
                         args=(r, n, str(tmp / "store"), str(tmp),
                               python_core))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0] * n
    out = []
    for r in range(n):
        with open(tmp / f"async{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    want = "PyController" if python_core else "NativeController"
    assert [o["core"] for o in out] == [want] * n
    return n, out


def _inputs(n, key):
    return [async_inputs(r, n)[key] for r in range(n)]


def test_out_of_order_enqueue_resolves(world):
    n, out = world
    for name in ASYNC_NAMES:
        want = sum(_inputs(n, name))
        for r in range(n):
            _same(out[r]["res"][f"ooo_{name}"], want, f"{name} rank {r}")


def test_partial_submission_waits(world):
    n, out = world
    assert not out[0]["res"]["partial_polled"]
    want = sum(_inputs(n, "a")) * np.float32(1.0 / n)
    for r in range(n):
        assert out[r]["res"]["partial_polled_after"]
        _same(out[r]["res"]["partial"], want, f"rank {r}")


def test_fused_and_other_async_ops(world):
    n, out = world
    f16 = lambda a: (a * np.float32(0.5)).astype(np.float16)  # noqa: E731
    g0 = sum(f16(a) for a in _inputs(n, "grouped")).astype(np.float32) * 2
    g1 = sum(f16(a) for a in _inputs(n, "grouped_b")).astype(np.float32) * 2
    gathered = np.concatenate(_inputs(n, "gather"))
    rs = sum(_inputs(n, "rs"))
    a2a = _inputs(n, "a2a")
    rows = np.concatenate(_inputs(n, "sparse_rows"))
    dense = np.zeros((8, 4), np.float32)
    np.add.at(dense, rows, np.concatenate(_inputs(n, "sparse_vals")))
    for r in range(n):
        res = out[r]["res"]
        _same(res["grouped0"], g0, f"grouped rank {r}")
        _same(res["grouped1"], g1, f"grouped bf16 rank {r}")
        _same(res["gather"], gathered, f"allgather rank {r}")
        _same(res["ggather"], gathered, f"grouped allgather rank {r}")
        _same(res["bcast"], _inputs(n, "bcast")[n - 1], f"broadcast {r}")
        _same(res["rs"], rs[2 * r:2 * r + 2], f"reducescatter rank {r}")
        _same(res["a2a"], np.concatenate([a[2 * r:2 * r + 2] for a in a2a]),
              f"alltoall rank {r}")
        _same(res["sparse"], dense, f"sparse rank {r}")
        _same(res["after_ps"], sum(_inputs(n, "b")), f"after sets {r}")


def test_process_set_members_and_non_members(world):
    n, out = world
    members = async_process_set(n)
    xs = _inputs(n, "ps")
    total = sum(xs[r] for r in members)
    for r in range(n):
        res, errors = out[r]["res"], out[r]["errors"]
        assert int(res["ps_id"]) == 1 and int(res["ps2_id"]) == 2
        assert list(res["ps_removed"]) == [True, False]
        if r in members:
            _same(res["ps_sum"], total, f"rank {r}")
            avg = total * np.float32(1.0 / len(members))
            _same(res["ps_avg"], avg, f"rank {r}")
            _same(res["ps_sync_avg"], avg, f"rank {r}")
            _same(res["ps_opt_grad"],
                  sum(xs[m] * np.float32(0.5) for m in members)
                  * np.float32(2.0 / len(members)), f"rank {r}")
            rows = [len(_inputs(n, "gather")[m]) for m in members]
            gathered = np.concatenate(
                [_inputs(n, "gather")[m] for m in members]).astype(np.float32)
            _same(res["ps_gather"], gathered, f"rank {r}")
            i = members.index(r)
            w = async_weights(gathered.shape).numpy() * len(members)
            _same(res["ps_gather_grad"],
                  w[sum(rows[:i]):sum(rows[:i + 1])], f"rank {r}")
        else:
            want = "calling process is not a member of this process set"
            assert errors == {**errors, "ps_sync": want, "ps_async": want}
        if r == n - 1:
            _same(res["ps2"], xs[r], f"rank {r}")


def test_a_mismatch_fails_every_rank_naming_the_rank(world):
    n, out = world
    for r in range(n):
        msg = out[r]["errors"]["mismatch"]
        assert msg.startswith("cross-rank tensor mismatch for 'mismatch'")
        assert "rank 1 submitted op=0 red_op=0 dtype=6 shape=[4]" in msg


def test_shutdown_with_an_op_in_flight_fails_it(world):
    n, out = world
    for r in range(n - 1):
        assert out[r]["errors"]["in_flight"] == f"rank {n - 1} has shut down"
    for r in range(n):
        assert float(out[r]["res"]["shutdown_s"]) < 30


def test_coordinator_blobs_replay_through_the_reference_core(world):
    from horovod_tpu.native.fallback import PyController

    n, out = world
    log = out[0]["log"]
    ref = PyController(0, n, 64 * 1024 * 1024, 1024)
    computed = 0
    for method, args, result in log:
        got = getattr(ref, method)(*args)
        if method == "compute_responses":
            assert got == result
            computed += 1
            wire.parse_response_list(got)
    assert computed > 10
    kinds = {m for m, _, _ in log}
    assert {"ingest", "compute_responses", "apply_responses",
            "declare_group", "register_process_set"} <= kinds

"""The port's C++ negotiation core (``horovod_tpu_torch/native/src``,
built by ``native/_build.py``, bound by ``native/core.py``) against the
JAX package's (``horovod_tpu/native``), on the CPU with g++.

* Every scripted sequence that ``tests/test_native.py`` cross-checks
  between the JAX package's two cores (the wire with cache steady
  state, predicted confirmations, join, per-process-set keys, shutdown,
  bypass and resync, resync recovery, mismatch diagnostics) runs on the
  port's ``NativeController``, the JAX package's ``NativeController``
  and the port's ``PyController``: every request blob, response blob,
  prediction and finished list is byte for byte the same.
* Mixed fleets coordinate: a port native rank with a port Python rank,
  and a port native rank with a JAX native rank, both ways round.
* ``parallel_gather`` / ``parallel_scatter`` round trip; the
  ``NativeTimeline`` file is byte for byte the JAX writer's; the GP's
  ``gp_predict`` / ``gp_expected_improvement`` are bitwise the JAX
  package's and within 1e-9 of the numpy twin (``obs/gaussian_process``).
* The two libraries in one process stay apart: the port's exports the
  C API alone, and each library's controllers and thread pool are its
  own.
* The build: ``make_controller`` picks the C++ core unless
  ``HVTPU_FORCE_PY_CONTROLLER`` is set; a build that fails raises with
  the compiler's output and names that variable (no fallback); two
  first builds at once compile once.
* F7: ``broadcast_parameters`` in a 2-rank gloo world sends the
  contiguous CPU tensors as one ``bp.fused.{n}.{bytes}`` broadcast and
  the rest as ``bp.{name}``, the names the JAX torch frontend gives, and
  every rank ends with the root's bits.
"""

import ctypes
import json
import threading

import numpy as np
import pytest
import torch

from horovod_tpu.native import core as jax_core
from horovod_tpu_torch import native
from horovod_tpu_torch.native import _build, core, fallback, wire
from torch_port_util import bp_state, bp_worker, spawn_world
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

IMPLS = {
    "port_native": core.NativeController,
    "jax_native": jax_core.NativeController,
    "port_py": fallback.PyController,
}


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both native libraries, built and loaded."""
    assert jax_core.available(), "the JAX package's native core must build"
    return core.load(), jax_core.load()


def make(cls, size=2, fusion=1 << 20, **kw):
    return [cls(r, size, fusion, **kw) for r in range(size)]


def run_cycle(ctrls, log, coordinator=0):
    """drain -> ingest at the coordinator -> compute -> apply, every
    blob and finished list appended to ``log``; returns the response."""
    blobs = [c.drain_requests() for c in ctrls]
    log.extend(blobs)
    for b in blobs:
        ctrls[coordinator].ingest(b)
    resp = ctrls[coordinator].compute_responses()
    log.append(resp)
    log.extend(c.apply_responses(resp) for c in ctrls)
    return resp


# -- the scripted sequences of tests/test_native.py ---------------------------

def seq_wire(cls):
    ops = [
        (1, "w/dense/kernel", wire.ALLREDUCE, wire.RED_AVERAGE, 6, (128, 64)),
        (2, "w/dense/bias", wire.ALLREDUCE, wire.RED_AVERAGE, 6, (64,)),
        (3, "bcast/step", wire.BROADCAST, wire.RED_SUM, 3, ()),
    ]
    log = []
    for step in range(3):     # includes cache steady-state cycles
        ctrls = make(cls, fusion=1 << 10)
        for _ in range(step + 1):
            for c in ctrls:
                for seq, name, op, red, dt, shape in ops:
                    c.enqueue(seq, name, op, red, dt, shape, 0, -1,
                              0 if op == wire.BROADCAST else -1)
            run_cycle(ctrls, log)
    return log


def seq_predicted(cls):
    ctrls = make(cls)
    log = []

    def enqueue_pair(seq0):
        for c in ctrls:
            c.enqueue(seq0 + c.rank, "pc/a", wire.ALLREDUCE, wire.RED_SUM,
                      6, (8,))
            c.enqueue(seq0 + 10 + c.rank, "pc/b", wire.ALLREDUCE,
                      wire.RED_SUM, 6, (8,))

    for step in range(2):     # two warm-up cycles establish the cache
        enqueue_pair(step * 100 + 1)
        run_cycle(ctrls, log)
    enqueue_pair(300)
    pred = [c.predict_responses([0, 1]) for c in ctrls]
    assert pred[0] is not None
    log.extend(pred)
    blobs = [wire.mark_predicted(c.drain_requests()) for c in ctrls]
    log.extend(blobs)
    for b in blobs:
        ctrls[0].ingest(b)
    resp = ctrls[0].compute_responses()
    log.append(resp)
    rl = wire.parse_response_list(resp)
    assert rl.responses == [] and rl.confirm_hashes == [
        wire.fnv1a64(pred[0])]
    for c in ctrls:            # the mispredict re-anchor
        c.force_resync()
        c.enqueue(400 + c.rank, "pc/a", wire.ALLREDUCE, wire.RED_SUM, 6,
                  (8,))
    blobs = [c.drain_requests() for c in ctrls]
    assert wire.parse_request_list(blobs[0]).cache_resync
    return log + blobs


def seq_join(cls):
    ctrls = make(cls, fusion=1 << 10)
    ctrls[1].set_joined()
    ctrls[0].enqueue(1, "ok_sum", wire.ALLREDUCE, wire.RED_SUM, 6, (4,))
    ctrls[0].enqueue(2, "bad_min", wire.ALLREDUCE, wire.RED_MIN, 6, (4,))
    ctrls[0].enqueue(3, "bad_int8", wire.ALLREDUCE, wire.RED_SUM, 1, (4,))
    ctrls[0].enqueue(4, "bad_root", wire.BROADCAST, wire.RED_SUM, 6, (4,),
                     0, -1, 1)
    log = []
    resp = run_cycle(ctrls, log)
    by_name = {rs.tensor_names[0]: rs
               for rs in wire.parse_response_list(resp).responses}
    assert by_name["ok_sum"].error == ""
    assert "does not support joined-rank" in by_name["bad_min"].error
    assert by_name["bad_root"].error == "broadcast root rank 1 has joined"
    return log


def seq_process_sets(cls):
    ctrls = make(cls, size=4, fusion=1 << 10)
    for c in ctrls:
        c.register_process_set(1, [0, 2])
        c.register_process_set(2, [1, 3])
    for r, psid, shape in ((0, 1, (2,)), (2, 1, (2,)), (1, 2, (5,)),
                           (3, 2, (5,))):
        ctrls[r].enqueue(1, "x", wire.ALLREDUCE, wire.RED_SUM, 6, shape,
                         psid)
    log = []
    resp = run_cycle(ctrls, log)
    assert sorted(rs.process_set_id for rs in
                  wire.parse_response_list(resp).responses) == [1, 2]
    return log


def seq_shutdown(cls):
    ctrls = make(cls, fusion=1 << 10)
    ctrls[0].enqueue(1, "stranded", wire.ALLREDUCE, wire.RED_SUM, 6, (4,))
    ctrls[1].set_shutdown()
    log = []
    rl = wire.parse_response_list(run_cycle(ctrls, log))
    assert not rl.shutdown and rl.responses[0].error == "rank 1 has shut down"
    ctrls[0].set_shutdown()
    assert wire.parse_response_list(run_cycle(ctrls, log)).shutdown
    return log


def seq_bypass_resync(cls):
    ctrls = make(cls, fusion=1 << 10, resync_every=3)
    log, kinds = [], set()
    for step in range(8):
        for c in ctrls:
            c.enqueue(step * 10 + c.rank + 1, "w/kernel", wire.ALLREDUCE,
                      wire.RED_AVERAGE, 6, (64, 64))
            c.enqueue(step * 10 + c.rank + 5, "w/bias", wire.ALLREDUCE,
                      wire.RED_AVERAGE, 6, (64,))
        n = len(log)
        run_cycle(ctrls, log)
        parsed = wire.parse_request_list(log[n])
        kinds |= {k for k in ("cache_bypass", "cache_resync")
                  if getattr(parsed, k)}
    assert kinds == {"cache_bypass", "cache_resync"}
    return log


def seq_resync_recovery(cls):
    rogue = wire.serialize_request_list(wire.RequestList(
        rank=1, cache_bypass=True, cache_bits=wire.bits_to_words([9])))
    force = wire.serialize_response_list(wire.ResponseList(
        cache_resync_needed=True))
    c0, c1 = make(cls)
    c1.enqueue(4, "x", wire.ALLREDUCE, wire.RED_SUM, 6, (2, 3))
    log = [c1.drain_requests()]          # x now in flight at rank 1
    c0.ingest(rogue)
    resp = c0.compute_responses()
    assert wire.parse_response_list(resp).cache_resync_needed
    log += [resp, c1.apply_responses(force), c1.drain_requests()]
    parsed = wire.parse_request_list(log[-1])
    assert parsed.cache_resync
    assert [rq.entry.name for rq in parsed.requests] == ["x"]
    return log


def seq_mismatch(cls):
    ctrls = make(cls)
    log = []
    ctrls[0].enqueue(1, "w/k", wire.ALLREDUCE, wire.RED_SUM, 6, (4, 4))
    ctrls[1].enqueue(1, "w/k", wire.ALLREDUCE, wire.RED_SUM, 6, (4, 8))
    rl = wire.parse_response_list(run_cycle(ctrls, log))
    assert rl.cache_resync_needed
    err = rl.responses[0].error
    assert err.startswith("cross-rank tensor mismatch for 'w/k'")
    assert "rank 1 submitted op=0 red_op=0 dtype=6 shape=[4,8]" in err
    ctrls[0].enqueue(2, "b", wire.BROADCAST, wire.RED_SUM, 6, (2,), 0, -1, 0)
    ctrls[1].enqueue(2, "b", wire.BROADCAST, wire.RED_SUM, 3, (2,), 0, -1, 1)
    err2 = wire.parse_response_list(
        run_cycle(ctrls, log)).responses[0].error
    assert "root_rank=0" in err2 and "root_rank=1" in err2
    return log


SEQUENCES = {
    "wire": seq_wire,
    "predicted_confirmation": seq_predicted,
    "join": seq_join,
    "process_set_keys": seq_process_sets,
    "shutdown": seq_shutdown,
    "bypass_and_resync": seq_bypass_resync,
    "resync_recovery": seq_resync_recovery,
    "mismatch_diagnostics": seq_mismatch,
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_sequence_is_byte_identical_across_the_three_cores(name):
    logs = {impl: SEQUENCES[name](cls) for impl, cls in IMPLS.items()}
    assert logs["port_native"] == logs["jax_native"]
    assert logs["port_native"] == logs["port_py"]
    assert any(isinstance(x, bytes) and x for x in logs["port_native"])


@pytest.mark.parametrize("rank0,rank1", [
    ("port_native", "port_py"), ("port_py", "port_native"),
    ("port_native", "jax_native"), ("jax_native", "port_native")])
def test_mixed_fleet_coordinates(rank0, rank1):
    ctrls = [IMPLS[rank0](0, 2, 1 << 20), IMPLS[rank1](1, 2, 1 << 20)]
    log = []
    for step in range(6):      # first sight, then bypass cycles
        for c in ctrls:
            c.enqueue(step + 1, "mixed", wire.ALLREDUCE, wire.RED_SUM, 6,
                      (16,))
            c.enqueue(step + 101, "mixed/b", wire.ALLREDUCE, wire.RED_SUM,
                      6, (3,))
        n = len(log)
        run_cycle(ctrls, log)
        assert log[n + 3:n + 5] == [[step + 1, step + 101]] * 2
    assert wire.parse_request_list(log[-5]).cache_bypass
    for c in ctrls:
        c.close()


# -- the utilities -------------------------------------------------------------

def test_parallel_gather_scatter_round_trip():
    rng = np.random.RandomState(5)
    srcs = [rng.randint(0, 256, size=n).astype(np.uint8)
            for n in (13, 0, 1, 4096, 70001, 3)]
    total = sum(s.nbytes for s in srcs)
    dst = bytearray(total)
    core.parallel_gather(memoryview(dst), [memoryview(s) for s in srcs])
    assert bytes(dst) == b"".join(s.tobytes() for s in srcs)
    ref = bytearray(total)
    jax_core.parallel_gather(memoryview(ref), [memoryview(s) for s in srcs])
    assert ref == dst
    outs = [bytearray(s.nbytes) for s in srcs]
    core.parallel_scatter(memoryview(bytes(dst)),
                          [memoryview(o) for o in outs])
    for s, o in zip(srcs, outs):
        assert bytes(o) == s.tobytes()


def test_timeline_file_is_the_jax_writers(tmp_path):
    files = []
    for mod in (core, jax_core):
        path = tmp_path / f"{mod.__name__}.json"
        tl = mod.NativeTimeline(str(path), rank=3)
        tl.event("NEGOTIATE_ALLREDUCE", "B", "negotiate", 1.0)
        tl.event("NEGOTIATE_ALLREDUCE", "E", "negotiate", 2.25)
        tl.event("COLLECTIVE", "X", "comm", 3.0, 4.5)
        tl.event('odd "name"\\', "i", "misc", 5.125)
        tl.mark_cycle(10.0)
        tl.flush()
        tl.close()
        files.append(path.read_bytes())
    assert files[0] == files[1]
    events = json.loads(files[0])
    assert [e["ph"] for e in events] == ["B", "E", "X", "i", "i"]


def _gp_data(seed, n=15, d=2):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, d)
    ys = np.sin(3 * xs[:, 0]) * np.cos(2 * xs[:, 1]) + 0.05 * rng.randn(n)
    return xs, ys, rng.rand(64, d)


def test_gp_is_bitwise_the_jax_packages_and_near_the_numpy_twin(
        monkeypatch):
    from horovod_tpu_torch.obs import gaussian_process as gpmod

    kw = dict(length_scale=0.3, noise=1e-4, signal_variance=1.0)
    xs, ys, cand = _gp_data(3)
    mu, sigma = core.gp_predict(xs, ys, cand, **kw)
    ref_mu, ref_sigma = jax_core.gp_predict(xs, ys, cand, **kw)
    assert mu.tobytes() == ref_mu.tobytes()
    assert sigma.tobytes() == ref_sigma.tobytes()
    best = float(ys.max())
    ei = core.gp_expected_improvement(xs, ys, cand, best_y=best, xi=0.01,
                                      **kw)
    ref_ei = jax_core.gp_expected_improvement(xs, ys, cand, best_y=best,
                                              xi=0.01, **kw)
    assert ei.tobytes() == ref_ei.tobytes()
    gp = gpmod.GaussianProcess(length_scale=0.3, noise=1e-4)
    gp.fit(xs, ys)
    native_mu, _ = gp.predict(cand)            # the native route
    native_ei = gpmod.expected_improvement(gp, cand, best)
    assert native_mu.tobytes() == mu.tobytes()
    assert native_ei.tobytes() == ei.tobytes()
    monkeypatch.setenv("HVTPU_FORCE_PY_GP", "1")
    twin_mu, twin_sigma = gp.predict(cand)
    np.testing.assert_allclose(mu, twin_mu, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sigma, twin_sigma, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        ei, gpmod.expected_improvement(gp, cand, best), rtol=0, atol=1e-9)


def test_gp_singular_gram_declines_and_shapes_are_checked():
    kw = dict(length_scale=0.3, noise=0.0, signal_variance=1.0)
    assert core.gp_predict(np.zeros((4, 2)), np.ones(4), np.zeros((1, 2)),
                           **kw) is None
    xs, ys, _ = _gp_data(9)
    with pytest.raises(ValueError, match="shape mismatch"):
        core.gp_predict(xs, ys, np.zeros((4, 3)), **kw)
    with pytest.raises(ValueError, match="shape mismatch"):
        core.gp_expected_improvement(xs, ys[:-1], np.zeros((4, 2)),
                                     best_y=0.0, xi=0.01, **kw)


# -- two libraries in one process ----------------------------------------------

def test_both_libraries_in_one_process_stay_apart(libraries):
    port_lib, jax_lib = libraries
    assert port_lib._name != jax_lib._name
    # the port's library exports the C API alone: the JAX library's
    # C++ symbols have no twin there to bind to, and the reverse
    with pytest.raises(AttributeError):
        getattr(port_lib, "_ZN3hvt10GlobalPoolEv")
    getattr(jax_lib, "_ZN3hvt10GlobalPoolEv")
    assert (ctypes.cast(port_lib.hvt_pool_num_threads, ctypes.c_void_p).value
            != ctypes.cast(jax_lib.hvt_pool_num_threads,
                           ctypes.c_void_p).value)
    assert port_lib.hvt_pool_num_threads() >= 2
    assert jax_lib.hvt_pool_num_threads() >= 2
    # controllers of one library are not seen by the other
    port_c = core.NativeController(0, 1, 1 << 20)
    jax_c = jax_core.NativeController(0, 1, 1 << 20)
    assert port_c.enqueue(1, "only/port", wire.ALLREDUCE, wire.RED_SUM, 6,
                          (4,))
    assert port_c.pending_count == 1 and jax_c.pending_count == 0
    # both thread pools at work at once give their own right answers
    rng = np.random.RandomState(2)
    srcs = [rng.randint(0, 256, size=5000).astype(np.uint8)
            for _ in range(64)]
    want = b"".join(s.tobytes() for s in srcs)
    got = {}

    def gather(mod):
        for i in range(20):
            dst = bytearray(len(want))
            mod.parallel_gather(memoryview(dst),
                                [memoryview(s) for s in srcs])
            got[(mod.__name__, i)] = bytes(dst)

    threads = [threading.Thread(target=gather, args=(m,))
               for m in (core, jax_core)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 40 and all(v == want for v in got.values())
    port_c.close()
    jax_c.close()
    with pytest.raises(RuntimeError, match="closed"):
        port_c.pending_count


# -- the build and the factory -------------------------------------------------

def test_make_controller_is_native_unless_forced(monkeypatch):
    monkeypatch.delenv("HVTPU_FORCE_PY_CONTROLLER", raising=False)
    c = native.make_controller(0, 1, 1 << 20)
    assert isinstance(c, core.NativeController)
    c.close()
    assert native.native_available()
    monkeypatch.setenv("HVTPU_FORCE_PY_CONTROLLER", "1")
    assert isinstance(native.make_controller(0, 1, 1 << 20),
                      fallback.PyController)


def test_library_is_keyed_on_sources_and_flags(monkeypatch):
    path = _build.lib_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "horovod_tpu_torch")
    assert path.exists() and core.load()._name == str(path)
    monkeypatch.setattr(_build, "CXXFLAGS", _build.CXXFLAGS + ["-g"])
    assert _build.lib_path() != path


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++"])
def test_a_failed_build_raises_and_nothing_falls_back(cxx, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(core, "_lib", None)
    monkeypatch.setattr(core, "_lib_error", None)
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.delenv("HVTPU_FORCE_PY_CONTROLLER", raising=False)
    for attempt in (core.load, lambda: native.make_controller(0, 1, 1 << 20),
                    lambda: core.parallel_gather(memoryview(bytearray(1)),
                                                 [memoryview(b"x")])):
        with pytest.raises(RuntimeError,
                           match="HVTPU_FORCE_PY_CONTROLLER") as e:
            attempt()
        assert "failed to build" in str(e.value)
    assert not native.native_available()
    assert not list(tmp_path.glob("*.so"))
    # the Python core stays the way out
    monkeypatch.setenv("HVTPU_FORCE_PY_CONTROLLER", "1")
    assert isinstance(native.make_controller(0, 1, 1 << 20),
                      fallback.PyController)


def test_first_builds_at_once_compile_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    compiled = []
    compile_ = _build._compile
    monkeypatch.setattr(_build, "_compile",
                        lambda out: compiled.append(out) or compile_(out))
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(_build.build()))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiled) == 1 and len(set(paths)) == 1 and len(paths) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [paths[0].name, "libhvt_core.lock"])
    lib = ctypes.CDLL(str(paths[0]))
    assert lib.hvt_abi_version() == core.ABI_VERSION


# -- F7: broadcast_parameters --------------------------------------------------

def test_f7_broadcast_parameters_fuses_and_names_as_reference(tmp_path,
                                                              monkeypatch):
    import horovod_tpu as hvt_mod
    import horovod_tpu.torch as ref_hvd
    from horovod_tpu.torch import functions as ref_functions

    codes, results = spawn_world(bp_worker, 2, tmp_path, timeout=120)
    assert codes == [0, 0]
    # the JAX torch frontend on rank 0's state: the names it gives and
    # the bits it leaves
    names = []
    for fn in ("broadcast", "broadcast_"):
        orig = getattr(ref_functions.mpi_ops, fn)

        def named(*args, _orig=orig, **kw):
            if "name" in kw:       # broadcast_'s own call passes it bare
                names.append(kw["name"])
            return _orig(*args, **kw)
        monkeypatch.setattr(ref_functions.mpi_ops, fn, named)
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    ref_hvd.init()
    try:
        state = bp_state(0)
        ref_hvd.broadcast_parameters(state, root_rank=0)
    finally:
        hvt_mod.shutdown()
    want = {n: t.contiguous().view(-1).view(torch.uint8).numpy()
            .tobytes().hex() for n, t in state.items()}
    total = 4 * 108 + 4 * 4 + 2 * 7 + 8
    assert names == [f"bp.fused.4.{total}", "bp.fc.weight_t"]
    for r, res in enumerate(results):
        assert [d.split(":")[1] for d in res["descs"]] == names, r
        assert res["bytes"] == want, r
    assert bp_state(1)["conv.weight"].numpy().tobytes().hex() != \
        want["conv.weight"]

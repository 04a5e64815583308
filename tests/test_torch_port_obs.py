"""The port's observability modules (``horovod_tpu_torch/obs``) against
the JAX package's (``horovod_tpu/obs``), on the CPU.

Each module gets the same inputs, made from a numpy seed, and where time
enters the same injected clock in both packages (each module's ``time``
replaced by a fake, or each package's ``core/clock`` seam):

* metrics: the same counter, gauge and histogram calls render the same
  Prometheus text and ``snapshot()``, byte for byte; ``merge_snapshots``
  equal; the HTTP endpoint serves ``/metrics`` and ``/debug``;
* timeline: the same calls write the same events (``ICI_ALLREDUCE``
  mapped to ``NCCL_ALLREDUCE``);
* tracing: the same op sequence writes the same span records, and
  ``tools/hvtputrace``'s merge and report equal;
* flight: the same notes give the same ring and postmortem;
* anomaly: a seeded series gives the same incidents, bitwise;
* stepprof: the interval algebra, ``decompose``, ``exposed_span`` and
  ``mfu`` bitwise, and the reference's alignment rule;
* profile: a synthetic Chrome trace with CUDA kernels and a NCCL kernel,
  the alignment of its intervals onto the wall clock, the card's idle
  share, a ``torch.profiler`` trace written here on the CPU, and cut
  files.
"""

from __future__ import annotations

import gzip
import json
import types
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.core import clock as ref_clock
from horovod_tpu.obs import anomaly as ref_anomaly
from horovod_tpu.obs import flight as ref_flight
from horovod_tpu.obs import metrics as ref_metrics
from horovod_tpu.obs import stepprof as ref_stepprof
from horovod_tpu.obs import timeline as ref_timeline
from horovod_tpu.obs import tracing as ref_tracing
from horovod_tpu_torch.core import clock as port_clock
from horovod_tpu_torch.obs import anomaly as port_anomaly
from horovod_tpu_torch.obs import flight as port_flight
from horovod_tpu_torch.obs import metrics as port_metrics
from horovod_tpu_torch.obs import profile as port_profile
from horovod_tpu_torch.obs import stepprof as port_stepprof
from horovod_tpu_torch.obs import timeline as port_timeline
from horovod_tpu_torch.obs import tracing as port_tracing
from tools import hvtputrace
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)


class FakeTime:
    """``time.monotonic`` / ``time.time`` advancing by a fixed step a
    read, so two runs of the same calls read the same times."""

    def __init__(self, mono: float = 100.0, wall: float = 1.7e9,
                 step: float = 0.00125):
        self.mono, self.wall_t, self.step = mono, wall, step

    def monotonic(self) -> float:
        self.mono += self.step
        return self.mono

    def time(self) -> float:
        self.wall_t += self.step
        return self.wall_t

    def sleep(self, s: float) -> None:
        self.mono += s
        self.wall_t += s


class FakeClock(FakeTime):
    """The ``core/clock`` seam's interface over :class:`FakeTime`."""

    def wall(self) -> float:
        return self.time()

    def call_later(self, delay_s, fn):  # pragma: no cover - unused
        raise NotImplementedError


@pytest.fixture
def fake_clocks():
    ref_clock.install(FakeClock())
    port_clock.install(FakeClock())
    yield
    ref_clock.install(None)
    port_clock.install(None)


# -- metrics --------------------------------------------------------------

def _drive_registry(m, reg, rng):
    c = reg.counter("hvtpu_test_ops_total", "Ops.\nTwo lines \\ here.")
    g = reg.gauge("hvtpu_test_depth", "Depth.")
    h = reg.histogram("hvtpu_test_seconds", "Latency.",
                      buckets=m.log_buckets(1e-4, 2.5, 9))
    hb = reg.histogram("hvtpu_test_bytes", "Bytes.",
                       buckets=m.DEFAULT_BYTE_BUCKETS)
    for i in range(40):
        c.inc(float(rng.integers(1, 5)), kind=("a", "b\"q", "c\n")[i % 3])
        g.set(float(rng.standard_normal()), rank=str(i % 2))
        g.inc(0.5)
        g.dec(0.25)
        h.observe(float(rng.exponential(0.01)), op="allreduce")
        hb.observe(float(rng.integers(0, 1 << 30)))
    h.observe_many(rng.exponential(0.1, size=17).tolist(), op="fused")
    c.inc(3)
    return reg


def test_metrics_exposition_and_snapshot_byte_for_byte():
    ref = _drive_registry(ref_metrics, ref_metrics.MetricsRegistry(),
                          np.random.default_rng(0))
    port = _drive_registry(port_metrics, port_metrics.MetricsRegistry(),
                           np.random.default_rng(0))
    assert port.exposition() == ref.exposition()
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    assert port_metrics.DEFAULT_TIME_BUCKETS == \
        ref_metrics.DEFAULT_TIME_BUCKETS
    # the module families the ops feed, by name and help
    for name in ("TENSOR_BYTES", "WIRE_BYTES", "ALLREDUCE_LATENCY"):
        assert getattr(port_metrics, name).help == \
            getattr(ref_metrics, name).help
    port_reg = port_metrics.MetricsRegistry()
    with pytest.raises(ValueError):
        port_reg.counter("x").inc(-1)
    port_reg.counter("y")
    with pytest.raises(TypeError):
        port_reg.gauge("y")


def test_merge_snapshots_equal_and_bucket_mismatch_raises():
    snaps = {}
    for pkg, m in (("ref", ref_metrics), ("port", port_metrics)):
        snaps[pkg] = [
            _drive_registry(m, m.MetricsRegistry(),
                            np.random.default_rng(r)).snapshot()
            for r in range(3)]
    merged_ref = ref_metrics.merge_snapshots(snaps["ref"])
    merged_port = port_metrics.merge_snapshots(snaps["port"])
    assert json.dumps(merged_port) == json.dumps(merged_ref)
    bad = json.loads(json.dumps(snaps["port"][0]))
    bad["hvtpu_test_seconds"]["buckets"] = [1.0]
    with pytest.raises(ValueError, match="bucket mismatch"):
        port_metrics.merge_snapshots([snaps["port"][1], bad])


def test_aggregate_in_a_world_of_one_is_the_local_snapshot():
    out = port_metrics.aggregate()
    assert out["merged"] == out["per_rank"][0]


def test_http_endpoint_serves_metrics_and_debug(monkeypatch):
    reg = port_metrics.MetricsRegistry()
    reg.counter("hvtpu_http_probe_total", "Probe.").inc(2)
    port_metrics.register_debug_provider("probe", lambda: {"ok": 1})
    port_metrics.register_debug_provider(
        "broken", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    port = port_metrics.start_http_server(0, addr="127.0.0.1", registry=reg)
    try:
        assert port_metrics.start_http_server(0) == port   # idempotent
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert b"hvtpu_http_probe_total 2" in text
        debug = json.loads(urllib.request.urlopen(
            base + "/debug", timeout=10).read())
        assert debug["probe"] == {"ok": 1}
        assert debug["broken"] == {"error": "boom"}
    finally:
        port_metrics.stop_http_server()
        port_metrics.unregister_debug_provider("probe")
        port_metrics.unregister_debug_provider("broken")
    monkeypatch.setenv("HVTPU_METRICS_PORT", "not-a-port")
    assert port_metrics.serve_from_env() is None
    monkeypatch.delenv("HVTPU_METRICS_PORT")
    assert port_metrics.serve_from_env() is None


# -- timeline -------------------------------------------------------------

def _timeline_events(mod, path, collective: str):
    tl = mod.Timeline(str(path), rank=3, mark_cycles=True)
    assert tl.mark_cycles
    tl.begin("allreduce.w", "NEGOTIATE_ALLREDUCE", bytes=64)
    tl.begin("allreduce.w", collective)        # ends the open span
    tl.instant("marker", k=1)
    tl.mark_cycle(7)
    tl.end("allreduce.w")
    tl.end("allreduce.w")                      # no open span: nothing
    tl.begin("allreduce.b", mod.QUEUE)
    tl.begin("allreduce.c", mod.MEMCPY_IN_FUSION_BUFFER)
    tl.close()                                 # ends the dangling spans
    tl.instant("after-close")
    with open(path) as f:
        return json.load(f)


def test_timeline_writes_the_reference_events(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_timeline, "time", FakeTime())
    monkeypatch.setattr(port_timeline, "time", FakeTime())
    ref = _timeline_events(ref_timeline, tmp_path / "ref.json",
                           ref_timeline.ICI_ALLREDUCE)
    port = _timeline_events(port_timeline, tmp_path / "port.json",
                            port_timeline.NCCL_ALLREDUCE)
    for e in ref:
        if e.get("name") == "ICI_ALLREDUCE":
            e["name"] = "NCCL_ALLREDUCE"
    assert port == ref
    assert port_timeline.NCCL_ALLREDUCE == "NCCL_ALLREDUCE"
    for name in ("NEGOTIATE", "QUEUE", "MEMCPY_IN_FUSION_BUFFER",
                 "MEMCPY_OUT_FUSION_BUFFER", "COMPILE", "CYCLE"):
        assert getattr(port_timeline, name) == getattr(ref_timeline, name)


# -- tracing --------------------------------------------------------------

def _trace_ops(mod, trace_dir, rank):
    mod.install(str(trace_dir), rank=rank, size=2)
    assert mod.ACTIVE
    mod.op_begin("allreduce.a", "allreduce")
    mod.op_begin("allreduce.b", "allreduce", extra=1)
    mod.op_phase("allreduce.a", mod.QUEUE)
    mod.op_phase("missing", mod.QUEUE)
    mod.op_phase_many(["allreduce.a", "allreduce.b"], mod.FUSE)
    mod.op_phase_many(["allreduce.a", "allreduce.b"], mod.EXEC)
    mod.op_done_many([("allreduce.a", {"bytes": 16}),
                      ("allreduce.b", {"bytes": 8}), ("gone", {})],
                     fused=2, zero_copy=False)
    mod.op_begin("allreduce.a", "allreduce", phase=mod.EXEC)
    mod.instant("arrival_skew", tensor="allreduce.a", skew_s=0.25)
    mod.step_boundary(wall_us=1.7e15 + rank, steps=1.0)
    mod.op_done("allreduce.a", bytes=16, wall_t0_us=1, wall_t1_us=2)
    mod.op_done("allreduce.a")
    mod.op_begin("barrier.noname.0", "barrier")   # dangling at close
    mod.uninstall()
    assert not mod.ACTIVE and mod.get_tracer() is None


def test_tracing_spans_and_hvtputrace_reports_equal(tmp_path, monkeypatch):
    dirs = {}
    for pkg, mod, tl in (("ref", ref_tracing, ref_timeline),
                         ("port", port_tracing, port_timeline)):
        dirs[pkg] = tmp_path / pkg
        monkeypatch.setattr(tl, "time", FakeTime())
        for rank in (0, 1):
            _trace_ops(mod, dirs[pkg], rank)
    for rank in (0, 1):
        name = f"rank{rank}.trace.json"
        with open(dirs["ref"] / name) as f:
            ref = json.load(f)
        with open(dirs["port"] / name) as f:
            port = json.load(f)
        assert port == ref
    assert hvtputrace.merge(str(dirs["port"])) == \
        hvtputrace.merge(str(dirs["ref"]))
    for fn in (hvtputrace.report, hvtputrace.overlap):
        port, ref = fn(str(dirs["port"])), fn(str(dirs["ref"]))
        for rep in (port, ref):
            rep.pop("trace_dir", None)      # the directories differ
        assert port == ref


def test_tracing_disabled_path_is_one_attribute():
    assert port_tracing.ACTIVE is False
    assert port_tracing.get_tracer() is None
    # the shims are no-ops without a tracer
    port_tracing.op_begin("x")
    port_tracing.op_done("x")
    port_tracing.instant("x")
    for name in ("NEGOTIATE", "QUEUE", "FUSE", "EXEC", "DONE", "PREDICT",
                 "DATA_WAIT", "STEP_BOUNDARY", "_PONG_TIMEOUT_MS",
                 "_SYNC_DEADLINE_S", "_KV_NS"):
        assert getattr(port_tracing, name) == getattr(ref_tracing, name)


# -- flight ---------------------------------------------------------------

def _flight_doc(mod, out_dir, monkeypatch):
    monkeypatch.setattr(mod, "_metrics", types.SimpleNamespace(
        debug_snapshot=lambda: {"job": {"rank": 1}},
        snapshot=lambda: {"hvtpu_x_total": {"type": "counter"}}))
    rec = mod.FlightRecorder(rank=1, size=2, generation=3,
                             out_dir=str(out_dir), window=16)
    rng = np.random.default_rng(5)
    for i in range(21):
        rec.note(("step", "kv_retry", "stall_warning")[i % 3],
                 {"i": i, "v": float(rng.standard_normal())}
                 if i % 4 else None)
    state = rec.debug_state()
    last = rec.last_event_t("kv_retry")
    path = rec.dump("stall_abort", collective="allreduce:w")
    rec.dump("sigusr2")
    with open(path) as f:
        doc = json.load(f)
    return rec.events(), state, last, doc, path.rsplit("/", 1)[-1]


def test_flight_ring_and_postmortem_equal(tmp_path, monkeypatch,
                                          fake_clocks):
    ref = _flight_doc(ref_flight, tmp_path / "ref", monkeypatch)
    port = _flight_doc(port_flight, tmp_path / "port", monkeypatch)
    assert port == ref
    events, state, _, doc, name = port
    assert state["dropped"] == 5 and state["events"] == 16
    assert doc["reasons"] == ["stall_abort", "sigusr2"]
    assert name == "postmortem-1-3.json"
    assert port_flight.POSTMORTEM_SCHEMA == ref_flight.POSTMORTEM_SCHEMA


def test_flight_install_gate_and_dump_without_recorder(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("HVTPU_FLIGHT", "0")
    assert port_flight.install(rank=0) is None and not port_flight.ACTIVE
    monkeypatch.delenv("HVTPU_FLIGHT")
    monkeypatch.delenv("HVTPU_FLIGHT_DIR", raising=False)
    assert port_flight.dump_postmortem("x") is None   # no dir: no litter
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    path = port_flight.dump_postmortem("restart_budget")
    with open(path) as f:
        assert json.load(f)["rank"] == "driver"
    rec = port_flight.install(rank=0, out_dir=str(tmp_path), sigusr2=False)
    try:
        assert port_flight.ACTIVE and port_flight.get_recorder() is rec
        port_flight.note("probe", k=1)
        assert rec.events()[-1]["kind"] == "probe"
        assert port_metrics.debug_snapshot()["flight"]["active"]
    finally:
        port_flight.uninstall()
    assert not port_flight.ACTIVE


# -- anomaly --------------------------------------------------------------

def _anomaly_run(mod):
    cfg = mod.AnomalyConfig(window=16, warmup=8, threshold=4.0,
                            min_rel=0.1, cooldown_s=0.0)
    eng = mod.AnomalyEngine(rank=2, size=4, config=cfg)
    rng = np.random.default_rng(11)
    fired = []
    for i in range(120):
        wall = 0.1 + 0.002 * float(rng.standard_normal())
        if i in (40, 41, 90):
            wall *= 3.0
        fired += eng.on_step({
            "step_wall_s": wall, "steps": 1.0,
            "exposed_comm_s": 0.01 + 0.001 * float(rng.random()),
            "data_wait_s": 0.0 if i != 70 else 0.05})
        skew = 0.001 * float(rng.random()) + (0.2 if i % 37 == 5 else 0.0)
        fired += eng.on_arrival_skew(f"allreduce.{i}", skew,
                                     int(rng.integers(0, 4)))
    return fired, eng.counts(), eng.debug_state()


def test_anomaly_incidents_bitwise(fake_clocks):
    ref = _anomaly_run(ref_anomaly)
    port = _anomaly_run(port_anomaly)
    assert port == ref
    assert port[1].get("step_time", 0) >= 1
    assert port[1].get("straggler", 0) >= 1
    assert port_anomaly.KINDS == ref_anomaly.KINDS


def test_robust_detector_scores_bitwise():
    for mod_pair in ((ref_anomaly, port_anomaly),):
        outs = []
        for mod in mod_pair:
            det = mod.RobustDetector(mod.AnomalyConfig(
                window=32, warmup=8, threshold=3.0, min_rel=0.05))
            series = np.random.default_rng(3).gamma(2.0, 1.0, 200)
            outs.append([det.update(float(v)) for v in series]
                        + [det.ewma, det.samples])
        assert outs[0] == outs[1]


# -- stepprof -------------------------------------------------------------

def _intervals(rng, n):
    t0 = rng.uniform(0, 100, n)
    return [(float(a), float(a + d))
            for a, d in zip(t0, rng.exponential(5, n))]


def test_stepprof_interval_algebra_bitwise():
    rng = np.random.default_rng(21)
    for _ in range(20):
        comp, comm = _intervals(rng, 30), _intervals(rng, 12)
        data, host = _intervals(rng, 5), _intervals(rng, 4)
        t0, t1 = sorted(rng.uniform(0, 110, 2).tolist())
        for fn in ("union", "total"):
            assert getattr(port_stepprof, fn)(comp) == \
                getattr(ref_stepprof, fn)(comp)
        cu, mu = ref_stepprof.union(comp), ref_stepprof.union(comm)
        for fn in ("intersect", "subtract"):
            assert getattr(port_stepprof, fn)(cu, mu) == \
                getattr(ref_stepprof, fn)(cu, mu)
        assert port_stepprof.clip(comp, t0, t1) == \
            ref_stepprof.clip(comp, t0, t1)
        kw = dict(compute=comp, comm=comm, data=data, host=host)
        assert port_stepprof.decompose(t0, t1, **kw) == \
            ref_stepprof.decompose(t0, t1, **kw)
        for span in comm[:4]:
            assert port_stepprof.exposed_span(span, cu) == \
                ref_stepprof.exposed_span(span, cu)
        flops, secs = float(rng.uniform(1e9, 1e12)), float(t1 - t0 + 1e-3)
        assert port_stepprof.mfu(flops, secs, peak=2e14) == \
            ref_stepprof.mfu(flops, secs, peak=2e14)
        ivs = [{"op": "k", "t0_us": a, "t1_us": b, "comm": False}
               for a, b in comp]
        for anchor in (t0, 3e15):
            assert port_stepprof.align_device_intervals(ivs, anchor) == \
                ref_stepprof.align_device_intervals(ivs, anchor)
    parts = port_stepprof.decompose(0.0, 10.0, compute=[(1, 4)],
                                    comm=[(3, 6)], data=[(5, 8)],
                                    host=[(7, 9)])
    assert sum(parts[k] for k in ("compute", "overlapped_comm",
                                  "exposed_comm", "data_wait", "host",
                                  "idle")) == parts["step_wall"]


def test_peak_flops_is_the_cards_own(monkeypatch):
    monkeypatch.setattr(port_stepprof, "PEAK_TFLOPS", None)
    monkeypatch.setattr(port_stepprof, "_card_peak", [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_stepprof.peak_flops() is None
    assert port_stepprof.mfu(1e12, 1.0) is None
    for name, want in (("NVIDIA H100 80GB HBM3", 989.0),
                       ("NVIDIA H100 PCIe", 756.0), ("NVIDIA A10", None)):
        monkeypatch.setattr(port_stepprof, "_card_peak", [])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, n=name: n)
        assert port_stepprof.card_peak_tflops() == want
    monkeypatch.setattr(port_stepprof, "PEAK_TFLOPS", 100.0)
    assert port_stepprof.peak_flops() == 1e14
    assert port_stepprof.mfu(1e13, 0.5) == 0.2


def test_measured_flops_counts_a_step():
    lin = torch.nn.Linear(8, 4)
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    # forward 2*2*8*4 and the weight gradient's as many (the input needs
    # no gradient)
    assert port_stepprof.measured_flops(
        lambda: lin(x).sum().backward()) == 256.0
    assert port_stepprof.measured_flops(lambda: None) is None


def test_collector_step_record_feeds_flight_and_anomaly(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    port_stepprof.reset()
    rec = port_flight.install(rank=0, out_dir=str(tmp_path), sigusr2=False)
    eng = port_anomaly.install(rank=0)
    try:
        port_metrics.note_step(examples=4)
        port_stepprof.note_comm("allreduce.w", *_now_window())
        port_metrics.note_step(examples=4)
        steps = [e for e in rec.events() if e["kind"] == "step"]
        assert len(steps) == 1 and steps[0]["collectives"] == 1
        assert eng.debug_state()["samples"]["step_time"] == 1
    finally:
        port_flight.uninstall()
        port_anomaly.uninstall()
        port_stepprof.reset()


def _now_window():
    import time

    t = time.time()
    return t - 1e-3, t


# -- profile --------------------------------------------------------------

BASE_NS = 1_760_000_000_000_000_000
KERNEL = "void at::native::vectorized_elementwise_kernel<4, Mul>(int, Mul)"
NCCL = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL"
        "(ncclDevKernelArgsStorage<4096ul>)")


def _synthetic_trace(path, gz=False):
    doc = {"baseTimeNanoseconds": BASE_NS, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 13,
         "args": {"name": "stream 13"}},
        {"ph": "X", "cat": "user_annotation", "pid": 900, "tid": 1,
         "name": port_stepprof.WINDOW_MARKER, "ts": 50.0, "dur": 400.0},
        {"ph": "X", "cat": "cpu_op", "pid": 900, "tid": 1,
         "name": "aten::mul", "ts": 60.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": KERNEL,
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 13, "name": NCCL,
         "ts": 120.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
         "name": "Memcpy DtoD (Device -> Device)", "ts": 300.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": KERNEL,
         "ts": 320.0, "dur": 20.0},
    ]}
    text = json.dumps(doc)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return text


def test_profile_reads_a_cuda_chrome_trace(tmp_path):
    _synthetic_trace(tmp_path / "host.1.pt.trace.json")
    rows = port_profile.op_summary(str(tmp_path))
    assert rows == [
        {"op": "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "total_ms": 0.1,
         "count": 1},
        {"op": "at::native::vectorized_elementwise_kernel",
         "total_ms": 0.07, "count": 2},
        {"op": "Memcpy DtoD", "total_ms": 0.01, "count": 1}]
    assert port_profile.device_time_ms(str(tmp_path)) == 0.18
    assert port_profile.op_summary(str(tmp_path), categories=(
        "cpu_op",)) == [{"op": "aten::mul", "total_ms": 0.005, "count": 1}]
    assert port_profile.is_comm_op(NCCL)
    assert port_profile.is_comm_op("ncclKernel_AllGather_RING_LL_Sum")
    assert not port_profile.is_comm_op(KERNEL)
    assert port_profile.plane_names(str(tmp_path)) == [
        "GPU 0 / stream 13", "GPU 0 / stream 7", "pid 900 / tid 1"]
    prof = port_profile.load_profile(str(tmp_path))
    assert prof["status"] == "ok"
    planes = prof["planes"]
    assert sorted(planes) == ["GPU 0 / stream 13", "GPU 0 / stream 7"]
    assert [iv["comm"] for iv in planes["GPU 0 / stream 13"]] == [True]
    first = planes["GPU 0 / stream 7"][0]
    assert first["t0_us"] == BASE_NS / 1e3 + 100.0
    assert first["t1_us"] == BASE_NS / 1e3 + 150.0


def test_join_aligns_on_the_window_marker(tmp_path, monkeypatch):
    """The window opened at wall time W (the marker's start on the
    profiler's clock): the card is busy 150 of the 400 µs (kernels and
    the copy), the NCCL kernel overlaps compute for 30 of its 100."""
    _synthetic_trace(tmp_path / "t.pt.trace.json.gz", gz=True)
    port_stepprof.reset()
    wall0 = 1.76e9 + 0.5
    out = port_stepprof.join_device_profile(
        str(tmp_path), window=(wall0, wall0 + 400e-6))
    assert out["status"] == "ok"
    assert out["shift_us"] == wall0 * 1e6 - (BASE_NS / 1e3 + 50.0)
    assert out["idle_share"] == pytest.approx(250 / 400, abs=1e-6)
    assert out["overlap_fraction"] == pytest.approx(0.3, abs=1e-6)
    assert out["exposed_comm_s"] == pytest.approx(70e-6, abs=1e-9)
    ivs = [{"op": "k", "t0_us": 10.0, "t1_us": 20.0, "comm": False}]
    moved, shift = port_stepprof.align_device_intervals(ivs, 500.0,
                                                        origin_us=5.0)
    assert shift == 495.0 and moved[0]["t0_us"] == 505.0


def test_idle_share_counts_the_card_only(tmp_path):
    """Without a NCCL kernel the host's comm windows stand in for the
    overlap, but the idle share stays the card's: 80 of 400 µs busy."""
    doc = json.loads(_synthetic_trace(tmp_path / "full.json"))
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if "ncclDevKernel" not in e.get("name", "")]
    d = tmp_path / "nonccl"
    d.mkdir()
    (d / "t.pt.trace.json").write_text(json.dumps(doc))
    port_stepprof.reset()
    wall0 = 1.76e9 + 0.5
    port_stepprof.note_comm("allreduce.w", wall0, wall0 + 300e-6)
    try:
        out = port_stepprof.join_device_profile(
            str(d), window=(wall0, wall0 + 400e-6))
    finally:
        port_stepprof.reset()
    assert out["idle_share"] == pytest.approx(320 / 400, abs=1e-6)
    assert out["overlap_fraction"] is not None


def test_profile_cut_files_and_host_only_capture(tmp_path):
    text = _synthetic_trace(tmp_path / "full.json")
    cut = tmp_path / "cut"
    cut.mkdir()
    (cut / "a.pt.trace.json").write_text(text[: len(text) // 2])
    with pytest.raises(port_profile.TruncatedProfile):
        port_profile.read_trace(str(cut / "a.pt.trace.json"))
    assert port_profile.load_profile(str(cut))["status"] == "truncated"
    gzcut = tmp_path / "gzcut"
    gzcut.mkdir()
    blob = gzip.compress(text.encode())
    (gzcut / "b.json.gz").write_bytes(blob[: len(blob) // 2])
    assert port_profile.load_profile(str(gzcut))["status"] == "truncated"
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port_profile.load_profile(str(empty))["status"] == "no-profile"
    (empty / "z.json").write_text("")
    assert port_profile.load_profile(str(empty))["status"] == "empty"
    assert port_stepprof.join_device_profile(
        str(cut))["overlap_fraction"] is None


def test_torch_profiler_trace_written_on_the_cpu(tmp_path):
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    with port_stepprof.profile_window(str(tmp_path)) as result:
        (a @ a).sum()
    # a host-only capture: no device events, the join says so
    assert result["status"] == "empty"
    rows = port_profile.op_summary(str(tmp_path), categories=("cpu_op",),
                                   group=False)
    assert any(r["op"] in ("aten::mm", "aten::matmul") for r in rows)
    assert any(n.endswith("/ tid " + n.rsplit(" ", 1)[-1]) or "/" in n
               for n in port_profile.plane_names(str(tmp_path)))
    doc = port_profile.read_trace(port_profile.newest(str(tmp_path)))
    assert port_profile.marker_us(doc, port_stepprof.WINDOW_MARKER) \
        is not None
    port_timeline.start_torch_profiler(str(tmp_path / "tp"))
    (a + a).sum()
    path = port_timeline.stop_torch_profiler()
    assert path is not None and path.endswith(".pt.trace.json")
    assert port_timeline.stop_torch_profiler() is None

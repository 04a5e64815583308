"""The optimizer's step spans (``obs/tracing.py``, recorded by
``torch/optimizer.py``) on the CPU, in a world of one.

A toy model whose bucket plan has two multi-tensor buckets and one
single-tensor bucket steps through ``hvd.DistributedOptimizer``:

* with no profiler on, two steps record no span and enter no
  ``hvd.*`` ``record_function`` range;
* under ``torch.profiler``, each step records one ``hvd.optimizer.step``,
  ``hvd.synchronize`` and ``hvd.update``, one ``hvd.hook`` a parameter,
  and one ``hvd.bucket.launch``, ``wait`` and ``unpack`` a bucket with
  the bucket's ``index``, ``tensors``, ``wire_bytes`` and ``grouped``,
  each nested in its parent on one thread;
* the exported trace holds the same ``hvd.*`` ranges;
* ``trace_offset`` maps every span onto its range in the trace: each
  holds its range to 50 µs at both ends, and the ends lie within 50 µs
  of the ranges' in the median;
* spans opened from many threads at once nest per thread.
"""

import collections
import gzip
import json
import statistics
import sys
import threading

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch as hvd
from horovod_tpu_torch.obs import tracing
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

# bytes: a.* 288, b.* 288, c.bias 64 | c.weight 512, d.bias 128 |
# d.weight 2048, so sorted by name the plan is 5 + 2 + 1 tensors
THRESHOLD = 1024
STEPS = 2
PER_STEP = {tracing.OPTIMIZER_STEP: 1, tracing.SYNCHRONIZE: 1,
            tracing.UPDATE: 1}
# each span's parent; a bucket launches where its last gradient became
# ready, and on the CPU that is the hook's thread
PARENT = {tracing.OPTIMIZER_STEP: None, tracing.HOOK: None,
          tracing.BUCKET_LAUNCH: tracing.HOOK,
          tracing.BUCKET_PACK: tracing.BUCKET_LAUNCH,
          tracing.BUCKET_DISPATCH: tracing.BUCKET_LAUNCH,
          tracing.SYNCHRONIZE: tracing.OPTIMIZER_STEP,
          tracing.UPDATE: tracing.OPTIMIZER_STEP,
          tracing.BUCKET_WAIT: tracing.SYNCHRONIZE,
          tracing.BUCKET_UNPACK: tracing.SYNCHRONIZE}
CODECS = {"none": (hvd.Compression.none, 4),
          "fp16": (hvd.Compression.fp16, 2)}


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.a = torch.nn.Linear(8, 8)
        self.b = torch.nn.Linear(8, 8)
        self.c = torch.nn.Linear(8, 16)
        self.d = torch.nn.Linear(16, 32)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x):
        for layer in (self.a, self.b, self.c):
            x = F.relu(layer(x))
        return self.d(x)


@pytest.fixture
def world(monkeypatch):
    monkeypatch.setenv("HVTPU_FUSION_THRESHOLD", str(THRESHOLD))
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _train(codec, steps=STEPS):
    model = Toy()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=CODECS[codec][0], gradient_predivide_factor=2.0)
    g = torch.Generator().manual_seed(5)
    for _ in range(steps):
        x = torch.randn(4, 8, generator=g)
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
    return model, opt


def _new_spans(before):
    ids = {s.id for s in before}
    return [s for s in tracing.step_spans() if s.id not in ids]


@pytest.fixture
def traced(world, tmp_path, request):
    """Two steps under the profiler: the optimizer, its new spans and
    the exported trace's events."""
    before = tracing.step_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, opt = _train(request.param)
    path = tmp_path / "trace.json.gz"
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return request.param, opt, _new_spans(before), events


def test_plan_has_multi_and_single_tensor_buckets(world):
    _, opt = _train("none", steps=0)
    sizes = [len(b) for b in opt.buckets]
    assert sizes == [5, 2, 1]


def test_no_profiler_no_span_and_no_range(world, monkeypatch):
    """Neither ``record_function`` nor the binding the spans enter their
    ranges through sees an ``hvd.*`` name, and no span opens."""
    real = torch.autograd.profiler.record_function
    enter = torch._C._autograd._record_function_with_args_enter

    class Guarded(real):
        def __init__(self, name, *args, **kwargs):
            if name.startswith("hvd."):
                raise AssertionError(f"{name} entered with no profiler")
            super().__init__(name, *args, **kwargs)

    def guarded_enter(name, *args):
        if name.startswith("hvd."):
            raise AssertionError(f"{name} entered with no profiler")
        return enter(name, *args)

    def refuse(*args, **kwargs):
        raise AssertionError("a step span opened with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Guarded)
    monkeypatch.setattr(torch._C._autograd,
                        "_record_function_with_args_enter", guarded_enter)
    monkeypatch.setattr(tracing, "span_open", refuse)
    before = tracing.step_spans()
    _train("fp16")
    assert tracing.step_spans() == before


@pytest.mark.parametrize("traced", sorted(CODECS), indirect=True)
def test_spans_a_step(traced):
    codec, opt, spans, _ = traced
    count = collections.Counter(s.name for s in spans)
    n_params = sum(1 for _ in opt._params)
    want = {name: n * STEPS for name, n in PER_STEP.items()}
    want[tracing.HOOK] = n_params * STEPS
    for name in (tracing.BUCKET_LAUNCH, tracing.BUCKET_WAIT,
                 tracing.BUCKET_UNPACK):
        want[name] = len(opt.buckets) * STEPS
    # a pack a multi-tensor bucket, a dispatch a bucket's allreduce
    want[tracing.BUCKET_PACK] = 2 * STEPS
    want[tracing.BUCKET_DISPATCH] = 3 * STEPS
    assert dict(count) == want

    itemsize = CODECS[codec][1]
    launches = [s for s in spans if s.name == tracing.BUCKET_LAUNCH]
    for k, s in enumerate(launches):
        bucket = opt.buckets[k % len(opt.buckets)]
        assert s.attrs == {
            "index": k % len(opt.buckets), "tensors": len(bucket),
            "wire_bytes": sum(p.numel() for p in bucket) * itemsize,
            "grouped": len(bucket) > 1}
    for name in (tracing.BUCKET_WAIT, tracing.BUCKET_UNPACK):
        got = [s.attrs["index"] for s in spans if s.name == name]
        assert got == list(range(len(opt.buckets))) * STEPS
    syncs = [s.attrs for s in spans if s.name == tracing.SYNCHRONIZE]
    assert syncs == [{"buckets": len(opt.buckets)}] * STEPS


@pytest.mark.parametrize("traced", sorted(CODECS), indirect=True)
def test_spans_nest(traced):
    _, _, spans, _ = traced
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if PARENT[s.name] is None:
            assert s.parent is None, s
            continue
        parent = by_id[s.parent]
        assert parent.name == PARENT[s.name], s
        assert parent.tid == s.tid
        assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns


@pytest.mark.parametrize("traced", sorted(CODECS), indirect=True)
def test_trace_holds_the_same_ranges(traced):
    _, _, spans, events = traced
    ranges = collections.Counter(
        e["name"] for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e["name"].startswith("hvd."))
    assert ranges == collections.Counter(s.name for s in spans)


@pytest.mark.parametrize("traced", sorted(CODECS), indirect=True)
def test_trace_offset_maps_each_span_onto_its_range(traced):
    """Mapped by the ``hvd.synchronize`` spans alone, every span holds
    its range in the trace, to 50 µs at each end, and the spans' ends
    lie within 50 µs of their ranges' in the median.  A span reads the
    clock before its range's enter and after its exit, so a thread
    preempted in between (the tests share the machine's cores) can only
    widen it: that is a wait the span rightly holds, not a mapping
    error."""
    _, _, spans, events = traced
    marks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("hvd."))
    sync = [m for m in marks if m[2] == tracing.SYNCHRONIZE]
    offset = tracing.trace_offset(spans, sync)
    assert offset is not None
    heads, tails = [], []
    for name in PARENT:
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.t0_ns)
        theirs = [m for m in marks if m[2] == name]
        assert len(mine) == len(theirs)
        for s, (a, b, _) in zip(mine, theirs):
            heads.append(a - (s.t0_ns / 1e3 + offset))
            tails.append(s.t1_ns / 1e3 + offset - b)
    assert min(heads) > -50 and min(tails) > -50
    assert statistics.median(heads) < 50 and statistics.median(tails) < 50


def test_trace_offset_takes_the_fitting_run_of_spans():
    """A record that spans an earlier session as well: the run of spans
    whose offsets agree is matched, and a name on one side only is left
    out."""
    def span(t0_us, t1_us, name="x"):
        return tracing.StepSpan(name, 1, int(t0_us * 1e3), int(t1_us * 1e3),
                                None, {}, 0)

    spans = [span(0, 40), span(100, 110), span(200, 230), span(300, 305),
             span(1, 2, "y")]
    marks = [(1200.0, 1230.0, "x"), (1300.0, 1305.0, "x"),
             (50.0, 60.0, "z")]
    assert tracing.trace_offset(spans, marks) == pytest.approx(1000.0)
    assert tracing.trace_offset(spans, [(5.0, 6.0, "z")]) is None
    # more ranges than spans: the spans are slid along the ranges
    assert tracing.trace_offset(spans[2:4], [(0.0, 40.0, "x")] + [
        (a + 7, b + 7, "x") for a, b, _ in marks[:2]]) == pytest.approx(
            1007.0)


def test_spans_nest_per_thread_under_contention():
    """Threads, more than cores, open and close nested spans at once
    with a short switch interval: each thread's spans nest on its own
    stack, and none is lost."""
    threads, rounds = 16, 200
    before = tracing.step_spans()
    errors = []

    def work():
        try:
            for _ in range(rounds):
                outer = tracing.span_open(tracing.HOOK)
                inner = tracing.span_open(tracing.BUCKET_LAUNCH)
                tracing.span_close(inner)
                tracing.span_close(outer)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert errors == []
    spans = _new_spans(before)
    assert len(spans) == 2 * threads * rounds
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == tracing.HOOK:
            assert s.parent is None
        else:
            assert by_id[s.parent].name == tracing.HOOK
            assert by_id[s.parent].tid == s.tid


def test_an_exception_closes_the_spans_left_open():
    """A span left open by an exception is closed, unrecorded, with the
    span around it, and the thread's next span has no stale parent."""
    before = tracing.step_spans()
    outer = tracing.span_open(tracing.SYNCHRONIZE)
    tracing.span_open(tracing.BUCKET_WAIT)
    tracing.span_close(outer)
    nxt = tracing.span_open(tracing.HOOK)
    tracing.span_close(nxt)
    spans = _new_spans(before)
    assert [s.name for s in spans] == [tracing.SYNCHRONIZE, tracing.HOOK]
    assert spans[1].parent is None

"""The readers of the optimizer's step spans, ``framework_host_ms`` and
``framework_idle_ms``, on a hand-made window and a hand-made span
record with known answers.

The window is [1000, 2000) µs of the trace's clock, 2 steps, the device
busy in [1000, 1300) and [1500, 2000), so idle in [1300, 1500).  The
record's clock runs 1000 µs behind the trace's: the main thread's
``hvd.synchronize`` spans at [250, 350) and [900, 960) µs have their
ranges at [1250, 1350) and [1900, 1960)."""

import threading

import pytest

from horovod_tpu_torch.obs import tracing
from portbench import cell, trace
from portbench.tests.test_portbench_counters import _ev

MAIN = threading.get_native_id()
OTHER = MAIN + 1
READERS = ("framework_host_ms", "framework_idle_ms")


def _span(name, t0_us, t1_us, tid=MAIN, parent=None):
    return tracing.StepSpan(name, tid, int(t0_us * 1e3), int(t1_us * 1e3),
                            parent, {}, 0)


SYNCS = [_span(tracing.SYNCHRONIZE, 250, 350),
         _span(tracing.SYNCHRONIZE, 900, 960)]

# name: (the record, framework_host_ms, framework_idle_ms); ms a step
CASES = {
    # a hook on another thread overlaps the first synchronize: [1250,
    # 1420) once, not 100 + 120 µs; idle inside it [1300, 1420)
    "overlap_counted_once": (
        SYNCS + [_span(tracing.HOOK, 300, 420, tid=OTHER)],
        (170 + 60) / 2e3, 120 / 2e3),
    # an update from 1950 runs past the window's end at 2000
    "clipped_to_the_window": (
        SYNCS + [_span(tracing.UPDATE, 950, 1100)],
        (100 + 100) / 2e3, 50 / 2e3),
    # the device idles in [1300, 1500); the spans cover only 50 µs of it
    "idle_outside_spans_not_counted": (
        SYNCS, (100 + 60) / 2e3, 50 / 2e3),
    "empty_record": ([], None, None),
}


def _window(ops=True):
    ev = [_ev("user_annotation", trace.WINDOW, 1000, 1000),
          _ev("user_annotation", tracing.SYNCHRONIZE, 1250, 100),
          _ev("user_annotation", tracing.SYNCHRONIZE, 1900, 60),
          _ev("user_annotation", trace.OPT_STEP, 1240, 730)]
    if ops:
        ev += [_ev("kernel", "vectorized_elementwise_kernel", 1000, 300, 7),
               _ev("kernel", "vectorized_elementwise_kernel", 1500, 500, 7)]
    return trace.window_of(ev, steps=2, flops_per_step=1.0,
                           conv_min_s_per_step=0.0, a1_bytes_per_step=0,
                           a1_passes_per_step=0, a1_launches=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_framework_readers(case, monkeypatch):
    record, host, idle = CASES[case]
    monkeypatch.setattr(tracing, "step_spans", lambda: list(record))
    w = _window()
    got = {m: cell.load_reader(m)(w) for m in READERS}
    want = {"framework_host_ms": host, "framework_idle_ms": idle}
    assert got == pytest.approx(want)
    # the idle counted lies inside the window's idle and the host time
    # inside the window, a step
    if host is not None:
        assert got["framework_idle_ms"] <= 200 / 2e3
        assert got["framework_host_ms"] <= w.window_s * 1e3 / w.steps


@pytest.mark.parametrize("reader", READERS)
def test_framework_readers_read_nothing_without_spans_to_map(reader,
                                                             monkeypatch):
    """No device operation (a CPU trace), spans on no thread that has
    ``hvd.synchronize`` ranges, or a program without step spans (as
    before they were added): None, and nothing raised."""
    read = cell.load_reader(reader)
    record = SYNCS + [_span(tracing.HOOK, 300, 420, tid=OTHER)]
    monkeypatch.setattr(tracing, "step_spans", lambda: list(record))
    assert read(_window(ops=False)) is None
    monkeypatch.setattr(tracing, "step_spans",
                        lambda: [s._replace(tid=OTHER) for s in record])
    assert read(_window()) is None
    monkeypatch.delattr(tracing, "step_spans")
    assert read(_window()) is None

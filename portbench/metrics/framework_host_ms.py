"""Host ms a step inside the framework's own work: the union, over the
rank's threads, of the optimizer's ``hvd.*`` step spans (its hooks,
bucket launches, ``synchronize`` and update;
``horovod_tpu_torch/obs/tracing.py``), mapped onto the trace's clock and
clipped to the window, over the traced steps.  Where the host runs
ahead of the card (ResNet-50 b256) it includes the time the launches
inside those spans wait in a full launch queue.  Nothing where the
program records no step spans, or the window has no device
operation."""

import threading

from portbench import intervals


def spans_on_trace(w):
    """The union of the rank's step spans on the trace's clock (µs),
    clipped to the window: the recorder's clock is mapped by the median
    offset of this thread's ``hvd.synchronize`` spans from their ranges
    in the trace.  None where there is nothing to map."""
    from horovod_tpu_torch.obs import tracing

    record = getattr(tracing, "step_spans", None)
    if not w.ops or record is None:
        return None
    spans = record()
    main = threading.get_native_id()
    offset = tracing.trace_offset(
        [s for s in spans if s.tid == main],
        [a for a in w.annotations if a[2] == tracing.SYNCHRONIZE])
    if offset is None:
        return None
    return intervals.union(
        (max(s.t0_ns / 1e3 + offset, w.t0), min(s.t1_ns / 1e3 + offset, w.t1))
        for s in spans) or None


def read(w):
    ivs = spans_on_trace(w)
    if ivs is None:
        return None
    return intervals.total(ivs) / 1e3 / w.steps

"""Device idle ms a step while some host thread of the rank is inside
one of the optimizer's ``hvd.*`` step spans: the window's gaps between
device operations intersected with the spans' union
(``framework_host_ms.spans_on_trace``), over the traced steps.  It
names the idle that the framework's host work leaves on the card; a
full launch queue cannot inflate it, since the card is busy then.
Nothing where the program records no step spans, or the window has no
device operation."""

from portbench import intervals
from portbench.metrics.framework_host_ms import spans_on_trace


def read(w):
    ivs = spans_on_trace(w)
    if ivs is None:
        return None
    idle = intervals.intersect(intervals.gaps(w.busy(), w.t0, w.t1), ivs)
    return intervals.total(idle) / 1e3 / w.steps

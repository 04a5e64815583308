"""The share of a step in which no operation runs on the device: one
minus the device's busy time a step (the union of its operations in the
traced window, over the traced steps) over the time of a step, on the
host's clock, of the same steps run untraced just before the window.
The traced window's own idle share (``device.busy_s`` against
``window_s``) also counts the time the profiler costs the host."""


def read(w):
    if not w.ops or not w.untraced_step_s:
        return None
    return 1.0 - w.busy_s() / w.steps / w.untraced_step_s

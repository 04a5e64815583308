"""Kernel A1's share of its roofline, in %: the bytes of the step's A1
passes worked out from the bucket plan (counters/a1_bytes.py) over the
card's 3.35 TB/s, times the traced steps, over the device time of
``scale_cast_table_kernel``.  Nothing when the window's A1 launches are
not the passes the plan asks for."""

from portbench import kernels


def read(w):
    busy = w.seconds(("a1",))
    want = w.a1_passes_per_step * w.steps
    if busy <= 0 or not want or w.a1_launches != want:
        return None
    return 100.0 * w.a1_bytes_per_step * w.steps / (
        kernels.PEAK_BYTES_PER_S * busy)

"""The whole step's share of the card's bf16 peak, in %: the operations
the published architecture needs a step (convolutions and dense layers,
forward, weight and input gradients; counters/conv_flops.py) over the
time of a step, on the host's clock, of the same steps run untraced
just before the traced window (the profiler's work on the host would
slow the window's steps), times 989 TFLOP/s."""

from portbench import kernels


def read(w):
    if not w.ops or not w.untraced_step_s:
        return None
    return 100.0 * w.flops_per_step / (
        w.untraced_step_s * kernels.PEAK_BF16_FLOPS)

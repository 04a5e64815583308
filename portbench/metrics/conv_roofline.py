"""The convolution and matrix-product kernels' share of their roofline,
in %: each layer pass's least time on the card (the larger of its
operations over the peak and its bytes over the bandwidth;
counters/conv_flops.py), summed over a step and the traced steps, over
the device time of the kernels in the ``conv_gemm`` group."""


def read(w):
    busy = w.seconds(("conv_gemm",))
    if busy <= 0:
        return None
    return 100.0 * w.conv_min_s_per_step * w.steps / busy

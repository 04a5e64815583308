"""Device ms a step in kernels that are not convolutions or matrix
products, NCCL or A1, and not launched inside ``opt.step()``: the
norms' passes, activations, pools, casts and the loss."""


def read(w):
    if not w.ops or not w.has_opt_ranges:
        return None
    return 1e3 * w.seconds(("other",), in_opt=False) / w.steps

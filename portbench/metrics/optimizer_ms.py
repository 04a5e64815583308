"""Device ms a step of the operations launched inside ``opt.step()``
(the benchmark's range around the call; each kernel tied to the call
that launched it): the last buckets' wire, the unpack into the
gradients and the update."""


def read(w):
    if not w.has_opt_ranges:
        return None
    ms = 1e3 * w.seconds(cats=("kernel", "gpu_memcpy", "gpu_memset"),
                         in_opt=True) / w.steps
    return ms if ms > 0 else None

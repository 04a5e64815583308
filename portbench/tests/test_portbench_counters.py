"""A1's bytes from a bucket plan, and the interval algebra and the trace
reduction on hand-made intervals."""

import pytest
import torch

from portbench import cell, intervals, trace
from portbench.counters import a1_bytes


def test_a1_bytes_from_hand_made_buckets():
    # float32 gradients, float16 wire: 4 + 2 bytes a pass, two passes
    buckets = [[(10, 4), (6, 4)], [(1000, 4)], [(3, 4), (5, 4), (8, 4)]]
    nbytes, passes = a1_bytes.a1_step(buckets, 2)
    assert passes == 4
    assert nbytes == 2 * 6 * (10 + 6) + 2 * 6 * (3 + 5 + 8)


def test_a1_bytes_from_the_programs_resnet50_plan():
    from horovod_tpu_torch.comm.fusion import plan_buckets
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.models import ResNet50

    model = ResNet50(device="meta")
    named = list(model.named_parameters())
    plan = plan_buckets([n for n, _ in named], [p for _, p in named],
                        Config.from_env().fusion_threshold_bytes)
    buckets = [[(named[e.index][1].numel(), 4) for e in b]
               for b in plan.buckets]
    nbytes, passes = a1_bytes.a1_step(buckets, 2)
    multi = [b for b in buckets if len(b) > 1]
    assert passes == 2 * len(multi) == 4
    assert nbytes == 12 * sum(n for b in multi for n, _ in b)


def test_interval_algebra():
    a = intervals.union([(5, 7), (0, 2), (1, 3), (6, 9), (10, 10)])
    assert a == [(0, 3), (5, 9)]
    b = [(2, 6), (8, 12)]
    assert intervals.intersect(a, b) == [(2, 3), (5, 6), (8, 9)]
    assert intervals.subtract(a, b) == [(0, 2), (6, 8)]
    assert intervals.total(a) == 7
    assert intervals.gaps(a, -1, 11) == [(-1, 0), (3, 5), (9, 11)]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction_on_a_hand_made_window():
    """Window [0, 100) µs, 2 steps; kernels by group, one launched
    inside opt.step(), one NCCL kernel half hidden."""
    ev = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("user_annotation", trace.OPT_STEP, 60, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 65, 1, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 66, 1, corr=5),
        _ev("kernel", "sm90_xmma_fprop_implicit_gemm", 10, 20, 7, corr=1),
        _ev("kernel", "vectorized_elementwise_kernel", 30, 10, 7, corr=2),
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_f16", 35, 15, 8, corr=3),
        _ev("kernel", "scale_cast_table_kernel", 70, 5, 7, corr=4),
        _ev("kernel", "multi_tensor_apply_kernel", 75, 5, 7, corr=5),
        _ev("cpu_op", "aten::relu", 40, 25),
    ]
    w = trace.window_of(ev, steps=2, flops_per_step=989e12 * 10e-6,
                        conv_min_s_per_step=5e-6, a1_bytes_per_step=1_675_000,
                        a1_passes_per_step=1, a1_launches=2,
                        untraced_step_s=40e-6)
    assert w.window_s == pytest.approx(100e-6)
    assert w.busy_s() == pytest.approx(50e-6)
    read = {m: cell.load_reader(m)(w) for m in (
        "idle_share", "mfu", "conv_roofline", "norm_elementwise_ms",
        "a1_roofline", "optimizer_ms")}
    # against the untraced steps' 40 µs: 25 µs busy a step
    assert read["idle_share"] == pytest.approx(0.375)
    assert read["mfu"] == pytest.approx(25.0)
    assert read["conv_roofline"] == pytest.approx(50.0)
    assert read["norm_elementwise_ms"] == pytest.approx(5e-3)
    assert read["a1_roofline"] == pytest.approx(20.0)
    assert read["optimizer_ms"] == pytest.approx(5e-3)
    gaps = dict(trace.breakdown(w)["idle_gaps"])
    assert gaps == pytest.approx({"outside>python": 30e-6,
                                  "portbench.opt_step>aten::relu": 20e-6})
    # A1 launches other than the plan's passes: no reading
    w.a1_launches = 3
    assert cell.load_reader("a1_roofline")(w) is None
    # no untraced steps: no step time for mfu and idle_share to read
    w.untraced_step_s = None
    assert cell.load_reader("mfu")(w) is None
    assert cell.load_reader("idle_share")(w) is None


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    for name in ("horovod_tpu_torch_extra", "jaxfoo", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "optax.contrib",
                        types.ModuleType("optax.contrib"))
    assert cell.forbidden_modules() == ["optax"]


def test_bit_digest_tells_bits_apart():
    from portbench.reference.train import bit_digest

    a = torch.randn(1000)
    b = a.clone()
    assert bit_digest(a) == bit_digest(b)
    b[3] = torch.nextafter(b[3], torch.tensor(float("inf")))
    assert bit_digest(a) != bit_digest(b)

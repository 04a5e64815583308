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


# (m, k, n): hand counts of flops and bytes a step, bf16, three passes
GEMMS = {
    # a weight: 4096 tokens x 2048 -> 1408
    "weight": ((4096, 2048, 1408),
               3 * 2 * 4096 * 2048 * 1408,
               3 * 2 * (4096 * 2048 + 2048 * 1408 + 4096 * 1408)),
    # a head: 256 tokens x 64 -> a vocabulary of 256
    "head": ((256, 64, 256),
             3 * 2 * 256 * 64 * 256,
             3 * 2 * (256 * 64 + 64 * 256 + 256 * 256)),
}


@pytest.mark.parametrize("case", sorted(GEMMS))
def test_gemm_terms_by_hand(case):
    from portbench.counters.transformer_flops import Gemm

    (m, k, n), flops, nbytes = GEMMS[case]
    g = Gemm(case, m, k, n, "bfloat16")
    assert g.passes * g.pass_flops() == flops
    assert g.passes * g.pass_bytes() == nbytes


# (batch, heads, seq_len, qk_dim, v_dim): causal pairs, flops, bytes (bf16)
ATTENTION = {
    # MLA's shapes: q/k heads of 192, v heads of 128, an 8K sequence
    "mla": ((1, 16, 8192, 192, 128), 8192 * 8193 // 2),
    "small": ((4, 4, 32, 16, 16), 32 * 33 // 2),
}


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_attention_terms_by_hand(case):
    from portbench.counters.transformer_flops import Attention

    (b, h, t, dq, dv), pairs = ATTENTION[case]
    a = Attention(case, b, h, t, dq, dv, "bfloat16")
    assert a.pairs == pairs == sum(range(1, t + 1))
    # forward: QK^T and PV; backward: dV, dP, dQ, dK
    fwd = 2 * b * h * pairs * dq + 2 * b * h * pairs * dv
    bwd = (2 * b * h * pairs * dv + 2 * b * h * pairs * dv
           + 2 * b * h * pairs * dq + 2 * b * h * pairs * dq)
    assert a.forward_flops() == fwd and a.backward_flops() == bwd
    row = 2 * b * h * t
    assert a.forward_bytes() == row * (dq + dq + dv + dv)
    assert a.backward_bytes() == row * (3 * dq + 3 * dv + dv + dq)


@pytest.mark.parametrize("tokens,per_token,held,routed,want", [
    (65536, 6, 8, 64, 49152.0),      # 8 of 64 experts, 8 x 8192 tokens
    (1000, 2, 3, 8, 750.0),
])
def test_expert_tokens_by_hand(tokens, per_token, held, routed, want):
    from portbench.counters.transformer_flops import expert_tokens

    got = expert_tokens(tokens, per_token, held, routed)
    assert got == want
    assert got / held == tokens * per_token / routed   # a held expert's


def test_decoder_step_work_sums_its_terms():
    """The tiny decoder's step: every GEMM three passes and its
    attention forward plus backward, counted by hand; the GEMMs' least
    time in ``min_s``, the attention's apart."""
    import json
    from pathlib import Path

    from portbench import kernels, tasks

    c = json.loads((Path(__file__).with_name("tiny_lm.json"))
                   .read_text())["config"]
    c = dict(c, compute_dtype="bfloat16")
    b, t, d, f, v, h = 8, 32, 64, 176, 256, 4
    m = b * t
    gemm = 2 * m * d * (4 * d + 3 * f)
    attn = 3 * 2 * b * h * (t * (t + 1) // 2) * 2 * (d // h)
    flops = 3 * (2 * gemm + 2 * m * d * v) + 2 * attn
    work = tasks.of(c).step_work(c, {"batch_per_rank": b, "seq_len": t})
    assert work["flops"] == flops
    assert work["min_s"] > 0 and work["attention_min_s"] > 0
    # at these sizes every pass is bound by its bytes
    gemm_bytes = 3 * 2 * sum(
        m * k + k * n + m * n for k, n in
        [(d, d)] * 4 + [(d, f)] * 2 + [(f, d)]) * 2 + \
        3 * 2 * (m * d + d * v + m * v)
    assert work["min_s"] == pytest.approx(gemm_bytes
                                          / kernels.PEAK_BYTES_PER_S)


# the names PyTorch's SDPA backends give their kernels on Hopper: flash,
# memory-efficient (cutlass fmha), cuDNN's fused attention; and a name
# of the program's own
ATTENTION_KERNELS = [
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, "
    "128, 128, 4, false, false, cutlass::bfloat16_t>, false, true>",
    "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<"
    "Flash_bwd_kernel_traits<64, 128, 128, 8>>",
    "void pytorch_flash::flash_bwd_dot_do_o_kernel<true, "
    "Flash_bwd_kernel_traits<64, 128, 128, 8>>",
    "void pytorch_flash::flash_bwd_convert_dq_kernel<Flash_bwd_kernel_"
    "traits<64, 128, 128, 8>>",
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
    "AttentionKernel<cutlass::bfloat16_t, cutlass::arch::Sm80, true, 64, "
    "64, 64, true, true>::Params)",
    "fmha_cutlassB_f32_aligned_64x64_k64_sm80(PyTorchMemEffAttention::"
    "AttentionBackwardKernel<cutlass::arch::Sm80, float, true, false, "
    "true, 64, 64, 64, false>::Params)",
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_"
    "64x64x64_4x1x1_kernel0_0",
    "cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_7_"
    "64x64x64_4x1x1_kernel0_0",
    # as traced on an H100 (torch 2.11, CUDA 12.8): cuDNN's SDPA in
    # bfloat16, the memory-efficient kernels in float32
    "cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_26_"
    "64x64x64_1x4x1_cga1x1x1_kernel0_0",
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_"
    "64x128x64_4x1x1_cga1x1x1_kernel0_0",
    "fmha_cutlassB_f32_aligned_64x64_k64_sm80(PyTorchMemEffAttention::"
    "AttentionBackwardKernel<cutlass::arch::Sm80, float, true, false, "
    "false, 64, 64, 64, false>::Params)",
    "fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
    "AttentionKernel<float, cutlass::arch::Sm80, true, 64, 64, 64, true, "
    "true>::Params)",
    "mla_attention_kernel",
]


@pytest.mark.parametrize("name", ATTENTION_KERNELS)
def test_attention_kernels_sort_into_their_group(name):
    from portbench import kernels

    assert kernels.group_of(name) == "attention"


def test_cells_kernels_keep_their_groups():
    """Every kernel name the two cells' traced runs show on the card
    (``kernel_groups.json``: the traces' full names and the ledger's
    breakdowns' shortened ones), in the group it took before the
    ``attention`` group existed."""
    import json
    from pathlib import Path

    from portbench import kernels

    seen = json.loads(Path(__file__).with_name("kernel_groups.json")
                      .read_text())
    assert seen
    moved = {n: (g, kernels.group_of(n)) for n, g in seen.items()
             if kernels.group_of(n) != g}
    assert not moved


@pytest.mark.parametrize("name,batch,macs,flops", [
    ("resnet50-v1.5", 256, 4_089_184_256, 6_220_563_873_792),
    ("vgg16", 64, 15_470_264_320, 5_929_483_370_496),
])
def test_cnn_work_stays_exact(name, batch, macs, flops):
    """The two cells' work through their task, to the multiply-add:
    ResNet-50's 4.089 and VGG-16's 15.470 GMACs an image, the step's
    operations, and no attention."""
    import json
    from pathlib import Path

    from portbench import tasks
    from portbench.counters import conv_flops

    c = json.loads((Path(__file__).parents[1] / "configs" / f"{name}.json")
                   .read_text())
    assert conv_flops.forward_macs(c) == macs
    work = tasks.of(c).step_work(c, {"batch_per_rank": batch})
    assert work["flops"] == flops and work["attention_min_s"] == 0.0

"""The fused norm (``horovod_tpu_torch/ops/norm.py``, ``csrc/norm.cu``)
on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py``'s norm
phase holds them against the plain version.  Here:

* ``TpuBatchNorm(x, residual=..., relu=...)`` on a CPU tensor computes
  exactly what the layer and its epilogue computed before they became
  one call (``F.relu(bn(x))``, ``F.relu(r + bn(x))``): outputs,
  gradients and running stats bit for bit, at ResNet-50's and Inception
  V3's channel counts and at counts that are not a multiple of 8;
* the closed-form backward the kernels implement
  (``ops.norm.grad_closed_form``), in float64, equals autograd of the
  plain composition, a channel whose variance clamps to 0 included;
* the synchronized norm through the new signature in a 2-rank gloo
  world equals the norm of the whole batch;
* the launch plan covers every element once, as the kernels' thread
  mapping reads it, and every kernel's name sorts into the benchmark's
  ``other`` group, so ``norm_elementwise_ms`` counts it.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models import TpuBatchNorm
from horovod_tpu_torch.ops import _build, norm as norm_ops
from torch_port_models_util import SBN_EPSILON, SBN_MOMENTUM, sbn_arrays
from torch_port_util import spawn_world


def _old_forward(bn: TpuBatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``TpuBatchNorm.forward`` as it was before the epilogue joined it."""
    c = x.shape[1]
    if bn.training:
        x2 = x.permute(0, 2, 3, 1).reshape(-1, c)
        mean = x2.mean(dim=0, dtype=torch.float32)
        mean_sq = x2.float().square().mean(dim=0)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        if bn.update_running:
            with torch.no_grad():
                m = bn.momentum
                bn.mean.copy_(m * bn.mean + (1.0 - m) * mean)
                bn.var.copy_(m * bn.var + (1.0 - m) * var)
    else:
        mean, var = bn.mean, bn.var
    inv = torch.rsqrt(var + bn.epsilon) * bn.scale
    shift = -mean * inv + bn.bias
    a = inv.to(bn.dtype).view(1, c, 1, 1)
    b = shift.to(bn.dtype).view(1, c, 1, 1)
    return (x * a + b).to(bn.dtype)


def _make(c: int, dtype, seed: int, eps: float = 1e-5) -> TpuBatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = TpuBatchNorm(c, dtype=dtype, momentum=0.9, epsilon=eps)
    with torch.no_grad():
        bn.scale.copy_(1 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.var.copy_(1 + 0.2 * torch.rand(c, generator=g))
    return bn


def _inputs(shape, dtype, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 1.5 + 0.3).to(dtype)
    r = torch.randn(shape, generator=g).to(dtype)
    w = torch.randn(shape, generator=g).to(dtype)
    cl = dict(memory_format=torch.channels_last)
    return x.contiguous(**cl), r.contiguous(**cl), w.contiguous(**cl)


def _run(bn, x, r, w, call):
    x = x.clone().requires_grad_(True)
    r = r.clone().requires_grad_(True)
    y = call(bn, x, r)
    (y.float() * w.float()).sum().backward()
    grads = {"x": x.grad, "r": r.grad, "scale": bn.scale.grad,
             "bias": bn.bias.grad}
    return y.detach(), grads, (bn.mean.clone(), bn.var.clone())


# (shape NCHW, epilogue): ResNet-50's channel counts, Inception V3's,
# and counts that are not a multiple of 8
SHAPES = [
    ((2, 64, 7, 7), "relu"),
    ((2, 256, 4, 4), "residual_relu"),
    ((2, 512, 3, 3), "none"),
    ((2, 2048, 2, 2), "residual_relu"),
    ((2, 80, 5, 5), "relu"),
    ((2, 192, 3, 3), "relu"),
    ((3, 48, 5, 3), "residual"),
    ((2, 12, 5, 5), "relu"),
    ((3, 13, 3, 5), "residual_relu"),
    ((2, 3, 4, 4), "none"),
]

CALLS = {
    "relu": (lambda bn, x, r: bn(x, relu=True),
             lambda bn, x, r: F.relu(_old_forward(bn, x))),
    "residual_relu": (lambda bn, x, r: bn(x, residual=r, relu=True),
                      lambda bn, x, r: F.relu(r + _old_forward(bn, x))),
    "residual": (lambda bn, x, r: bn(x, residual=r),
                 lambda bn, x, r: r + _old_forward(bn, x)),
    "none": (lambda bn, x, r: bn(x), lambda bn, x, r: _old_forward(bn, x)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape,epilogue", SHAPES,
                         ids=[f"{'x'.join(map(str, s))}-{e}"
                              for s, e in SHAPES])
def test_cpu_call_is_the_old_composition(shape, epilogue, training, dtype):
    new_call, old_call = CALLS[epilogue]
    x, r, w = _inputs(shape, dtype, seed=shape[1])
    got_bn, want_bn = (_make(shape[1], dtype, seed=7) for _ in range(2))
    got_bn.train(training)
    want_bn.train(training)
    got = _run(got_bn, x, r, w, new_call)
    want = _run(want_bn, x, r, w, old_call)
    assert got[0].dtype == dtype
    assert torch.equal(got[0], want[0])
    for k in ("x", "scale", "bias"):
        assert torch.equal(got[1][k], want[1][k]), k
    if epilogue.startswith("residual"):
        assert torch.equal(got[1]["r"], want[1]["r"])
    else:
        assert got[1]["r"] is None and want[1]["r"] is None
    for g, v in zip(got[2], want[2]):
        assert torch.equal(g, v)


def test_update_running_false_leaves_the_stats():
    x, r, w = _inputs((2, 16, 3, 3), torch.bfloat16, seed=1)
    bn = _make(16, torch.bfloat16, seed=2)
    before = (bn.mean.clone(), bn.var.clone())
    bn.update_running = False
    _run(bn, x, r, w, CALLS["residual_relu"][0])
    assert torch.equal(bn.mean, before[0]) and torch.equal(bn.var, before[1])


# -- the closed-form backward --------------------------------------------------

def _with_clamping_channel(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` (channels-last) with channel ``k`` set to a constant whose
    float64 ``E[x^2] - E[x]^2`` over the ``(N*H*W, C)`` view is below 0,
    so the variance clamps."""
    c = x.shape[1]
    for v in np.arange(0.1, 10.0, 0.1):
        x[:, k] = float(v)
        x2 = x.permute(0, 2, 3, 1).reshape(-1, c)
        if (x2.square().mean(0) - x2.mean(0).square())[k].item() < 0:
            return x
    raise AssertionError("no constant clamps")


def _plain64(x, scale, bias, mean_buf, var_buf, eps, training, r, relu):
    """``batch_norm_plain``'s composition with every step in float64."""
    c = x.shape[1]
    if training:
        x2 = x.permute(0, 2, 3, 1).reshape(-1, c)
        mean = x2.mean(dim=0)
        var = torch.clamp(x2.square().mean(dim=0) - mean.square(), min=0.0)
    else:
        mean, var = mean_buf, var_buf
    inv = torch.rsqrt(var + eps) * scale
    shift = -mean * inv + bias
    y = x * inv.view(1, c, 1, 1) + shift.view(1, c, 1, 1)
    if r is not None:
        y = r + y
    return F.relu(y) if relu else y


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("epilogue", ["relu", "residual_relu", "none",
                                      "residual"])
def test_closed_form_backward_is_autograd(epilogue, training):
    n, c, h, w_ = 3, 10, 4, 5
    m = n * h * w_
    g = torch.Generator().manual_seed(3)
    f64 = dict(generator=g, dtype=torch.float64)
    x = (torch.randn(n, c, h, w_, **f64) + 0.4).contiguous(
        memory_format=torch.channels_last)
    x = _with_clamping_channel(x, 7)      # channel 7: the variance clamps
    r = torch.randn(n, c, h, w_, **f64)
    dy = torch.randn(n, c, h, w_, **f64)
    scale = (1 + 0.2 * torch.randn(c, **f64)).requires_grad_(True)
    bias = (0.1 * torch.randn(c, **f64)).requires_grad_(True)
    mean_buf = 0.1 * torch.randn(c, **f64)
    var_buf = 1 + 0.2 * torch.rand(c, **f64)
    eps = 1e-3
    relu, res = epilogue.endswith("relu"), epilogue.startswith("residual")
    xa = x.clone().requires_grad_(True)
    ra = r.clone().requires_grad_(True)
    y = _plain64(xa, scale, bias, mean_buf, var_buf, eps, training,
                 ra if res else None, relu)
    y.backward(dy)

    rows = lambda t: t.permute(0, 2, 3, 1).reshape(m, c)  # noqa: E731
    x2 = rows(x)
    if training:
        mean = x2.mean(0)
        raw = x2.square().mean(0) - mean.square()
        var = raw.clamp(min=0)
        assert raw[7] < 0 and var[7] == 0
    else:
        mean, var, raw = mean_buf, var_buf, var_buf
    s = scale.detach()
    inv = torch.rsqrt(var + eps) * s
    a, b = inv, bias.detach() - mean * inv
    relu_src = None if not relu else rows(y.detach()) if res else x2 * a + b
    dx, dscale, dbias, dr, c0, c1 = norm_ops.grad_closed_form(
        x2, rows(dy), relu_src, a, mean, var, raw, s, eps,
        training=training)
    if not training:
        assert not c0.any() and not c1.any()

    def close(got, want, what):
        tol = 1e-10 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol, what

    close(dx, rows(xa.grad), "dx")
    close(dscale, scale.grad, "dscale")
    close(dbias, bias.grad, "dbias")
    if res:
        close(dr, rows(ra.grad), "dr")


# -- synchronized norm, 2 ranks -------------------------------------------------

def test_sync_norm_two_ranks_through_the_epilogue(tmp_path):
    from torch_port_models_util import SBN_LOCAL, sync_bn_epilogue_worker

    world = 2
    codes, _ = spawn_world(sync_bn_epilogue_worker, world, tmp_path,
                           timeout=120)
    assert codes == [0] * world, codes
    ranks = [dict(np.load(tmp_path / f"sbn_epi{r}.npz"))
             for r in range(world)]
    # the norm of the whole batch, in one process
    a = sbn_arrays(world)
    nchw = lambda k: torch.from_numpy(  # noqa: E731
        a[k].transpose(0, 3, 1, 2).copy())
    bn = TpuBatchNorm(SBN_LOCAL[3], dtype=torch.float32,
                      momentum=SBN_MOMENTUM, epsilon=SBN_EPSILON)
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(a[k]))
    x = nchw("x").requires_grad_(True)
    r = nchw("w").flip(0).requires_grad_(True)
    y = bn(x, residual=r, relu=True)
    (y * nchw("w")).sum().backward()
    want = {"y": y.detach(), "dx": x.grad, "dr": r.grad}
    n = SBN_LOCAL[0]
    for rank, got in enumerate(ranks):
        for k, v in want.items():
            np.testing.assert_allclose(
                got[k], v[rank * n:(rank + 1) * n].numpy(), rtol=1e-5,
                atol=1e-5, err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["mean"], bn.mean.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["var"], bn.var.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for k in ("dscale", "dbias"):
        want_k = getattr(bn, k[1:]).grad.numpy()
        np.testing.assert_allclose(sum(g[k] for g in ranks), want_k,
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# -- the launch plan and the kernels' names -------------------------------------

# (rows, channels): every distinct ResNet-50 norm at batch 256 and some of
# Inception V3's at batch 128 (299x299), odd counts beside
PLAN_SHAPES = [
    (3211264, 64), (802816, 64), (802816, 256), (802816, 128),
    (200704, 128), (200704, 512), (200704, 256), (50176, 256),
    (50176, 1024), (50176, 512), (12544, 512), (12544, 2048),
    (2841728, 32), (2759168, 64), (692224, 80), (156800, 192),
    (36992, 768), (8192, 1280), (8192, 2048), (1000, 13), (7, 3),
]


@pytest.mark.parametrize("rows,channels,vec", [
    (r, c, v) for r, c in PLAN_SHAPES for v in (8, 4, 1) if c % v == 0])
def test_plan_covers_the_view(rows, channels, vec):
    ctas = 132 * 3              # a wave of a kernel at 3 CTAs an SM
    p = norm_ops.plan(rows, channels, vec, ctas)
    tile_channels = p.tpr * vec
    assert 1 <= p.tpr <= norm_ops.TILE_VECTORS
    assert p.tpr * p.rpi <= norm_ops.THREADS
    assert tile_channels <= norm_ops.THREADS
    assert p.tiles * tile_channels >= channels
    assert (p.tiles - 1) * tile_channels < channels
    assert p.chunk_rows % p.rpi == 0
    assert p.chunks * p.chunk_rows >= rows > (p.chunks - 1) * p.chunk_rows
    groups = norm_ops.partial_rows(p) - p.chunks
    assert groups == -(-p.chunks // norm_ops.GROUP)
    assert p.tiles * (groups + 1) <= norm_ops.COUNTERS
    # one wave at most, and most of it where the rows allow
    assert p.tiles * p.chunks <= ctas
    if rows >= 64 * ctas * p.rpi:
        assert p.tiles * p.chunks > 0.95 * (ctas - p.tiles)


def _covered(p, vec: int) -> np.ndarray:
    """How often each element of the view is visited by the kernels'
    threads, read as ``lane_of`` in csrc/norm.cu maps them."""
    seen = np.zeros((p.rows, p.channels), dtype=np.int64)
    for t in range(norm_ops.THREADS):
        j, i = t % p.tpr, t // p.tpr
        if i >= p.rpi:
            continue
        for tile in range(p.tiles):
            col = (tile * p.tpr + j) * vec
            if col >= p.channels:
                continue
            for chunk in range(p.chunks):
                end = min((chunk + 1) * p.chunk_rows, p.rows)
                rows = np.arange(chunk * p.chunk_rows + i, end, p.rpi)
                seen[rows, col:col + vec] += 1
    return seen


@pytest.mark.parametrize("rows,channels,vec", [
    (1000, 80, 8), (777, 64, 8), (50, 2048, 8), (300, 192, 4),
    (97, 13, 1), (3, 3, 1), (4000, 320, 8)])
def test_thread_mapping_visits_every_element_once(rows, channels, vec):
    p = norm_ops.plan(rows, channels, vec, 4)
    assert (_covered(p, vec) == 1).all()


def test_vector_width():
    assert norm_ops.vector_width(64, torch.bfloat16) == 8
    assert norm_ops.vector_width(64, torch.float16) == 8
    assert norm_ops.vector_width(64, torch.float32) == 4
    assert norm_ops.vector_width(12, torch.bfloat16) == 1
    assert norm_ops.vector_width(12, torch.float32) == 4
    assert norm_ops.vector_width(6, torch.float32) == 1


def test_unaligned_views_are_copied_aligned():
    """A channels-last view at an address that is not a multiple of 16
    bytes reaches the kernels as an aligned copy; an aligned one as it
    is; any other layout as a channels-last copy."""
    flat = torch.arange(2 * 3 * 3 * 8 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(2, 3, 3, 8).permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=torch.channels_last)
    assert view.data_ptr() % 16 != 0
    copy = norm_ops._channels_last(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    assert copy.is_contiguous(memory_format=torch.channels_last)
    aligned = copy.detach()
    assert norm_ops._channels_last(aligned) is aligned
    nchw = view.contiguous()
    made = norm_ops._channels_last(nchw)
    assert made.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(made, nchw)


def test_cuda_checks_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8, 3, 3, dtype=torch.bfloat16)
    vecs = [torch.zeros(8) for _ in range(4)]
    norm_ops._check_cuda(x, None, torch.bfloat16, vecs)
    with pytest.raises(TypeError):
        norm_ops._check_cuda(x, None, torch.float32, vecs)
    with pytest.raises(ValueError):
        norm_ops._check_cuda(x[:, :, 0], None, torch.bfloat16, vecs)
    with pytest.raises(ValueError):
        norm_ops._check_cuda(x, x.float(), torch.bfloat16, vecs)
    with pytest.raises(ValueError):
        norm_ops._check_cuda(x, None, torch.bfloat16,
                             vecs[:3] + [torch.zeros(7)])


def test_constants_match_the_kernels():
    text = (_build.CSRC / "norm.cu").read_text()
    for name, value in (("kThreads", norm_ops.THREADS),
                        ("kGroup", norm_ops.GROUP)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    rows = re.search(r"enum StatRow \{([^}]*)\}", text).group(1)
    assert rows.count(",") == len(norm_ops.STAT_ROWS)
    rows = re.search(r"enum GradRow \{([^}]*)\}", text).group(1)
    assert rows.count(",") == len(norm_ops.GRAD_ROWS)


def test_the_ctypes_signatures_match_the_c_functions():
    """Each ``extern "C"`` function of norm.cu takes as many arguments as
    ``_library`` declares."""
    text = (_build.CSRC / "norm.cu").read_text()
    declared = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        args = [a for a in m.group(2).split(",") if a.strip()]
        declared[m.group(1)] = len(args)
    src = (_build.CSRC.parent / "ops" / "norm.py").read_text()
    for m in re.finditer(r'\("(hvtpu_norm_\w+)", \[([^\]]*)\]', src):
        assert declared[m.group(1)] == len(m.group(2).split(",")), \
            m.group(1)
    assert {"hvtpu_norm_stats", "hvtpu_norm_apply", "hvtpu_norm_finalize",
            "hvtpu_norm_grad_reduce", "hvtpu_norm_grad_input"} <= set(
                declared)


def test_kernel_names_fall_in_other():
    from portbench.kernels import group_of

    text = (_build.CSRC / "norm.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)",
                       text)
    structs = re.findall(r"struct (\w+Args)", text)
    assert set(names) == {"norm_stats_kernel", "norm_finalize_kernel",
                          "norm_apply_kernel", "norm_grad_reduce_kernel",
                          "norm_grad_input_kernel"}
    assert structs
    for name in names:
        assert name.startswith("norm_")
        for s in structs:
            for targs in ("__nv_bfloat16, 8, true, true", "__half, 8, 2",
                          "float, 4, false, false", "float"):
                full = (f"void (anonymous namespace)::{name}<{targs}>"
                        f"((anonymous namespace)::{s})")
                assert group_of(full) == "other", full


class _ForwardOnly(torch.nn.Module):
    """A norm that takes ``x`` alone, as ``hvd.SyncBatchNorm`` does."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50", "InceptionV3"])
def test_a_swapped_in_norm_keeps_the_models_function(name):
    """A model whose norms are replaced by modules that take ``x`` alone
    (how ``hvd.SyncBatchNorm`` is swapped in) computes what the model
    computes, the epilogue in torch (``norm_relu``)."""
    from horovod_tpu_torch import models

    side = 75 if name == "InceptionV3" else 32
    kw = dict(num_classes=10) if name == "InceptionV3" else dict(
        num_classes=10, num_filters=8)
    ref = getattr(models, name)(dtype=torch.float32,
                                generator=torch.Generator().manual_seed(0),
                                **kw)
    swapped = getattr(models, name)(dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(0),
                                    **kw)
    n = 0
    for parent in list(swapped.modules()):
        for cname, child in list(parent.named_children()):
            if isinstance(child, TpuBatchNorm):
                setattr(parent, cname, _ForwardOnly(child))
                n += 1
    assert n == sum(isinstance(m, TpuBatchNorm) for m in ref.modules())
    x = torch.randn(2, side, side, 3, generator=torch.Generator().manual_seed(1))
    ref.train()
    swapped.train()
    assert torch.equal(ref(x), swapped(x))

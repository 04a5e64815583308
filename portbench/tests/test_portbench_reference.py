"""The frozen reference against the program at a tiny size on the CPU,
in float32: the same function, the same gradients; and the control, the
reference in fp8, fails the cell's check."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from portbench import check, data, reference
from portbench.cell import reference_readings
from portbench.tests.tiny import tiny_spec

ROOT = Path(__file__).resolve().parents[2]


def _pair(arch):
    name = {"resnet": "resnet50-v1.5", "vgg": "vgg16"}[arch]
    c = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    if arch == "resnet":
        c.update(num_filters=8, num_classes=10, image_size=64)
        kw = {"num_filters": 8, "num_classes": 10}
    else:
        c.update(num_classes=10, image_size=32)
        kw = {"image_size": 32, "num_classes": 10}
    c["compute_dtype"] = "float32"
    from horovod_tpu_torch import models

    ref = reference.build(c, "cpu")
    w = data.make_weights([(n, p.shape) for n, p in ref.named_parameters()],
                          2 ** 31 + 77, "cpu", c["init"])
    prog = getattr(models, c["port_model"])(
        dtype=torch.float32, device="meta", **kw).to_empty(device="cpu")
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(w[n])
        for n, p in prog.named_parameters():
            p.copy_(w[n])
        for n, b in prog.named_buffers():
            b.fill_(0.0 if n.endswith(".mean") else 1.0)
    return c, ref, prog


def _grads(model, x, y):
    model.zero_grad()
    F.cross_entropy(model(x), y).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["resnet", "vgg"])
def test_reference_is_the_programs_function(arch):
    """Logits within float32's rounding.  Gradients: VGG's in float64
    to rounding; ResNet's (whose norms keep their statistics in float32
    on both sides) in float32, each leaf's to 1e-4 of its norm; the
    leaves behind a norm whose scale starts at 0 have none on either
    side."""
    c, ref, prog = _pair(arch)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, c["image_size"], c["image_size"], 3, generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    a, b = prog(x), ref(x)
    assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    if arch == "vgg":
        for m in (ref, prog):
            m.double()
            for sub in m.modules():
                for attr in ("dtype", "compute_dtype"):
                    if hasattr(sub, attr):
                        setattr(sub, attr, torch.float64)
        x = x.double()
    got, want = _grads(prog, x, y), _grads(ref, x, y)
    for n, w in want.items():
        if w.norm() == 0:
            assert got[n].norm() == 0, n
    worst = max(float((got[n] - w).norm() / w.norm())
                for n, w in want.items() if w.norm() > 0)
    assert worst <= (1e-9 if arch == "vgg" else 1e-4)


@pytest.mark.parametrize("cell", ["resnet50.b256.fp16", "vgg16.b64.fp16"])
def test_control_fails_the_cells_check(cell):
    """The reference computed in fp8 in the program's place, at a tiny
    size, against the reference: not correct under the cell's limits."""
    spec = tiny_spec(cell)
    spec["config"]["compute_dtype"] = "bfloat16"
    args = (spec["config"], spec["traffic"], 5, 1, torch.device("cpu"))
    ctl = reference_readings(*args, precision="fp8", keep_buffers=True)
    ref = reference_readings(*args, against=ctl.pop("buffers"))
    ok, rows = check.judge(check.readings(ctl, ref), spec["limits"])
    assert not ok, rows


def test_narrow_controls_change_only_their_part():
    """fp8 in the residual branches alone leaves the first forward pass
    as it was (each branch ends in a norm of scale 0) and moves the first
    gradient of those norms' scales; norm statistics in bfloat16 move the
    first forward pass."""
    spec = tiny_spec("resnet50.b256.fp16")
    spec["config"]["compute_dtype"] = "bfloat16"
    args = (spec["config"], spec["traffic"], 5, 1, torch.device("cpu"))
    got = {}
    for precision in ("fp8_branches", "bf16_stats"):
        ctl = reference_readings(*args, precision=precision,
                                 keep_buffers=True)
        ref = reference_readings(*args, against=ctl.pop("buffers"))
        got[precision] = check.readings(ctl, ref)
    assert got["fp8_branches"]["logits_gap"] == 0
    assert got["fp8_branches"]["grad_diff_gap"] > 0.01
    assert got["bf16_stats"]["logits_gap"] > 0

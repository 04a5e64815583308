"""The pieces a causal language model adds to the harness, on the CPU:
the weights' rules by suffix and the buffers' rules, the token batches
and the bounded reading of the logits, the reference's AdamW against
``torch.optim.AdamW``, and the frozen decoder reference against the
tests' tiny program."""

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from portbench import check, data, reference, tasks
from portbench.cell import reference_readings
from portbench.reference.train import _adamw
from portbench.tests.tiny import tiny_spec
from portbench.tests.tiny_lm import TinyDecoder

TINY = json.loads(Path(__file__).with_name("tiny_lm.json").read_text())


def test_suffix_rules_take_one_experts_fan():
    """A stacked ``[E, in, out]`` expert weight under a rule by suffix
    takes the fan of one expert's input; the dense rule the rest; the
    draw itself is the one flat normal, whatever the rules."""
    specs = [("gate.weight", torch.Size([64, 2048])),
             ("experts.w_in", torch.Size([8, 2048, 1408])),
             ("experts.w_out", torch.Size([8, 1408, 2048]))]
    init = {"dense": 0.01, "suffix": {
        ".w_in": {"gain": 2.0, "fan_dims": [-2]},
        "experts.w_out": {"gain": 1.0, "fan_dims": [-2]}}}
    w = data.make_weights(specs, 7, "cpu", init)
    plain = data.make_weights(specs, 7, "cpu", {"dense": 1.0, "suffix": {
        ".w_in": 1.0, ".w_out": 1.0}})
    for name, std in [("gate.weight", 0.01),
                      ("experts.w_in", math.sqrt(2.0 / 2048)),
                      ("experts.w_out", math.sqrt(1.0 / 1408))]:
        assert torch.equal(w[name], plain[name] * std), name
    with pytest.raises(ValueError, match="rule by suffix"):
        data.make_weights(specs, 7, "cpu", {"dense": "he_fan_in"})


class _Owner(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("table", torch.empty(3))
        self.calls = 0

    def reset_buffers(self):
        self.calls += 1
        self.table.copy_(torch.arange(3.0))


class _Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.Module()
        self.norm.register_buffer("mean", torch.empty(2))
        self.register_buffer("count", torch.empty(2))
        self.rope = _Owner()


def test_buffers_by_rule():
    m = _Model()
    data.fill_buffers(m, {"buffers": {"count": "ones",
                                      "rope.table": "computed"}})
    assert torch.equal(m.norm.mean, torch.zeros(2))
    assert torch.equal(m.count, torch.ones(2))
    assert m.rope.calls == 1
    assert torch.equal(m.rope.table, torch.arange(3.0))
    with pytest.raises(RuntimeError, match="count"):
        data.fill_buffers(_Model(), {"buffers": {"rope.table": "computed"}})


def test_token_batches_and_bounded_reading():
    c, t = TINY["config"], dict(TINY["traffic"], distinct_batches=2)
    task = tasks.of(c)
    a = task.make_batches(t, c, 2 ** 40 + 3, 1, "cpu")
    b = task.make_batches(t, c, 2 ** 40 + 3, 1, "cpu")
    other = task.make_batches(t, c, 2 ** 40 + 3, 0, "cpu")
    assert len(a) == 2
    for (x, y), (x2, y2), (x3, _) in zip(a, b, other):
        assert x.dtype == torch.int64 and x.shape == (8, 32)
        assert torch.equal(x, x2) and torch.equal(y, y2)
        assert not torch.equal(x, x3)
        assert torch.equal(x[:, 1:], y[:, :-1])
        assert 0 <= int(x.min()) and int(x.max()) < c["vocab_size"]
    z = torch.randn(8, 32, c["vocab_size"])
    r = task.reading(z)
    assert r.shape == (16 * c["vocab_size"],)
    assert torch.equal(r, z[0, -16:].flatten())


def test_images_task_is_the_cnn_path():
    """A configuration without ``task``: the images, its loss and
    reading, its work counted by the convolutions' counter alone."""
    from portbench.counters import conv_flops

    c = json.loads((Path(__file__).parents[1] / "configs" / "vgg16.json")
                   .read_text())
    task = tasks.of(c)
    assert task is tasks.of(dict(c, task="image_classification"))
    work = task.step_work(c, {"batch_per_rank": 64})
    assert work == dict(conv_flops.step_work(c, 64), attention_min_s=0.0)
    with pytest.raises(ValueError):
        tasks.of(dict(c, task="masked_lm"))


def test_reference_adamw_is_torchs():
    """The reference's AdamW, written out, against ``torch.optim.AdamW``
    over 3 steps of the same gradients: the same update to float32's
    rounding."""
    cfg = {"lr": 1e-3, "betas": [0.9, 0.95], "eps": 1e-8,
           "weight_decay": 0.1}
    g = torch.Generator().manual_seed(5)
    p0 = torch.randn(1000, generator=g)
    grads = [torch.randn(1000, generator=g) * 10 ** -k for k in range(3)]
    p = nn.Parameter(p0.clone())
    opt = torch.optim.AdamW([p], lr=cfg["lr"], betas=tuple(cfg["betas"]),
                            eps=cfg["eps"], weight_decay=cfg["weight_decay"])
    mine, m, v = p0.clone(), torch.zeros(1000), torch.zeros(1000)
    for s, grad in enumerate(grads):
        p.grad = grad.clone()
        opt.step()
        _adamw(mine, grad, m, v, s + 1, cfg)
    assert torch.allclose(mine, p.detach(), rtol=0, atol=1e-6)
    want = opt.state[p]["exp_avg"]
    assert (m - want).norm() <= 1e-6 * want.norm()
    assert (mine - p0).abs().max() > 1e-3


def test_decoder_reference_is_the_tiny_programs_function():
    """The frozen decoder against the tests' program on the same weights
    and ids, in float32: logits and every gradient to 1e-5 of their
    norm."""
    c = TINY["config"]
    ref = reference.build(c, "cpu")
    specs = [(n, p.shape) for n, p in ref.named_parameters()]
    w = data.make_weights(specs, 2 ** 31 + 77, "cpu", c["init"])
    prog = TinyDecoder(device="meta", **c["port_kwargs"]).to_empty(
        device="cpu")
    assert [n for n, _ in prog.named_parameters()] == [n for n, _ in specs]
    with torch.no_grad():
        for model in (ref, prog):
            for n, p in model.named_parameters():
                p.copy_(w[n])
    data.fill_buffers(prog, c["init"])
    task = tasks.of(c)
    x, y = task.make_batches(TINY["traffic"], c, 9, 0, "cpu")[0]
    grads = {}
    for name, model in (("ref", ref), ("prog", prog)):
        model.zero_grad()
        z = model(x)
        task.loss(z, y).backward()
        grads[name] = (z.detach(), {n: p.grad for n, p in
                                    model.named_parameters()})
    (za, ga), (zb, gb) = grads["prog"], grads["ref"]
    assert za.dtype == torch.float32 and za.shape == (8, 32, 256)
    assert (za - zb).norm() <= 1e-5 * zb.norm()
    for n, want in gb.items():
        assert (ga[n] - want).norm() <= 1e-5 * want.norm(), n


def test_reference_blocks_of_rows_sum_to_the_batch():
    """The reference's step, one row at a time: the same loss, reading
    and gradients as the whole batch's mean, to float32's rounding."""
    c = TINY["config"]
    ref = reference.build(c, "cpu")
    specs = [(n, p.shape) for n, p in ref.named_parameters()]
    w = data.make_weights(specs, 11, "cpu", c["init"])
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(w[n])
    task = tasks.of(c)
    x, y = task.make_batches(TINY["traffic"], c, 9, 0, "cpu")[0]
    assert x.shape[0] > 1
    params = list(ref.parameters())
    z = ref(x, "bf16")
    whole = task.loss(z, y)
    whole_grads = torch.autograd.grad(whole, params)
    rows = task.reference_step(ref, x, y, params, "bf16")
    assert float(rows[0]) == pytest.approx(float(whole.detach()), rel=1e-6)
    assert torch.equal(rows[2], task.reading(z))
    for a, b in zip(rows[1], whole_grads):
        assert (a - b).norm() <= 1e-5 * b.norm()


def test_control_fails_the_tiny_lm_check():
    """The decoder reference in fp8 in the program's place against the
    reference: not correct under the tiny model's limits."""
    spec = tiny_spec("tiny_lm")
    args = (spec["config"], spec["traffic"], 5, 1, torch.device("cpu"))
    ctl = reference_readings(*args, precision="fp8", keep_buffers=True)
    ref = reference_readings(*args, against=ctl.pop("buffers"))
    ok, rows = check.judge(check.readings(ctl, ref), spec["limits"])
    assert not ok, rows


def test_calibration_reads_a_causal_lm(capsys):
    """``calibrate``'s controls on the tiny causal LM: the fp8 control
    and half of the sequences, each seed's line and the summary."""
    from portbench import calibrate

    spec = dict(tiny_spec("tiny_lm"), seeds=[3])
    spec["device"] = "cpu"
    assert calibrate.calibrate(spec, ["control", "half_batch"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    summary = lines[-1]["summary"]
    assert set(summary) == {"control", "half_batch"}
    assert summary["half_batch"]["loss1_gap"] > 0
    assert summary["control"]["logits_gap"] > 0

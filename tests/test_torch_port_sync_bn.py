"""``SyncBatchNorm`` (``horovod_tpu_torch/torch/sync_batch_norm.py``), on
the CPU.

* At one process, bitwise against the JAX package's torch surface
  (``horovod_tpu.torch.SyncBatchNorm`` and ``_SyncBatchNormFn``): the
  module (plain ``_BatchNorm`` at one rank) and the function itself
  (forward, the input's, weight's and bias's gradients, the running
  statistics), with ``affine=False`` and ``momentum=None`` too.
* In one 2-process gloo world (``tests/torch_port_util.py``
  ``sbn_worker``), over 2 training steps, against one
  ``torch.nn.BatchNorm2d`` over the concatenated global batch: each
  rank's output and input gradient, the weight and bias gradients summed
  over the ranks, the running statistics, and eval mode.  The tolerance
  is rtol 1e-5 / atol 1e-5 (1e-4 on gradients summed over the global
  batch): the port takes the statistics from a sum and a sum of squares
  in float32, ``BatchNorm2d`` from its own two-pass reduction, so the
  two round differently.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.torch import sync_batch_norm as port_sbn
from torch_port_util import (
    SBN_SHAPE,
    SBN_STEPS,
    SBN_VARIANTS,
    sbn_inputs,
    sbn_worker,
    spawn_world,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

WORLD = 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sbn")
    codes, _ = spawn_world(sbn_worker, WORLD, tmp, timeout=120)
    assert codes == [0] * WORLD, codes
    return [dict(np.load(tmp / f"sbn{r}.npz")) for r in range(WORLD)]


def _global_batch_norm(name):
    """``torch.nn.BatchNorm2d`` over both ranks' batches, step by step:
    each step's output and input gradient cut into the ranks' slices."""
    torch.manual_seed(0)
    bn = torch.nn.BatchNorm2d(SBN_SHAPE[1], **SBN_VARIANTS[name])
    if bn.weight is not None:
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
    out = {}
    for step in range(SBN_STEPS):
        per = [sbn_inputs(r, step) for r in range(WORLD)]
        x = torch.from_numpy(np.concatenate([p["x"] for p in per]))
        x.requires_grad_(True)
        w = torch.from_numpy(np.concatenate([p["w"] for p in per]))
        bn.zero_grad()
        y = bn(x)
        (y * w).sum().backward()
        out[f"out_{step}"] = y.detach().chunk(WORLD)
        out[f"dx_{step}"] = x.grad.chunk(WORLD)
    out["bn"] = bn
    return out


@pytest.mark.parametrize("name", sorted(SBN_VARIANTS))
def test_two_ranks_match_one_batch_norm_over_the_global_batch(ranks, name):
    want = _global_batch_norm(name)
    bn = want["bn"]
    for r, res in enumerate(ranks):
        for step in range(SBN_STEPS):
            for key in ("out", "dx"):
                np.testing.assert_allclose(
                    res[f"{name}_{key}_{step}"],
                    want[f"{key}_{step}"][r].numpy(), **TOL,
                    err_msg=f"{name} {key} step {step} rank {r}")
        if bn.weight is not None:
            np.testing.assert_allclose(res[f"{name}_dw"],
                                       bn.weight.grad.numpy(), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(res[f"{name}_db"],
                                       bn.bias.grad.numpy(), rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(res[f"{name}_mean"],
                                   bn.running_mean.numpy(), **TOL)
        np.testing.assert_allclose(res[f"{name}_var"],
                                   bn.running_var.numpy(), **TOL)
        bn.eval()
        x = torch.from_numpy(sbn_inputs(r, 0)["x"])
        np.testing.assert_allclose(res[f"{name}_eval"],
                                   bn(x).detach().numpy(), **TOL)
        bn.train()


@pytest.fixture
def both(tmp_path, monkeypatch):
    import horovod_tpu.torch as ref_hvd

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    ref_hvd.init()
    hvd.init(device="cpu")
    yield ref_hvd
    hvd.shutdown()
    ref_hvd.shutdown()


def _run_fn(fn_cls, affine, momentum, x, w):
    torch.manual_seed(1)
    c = SBN_SHAPE[1]
    weight = torch.rand(c, requires_grad=True) if affine else None
    bias = torch.rand(c, requires_grad=True) if affine else None
    mean, var = torch.zeros(c), torch.ones(c)
    xx = x.clone().requires_grad_(True)
    out = fn_cls.apply(xx, weight, bias, mean, var, 1e-5, momentum, None)
    (out * w).sum().backward()
    grads = [xx.grad] + ([weight.grad, bias.grad] if affine else [])
    return [out.detach(), mean, var] + grads


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("momentum", [0.1, 0.5])
def test_world_of_one_function_bitwise_the_reference(both, affine, momentum):
    from horovod_tpu.torch import sync_batch_norm as ref_sbn

    inp = sbn_inputs(0, 0)
    x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
    got = _run_fn(port_sbn._SyncBatchNormFn, affine, momentum, x, w)
    want = _run_fn(ref_sbn._SyncBatchNormFn, affine, momentum, x, w)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", list(SBN_VARIANTS.values()),
                         ids=list(SBN_VARIANTS))
def test_world_of_one_module_bitwise_the_reference(both, kw):
    ref_hvd = both
    mods = []
    for cls in (hvd.SyncBatchNorm, ref_hvd.SyncBatchNorm):
        torch.manual_seed(2)
        mods.append(cls(SBN_SHAPE[1], **kw))
    for step in range(SBN_STEPS):
        inp = sbn_inputs(0, step)
        outs = []
        for m in mods:
            x = torch.from_numpy(inp["x"]).requires_grad_(True)
            m.zero_grad()
            y = m(x)
            (y * torch.from_numpy(inp["w"])).sum().backward()
            outs.append((y.detach(), x.grad,
                         None if m.weight is None else m.weight.grad))
        for a, b in zip(*outs):
            assert (a is None and b is None) or torch.equal(a, b)
    for a, b in zip(mods[0].state_dict().values(),
                    mods[1].state_dict().values()):
        assert torch.equal(a, b)


def test_the_count_is_made_on_the_input_device(both, monkeypatch):
    """The reference builds the count as a CPU tensor, which a card
    tensor cannot be concatenated with; the port makes it on the input's
    device (seen here through the device ``torch.tensor`` is asked
    for)."""
    devices = []
    real = torch.tensor

    def spy(*a, **kw):
        devices.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(port_sbn.torch, "tensor", spy)
    x = torch.from_numpy(sbn_inputs(0, 0)["x"])
    port_sbn._SyncBatchNormFn.apply(x, None, None, None, None, 1e-5, 0.1,
                                    None)
    assert devices == [x.device]


def test_surface_and_input_check():
    assert "SyncBatchNorm" in hvd.torch.__all__
    assert hvd.SyncBatchNorm is hvd.torch.SyncBatchNorm
    with pytest.raises(ValueError, match="at least 2D"):
        hvd.SyncBatchNorm(3)(torch.zeros(3))

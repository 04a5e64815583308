"""Parity of the PyTorch port's ResNet with the flax ResNet.

A narrow ResNet (stage_sizes=[1,1,1,1], bottleneck, num_filters=8, 10
classes, float32) with the same weights on both sides — made by flax,
perturbed with numpy so no BatchNorm scale is zero, and carried across
by ``horovod_tpu_torch.weights`` — must give the same logits, the same
loss gradients for every parameter and the same BatchNorm running stats
after one train-mode call.  32x32 and 36x36 inputs cover flax's
asymmetric and symmetric ``SAME`` padding.

Tolerance rtol 1e-4, atol 1e-5: float32 convolutions and reductions are
summed in another order by XLA and by PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models.resnet import BottleneckBlock as FlaxBottleneck
from horovod_tpu.models.resnet import ResNet as FlaxResNet
from horovod_tpu_torch.models import ResNet
from horovod_tpu_torch.models.resnet import _same_pads
from horovod_tpu_torch.weights import resnet_params_from_jax
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
NUM_CLASSES = 10


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_narrow(size: int, batch: int = 8, seed: int = 0,
                perturb: bool = True):
    """(flax module, flax variables as numpy, torch model, x, labels)."""
    rng = np.random.RandomState(seed)
    flax_model = FlaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=FlaxBottleneck,
                            num_classes=NUM_CLASSES, num_filters=8,
                            dtype=jnp.float32)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, size=(batch,))
    variables = _np_tree(flax_model.init(jax.random.PRNGKey(seed),
                                         jnp.asarray(x), train=False))

    def perturbed(path, a):
        leaf = path[-1].key
        if leaf == "scale":
            return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if leaf in ("bias", "mean"):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if leaf == "var":
            return (1.0 + 0.2 * rng.rand(*a.shape)).astype(np.float32)
        return a

    if perturb:
        variables = jax.tree_util.tree_map_with_path(perturbed, variables)
    model = ResNet([1, 1, 1, 1], num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(resnet_params_from_jax(variables["params"],
                                                 variables["batch_stats"]))
    return flax_model, variables, model, x, labels


def flax_loss_and_grads(flax_model, variables, x, labels):
    def loss_fn(params):
        logits, new = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, (logits, new["batch_stats"])

    (loss, (logits, stats)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(logits), _np_tree(grads), _np_tree(stats)


def torch_loss_and_grads(model, x, labels):
    model.train()
    model.zero_grad()
    logits = model(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), logits.detach().numpy()


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)),   # ResNet-50 stem
    (56, 3, 2, (0, 1)),    # strided 3x3 on an even size
    (9, 3, 2, (1, 1)),     # strided 3x3 on an odd size
    (56, 1, 2, (0, 0)),    # strided projection
    (56, 3, 1, (1, 1)),
])
def test_same_padding_matches_lax(size, k, s, want):
    assert _same_pads(size, k, s) == want
    lax_pads = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert tuple(lax_pads) == want


@pytest.mark.parametrize("size", [32, 36])
def test_train_forward_grads_and_stats(size):
    flax_model, variables, model, x, labels = make_narrow(size)
    f_loss, f_logits, f_grads, f_stats = flax_loss_and_grads(
        flax_model, variables, x, labels)
    t_loss, t_logits = torch_loss_and_grads(model, x, labels)

    _close(t_logits, f_logits, "logits")
    _close(t_loss, f_loss, "loss")
    want_grads = resnet_params_from_jax(f_grads, {})
    got_grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for name, g in got_grads.items():
        _close(g.numpy(), want_grads[name].numpy(), f"grad {name}")
    want_stats = resnet_params_from_jax({}, f_stats)
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want_stats)
    for name, b in buffers.items():
        _close(b.numpy(), want_stats[name].numpy(), f"stat {name}")


@pytest.mark.parametrize("size", [32, 36])
def test_eval_forward(size):
    flax_model, variables, model, x, _ = make_narrow(size, seed=1)
    want = flax_model.apply(variables, jnp.asarray(x), train=False)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want), "eval logits")


def test_weights_layout_and_names():
    _, variables, model, _, _ = make_narrow(32)
    state = resnet_params_from_jax(variables["params"],
                                   variables["batch_stats"])
    kernel = variables["params"]["BottleneckBlock_1"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(
        state["BottleneckBlock_1.Conv_1.weight"].numpy(),
        kernel.transpose(3, 2, 0, 1))
    dense = variables["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state["Dense_0.weight"].numpy(), dense.T)
    assert set(state) == set(model.state_dict())


def test_resnet50_parameter_inventory():
    from horovod_tpu_torch.models import ResNet50

    model = ResNet50(dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))
    params = list(model.named_parameters())
    assert len(params) == 161
    assert sum(p.dim() == 4 for _, p in params) == 53
    assert sum(p.numel() for _, p in params) == 25_557_032
    # the last BatchNorm scale of every block starts at zero
    for name in model.block_names:
        assert torch.count_nonzero(
            getattr(model, name).TpuBatchNorm_2.scale) == 0

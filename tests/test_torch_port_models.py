"""The port's CNNs and MLP (``horovod_tpu_torch/models/{resnet,vgg,mlp,
tpu_norm}.py``) against the flax models of ``horovod_tpu.models``.

* **Full width, names and shapes.**  Every model the reference exports
  (ResNet-18/34/50/101/152, the ``s2d`` stem and ``remat``, VGG-16/19,
  Inception V3, the MLP), made on the ``meta`` device: its ``state_dict``
  has the names and shapes of the flax ``params`` and ``batch_stats``
  (``jax.eval_shape`` of ``init``, no compute), conv kernels HWIO ->
  OIHW, Dense kernels transposed.
* **Numbers at a small size**, float32, the same weights on both sides
  (flax's init, the BatchNorm scales, biases and running stats perturbed
  with numpy so none is trivial, carried by ``weights.params_from_jax``),
  one train-mode step with softmax cross-entropy: the logits, the loss
  gradient of every parameter and the running stats after the step.
  ResNet with ``BasicBlock`` (8 filters, ``[1, 1, 1, 1]``) on the 7x7
  stem and on ``s2d``; with ``BottleneckBlock`` under ``remat`` (flax's
  ``nn.remat`` with its ``conv_out`` policy), whose port is also bitwise
  its own ``remat=False`` in logits, gradients and stats; VGG-16 at 64x64,
  so the last map is 2x2 and the flatten order shows (at 32x32 it is 1x1);
  the MLP.  Inception V3 has a file of its own
  (``test_torch_port_models_inception.py``).
* **Synchronized BatchNorm.**  ``TpuBatchNorm(axis_name="world")`` in a
  2-rank gloo world (``tests/torch_port_models_util.py``) against the flax
  ``TpuBatchNorm(axis_name=...)`` under ``jax.shard_map`` over 2 devices:
  each rank's output and input gradient, the parameter gradients summed
  over the ranks (``shard_map``'s transpose of a replicated parameter),
  the running stats.

Tolerance: each compared tensor within ``TOL`` times its largest
magnitude.  ``TOL`` is 3e-4: XLA and PyTorch sum float32 convolutions and
reductions in other orders, and through a few BatchNorm layers in train
mode that moves gradients by up to 1.1e-4 of their largest magnitude
(the ``remat`` bottleneck; logits 1.4e-5), everything else within 3.5e-5.
The synchronized norm alone holds 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu import models as ref_models
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu_torch import models as port_models
from horovod_tpu_torch.weights import params_from_jax
from torch_port_models_util import (
    SBN_EPSILON,
    SBN_LOCAL,
    SBN_MOMENTUM,
    sbn_arrays,
    sync_bn_worker,
)
from torch_port_util import spawn_world
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

TOL = 3e-4
SBN_TOL = 1e-5
CLASSES = 10


# -- full width: names and shapes ----------------------------------------------

FULL = {
    # name: (flax model, port model on meta, input side)
    "ResNet18": (lambda: ref_models.ResNet18(),
                 lambda: port_models.ResNet18(device="meta"), 224),
    "ResNet34": (lambda: ref_models.ResNet34(),
                 lambda: port_models.ResNet34(device="meta"), 224),
    "ResNet50": (lambda: ref_models.ResNet50(),
                 lambda: port_models.ResNet50(device="meta"), 224),
    "ResNet101": (lambda: ref_models.ResNet101(),
                  lambda: port_models.ResNet101(device="meta"), 224),
    "ResNet152": (lambda: ref_models.ResNet152(),
                  lambda: port_models.ResNet152(device="meta"), 224),
    "ResNet50_s2d": (lambda: ref_models.ResNet50(stem="s2d"),
                     lambda: port_models.ResNet50(stem="s2d",
                                                  device="meta"), 224),
    "ResNet50_remat": (lambda: ref_models.ResNet50(remat=True),
                       lambda: port_models.ResNet50(remat=True,
                                                    device="meta"), 224),
    "VGG16": (lambda: ref_models.VGG16(),
              lambda: port_models.VGG16(device="meta"), 224),
    "VGG19": (lambda: ref_models.VGG19(),
              lambda: port_models.VGG19(device="meta"), 224),
    "InceptionV3": (lambda: ref_models.InceptionV3(),
                    lambda: port_models.InceptionV3(device="meta"), 299),
    "MLP": (lambda: ref_models.MLP(), lambda: port_models.MLP(device="meta"),
            28),
}


def _flax_shapes(model, side: int) -> dict:
    """The port's ``state_dict`` names and shapes the flax variables
    carry to: conv kernels HWIO -> OIHW, Dense kernels transposed."""
    channels = 1 if isinstance(model, ref_models.MLP) else 3
    x = jnp.zeros((1, side, side, channels), jnp.float32)
    kw = {} if isinstance(model, (ref_models.MLP, ref_models.VGG)) else {
        "train": False}
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x,
                                                  **kw))
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        names = [k.key for k in path[1:]]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            names[-1] = "weight"
            shape = ((shape[3], shape[2], shape[0], shape[1])
                     if len(shape) == 4 else shape[::-1])
        out[".".join(names)] = shape
    return out


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_names_and_shapes(name):
    ref, port, side = FULL[name]
    want = _flax_shapes(ref(), side)
    got = {k: tuple(v.shape) for k, v in port().state_dict().items()}
    assert got == want


def test_every_model_exports_its_reference_partials():
    for name in ("ResNet18", "ResNet34", "ResNet50", "ResNet101",
                 "ResNet152"):
        ref = getattr(ref_models, name).keywords
        port = getattr(port_models, name).keywords
        assert port["stage_sizes"] == ref["stage_sizes"], name
        block = port.get("block_cls", port_models.BottleneckBlock)
        assert block.__name__ == ref["block_cls"].__name__, name
    assert port_models.VGG16.keywords == {"depth": 16}
    assert port_models.VGG19.keywords == {"depth": 19}


# -- numbers at a small size ----------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(variables, seed: int):
    """BatchNorm scales near 1, biases and means near 0, variances near 1:
    none trivial; convolution and Dense biases stay flax's zeros."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        key = path[-1].key
        norm = any("BatchNorm" in str(getattr(p, "key", "")) or
                   str(getattr(p, "key", "")).startswith(("bn_", "norm_"))
                   for p in path[:-1])
        if key == "scale":
            return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if key == "bias" and norm:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if key == "mean":
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if key == "var":
            return (1.0 + 0.2 * rng.rand(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def flax_step(model, variables, x, labels, train_kw: bool):
    """(logits, {name: gradient}, {name: running stat}) of one train-mode
    step of the flax model, names as the port's."""
    stats = variables.get("batch_stats")

    def loss_fn(params):
        kw = {"train": True} if train_kw else {}
        if stats is not None:
            logits, new = model.apply(
                {"params": params, "batch_stats": stats}, jnp.asarray(x),
                mutable=["batch_stats"], **kw)
            new = new["batch_stats"]
        else:
            logits, new = model.apply({"params": params}, jnp.asarray(x),
                                      **kw), {}
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, (logits, new)

    (_, (logits, new)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return (np.asarray(logits), params_from_jax(_np_tree(grads)),
            params_from_jax({}, _np_tree(new)))


def port_step(model, x, labels):
    model.train()
    model.zero_grad()
    logits = model(torch.from_numpy(x))
    F.cross_entropy(logits, torch.from_numpy(labels)).backward()
    return logits.detach(), model


def _close(got, want, what: str, tol: float = TOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest magnitude"


def check_step(flax_model, port_ctor, x, labels, *, seed=0, train_kw=True):
    """Carry flax's (perturbed) weights to the port, one step on each,
    compare; returns the port model after its step."""
    kw = {"train": False} if train_kw else {}
    # jitted: an eager flax init compiles each op on its own
    variables = _perturbed(_np_tree(jax.jit(
        lambda key, xx: flax_model.init(key, xx, **kw))(
            jax.random.PRNGKey(seed), jnp.asarray(x))), seed)
    logits, grads, stats = flax_step(flax_model, variables, x, labels,
                                     train_kw)
    model = port_ctor()
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables.get("batch_stats")))
    got, model = port_step(model, x, labels)
    _close(got, logits, "logits")
    params = dict(model.named_parameters())
    assert params.keys() == grads.keys()
    for name, g in grads.items():
        _close(params[name].grad, g, f"gradient {name}")
    sd = model.state_dict()
    for name, s in stats.items():
        _close(sd[name], s, f"running stat {name}")
    return model


def _images(side, batch=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, side, side, 3).astype(np.float32),
            rng.randint(0, CLASSES, size=(batch,)))


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_resnet_basic_block(stem):
    x, y = _images(32)
    flax_model = ref_models.ResNet(stage_sizes=[1, 1, 1, 1],
                                   block_cls=ref_resnet.BasicBlock,
                                   num_classes=CLASSES, num_filters=8,
                                   dtype=jnp.float32, stem=stem)
    check_step(flax_model, lambda: port_models.ResNet(
        [1, 1, 1, 1], num_classes=CLASSES, num_filters=8,
        dtype=torch.float32, block_cls=port_models.BasicBlock, stem=stem),
        x, y)


def test_resnet_bottleneck_remat():
    x, y = _images(32)
    flax_model = ref_models.ResNet(stage_sizes=[1, 1, 1, 1],
                                   block_cls=ref_resnet.BottleneckBlock,
                                   num_classes=CLASSES, num_filters=8,
                                   dtype=jnp.float32, remat=True)
    kw = dict(num_classes=CLASSES, num_filters=8, dtype=torch.float32)
    remat = check_step(flax_model, lambda: port_models.ResNet(
        [1, 1, 1, 1], remat=True, **kw), x, y)
    # the same weights and stats without remat: bitwise the same step
    state = remat.state_dict()
    fresh = port_models.ResNet([1, 1, 1, 1], remat=True, **kw)
    fresh.load_state_dict(state)
    plain = port_models.ResNet([1, 1, 1, 1], **kw)
    plain.load_state_dict({k.replace("CheckpointBottleneckBlock",
                                     "BottleneckBlock"): v
                           for k, v in state.items()})
    logits = [port_step(m, x, y)[0] for m in (fresh, plain)]
    assert torch.equal(logits[0], logits[1])
    for (n, p), (_, q) in zip(fresh.named_parameters(),
                              plain.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
    for (n, a), (_, b) in zip(fresh.state_dict().items(),
                              plain.state_dict().items()):
        assert torch.equal(a, b), n


def test_vgg16_at_64_flattens_nhwc():
    x, y = _images(64, batch=2)
    check_step(ref_models.VGG16(num_classes=CLASSES, dtype=jnp.float32),
               lambda: port_models.VGG16(num_classes=CLASSES,
                                         dtype=torch.float32,
                                         image_size=64),
               x, y, train_kw=False)


def test_mlp():
    rng = np.random.RandomState(2)
    x = rng.randn(8, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(8,))
    check_step(ref_models.MLP(), lambda: port_models.MLP(), x, y,
               train_kw=False)


# -- synchronized BatchNorm, 2 ranks -------------------------------------------

def _flax_sync_bn(world: int):
    from horovod_tpu.models.tpu_norm import TpuBatchNorm as FlaxBN
    from jax.sharding import Mesh, PartitionSpec as P

    a = sbn_arrays(world)
    mesh = Mesh(np.array(jax.devices()[:world]), ("bn",))
    bn = FlaxBN(momentum=SBN_MOMENTUM, epsilon=SBN_EPSILON,
                dtype=jnp.float32, axis_name="bn")
    stats = {"mean": a["mean"], "var": a["var"]}

    def local(params, x, w):
        y, new = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return y, new["batch_stats"], jax.lax.psum(jnp.sum(y * w), "bn")

    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P("bn"), P("bn")),
                      out_specs=(P("bn"), P(), P()))

    def loss(params, x):
        y, new, total = f(params, x, a["w"])
        return total, (y, new)

    params = {"scale": a["scale"], "bias": a["bias"]}
    (_, (y, new)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, a["x"])
    return _np_tree(dict(y=y, dx=gx, dscale=gp["scale"], dbias=gp["bias"],
                         mean=new["mean"], var=new["var"]))


def test_sync_batch_norm_two_ranks(tmp_path):
    world = 2
    codes, _ = spawn_world(sync_bn_worker, world, tmp_path, timeout=120)
    assert codes == [0] * world, codes
    ranks = [dict(np.load(tmp_path / f"sbn{r}.npz")) for r in range(world)]
    ref = _flax_sync_bn(world)
    n = SBN_LOCAL[0]
    for r, got in enumerate(ranks):
        for k in ("y", "dx"):
            _close(got[k], ref[k][r * n:(r + 1) * n], f"rank {r} {k}",
                   SBN_TOL)
        for k in ("mean", "var"):
            _close(got[k], ref[k], f"rank {r} running {k}", SBN_TOL)
    for k in ("dscale", "dbias"):
        _close(sum(g[k] for g in ranks), ref[k], f"summed {k}", SBN_TOL)

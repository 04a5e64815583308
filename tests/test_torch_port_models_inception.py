"""Inception V3 of the port (``horovod_tpu_torch/models/inception.py``)
against the flax ``horovod_tpu.models.InceptionV3``, float32, the same
weights on both sides (flax's init, the BatchNorm scales, biases and
running stats perturbed with numpy, carried by ``weights.params_from_jax``).

* **75x75, batch 2** (the smallest input its ``VALID`` stages take), the
  norms on their running stats: the logits, the loss gradient of every
  parameter and of the input.
* **299x299, batch 2** (the benchmark's size), one train-mode step: the
  logits and every running stat after it.

Train-mode gradients are not compared, at any size: they are not a
well-posed function of the inputs in float32.  At 75x75 the last blocks'
maps are 1x1, so each norm sees 2 values a channel and its output is +-1;
even at 299x299 a relative change of 1e-6 in the input moves the port's
own train-mode gradients by up to 17% of their largest magnitude (and
the reference's differ from the port's by as much), the statistics'
``E[x^2] - E[x]^2`` cancelling in float32 through 94 norms.  The
train-mode forward is well posed at 299 and is held; so are the gradients
through the running stats, which exercise every conv, pool, concat and
norm of the backward pass.

Tolerance: each tensor within 1e-4 of its largest magnitude (measured:
gradients 2.7e-6, train-mode logits 5.3e-5, running stats 7.4e-6 at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

from horovod_tpu import models as ref_models
from horovod_tpu_torch import models as port_models
from horovod_tpu_torch.weights import params_from_jax
from test_torch_port_models import _close, _np_tree, _perturbed
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

TOL = 1e-4
CLASSES = 10


def _setup(side: int, seed: int = 0):
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(2, side, side, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(2,))
    flax_model = ref_models.InceptionV3(num_classes=CLASSES,
                                        dtype=jnp.float32)
    # jitted: an eager flax init compiles each op on its own
    variables = _perturbed(_np_tree(jax.jit(
        lambda key, xx: flax_model.init(key, xx, train=False))(
            jax.random.PRNGKey(seed), jnp.asarray(x))), seed)
    model = port_models.InceptionV3(num_classes=CLASSES, dtype=torch.float32)
    model.load_state_dict(params_from_jax(variables["params"],
                                          variables["batch_stats"]))
    return flax_model, variables, model, x, y


def test_inception_75_gradients_through_the_running_stats():
    flax_model, variables, model, x, y = _setup(75)

    def loss_fn(params, xx):
        logits = flax_model.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  xx, train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (_, logits), (grads, gx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables["params"],
                                                jnp.asarray(x))
    model.eval()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt)
    F.cross_entropy(out, torch.from_numpy(y)).backward()
    _close(out.detach(), logits, "logits", TOL)
    _close(xt.grad, gx, "input gradient", TOL)
    want = params_from_jax(_np_tree(grads))
    params = dict(model.named_parameters())
    assert params.keys() == want.keys()
    for name, g in want.items():
        _close(params[name].grad, g, f"gradient {name}", TOL)


def test_inception_299_train_step_logits_and_running_stats():
    flax_model, variables, model, x, _ = _setup(299)
    logits, new = jax.jit(lambda v, xx: flax_model.apply(
        v, xx, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    _close(out, logits, "logits", TOL)
    want = params_from_jax({}, _np_tree(new["batch_stats"]))
    sd = model.state_dict()
    assert len(want) == 2 * 94
    for name, s in want.items():
        _close(sd[name], s, f"running stat {name}", TOL)

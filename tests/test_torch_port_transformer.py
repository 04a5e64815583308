"""The hybrid-parallel transformer (``horovod_tpu_torch/models/
transformer.py``) on the CPU against the JAX package's.

Gloo worlds of 1, 2 and 8 processes (``tests/torch_port_util.py``
``transformer_worker``), started together while the reference computes,
each run their cases of ``TFM_CASES``: the reference's parameters
(``init_params(PRNGKey(0))``, float32 ``tiny_cfg`` of
``tests/test_transformer.py``) carried across by
``weights.transformer_params_from_jax``, the loss of this rank's dp shard
of a fixed batch and this rank's gradients after the port's convention
(``loss / world`` back-propagated, ``reduce_gradients``).  The reference
runs ``make_loss_fn`` at the same layout over the first devices of the 8
virtual CPU devices; its global gradients are sliced for rank r by
``NamedSharding(mesh, param_specs).devices_indices_map`` at JAX device r,
which has rank r's mesh coordinates.

Tolerances are ``tests/test_transformer.py``'s: the loss within rtol
1e-5, every gradient shard within rtol 5e-4 / atol 5e-5.  Layouts
(dp, tp, pp): (1,1,1), (2,1,1), (1,2,1), (1,1,2), (2,2,2) under
``megatron_sp``; ring and Ulysses with a dedicated sp of 2 (dp 2, tp 2);
the Switch MoE (4 experts) at dp 2 with ep sharing dp.  Then 3
``make_train_step`` steps with ``torch.optim.Adam`` against the
reference's with ``optax.adam`` at (2,2,2), lr 1e-2: each step's loss
within rtol 1e-5, and the final parameters within atol 3e-4, 1% of the
3 x lr Adam moves a parameter at most in 3 steps: Adam divides each
gradient by its own magnitude, so where a gradient element is near zero
its allowed 5e-5 is a large share of it and of its normalized step (the
largest difference seen is 1.0e-4, in ``wqkv``).  Then the model's own seeded init: the tree's names, shapes and
dtypes the reference's (bfloat16, the router float32), the module's
parameters that tree, and a finite loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding

from horovod_tpu import parallel as ref_par
from horovod_tpu.models import transformer as ref_tfm
from torch_port_util import (
    TFM_CASES,
    TFM_LR,
    TFM_TINY,
    TFM_TRAIN,
    TFM_TRAIN_STEPS,
    TFM_WORLDS,
    join_world,
    start_world,
    tfm_params_key,
    tfm_tokens,
    transformer_worker,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
# Adam moves a parameter by at most about lr a step; 1% of that movement
PARAM_ATOL = 0.01 * TFM_TRAIN_STEPS * TFM_LR


def _cfg(cfg_kw, dtype=jnp.float32):
    return ref_tfm.TransformerConfig(**{**TFM_TINY, **cfg_kw}, dtype=dtype)


def _layout(world, lay_kw):
    return ref_par.make_layout(jax.devices()[:world], **lay_kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _params(cfg_kw):
    return ref_tfm.init_params(_cfg(cfg_kw), jax.random.PRNGKey(0))


def _shards(tree, cfg, layout, rank):
    """Rank ``rank``'s block of every leaf of a global tree, by the
    reference's specs at JAX device ``rank``."""
    specs = _flat(ref_tfm.param_specs(cfg, layout))
    dev = jax.devices()[rank]
    out = {}
    for name, a in _flat(tree).items():
        a = np.asarray(a)
        index = NamedSharding(layout.mesh, specs[name]).devices_indices_map(
            a.shape)[dev]
        out[name] = a[index]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every world, compute the reference meanwhile, join."""
    flat = {key: {n: np.asarray(a) for n, a in _flat(_params(kw)).items()}
            for key, kw in (("dense", {}), ("moe", {"n_experts": 4,
                                                    "n_layers": 2}))}
    handles = {}
    for world in TFM_WORLDS:
        tmp = tmp_path_factory.mktemp(f"tfm{world}")
        for key, arrays in flat.items():
            np.savez(tmp / f"params_{key}.npz", **arrays)
        handles[world] = start_world(transformer_worker, world, tmp)

    toks = jnp.asarray(tfm_tokens())
    ref = {}
    for name, (world, cfg_kw, lay_kw) in TFM_CASES.items():
        cfg, layout = _cfg(cfg_kw), _layout(world, lay_kw)
        loss, grads = jax.jit(jax.value_and_grad(
            ref_tfm.make_loss_fn(cfg, layout)))(_params(cfg_kw), toks)
        ref[name] = (float(loss), grads, cfg, layout)

    world, cfg_kw, lay_kw = TFM_TRAIN
    cfg, layout = _cfg(cfg_kw), _layout(world, lay_kw)
    tx = optax.adam(TFM_LR)
    step = ref_tfm.make_train_step(cfg, layout, tx)
    params = _params(cfg_kw)
    opt_state = tx.init(params)
    losses = []
    for _ in range(TFM_TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, toks)
        losses.append(float(loss))
    ref["train"] = (losses, jax.tree.map(np.asarray, params), cfg, layout)

    out = {}
    for world, handle in handles.items():
        codes, infos = join_world(handle, timeout=240)
        assert codes == [0] * world, (world, codes)
        tmp = handle[2]
        out[world] = [(dict(np.load(tmp / f"tfm{r}.npz")), infos[r])
                      for r in range(world)]
    return ref, out


@pytest.mark.parametrize("name", sorted(TFM_CASES))
def test_loss_and_gradient_shards_match_reference(runs, name):
    ref, out = runs
    world = TFM_CASES[name][0]
    loss, grads, cfg, layout = ref[name]
    for r, (res, _) in enumerate(out[world]):
        np.testing.assert_allclose(res[f"{name}/loss"], loss,
                                   rtol=LOSS_RTOL,
                                   err_msg=f"{name} loss, rank {r}")
        want = _shards(grads, cfg, layout, r)
        got = {k.split("/", 1)[1]: v for k, v in res.items()
               if k.startswith(f"{name}/") and k != f"{name}/loss"}
        assert set(got) == set(want), (name, sorted(got), sorted(want))
        for n, g in want.items():
            np.testing.assert_allclose(
                got[n], g, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                err_msg=f"grad {n} ({name}, rank {r})")


def test_train_steps_match_optax_adam(runs):
    ref, out = runs
    losses, params, cfg, layout = ref["train"]
    assert losses[-1] < losses[0]
    for r, (res, _) in enumerate(out[TFM_TRAIN[0]]):
        np.testing.assert_allclose(res["train/losses"], losses,
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        for n, p in _shards(params, cfg, layout, r).items():
            np.testing.assert_allclose(
                res[f"train/{n}"], p, rtol=0, atol=PARAM_ATOL,
                err_msg=f"param {n} after {TFM_TRAIN_STEPS} steps, rank {r}")


@pytest.mark.parametrize("key,cfg_kw", [("dense", {}),
                                        ("moe", {"n_experts": 4})])
def test_own_init_has_the_reference_tree(runs, key, cfg_kw):
    _, out = runs
    info = out[1][0][1]["init"][key]
    want = {n: [list(a.shape), str(a.dtype)] for n, a in _flat(
        ref_tfm.init_params(_cfg(cfg_kw, jnp.bfloat16),
                            jax.random.PRNGKey(0))).items()}
    assert info["tree"] == want
    assert info["module_is_the_tree"]
    assert np.isfinite(info["loss"])


def test_megatron_sp_refuses_a_dedicated_sp_axis():
    """The reference's message, raised before any collective: a world of
    one process is enough (the check reads the layout's axis names)."""
    import horovod_tpu_torch.models.transformer as port_tfm
    from horovod_tpu_torch.parallel.mesh import MeshLayout

    lay = MeshLayout(mesh=None, logical_to_physical={
        "dp": "dp", "tp": "tp", "pp": "pp", "sp": "sp", "ep": "dp"})
    with pytest.raises(ValueError) as port_err:
        port_tfm.make_loss_fn(port_tfm.TransformerConfig(), lay)
    with pytest.raises(ValueError) as ref_err:
        ref_tfm.make_loss_fn(_cfg({}), _layout(2, dict(dp=1, sp=2)))
    assert str(port_err.value) == str(ref_err.value)


def test_model_names_are_the_references():
    import horovod_tpu.models as ref_models
    import horovod_tpu_torch.models as port_models

    names = ["TransformerConfig", "transformer_init_params",
             "transformer_loss_fn", "transformer_train_step",
             "transformer_param_specs"]
    assert set(names) <= set(ref_models.__all__)
    assert set(names) <= set(port_models.__all__)
    ref_fields = [f.name for f in
                  ref_tfm.TransformerConfig.__dataclass_fields__.values()]
    port_fields = [f.name for f in port_models.TransformerConfig
                   .__dataclass_fields__.values()]
    assert port_fields == ref_fields
    ref_default, port_default = (ref_tfm.TransformerConfig(),
                                 port_models.TransformerConfig())
    for f in ref_fields:
        if f != "dtype":
            assert getattr(port_default, f) == getattr(ref_default, f), f
    assert str(port_default.dtype) == "torch.bfloat16"

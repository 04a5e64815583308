"""``allreduce_gradients`` and ``ShardedDistributedOptimizer``
(``horovod_tpu_torch/api/optimizer.py``), on the CPU, against the JAX
package's (``horovod_tpu/api/optimizer.py``).

* At one process, bitwise: the eager bucket plan (its ops' names, its
  results, Sum/Average/Adasum with pre- and postscale) against the
  reference's eager path; under ``HVTPU_AUTOTUNE`` the threshold in force
  is the tuner's current candidate and ``record_step`` gets the step's
  bytes, as the reference's; ``note_step`` counts the step; the sharded
  optimizer at one rank is ``torch.optim.SGD`` bit for bit, and refuses
  int8 with the reference's message.
* In one 2-process and one 3-process gloo world
  (``tests/torch_port_util.py`` ``opt_worker``), bitwise against the
  reference inside ``jax.shard_map``: ``allreduce_gradients`` along the
  world axis and on the eager plan (gradients that are eighths of small
  integers, so the sums are exact at 3 ranks), and scoped by a process
  set's device groups.
* ``ShardedDistributedOptimizer(torch.optim.SGD, momentum=0.9)`` over 3
  steps against ``ShardedDistributedOptimizer(optax.sgd(0.1,
  momentum=0.9))``: the two do not round alike.  XLA fuses optax's
  ``g + 0.9 * t`` into one rounding (an FMA), where ``torch.optim.SGD``
  rounds ``0.9 * t`` and then the sum; optax rounds the update
  ``-0.1 * t`` and then ``p + u``, where ``p.add_(t, alpha=-0.1)`` rounds
  differently again.  So the first momentum shard (the gradient itself)
  is bitwise, and each later step may add one float32 rounding: each
  rank's momentum shard and the parameters are held within
  ``(step + 1) * 2**-23`` times their largest magnitude, and the ranks'
  parameters bitwise equal to each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.api import optimizer as jax_opt
from horovod_tpu.comm import fusion as jax_fusion
from horovod_tpu.comm.compression import Compression as JaxCompression
from horovod_tpu.comm.reduce_ops import ReduceOp as R
from horovod_tpu_torch.api import optimizer as port_opt
from horovod_tpu_torch.comm.compression import Compression
from torch_port_util import (
    OPT_LR,
    OPT_STEPS,
    OPT_THRESHOLD,
    opt_grads,
    opt_params,
    opt_worker,
    spawn_world,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

AXIS = "i"
WORLDS = (2, 3)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"opt{world}")
        codes, _ = spawn_world(opt_worker, world, tmp, timeout=120)
        assert codes == [0] * world, codes
        out[world] = [dict(np.load(tmp / f"opt{r}.npz"))
                      for r in range(world)]
    return out


def _jax_grads(rank, step=0):
    g = {k: jnp.asarray(v) for k, v in opt_grads(rank, step).items()}
    g["e"] = g["e"].astype(jnp.bfloat16)
    return g


def _torch_grads(rank=0):
    g = {k: torch.from_numpy(v) for k, v in opt_grads(rank).items()}
    g["e"] = g["e"].to(torch.bfloat16)
    return g


def _stacked(world, step=0):
    per = [_jax_grads(r, step) for r in range(world)]
    return {k: jnp.stack([g[k] for g in per]) for k in per[0]}


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world], dtype=object), (AXIS,))


def _f32(tree):
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in tree.items()}


def _bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                  err_msg=what)


def _reference_axis(world, op, groups=None):
    def body(g):
        out = jax_opt.allreduce_gradients(
            {k: v[0] for k, v in g.items()}, axis_name=AXIS, op=op,
            prescale_factor=0.5, fusion_threshold_bytes=OPT_THRESHOLD) \
            if groups is None else jax_fusion.fused_tree_allreduce(
                {k: v[0] for k, v in g.items()}, axis_name=AXIS,
                threshold_bytes=OPT_THRESHOLD, op=op, groups=groups)
        return {k: v[None] for k, v in out.items()}

    out = jax.jit(jax.shard_map(body, mesh=_mesh(world), in_specs=(P(AXIS),),
                                out_specs=P(AXIS), check_vma=False))(
        _stacked(world))
    return _f32(out)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,op", [("sum", R.SUM), ("avg", R.AVERAGE)])
def test_allreduce_gradients_both_modes_match_shard_map(worlds, world, name,
                                                        op):
    want = _reference_axis(world, op)
    for mode in ("axis", "eager"):
        for r, res in enumerate(worlds[world]):
            for k in want:
                _bitwise(res[f"{mode}_{name}_{k}"], want[k][r],
                         f"{mode} {name} {k}, {world} ranks, rank {r}")


def test_allreduce_gradients_scoped_by_a_process_set(worlds):
    want = _reference_axis(3, R.AVERAGE, groups=[[0, 2], [1]])
    for r, res in enumerate(worlds[3]):
        for k in want:
            _bitwise(res[f"set_avg_{k}"], want[k][r], f"set {k} rank {r}")


def _reference_sharded(world):
    """The reference's ZeRO-1 SGD over ``world`` devices: the parameters
    after each step and each rank's momentum shard."""
    tx = jax_opt.ShardedDistributedOptimizer(
        optax.sgd(OPT_LR, momentum=0.9), axis_name=AXIS)
    mesh = _mesh(world)
    params = {k: jnp.asarray(v) for k, v in opt_params().items()}
    state = jax.jit(jax.shard_map(tx.init, mesh=mesh, in_specs=(P(),),
                                  out_specs=P(AXIS), check_vma=False))(params)

    def update(g, s, p):
        upd, s2 = tx.update({k: v[0] for k, v in g.items()}, s, p)
        return upd, s2

    step_fn = jax.jit(jax.shard_map(
        update, mesh=mesh, in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=(P(), P(AXIS)), check_vma=False))
    out = []
    for step in range(OPT_STEPS):
        per = [{k: jnp.asarray(v) for k, v in opt_grads(r, step).items()}
               for r in range(world)]
        g = {k: jnp.stack([x[k] for x in per]) for k in per[0]}
        upd, state = step_fn(g, state, params)
        params = optax.apply_updates(params, upd)
        flat = np.concatenate([np.asarray(params[k]).reshape(-1)
                               for k in sorted(params)])
        trace = np.asarray(jax.tree_util.tree_leaves(state)[0])
        out.append((flat, trace.reshape(world, -1)))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_optimizer_matches_the_reference(worlds, world):
    want = _reference_sharded(world)
    for step, (params, shards) in enumerate(want):
        for r, res in enumerate(worlds[world]):
            what = f"step {step}, {world} ranks, rank {r}"
            if step == 0:
                _bitwise(res["momentum_0"], shards[r], f"momentum {what}")
            np.testing.assert_allclose(
                res[f"momentum_{step}"], shards[r], rtol=0,
                atol=(step + 1) * 2.0 ** -23 * np.abs(shards).max(),
                err_msg=f"momentum {what}")
            np.testing.assert_allclose(
                res[f"params_{step}"], params, rtol=0,
                atol=(step + 1) * 2.0 ** -23 * np.abs(params).max(),
                err_msg=f"params {what}")
            np.testing.assert_array_equal(res[f"params_{step}"],
                                          worlds[world][0][f"params_{step}"])
        # each rank holds 1/N of the state
        assert shards.shape == (world, -(-params.size // world))
    for res in worlds[world]:
        assert res["zeroed"].all()


# -- one process ----------------------------------------------------------------

@pytest.fixture
def both(tmp_path, monkeypatch):
    import horovod_tpu as hvt

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    hvt.init()
    hvd.init(device="cpu")
    yield hvt
    hvd.shutdown()
    hvt.shutdown()


def _names(monkeypatch, module, attr="allreduce"):
    calls = []
    real = getattr(module, attr)

    def spy(x, **kw):
        calls.append(kw.get("name"))
        return real(x, **kw)

    monkeypatch.setattr(module, attr, spy)
    return calls


@pytest.mark.parametrize("name,kw", [
    ("sum", dict(op=R.SUM, prescale_factor=0.5, postscale_factor=3.0)),
    ("avg", dict(op=R.AVERAGE)),
    ("adasum", dict(op=R.ADASUM)),
])
def test_world_of_one_eager_plan_matches_reference(both, monkeypatch, name,
                                                   kw):
    from horovod_tpu.comm import eager as jax_eager
    from horovod_tpu_torch.comm import eager as port_eager
    from horovod_tpu_torch.comm.reduce_ops import ReduceOp as PortR

    got_names = _names(monkeypatch, port_eager)
    want_names = _names(monkeypatch, jax_eager)
    port_kw = dict(kw, op=PortR[kw["op"].name])
    got = hvd.allreduce_gradients(_torch_grads(),
                                  fusion_threshold_bytes=OPT_THRESHOLD,
                                  **port_kw)
    want = jax_opt.allreduce_gradients(_jax_grads(0),
                                       fusion_threshold_bytes=OPT_THRESHOLD,
                                       **kw)
    assert list(got) == list(_torch_grads())
    assert got["e"].dtype == torch.bfloat16
    for k, v in _f32(want).items():
        _bitwise(got[k].float().numpy(), v, f"{name} {k}")
    assert got_names == want_names and len(got_names) > 1


def test_world_of_one_autotune_sets_the_threshold(tmp_path, monkeypatch):
    """Under ``HVTPU_AUTOTUNE`` both packages bucket by the tuner's
    current candidate and record the step's bytes; an explicit threshold
    leaves the tuner out."""
    import horovod_tpu as hvt

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HVTPU_AUTOTUNE", "1")
    hvt.init()
    hvd.init(device="cpu")
    try:
        from horovod_tpu.core import state as jax_state
        from horovod_tpu_torch.core import state as port_state

        seen = {}
        for tag, st in (("port", port_state.global_state()),
                        ("ref", jax_state.global_state())):
            tuner = st.autotuner
            assert tuner is not None
            seen[tag] = {"current": tuner.current[0], "bytes": []}
            monkeypatch.setattr(
                tuner, "record_step",
                lambda n, _s=seen[tag]: _s["bytes"].append(n))
        plans = {}
        for tag, mod in (("port", port_opt), ("ref", jax_opt)):
            real = mod.plan_buckets
            monkeypatch.setattr(
                mod, "plan_buckets",
                lambda n, l, t, _tag=tag, _real=real: (
                    plans.setdefault(_tag, []).append(t), _real(n, l, t))[1])
        hvd.allreduce_gradients(_torch_grads())
        jax_opt.allreduce_gradients(_jax_grads(0))
        hvd.allreduce_gradients(_torch_grads(), fusion_threshold_bytes=64)
        jax_opt.allreduce_gradients(_jax_grads(0), fusion_threshold_bytes=64)
        assert seen["port"]["current"] == seen["ref"]["current"]
        assert plans["port"] == plans["ref"] == [seen["port"]["current"], 64]
        assert seen["port"]["bytes"] == seen["ref"]["bytes"] \
            == [sum(v.numel() * v.element_size()
                    for v in _torch_grads().values())]
    finally:
        hvd.shutdown()
        hvt.shutdown()


def test_threshold_falls_back_to_config_then_64_mb(monkeypatch):
    plans = []
    real = port_opt.plan_buckets
    monkeypatch.setattr(port_opt, "plan_buckets",
                        lambda n, l, t: (plans.append(t), real(n, l, t))[1])
    monkeypatch.setattr(port_opt.eager_comm, "allreduce",
                        lambda x, **kw: x.clone())
    port_opt.allreduce_gradients(_torch_grads())
    monkeypatch.setenv("HVTPU_FUSION_THRESHOLD", "1000")
    hvd.init(device="cpu")
    try:
        port_opt.allreduce_gradients([v for v in _torch_grads().values()])
    finally:
        hvd.shutdown()
    assert plans == [64 * 1024 * 1024, 1000]


def test_note_step_counts_each_call(both):
    from horovod_tpu_torch.obs import metrics

    steps = metrics.REGISTRY.counter("hvtpu_optimizer_steps_total", "")
    before = steps.value()
    hvd.allreduce_gradients(_torch_grads())
    assert steps.value() == before + 1


def test_sharded_optimizer_at_one_rank_is_sgd_bitwise(both):
    rng = np.random.RandomState(3)
    model = [torch.nn.Parameter(torch.from_numpy(
        rng.randn(*s).astype(np.float32))) for s in ((7, 5), (5,), (3, 2))]
    plain = [torch.nn.Parameter(p.detach().clone()) for p in model]
    sharded = hvd.ShardedDistributedOptimizer(
        torch.optim.SGD, model, axis_name="world", lr=OPT_LR, momentum=0.9)
    ref = torch.optim.SGD(plain, lr=OPT_LR, momentum=0.9)
    for _ in range(OPT_STEPS):
        for a, b in zip(model, plain):
            g = torch.from_numpy(rng.randn(*a.shape).astype(np.float32))
            a.grad, b.grad = g.clone(), g.clone()
        sharded.step()
        ref.step()
        for a, b in zip(model, plain):
            assert torch.equal(a, b)
    assert sharded.shard.numel() == sum(p.numel() for p in model)
    state = sharded.state_dict()
    assert len(state["state"]) == 1      # one flat shard, one buffer


def test_sharded_optimizer_refuses_int8_as_the_reference():
    with pytest.raises(ValueError) as want:
        jax_opt.ShardedDistributedOptimizer(optax.sgd(0.1), axis_name=AXIS,
                                            compression=JaxCompression.int8)
    with pytest.raises(ValueError) as got:
        hvd.ShardedDistributedOptimizer(
            torch.optim.SGD, [torch.nn.Parameter(torch.zeros(2))],
            axis_name="world", compression=Compression.int8, lr=0.1)
    assert str(got.value) == str(want.value)


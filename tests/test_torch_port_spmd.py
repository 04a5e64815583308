"""The collectives over a mesh axis (``horovod_tpu_torch/comm/spmd.py``)
and ``fused_tree_allreduce``, on the CPU, against the JAX package.

One 2-process and one 3-process gloo world (``tests/torch_port_util.py``
``spmd_worker``) run every function on their own rank's inputs; the
reference runs ``horovod_tpu.comm.spmd`` (and ``comm.fusion``) inside
``jax.shard_map`` over the first 2 or 3 of the 8 virtual CPU devices on
the same inputs.  Every comparison is bitwise on every rank, except:

* Adasum (2 ranks), within rtol 1e-5 / atol 1e-6: its dot products sum
  in another order (``tests/test_torch_port_adasum.py``);
* int8 with stochastic rounding, which draws from another generator
  than JAX's: within the reference's own error bound (two quantization
  errors of at most a scale each, a scale an absmax / 127 of its block);
  its key folds the axis index, shown over a one-rank axis whose index
  is 0 on both ranks.

The float inputs of the plain reductions are eighths of small integers,
so every sum is exact and gloo's summation order at 3 ranks gives XLA's
bits (ROADMAP Queue C).  The int8 route is held against the reference's
two-phase codec, and with ``HVTPU_QUANTIZED_RING=1`` at 2 ranks against
its ring A6 in the Pallas interpreter; a spy shows the port's ring ran.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.comm import compression as jax_compression
from horovod_tpu.comm import fusion as jax_fusion
from horovod_tpu.comm import spmd as jax_spmd
from horovod_tpu.comm.reduce_ops import ReduceOp as R
from torch_port_util import (
    SPMD_SEGMENTS,
    SPMD_THRESHOLD,
    spawn_world,
    spmd_inputs,
    spmd_worker,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

AXIS = "i"
WORLDS = (2, 3)
C = jax_compression.Compression


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"spmd{world}")
        codes, infos = spawn_world(spmd_worker, world, tmp, timeout=120)
        assert codes == [0] * world, codes
        out[world] = [(dict(np.load(tmp / f"spmd{r}.npz")), infos[r])
                      for r in range(world)]
    return out


def _stack(world, key, cast=None):
    arrs = [np.asarray(spmd_inputs(r, world)[key]) for r in range(world)]
    out = jnp.stack([jnp.asarray(a) for a in arrs])
    return out.astype(cast) if cast is not None else out


def _run(world, body, *stacked):
    """``body`` on each rank's slice of ``stacked`` in ``shard_map`` over
    ``world`` devices; every rank's output, float32 for a 16-bit float."""
    mesh = Mesh(np.asarray(jax.devices()[:world], dtype=object), (AXIS,))
    fn = jax.shard_map(lambda *xs: body(*(x[0] for x in xs))[None],
                       mesh=mesh, in_specs=(P(AXIS),) * len(stacked),
                       out_specs=P(AXIS), check_vma=False)
    out = jax.jit(fn)(*stacked)
    if out.dtype in (jnp.bfloat16, jnp.float16):
        out = out.astype(jnp.float32)
    return np.asarray(out)


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a
    return a.view({8: np.uint64, 4: np.uint32, 2: np.uint16,
                   1: np.uint8}[a.itemsize])


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _held(worlds, world, key, want):
    for r, (res, _) in enumerate(worlds[world]):
        _assert_bitwise(res[key], want[r], f"{key}, {world} ranks, rank {r}")


ALLREDUCE = {
    "sum_f32": ("exact", None, dict(op=R.SUM)),
    "avg_f32": ("exact", None, dict(op=R.AVERAGE)),
    "avg_bf16": ("exact", jnp.bfloat16, dict(op=R.AVERAGE)),
    "sum_f16": ("exact", jnp.float16, dict(op=R.SUM)),
    "sum_i32": ("ints", None, dict(op=R.SUM)),
    "avg_i32": ("ints", None, dict(op=R.AVERAGE)),
    "min": ("exact", None, dict(op=R.MIN)),
    "max": ("exact", None, dict(op=R.MAX)),
    "prod": ("pos", None, dict(op=R.PRODUCT)),
    "scaled": ("exact", None, dict(op=R.SUM, prescale_factor=0.5,
                                   postscale_factor=3.0)),
    "scaled_i32": ("ints", None, dict(average=False, prescale_factor=2.0,
                                      postscale_factor=0.5)),
    "fp16_wire": ("exact", None, dict(op=R.SUM, compression=C.fp16)),
    "bf16_wire": ("exact", None, dict(op=R.AVERAGE, compression=C.bf16)),
    "int8_sum": ("wide", None, dict(op=R.SUM, compression=C.int8)),
    "int8_avg": ("wide", None, dict(op=R.AVERAGE, compression=C.int8)),
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", sorted(ALLREDUCE))
def test_allreduce_matches_spmd(worlds, world, key):
    src, cast, kw = ALLREDUCE[key]
    want = _run(world, lambda x: jax_spmd.allreduce(x, axis_name=AXIS, **kw),
                _stack(world, src, cast))
    _held(worlds, world, key, want)


@pytest.mark.parametrize("world", WORLDS)
def test_grouped_allreduce_matches_spmd(worlds, world):
    for op, name, second in ((R.AVERAGE, "avg", ("small", jnp.bfloat16)),
                             (R.MAX, "max", ("ints", None))):
        for i in range(2):
            want = _run(world, lambda a, b: jax_spmd.grouped_allreduce(
                [a, b], axis_name=AXIS, op=op)[i],
                _stack(world, "exact"), _stack(world, *second))
            _held(worlds, world, f"grouped_{name}_{i}", want)


@pytest.mark.parametrize("world", WORLDS)
def test_allgather_broadcast_alltoall_reducescatter(worlds, world):
    for key, src, body in (
            ("gather_f32", "exact",
             lambda x: jax_spmd.allgather(x, axis_name=AXIS)),
            ("gather_i32", "ints",
             lambda x: jax_spmd.allgather(x, axis_name=AXIS)),
            ("bcast_f32", "exact",
             lambda x: jax_spmd.broadcast(x, root_rank=1, axis_name=AXIS)),
            ("bcast_bool", "bools",
             lambda x: jax_spmd.broadcast(x, root_rank=world - 1,
                                          axis_name=AXIS)),
            ("a2a", "a2a", lambda x: jax_spmd.alltoall(x, axis_name=AXIS)),
            ("rs_sum", "rs", lambda x: jax_spmd.reducescatter(
                x, axis_name=AXIS, op=R.SUM)),
            ("rs_avg", "rs", lambda x: jax_spmd.reducescatter(
                x, axis_name=AXIS, op=R.AVERAGE))):
        _held(worlds, world, key, _run(world, body, _stack(world, src)))
    want = _run(world, lambda x: jax_spmd.barrier(AXIS), _stack(world, "ints"))
    _held(worlds, world, "barrier", want)


@pytest.mark.parametrize("world", WORLDS)
def test_axis_introspection_and_refusals(worlds, world):
    for r, (_, info) in enumerate(worlds[world]):
        assert info["axis"] == [world, r]
        assert info["rs_min"] == \
            "ValueError: reducescatter supports Sum and Average"
        with pytest.raises(ValueError) as e:
            _run(world, lambda x: jax_spmd.alltoall(x, axis_name=AXIS),
                 _stack(world, "a2a")[:, :-1])
        assert info["a2a_indivisible"] == f"ValueError: {e.value}"


@pytest.mark.parametrize("world", WORLDS)
def test_groups_match_spmd(worlds, world):
    """At 3 ranks the partition is a process set's device groups: the
    members [0, 2] and the singleton [1], whose Average still divides by
    the first part's size, as the reference's does."""
    groups = [[0], [1]] if world == 2 else [[0, 2], [1]]
    for r, (_, info) in enumerate(worlds[world]):
        assert info["groups"] == groups
    for key, op in (("g_sum", R.SUM), ("g_avg", R.AVERAGE),
                    ("g_min", R.MIN)):
        want = _run(world, lambda x: jax_spmd.allreduce(
            x, axis_name=AXIS, op=op, groups=groups), _stack(world, "exact"))
        _held(worlds, world, key, want)
    infos = [info for _, info in worlds[world]]
    if world == 2:
        want = _run(world, lambda x: jax_spmd.allgather(
            x, axis_name=AXIS, groups=groups), _stack(world, "exact"))
        _held(worlds, world, "g_gather", want)
    else:
        with pytest.raises(ValueError) as e:
            jax_spmd._require_equal_groups(groups, "allgather")
        assert {i["g_gather"] for i in infos} == {f"ValueError: {e.value}"}
    for key, kw, exc in (
            ("g_int8", dict(compression=C.int8), NotImplementedError),
            ("g_adasum", dict(op=R.ADASUM), NotImplementedError)):
        with pytest.raises(exc) as e:
            _run(world, lambda x: jax_spmd.allreduce(
                x, axis_name=AXIS, groups=groups, **kw),
                _stack(world, "wide"))
        assert {i[key] for i in infos} == {f"{exc.__name__}: {e.value}"}


def _tree(world):
    """The reference's tree of ``spmd_tree``, stacked over the ranks."""
    return {"b": _stack(world, "tree_b", jnp.bfloat16),
            "a": _stack(world, "tree_a"), "c": _stack(world, "tree_c")}


def _run_tree(world, op):
    mesh = Mesh(np.asarray(jax.devices()[:world], dtype=object), (AXIS,))

    def body(tree):
        out = jax_fusion.fused_tree_allreduce(
            {k: v[0] for k, v in tree.items()}, axis_name=AXIS,
            threshold_bytes=SPMD_THRESHOLD, op=op)
        return {k: v[None] for k, v in out.items()}

    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(AXIS),),
                                out_specs=P(AXIS), check_vma=False))(
        _tree(world))
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v) for k, v in out.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_fused_tree_allreduce_matches_reference(worlds, world):
    for name, op in (("sum", R.SUM), ("avg", R.AVERAGE)):
        want = _run_tree(world, op)
        for r, (_, info) in enumerate(worlds[world]):
            assert info[f"tree_{name}_keys"] == ["b", "a", "c"]
        for k in want:
            _held(worlds, world, f"tree_{name}_{k}", want[k])


def test_the_plans_agree_on_the_tree():
    """The port names a dict's entries as the reference's tree paths, so
    both packages bucket the tree alike."""
    from horovod_tpu_torch.comm import fusion

    tree = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            {"b": np.zeros(7), "a": np.zeros((4, 3)),
             "c": np.zeros(11)}.items()}
    names, leaves, rebuild = fusion.tree_leaves(tree)
    got = fusion.plan_buckets(names, leaves, SPMD_THRESHOLD)
    want, _ = jax_fusion.plan_for_tree(
        {k: jnp.zeros(v.shape) for k, v in tree.items()}, SPMD_THRESHOLD)
    assert [[e.name for e in b] for b in got.buckets] == \
        [[e.name for e in b] for b in want.buckets]
    assert len(got.buckets) > 1
    assert list(rebuild(leaves)) == ["b", "a", "c"]
    names, _, rebuild = fusion.tree_leaves([leaves[0], leaves[1]])
    assert names == ["[0]", "[1]"] and isinstance(rebuild([1, 2]), list)


def test_adasum_at_two_ranks_within_tolerance(worlds):
    for key, seg in (("adasum", None), ("adasum_seg", SPMD_SEGMENTS)):
        want = _run(2, lambda x: jax_spmd.allreduce(
            x, axis_name=AXIS, op=R.ADASUM, adasum_segments=seg),
            _stack(2, "wide"))
        for r, (res, _) in enumerate(worlds[2]):
            np.testing.assert_allclose(res[key], want[r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} rank {r}")
        np.testing.assert_array_equal(worlds[2][0][0][key],
                                      worlds[2][1][0][key])
    want = _run_tree(2, R.ADASUM)
    for k in want:
        for r, (res, _) in enumerate(worlds[2]):
            np.testing.assert_allclose(res[f"tree_adasum_{k}"], want[k][r],
                                       rtol=1e-5, atol=1e-6)


def test_adasum_at_three_ranks_refused_as_the_reference_refuses(worlds):
    with pytest.raises(ValueError) as e:
        _run(3, lambda x: jax_spmd.allreduce(x, axis_name=AXIS, op=R.ADASUM),
             _stack(3, "wide"))
    assert {info["adasum"] for _, info in worlds[3]} == \
        {f"ValueError: {e.value}"}


@pytest.mark.parametrize("world", WORLDS)
def test_int8_stochastic_within_the_reference_bound(worlds, world):
    xs = np.asarray(_stack(world, "wide"))
    want = _run(world, lambda x: jax_spmd.allreduce(
        x, axis_name=AXIS, op=R.SUM, compression=C.int8_stochastic),
        _stack(world, "wide"))
    exact = xs.astype(np.float64).sum(0)
    # each phase errs by under one scale: phase 1 a sum of the ranks'
    # block scales, phase 2 the reduced block's
    absmax = np.abs(xs).max() * world
    bound = 2 * world * absmax / 127
    for r, (res, _) in enumerate(worlds[world]):
        assert np.abs(res["stoch"] - exact).max() <= bound
        assert np.abs(want[r] - exact).max() <= bound
    got = [res["stoch"] for res, _ in worlds[world]]
    assert all(np.array_equal(got[0], g) for g in got)


def test_stochastic_key_folds_the_axis_index(worlds):
    """Over the one-rank ``ici`` axis of 2 hosts both ranks are index 0:
    the same payload gets the same dither on both, as the reference's
    ``_dither_key`` folds ``axis_index``; and it is the one-rank codec's
    result, not the payload."""
    a, b = (res["stoch_ici"] for res, _ in worlds[2])
    _assert_bitwise(a, b, "stochastic over ici")
    payload = spmd_inputs(0, 2)["wide"]
    assert not np.array_equal(a, payload)
    assert np.abs(a - payload).max() <= 2 * np.abs(payload).max() / 127


def _route(op, comp):
    return _run(2, lambda x: jax_spmd.allreduce(
        x, axis_name=AXIS, op=op, compression=comp), _stack(2, "wide"))


def test_int8_route_reaches_the_ring_as_the_reference(worlds, monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("HVTPU_QUANTIZED_RING", "1")
    from horovod_tpu.ops import ring as jax_ring

    calls = []
    real = jax_ring.ring_allreduce
    monkeypatch.setattr(jax_ring, "ring_allreduce",
                        lambda *a, **kw: (calls.append(kw), real(*a, **kw))[1])
    for key, op in (("ring_sum", R.SUM), ("ring_avg", R.AVERAGE)):
        _held(worlds, 2, key, _route(op, C.int8))
    assert [c.get("quantized") for c in calls] == [True, True]
    # stochastic rounding keeps the two-phase codec on both sides
    for r, (res, info) in enumerate(worlds[2]):
        assert info["ring_calls"] == [True, True]
        _assert_bitwise(res["ring_stoch"], res["stoch"], f"rank {r}")
        assert not np.array_equal(res["ring_sum"], res["int8_sum"])


def test_meshes_across_ranks(worlds):
    for world in WORLDS:
        for r, (res, info) in enumerate(worlds[world]):
            assert info["world_mesh"] == [["world"], list(range(world)),
                                          True]
            assert info["num_devices"] == world
            assert info["local_devices"] == ["cpu"]
            # trailing axes are fast: a (1, n) mesh puts every rank on tp
            assert info["nd"] == [[list(range(world))],
                                  [[i] for i in range(world)],
                                  world, r, world, r]
            assert info["nd_bad"] == \
                f"ValueError: mesh shape (2, 2) does not cover {world} devices"
            _assert_bitwise(res["nd_tp_sum"], res["sum_f32"], "tp sum")
            x = spmd_inputs(r, world)["exact"]
            _assert_bitwise(res["nd_tp_solo"], x, "one-rank tp")
    for r, (res, info) in enumerate(worlds[2]):
        assert info["hier"] == [["dcn", "ici"], [[0], [1]], 2, 1, r, 0]
        _assert_bitwise(res["hier_dcn_sum"], res["sum_f32"], "dcn sum")
    for _, info in worlds[3]:
        assert info["hier"] == (
            "ValueError: hierarchical mesh requires equal device counts "
            "per process; got [1, 2]")


def test_int8_refusals_at_one_process():
    """Adasum refuses int8 whatever the axis, with the reference's
    message, before any collective."""
    from horovod_tpu_torch.comm import spmd
    from horovod_tpu_torch.comm.compression import Compression

    with pytest.raises(ValueError) as want:
        _run(2, lambda x: jax_spmd.allreduce(
            x, axis_name=AXIS, op=R.ADASUM, compression=C.int8),
            _stack(2, "wide"))
    with pytest.raises(ValueError) as got:
        spmd.allreduce(torch.zeros(4), axis_name="world", op=R.ADASUM,
                       compression=Compression.int8, mesh=object())
    assert str(got.value) == str(want.value)


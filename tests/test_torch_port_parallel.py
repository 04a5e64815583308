"""The parallel layers (``horovod_tpu_torch/parallel``) on the CPU against
the JAX package's (``horovod_tpu/parallel``).

One 2-process and one 3-process gloo world (``tests/torch_port_util.py``
``parallel_worker``) run every collective of ``parallel/_collectives.py``
and every layer on their own rank's inputs over a 1-D mesh axis ``i``,
forward and the gradients of ``<output, cotangent>`` for a seeded
cotangent a rank; the reference runs the same functions inside
``jax.shard_map`` over the first 2 or 3 of the 8 virtual CPU devices on
the same inputs, stacked, and ``jax.vjp`` with the same cotangents.
Both are the vector-Jacobian product of the one function from every
rank's inputs to every rank's outputs, so each rank's gradients compare
one to one.

Tolerances: the collectives and their gradients are bitwise (gathers and
permutations; sums of eighths of small integers are exact in any
order).  ``jax.vjp`` of the untiled ``all_to_all`` fails its own
cotangent shape check, so that gradient is held against the reference's
forward of the adjoint on the cotangent.  The layers take the reference's own (``tests/test_parallel.py``):
column -> row within rtol/atol 1e-5; Ulysses and ring attention forward
within 2e-5, gradients 1e-4; the pipeline forward within 1e-5, gradients
1e-4; the MoE within rtol 1e-4 / atol 1e-5, its routing's one-hot
dispatch bitwise and combine and aux within rtol 1e-6.  The layouts,
their coordinates and their refusals are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import parallel as ref_par
from horovod_tpu.parallel import mesh as ref_mesh
from horovod_tpu_torch import parallel as port_par
from horovod_tpu_torch.parallel import mesh as port_mesh
from torch_port_util import (
    PAR_MICRO,
    join_world,
    par_inputs,
    par_layout_cases,
    par_partial_perm,
    par_ring_perm,
    parallel_worker,
    start_world,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

AXIS = "i"
WORLDS = (2, 3)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    handles = {w: start_world(parallel_worker, w,
                              tmp_path_factory.mktemp(f"par{w}"))
               for w in WORLDS}
    out = {}
    for world, handle in handles.items():
        codes, infos = join_world(handle, timeout=180)
        assert codes == [0] * world, codes
        tmp = handle[2]
        out[world] = [(dict(np.load(tmp / f"par{r}.npz")), infos[r])
                      for r in range(world)]
    return out


def _stack(world, key):
    return jnp.stack([jnp.asarray(par_inputs(r, world)[key])
                      for r in range(world)])


def _shard_map(world, body, n_in):
    mesh = Mesh(np.asarray(jax.devices()[:world], dtype=object), (AXIS,))

    def local(*xs):
        outs = body(*(x[0] for x in xs))
        outs = outs if isinstance(outs, tuple) else (outs,)
        return tuple(o[None] for o in outs)

    return jax.shard_map(local, mesh=mesh, in_specs=(P(AXIS),) * n_in,
                         out_specs=P(AXIS))


def _reference(world, body, inputs, cts):
    """``body`` on each rank's inputs in ``shard_map`` over ``world``
    devices, and its VJP: (every rank's outputs, every rank's input
    gradients), as numpy, rank-major."""
    fn = _shard_map(world, body, len(inputs))

    def run(xs, cs):
        outs, vjp = jax.vjp(fn, *xs)
        return outs, vjp(cs)

    outs, grads = jax.jit(run)([_stack(world, k) for k in inputs],
                               tuple(_stack(world, c) for c in cts))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _check(worlds, world, name, inputs, outs, grads, tol):
    for r, (res, _) in enumerate(worlds[world]):
        got = [res[f"{name}/out{i}"] for i in range(len(outs))]
        got += [res[f"{name}/d_{k}"] for k in inputs]
        want = [o[r] for o in outs] + [g[r] for g in grads]
        labels = ([f"out{i}" for i in range(len(outs))]
                  + [f"d_{k}" for k in inputs])
        for label, g, w in zip(labels, got, want):
            what = f"{name} {label}, {world} ranks, rank {r}"
            assert g.shape == w.shape, (what, g.shape, w.shape)
            if tol is None:
                np.testing.assert_array_equal(_bits(g), _bits(w),
                                              err_msg=what)
            else:
                rtol, atol = tol["out" if label.startswith("out")
                                 else "grad"]
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=what)


# -- the collectives: bitwise, forward and gradient --------------------------

def _collectives(world):
    return {
        "psum": (lambda a: lax.psum(a, AXIS), ["psum"], ["psum_ct"]),
        "all_gather": (lambda a: lax.all_gather(a, AXIS, axis=1, tiled=True),
                       ["ag"], ["ag_ct"]),
        "all_gather_untiled": (
            lambda a: lax.all_gather(a, AXIS, axis=1, tiled=False),
            ["ag"], ["ag_u_ct"]),
        "psum_scatter": (lambda a: lax.psum_scatter(
            a, AXIS, scatter_dimension=1, tiled=True), ["rs"], ["rs_ct"]),
        "psum_scatter_untiled": (lambda a: lax.psum_scatter(
            a, AXIS, scatter_dimension=0, tiled=False),
            ["rs_u"], ["rs_u_ct"]),
        "all_to_all": (lambda a: lax.all_to_all(a, AXIS, 0, 1, tiled=True),
                       ["a2a"], ["a2a_ct"]),
        "all_to_all_untiled": (
            lambda a: lax.all_to_all(a, AXIS, 0, 1, tiled=False),
            ["a2a_u"], ["a2a_u_ct"],
            lambda c: lax.all_to_all(c, AXIS, 1, 0, tiled=False)),
        "ppermute_ring": (
            lambda a: lax.ppermute(a, AXIS, par_ring_perm(world)),
            ["perm"], ["perm_ct"]),
        "ppermute_partial": (
            lambda a: lax.ppermute(a, AXIS, par_partial_perm(world)),
            ["perm"], ["perm_ct"]),
    }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(_collectives(2)))
def test_collective_and_adjoint_match_lax(worlds, world, name):
    body, inputs, cts, *adjoint = _collectives(world)[name]
    if adjoint:
        # jax.vjp of the untiled all_to_all fails its own cotangent shape
        # check (jax 0.9), so its gradient is held against the reference's
        # forward of the adjoint, all_to_all(ct, 1, 0), on the cotangent
        outs = [np.asarray(o) for o in jax.jit(
            _shard_map(world, body, 1))(_stack(world, inputs[0]))]
        grads = [np.asarray(jax.jit(_shard_map(world, adjoint[0], 1))(
            _stack(world, cts[0]))[0])]
    else:
        outs, grads = _reference(world, body, inputs, cts)
    _check(worlds, world, name, inputs, outs, grads, tol=None)


@pytest.mark.parametrize("world", WORLDS)
def test_axis_index_and_size(worlds, world):
    for r, (_, info) in enumerate(worlds[world]):
        assert info["axis"] == [r, world]


# -- the layers: the reference's tolerances -----------------------------------

TP_TOL = {"out": (1e-5, 1e-5), "grad": (1e-5, 1e-5)}
ATTN_TOL = {"out": (2e-5, 2e-5), "grad": (1e-4, 1e-4)}
PP_TOL = {"out": (1e-5, 1e-5), "grad": (1e-4, 1e-4)}
MOE_TOL = {"out": (1e-4, 1e-5), "grad": (1e-4, 1e-5)}


def _stage(params, x, with_aux):
    w, b = params
    y = jnp.tanh(x @ w + b)
    return (y, jnp.mean(y * y)) if with_aux else y


def _expert(params, tok):
    w1, w2 = params
    return jnp.tanh(tok @ w1) @ w2


def _layers(world):
    cases = {
        "tp": (lambda a, w1, b1, w2, b2: ref_par.row_parallel(
            ref_par.column_parallel(a, w1, b1), w2, AXIS, b2),
            ["tp_x", "tp_w1", "tp_b1", "tp_w2", "tp_b2"], ["tp_ct"], TP_TOL),
        "moe": (lambda a, g, w1, w2: ref_par.expert_parallel_moe(
            a, g, (w1, w2), _expert, AXIS, num_experts=2 * world,
            capacity_factor=0.5),
            ["moe_x", "moe_gate", "moe_w1", "moe_w2"],
            ["moe_ct", "moe_aux_ct"], MOE_TOL),
    }
    for causal, tag in ((False, "full"), (True, "causal")):
        cases[f"ulysses_{tag}"] = (
            lambda q, k, v, c=causal: ref_par.ulysses_attention(
                q, k, v, AXIS, causal=c),
            ["uly_q", "uly_k", "uly_v"], ["uly_ct"], ATTN_TOL)
        cases[f"ring_{tag}"] = (
            lambda q, k, v, c=causal: ref_par.ring_attention(
                q, k, v, AXIS, causal=c),
            ["ring_q", "ring_k", "ring_v"], ["ring_ct"], ATTN_TOL)
    for m in PAR_MICRO:
        ins = ["pp_w", "pp_b", f"pp_mb{m}"]
        cases[f"pipeline_m{m}"] = (
            lambda w, b, mb: ref_par.pipeline_apply(
                lambda p, h: _stage(p, h, False), (w, b), mb, AXIS),
            ins, [f"pp_ct{m}"], PP_TOL)
        cases[f"pipeline_aux_m{m}"] = (
            lambda w, b, mb: ref_par.pipeline_apply(
                lambda p, h: _stage(p, h, True), (w, b), mb, AXIS,
                with_aux=True),
            ins, [f"pp_ct{m}", "pp_aux_ct"], PP_TOL)
    return cases


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(_layers(2)))
def test_layer_and_gradient_match_reference(worlds, world, name):
    body, inputs, cts, tol = _layers(world)[name]
    outs, grads = _reference(world, body, inputs, cts)
    _check(worlds, world, name, inputs, outs, grads, tol)


@pytest.mark.parametrize("world", WORLDS)
def test_switch_route_matches_and_moe_overflows(worlds, world):
    for r, (res, _) in enumerate(worlds[world]):
        x = par_inputs(r, world)
        dispatch, combine, aux = ref_par.switch_route(
            jnp.asarray(x["moe_x"]), jnp.asarray(x["moe_gate"]), 2 * world, 3)
        np.testing.assert_array_equal(res["route/dispatch"],
                                      np.asarray(dispatch))
        np.testing.assert_allclose(res["route/combine"], np.asarray(combine),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(res["route/aux"], np.asarray(aux),
                                   rtol=1e-6)
        # the MoE case's capacity (factor 0.5) drops tokens on every rank
        e = 2 * world
        cap = int(np.ceil(16 * 0.5 / e))
        d_ref, _, _ = ref_par.switch_route(
            jnp.asarray(x["moe_x"]), jnp.asarray(x["moe_gate"]), e, cap)
        assert float(np.asarray(d_ref).sum()) < 16


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_have_the_reference_messages(worlds, world):
    mesh = Mesh(np.asarray(jax.devices()[:world], dtype=object), (AXIS,))

    def message(body, *args):
        fn = jax.shard_map(body, mesh=mesh, in_specs=(P(),) * len(args),
                           out_specs=P(), check_vma=False)
        with pytest.raises(ValueError) as e:
            jax.jit(fn)(*args)
        return f"ValueError: {e.value}"

    q = jnp.ones((2, 4, 1, 8))
    heads = message(lambda q: ref_par.ulysses_attention(q, q, q, AXIS), q)
    x = jnp.ones((16, 8))
    experts = message(lambda x: ref_par.expert_parallel_moe(
        x, jnp.ones((8, world + 1)), (), _expert, AXIS,
        num_experts=world + 1)[0], x)
    for _, info in worlds[world]:
        assert info["errors"]["ulysses_heads"] == heads
        assert info["errors"]["moe_experts"] == experts
        assert "whole world" in info["errors"]["subset"]


# -- the layouts ----------------------------------------------------------------

def _ref_layout(world, kw, rank):
    devices = jax.devices()[:world]
    try:
        lay = (ref_par.auto_layout(devices) if kw is None
               else ref_par.make_layout(devices, **kw))
    except ValueError as e:
        return {"error": str(e)}
    where = np.argwhere(lay.mesh.devices == devices[rank])[0]
    return {"shape": [[a, n] for a, n in lay.mesh.shape.items()],
            "map": dict(lay.logical_to_physical),
            "sizes": {a: lay.axis_size(a) for a in ("dp", "tp", "pp", "sp",
                                                    "ep")},
            "coords": [int(i) for i in where]}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(par_layout_cases(2)) + ["auto"])
def test_layout_matches_reference(worlds, world, case):
    kw = None if case == "auto" else par_layout_cases(world)[case]
    for r, (_, info) in enumerate(worlds[world]):
        got = info["auto"] if kw is None else info["layouts"][case]
        assert got == _ref_layout(world, kw, r), (case, world, r)


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_default_matches_reference(n):
    assert port_mesh._factor_default(n) == ref_mesh._factor_default(n)


def test_bubble_fraction_and_tp_shard_dim_match_reference():
    for m in range(1, 9):
        for s in range(1, 9):
            assert (port_par.bubble_fraction(m, s)
                    == ref_par.bubble_fraction(m, s))
    assert port_par.tp_shard_dim(12, 4) == ref_par.tp_shard_dim(12, 4) == 3
    for mod in (port_par, ref_par):
        with pytest.raises(ValueError, match="heads=6 not divisible by tp=4"):
            mod.tp_shard_dim(6, 4, "heads")


def test_public_names_are_the_references():
    assert port_par.__all__ == ref_par.__all__
    assert port_par.LOGICAL_AXES == ref_par.LOGICAL_AXES
    for name in port_par.__all__:
        assert hasattr(port_par, name), name

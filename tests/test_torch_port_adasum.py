"""Adasum in the port (``horovod_tpu_torch/comm/adasum.py`` and
``op=Adasum`` on the collectives, the ``*_async`` ops and
``DistributedOptimizer``), on the CPU, against the JAX package.

* ``pairwise_adasum`` against the JAX package's ``_pairwise_adasum``
  (float32, float16, bfloat16; one segment and a segment a tensor), and
  against the float64 reference: float32 within rtol 1e-5 / atol 1e-6
  (the dot products sum in another order), the 16-bit dtypes within one
  unit in their last place.  Identical inputs give the input and
  orthogonal ones their sum, bitwise.
* One 4-rank gloo spawn (and one more on the Python negotiation core,
  bitwise the first): ``adasum_reduce`` (whole buffer and a segment a
  tensor) and ``allreduce(op=Adasum)`` sync, async and through the
  optimizer, over the world of 4 and over the set {1, 3}, against the
  JAX package's ``spmd.allreduce(op=ADASUM)`` on 4 and 2 of the 8
  virtual CPU devices and against ``adasum_reduce_reference`` (float64),
  within rtol 1e-5 / atol 1e-6; every member holds the same bits; the
  fp16 wire; identical and orthogonal inputs across the 4 ranks; over
  the set {0, 1, 2} the reference's refusal of a size that is not a
  power of two (its ``adasum_reduce`` raises the same ``ValueError`` at
  3 devices), raised by the sync op and failing the async op.
* At a world of one, against the JAX torch frontend, bitwise: the int8
  refusal, the identity, and ``DistributedOptimizer(op=Adasum)`` over 3
  steps of a narrow ResNet.
"""

import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.comm import adasum as jax_adasum
from horovod_tpu.comm import spmd as jax_spmd
from horovod_tpu.comm.compression import Compression as JaxCompression
from horovod_tpu.comm.reduce_ops import ReduceOp as JaxReduceOp
from horovod_tpu_torch.comm import adasum
from horovod_tpu_torch.comm.compression import Compression as Engine
from horovod_tpu_torch.comm.reduce_ops import ReduceOp
from torch_port_util import (
    ADASUM_SETS,
    adasum_inputs,
    adasum_worker,
    narrow_resnet,
    synthetic_batches,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-6
DTYPES = {
    "f32": (torch.float32, jnp.float32, np.float32, None),
    "f16": (torch.float16, jnp.float16, np.float16, 2.0 ** -10),
    "bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16, 2.0 ** -7),
}
SHAPES = [(33,), (4, 5), (7, 3, 2), (1,)]


def _segments(shapes):
    sizes = [int(np.prod(s)) for s in shapes]
    return [(sum(sizes[:i]), n) for i, n in enumerate(sizes)]


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, ulp=None, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if ulp is None:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=ulp, atol=0,
                                   err_msg=what)


def _pair(key, seed):
    tdt, jdt, ndt, _ulp = DTYPES[key]
    rng = np.random.RandomState(seed)
    n = sum(int(np.prod(s)) for s in SHAPES)
    a = rng.randn(n).astype(np.float32).astype(ndt)
    b = (rng.randn(n) * 3).astype(np.float32).astype(ndt)
    return a, b


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("key", list(DTYPES))
def test_pairwise_adasum_matches_jax(key, segmented):
    tdt, jdt, ndt, ulp = DTYPES[key]
    a, b = _pair(key, sum(map(ord, key)) + segmented)
    segs = _segments(SHAPES) if segmented else None
    got = adasum.pairwise_adasum(_torch(a, tdt), _torch(b, tdt), segs)
    want = jax_adasum._pairwise_adasum(jnp.asarray(a), jnp.asarray(b), segs)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got.float().numpy(), np.asarray(want, np.float32), ulp, key)
    if key == "f32":
        pieces = [(a, b)] if not segmented else [
            (a[o:o + n], b[o:o + n]) for o, n in segs]
        ref = np.concatenate([adasum.adasum_reduce_reference([x, y])
                              for x, y in pieces])
        _close(got.numpy(), ref, what="float64 reference")


def test_identical_and_orthogonal_inputs():
    a, b = _pair("f32", 7)
    ta = torch.from_numpy(a)
    assert torch.equal(adasum.pairwise_adasum(ta, ta.clone()), ta)
    left = np.where(np.arange(a.size) % 2 == 0, a, 0).astype(np.float32)
    right = np.where(np.arange(a.size) % 2 == 1, b, 0).astype(np.float32)
    got = adasum.pairwise_adasum(torch.from_numpy(left),
                                 torch.from_numpy(right))
    assert got.numpy().tobytes() == (left + right).tobytes()


def test_segments_must_tile_the_buffer():
    a = torch.ones(6)
    with pytest.raises(ValueError, match="tile"):
        adasum.pairwise_adasum(a, a, [(0, 2), (3, 3)])


def test_reference_is_the_jax_packages():
    rng = np.random.RandomState(3)
    xs = [rng.randn(12) for _ in range(4)]
    assert np.array_equal(adasum.adasum_reduce_reference(xs),
                          jax_adasum.adasum_reduce_reference(xs))


def _jax_allreduce(rows, segments=None, compression=JaxCompression.none):
    """``spmd.allreduce(op=ADASUM)`` with one row of ``rows`` a device;
    every device's result."""
    n = len(rows)
    mesh = Mesh(np.array(jax.devices()[:n]), ("r",))
    fn = jax.shard_map(
        lambda x: jax_spmd.allreduce(
            x[0], axis_name="r", op=JaxReduceOp.ADASUM,
            compression=compression, adasum_segments=segments)[None],
        mesh=mesh, in_specs=(P("r"),), out_specs=P("r"), check_vma=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(np.stack(rows))))


# -- 4 ranks over gloo --------------------------------------------------------

def _four_ranks(tmp, python_core: bool):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=adasum_worker,
                         args=(r, 4, str(tmp / "store"), str(tmp),
                               python_core))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0] * 4
    out = []
    for r in range(4):
        with open(tmp / f"adasum{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    want = "PyController" if python_core else "NativeController"
    assert [o["core"] for o in out] == [want] * 4
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 4 ranks on the default negotiation core (C++)."""
    return _four_ranks(tmp_path_factory.mktemp("adasum4"), False)


@pytest.fixture(scope="module")
def four_ranks_py(tmp_path_factory):
    """The same 4 ranks on the Python core."""
    return _four_ranks(tmp_path_factory.mktemp("adasum4py"), True)


def test_four_ranks_python_core_is_bitwise_the_native_core(four_ranks,
                                                            four_ranks_py):
    for native, py in zip(four_ranks, four_ranks_py):
        assert native["errors"] == py["errors"]
        assert sorted(native["res"]) == sorted(py["res"])
        for k, v in native["res"].items():
            assert v.tobytes() == py["res"][k].tobytes(), k


@pytest.mark.parametrize("key", ["world", "pair"])
def test_adasum_reduce_matches_jax_and_float64(four_ranks, key):
    members = ADASUM_SETS[key] or [0, 1, 2, 3]
    inputs = [adasum_inputs(r) for r in members]
    flats = [np.concatenate([x.reshape(-1) for x in xs]) for xs in inputs]
    segs = _segments([x.shape for x in inputs[0]])
    want = _jax_allreduce(flats)
    want_seg = _jax_allreduce(flats, segs)
    ref = adasum.adasum_reduce_reference(flats)
    ref_seg = np.concatenate([adasum.adasum_reduce_reference(
        [f[o:o + n] for f in flats]) for o, n in segs])
    first = four_ranks[members[0]]["res"]
    for r in members:
        res = four_ranks[r]["res"]
        # every member holds the same bits
        assert res[f"{key}/reduce"].tobytes() == \
            first[f"{key}/reduce"].tobytes()
        assert res[f"{key}/segments"].tobytes() == \
            first[f"{key}/segments"].tobytes()
        _close(res[f"{key}/reduce"], want[0], what=f"{key} rank {r}")
        _close(res[f"{key}/reduce"], ref, what=f"{key} float64")
        _close(res[f"{key}/segments"], want_seg[0], what=f"{key} segments")
        _close(res[f"{key}/segments"], ref_seg, what=f"{key} seg float64")


@pytest.mark.parametrize("key", ["world", "pair"])
def test_allreduce_adasum_sync_async_and_optimizer(four_ranks, key):
    members = ADASUM_SETS[key] or [0, 1, 2, 3]
    inputs = [adasum_inputs(r) for r in members]
    for i in range(len(inputs[0])):
        rows = [xs[i] for xs in inputs]
        want = _jax_allreduce(rows)[0]
        ref = adasum.adasum_reduce_reference(rows)
        for r in members:
            res = four_ranks[r]["res"]
            got = res[f"{key}/sync{i}"]
            assert got.shape == rows[0].shape and got.dtype == np.float32
            _close(got, want, what=f"{key} tensor {i} rank {r}")
            _close(got, ref, what=f"{key} tensor {i} float64")
            # the controller's per-tensor route and the optimizer's
            # tensor-by-tensor reduction run the same combine
            assert res[f"{key}/async{i}"].tobytes() == got.tobytes()
            assert res[f"{key}/opt{i}"].tobytes() == got.tobytes()
    f16 = _jax_allreduce([xs[0] for xs in inputs],
                         compression=JaxCompression.fp16)[0]
    for r in members:
        _close(four_ranks[r]["res"][f"{key}/fp16"], f16, ulp=2.0 ** -10,
               what=f"{key} fp16 wire")


def test_identical_and_orthogonal_across_four_ranks(four_ranks):
    same = adasum_inputs(0)[0]
    orth = np.concatenate([same[:8]] * 4)
    for r in range(4):
        res = four_ranks[r]["res"]
        assert res["world/ident"].tobytes() == same.tobytes()
        assert res["world/orth"].tobytes() == orth.tobytes()


def test_a_set_of_three_is_refused_as_the_reference_refuses_it(four_ranks):
    msg = "Adasum requires a power-of-two world size, got 3"
    with pytest.raises(ValueError, match=msg):
        _jax_allreduce([adasum_inputs(r)[0] for r in range(3)])
    for r in range(4):
        errors = four_ranks[r]["errors"]
        if r in ADASUM_SETS["three"]:
            assert errors["three_sync"] == ("ValueError", msg)
            assert errors["three_async"] == ("HorovodInternalError", msg)
        else:
            assert not errors


# -- a world of one, against the JAX torch frontend ---------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port and the JAX torch frontend, each in a world of one."""
    import horovod_tpu as hvt_mod
    import horovod_tpu.torch as ref_hvd

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVTPU_FLIGHT_DIR", str(tmp_path_factory.mktemp("flight")))
        mp.setenv("HVTPU_PALLAS_INTERPRET", "1")
        hvd.init(device="cpu")
        ref_hvd.init()
        try:
            yield hvd, ref_hvd
        finally:
            hvt_mod.shutdown()
            hvd.shutdown()


def test_world_of_one_identity_and_int8_refusal(both):
    import horovod_tpu as hvt_mod
    from horovod_tpu_torch.comm import eager

    port, ref = both
    assert int(port.Adasum) == int(ref.Adasum) == int(ReduceOp.ADASUM)
    x = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    for h in both:
        got = h.allreduce(torch.from_numpy(x), op=h.Adasum,
                          prescale_factor=2.0, postscale_factor=0.25)
        assert got.numpy().tobytes() == (x * np.float32(0.5)).tobytes()
        out = h.synchronize(h.allreduce_async(torch.from_numpy(x),
                                              op=h.Adasum, name="one"))
        assert out.numpy().tobytes() == x.tobytes()
    errors = []
    for fn in (lambda: eager.allreduce(torch.from_numpy(x),
                                       op=ReduceOp.ADASUM,
                                       compression=Engine.int8),
               lambda: hvt_mod.allreduce(jnp.asarray(x),
                                         op=hvt_mod.Adasum,
                                         compression=JaxCompression.int8)):
        with pytest.raises(ValueError) as e:
            fn()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_world_of_one_optimizer_adasum_matches_jax_frontend(both):
    batches = synthetic_batches(3)
    params = []
    for h in both:
        model = narrow_resnet()
        opt = h.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(), op=h.Adasum)
        for x, y in batches:
            opt.zero_grad()
            torch.nn.functional.cross_entropy(
                model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
            opt.step()
        params.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*params):
        assert a.numpy().tobytes() == b.numpy().tobytes()

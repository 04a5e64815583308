"""Average over a rank count that is not a power of two, against the JAX
package on a 3-device mesh.

XLA compiles ``spmd.allreduce``'s ``out / n`` and ``quantized_allreduce``'s
``out / n_ranks`` to a multiply by the reciprocal (float32 ``1/3`` for
float32 and, computed in float32, for bfloat16; float16 ``1/3`` for
float16).  At 3 ranks that differs from ``sum / 3`` in about a third of
the elements.  Three gloo ranks of the port run ``allreduce(op=Average)``
in float32/bfloat16/float16 (inputs whose partial sums are exact, so the
two summation orders agree and only the scaling is compared), int32
(floor division), int8 compression and ``quantized_allreduce(average=
True)``, and ``reducescatter(op=Average)``; each is held bitwise against
``horovod_tpu.comm.spmd`` / ``horovod_tpu.comm.quantized`` in
``jax.shard_map`` over 3 CPU devices.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.comm import compression as jax_compression
from horovod_tpu.comm import spmd as jax_spmd
from horovod_tpu.comm.quantized import quantized_allreduce as jax_quantized
from horovod_tpu.comm.reduce_ops import ReduceOp as JaxReduceOp
from torch_port_util import average_inputs, average_worker
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

RANKS = 3


@pytest.fixture(scope="module")
def three_rank_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("average")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=average_worker,
                         args=(r, RANKS, str(tmp / "store"), str(tmp)))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0] * RANKS
    return [dict(np.load(tmp / f"avg{r}.npz")) for r in range(RANKS)]


def _per_rank(key, dtype=None):
    arrs = [jnp.asarray(average_inputs(r)[key]) for r in range(RANKS)]
    return jnp.stack([a.astype(dtype) if dtype else a for a in arrs])


def _shard_map(body, stacked):
    mesh = Mesh(np.asarray(jax.devices()[:RANKS], dtype=object), ("i",))
    out = jax.jit(jax.shard_map(lambda xs: body(xs[0])[None], mesh=mesh,
                                in_specs=(P("i"),), out_specs=P("i"),
                                check_vma=False))(stacked)
    return np.asarray(out.astype(jnp.float32) if jnp.issubdtype(
        out.dtype, jnp.floating) else out)


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.itemsize])


def _assert_ranks_equal(results, key, want):
    for r in range(RANKS):
        np.testing.assert_array_equal(_bits(results[r][key]), _bits(want[r]),
                                      err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("name,dtype", [
    ("f32", jnp.float32), ("bf16", jnp.bfloat16), ("f16", jnp.float16)])
def test_three_rank_average_matches_spmd(three_rank_results, name, dtype):
    stacked = _per_rank("exact", dtype)
    want = _shard_map(lambda x: jax_spmd.allreduce(
        x, axis_name="i", op=JaxReduceOp.AVERAGE), stacked)
    _assert_ranks_equal(three_rank_results, f"avg_{name}", want)
    if name != "bf16":
        # the test can tell the two scalings apart: the sum divided by 3
        # (the port before this repair) differs somewhere
        total = np.asarray(stacked.astype(jnp.float32).sum(0)).astype(
            np.dtype(dtype))
        divided = (total / np.asarray(RANKS, total.dtype)).astype(np.float32)
        assert (divided != want[0]).any()


def test_three_rank_integer_average_floor_divides(three_rank_results):
    stacked = _per_rank("ints")
    want = _shard_map(lambda x: jax_spmd.allreduce(
        x, axis_name="i", op=JaxReduceOp.AVERAGE), stacked)
    assert want.dtype == np.int32
    for r in range(RANKS):
        got = three_rank_results[r]["avg_int"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[r])
    np.testing.assert_array_equal(want[0], np.asarray(stacked).sum(0) // 3)


def test_three_rank_int8_average_matches_spmd(three_rank_results):
    want = _shard_map(lambda x: jax_spmd.allreduce(
        x, axis_name="i", op=JaxReduceOp.AVERAGE,
        compression=jax_compression.Compression.int8), _per_rank("int8"))
    _assert_ranks_equal(three_rank_results, "avg_int8", want)


def test_three_rank_quantized_average_matches_jax(three_rank_results):
    want = _shard_map(lambda x: jax_quantized(x, axis_name="i",
                                              average=True),
                      _per_rank("int8"))
    _assert_ranks_equal(three_rank_results, "quantized_avg", want)


def test_three_rank_reducescatter_average_matches_spmd(three_rank_results):
    want = _shard_map(lambda x: jax_spmd.reducescatter(
        x, axis_name="i", op=JaxReduceOp.AVERAGE), _per_rank("rs"))
    _assert_ranks_equal(three_rank_results, "rs_avg", want)

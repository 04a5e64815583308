"""The torch surface's collectives (``horovod_tpu_torch/torch/mpi_ops.py``)
against the JAX package's torch frontend (``horovod_tpu/torch/mpi_ops.py``)
on the CPU.

* World size 1: each of the six autograd Functions (allreduce, grouped
  allreduce with a grad-free member, allgather, broadcast, alltoall with
  equal and given splits, reducescatter) gives the reference's forward
  and the input's ``.grad`` after the backward of a weighted sum,
  **bitwise**, through the reference's positional signatures as well.
  The reference's Pallas kernels run in interpret mode.
* The codec mapping: every surface and engine codec maps onto the engine
  codec of the same name as the reference's ``_engine_compression``.
* Two ranks over gloo: the backward of allreduce (Sum, Average),
  allgather with ragged rows, broadcast from rank 1, reducescatter over
  an uneven dim 0 (Sum, Average) and alltoall with splits equal the
  reference's adjoints written out in numpy, bitwise (every sum has two
  terms, exact in either order).  A bfloat16 tensor under the surface's
  ``Compression.fp16`` crosses an fp16 wire: bitwise
  ``horovod_tpu.comm.spmd.allreduce`` with the engine's fp16 codec on a
  2-device CPU mesh, and unlike the bfloat16 wire; the engine's int8
  codec passed to the surface maps to ``none``.
* The int8 kernels' plain versions at the edges of the kernels' layout
  (a lane's word, half and whole blocks, a block plus one, a word past a
  block, inputs at odd offsets), bitwise the Pallas reference in
  interpret mode.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.comm import compression as jax_compression
from horovod_tpu.comm import spmd as jax_spmd
from horovod_tpu.comm.reduce_ops import ReduceOp as JaxReduceOp
from horovod_tpu.ops import dequantize_int8_blocks as jax_dequantize
from horovod_tpu.ops import quantize_int8_blocks as jax_quantize
from horovod_tpu_torch.comm.compression import Compression as EngineCompression
from horovod_tpu_torch.ops import (
    dequantize_int8_blocks,
    dequantize_int8_blocks_plain,
    quantize_int8_blocks,
    quantize_int8_blocks_plain,
)
from horovod_tpu_torch.torch import mpi_ops
from torch_port_util import (
    A2A_SPLITS,
    MPI_ROOT,
    mpi_ops_inputs,
    mpi_ops_worker,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)


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


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind in "iub":      # integers; floats and bfloat16 by bits
        return a
    return a.view({4: np.uint32, 2: np.uint16}[a.itemsize])


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


# -- world size 1 against the JAX torch frontend -------------------------------

def _arrays(seed: int, *shapes):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 3).astype(np.float32) for s in shapes]


# name: (input shapes, dtype, the call on the hvd module h and the leaves)
CASES = {
    "allreduce_sum": ([(6, 5)], torch.float32,
                      lambda h, x: h.allreduce(x, op=h.Sum)),
    "allreduce_default_average": ([(6, 5)], torch.float32,
                                  lambda h, x: h.allreduce(x)),
    "allreduce_scaled": ([(33,)], torch.float32,
                         lambda h, x: h.allreduce(x, op=h.Sum,
                                                  prescale_factor=0.5,
                                                  postscale_factor=4.0)),
    "allreduce_bf16_scaled": ([(33,)], torch.bfloat16,
                              lambda h, x: h.allreduce(
                                  x, op=h.Average, prescale_factor=3.0,
                                  postscale_factor=0.7)),
    "allreduce_positional_average": ([(4, 3)], torch.float32,
                                     lambda h, x: h.allreduce(x, True)),
    "allreduce_positional_codec": ([(4, 3)], torch.float32,
                                   lambda h, x: h.allreduce(
                                       x, False, "n", h.Compression.fp16)),
    "grouped_allreduce_mixed": (
        [(5, 3), (4,), (2, 2)], torch.float32,
        lambda h, a, b, c: h.grouped_allreduce(
            [a, b.detach(), c], None, "g", h.Compression.none, h.Sum)),
    "allgather": ([(5, 4)], torch.float32,
                  lambda h, x: h.allgather(x, "g")),
    "broadcast_positional": ([(7,)], torch.float32,
                             lambda h, x: h.broadcast(x, 0, "n")),
    "alltoall_equal": ([(6, 3)], torch.float32, lambda h, x: h.alltoall(x)),
    "alltoall_splits": ([(6, 3)], torch.float32,
                        lambda h, x: h.alltoall(x, [6], "n")),
    "reducescatter_sum": ([(5, 3)], torch.float32,
                          lambda h, x: h.reducescatter(x, h.Sum, "n")),
    "reducescatter_average": ([(4, 2)], torch.float32,
                              lambda h, x: h.reducescatter(x, h.Average)),
}


def _run(h, name):
    """[forward outputs..., grads of the leaves...] of one case, the
    backward of sum(out * w) over the differentiable outputs."""
    shapes, dtype, call = CASES[name]
    seed = sum(map(ord, name))
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in _arrays(seed, *shapes)]
    out = call(h, *leaves)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    rng = np.random.RandomState(seed + 1)
    loss = 0
    for o in outs:
        if o.requires_grad:
            w = torch.from_numpy(rng.randn(*o.shape).astype(np.float32))
            loss = loss + (o * w.to(o.dtype)).sum()
    loss.backward()
    grads = [x.grad for x in leaves if x.grad is not None]
    return outs, grads


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_forward_and_grad_match_jax_frontend(both, name):
    port, ref = both
    outs, grads = _run(port, name)
    ref_outs, ref_grads = _run(ref, name)
    assert len(outs) == len(ref_outs) and len(grads) == len(ref_grads)
    assert grads, "no gradient reached the inputs"
    for got, want in zip(outs + grads, ref_outs + ref_grads):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))
    assert [o.requires_grad for o in outs] == \
        [o.requires_grad for o in ref_outs]


@pytest.mark.parametrize("op", ["Min", "Max", "Product"])
def test_grad_of_a_non_sum_allreduce_is_refused(both, op):
    for h in both:
        y = h.allreduce(torch.ones(3, requires_grad=True), op=getattr(h, op))
        with pytest.raises(NotImplementedError):
            y.sum().backward()


def test_in_place_ops_take_positional_arguments(both):
    for h in both:
        t = torch.arange(6.0)
        assert h.allreduce_(t, False, "n") is t
        assert h.broadcast_(t, 0, "n") is t
        assert torch.equal(t, torch.arange(6.0))
    ts = [torch.ones(2), torch.arange(3.0)]
    assert hvd.grouped_allreduce_(ts, False) is ts
    assert torch.equal(ts[1], torch.arange(3.0))


@pytest.mark.parametrize("surface,codec", [
    ("surface", "none"), ("surface", "fp16"), ("surface", "bf16"),
    ("engine", "none"), ("engine", "fp16"), ("engine", "bf16"),
    ("engine", "int8"), ("engine", "int8_stochastic")])
def test_codec_mapping_matches_reference(surface, codec):
    from horovod_tpu.torch import compression as ref_surface
    from horovod_tpu.torch.mpi_ops import _engine_compression

    if surface == "surface":
        got = mpi_ops.engine_compression(getattr(hvd.Compression, codec))
        want = _engine_compression(getattr(ref_surface.Compression, codec))
    else:
        got = mpi_ops.engine_compression(getattr(EngineCompression, codec))
        want = _engine_compression(
            getattr(jax_compression.Compression, codec))
    names = {"NoneCompressor": "none", "FP16Compressor": "fp16",
             "BF16Compressor": "bf16"}
    assert got is getattr(EngineCompression, names[want.__name__])


def test_optimizer_uses_the_surface_mapping():
    from horovod_tpu_torch.torch import optimizer

    assert optimizer.engine_compression is mpi_ops.engine_compression


# -- two ranks over gloo -------------------------------------------------------

@pytest.fixture(scope="module")
def two_rank(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mpi_ops")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mpi_ops_worker,
                         args=(r, 2, str(tmp / "store"), str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0, 0]
    return [dict(np.load(tmp / f"mpi{r}.npz")) for r in range(2)]


def _of(key):
    return [mpi_ops_inputs(r)[key] for r in range(2)]


def _same(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)),
                                  err_msg=what)


def test_two_rank_allreduce_grads_are_the_reference_adjoint(two_rank):
    x, ws, wa = _of("x"), _of("w_sum"), _of("w_avg")
    for r, res in enumerate(two_rank):
        _same(res["allreduce_sum"], x[0] + x[1], f"forward rank {r}")
        _same(res["grad_allreduce_sum"], ws[0] + ws[1], f"Sum rank {r}")
        _same(res["allreduce_avg"], (x[0] + x[1]) / 2, f"forward rank {r}")
        _same(res["grad_allreduce_avg"], (wa[0] + wa[1]) / 2,
              f"Average rank {r}")


def test_two_rank_allgather_grad_slices_this_ranks_rows(two_rank):
    g, w = _of("gather"), _of("w_gather")
    summed = w[0] + w[1]
    offsets = [0, len(g[0])]
    for r, res in enumerate(two_rank):
        _same(res["allgather"], np.concatenate(g), f"forward rank {r}")
        _same(res["grad_allgather"],
              summed[offsets[r]:offsets[r] + len(g[r])], f"rank {r}")


def test_two_rank_broadcast_grad_reaches_the_root_only(two_rank):
    b, w = _of("bcast"), _of("w_bcast")
    for r, res in enumerate(two_rank):
        _same(res["bcast"], b[MPI_ROOT], f"forward rank {r}")
        want = w[0] + w[1] if r == MPI_ROOT else np.zeros_like(w[0])
        _same(res["grad_bcast"], want, f"rank {r}")


def test_two_rank_reducescatter_grad_allgathers(two_rank):
    x = _of("rs")
    rows = [slice(0, 3), slice(3, 5)]    # uneven: rank 0 takes the extra
    for name in ("sum", "avg"):
        w = _of(f"w_rs_{name}")
        gathered = np.concatenate(w)
        total = x[0] + x[1]
        for r, res in enumerate(two_rank):
            fwd = total[rows[r]] if name == "sum" else total[rows[r]] / 2
            _same(res[f"rs_{name}"], fwd, f"forward {name} rank {r}")
            _same(res[f"grad_rs_{name}"],
                  gathered if name == "sum" else gathered / 2,
                  f"{name} rank {r}")


def test_two_rank_alltoall_grad_returns_rows_to_senders(two_rank):
    w = _of("w_a2a")
    for r, res in enumerate(two_rank):
        parts = []
        for t in range(2):
            # the rows rank r sent to rank t sit in t's output after
            # those of the ranks before r
            at = sum(A2A_SPLITS[s][t] for s in range(r))
            parts.append(w[t][at:at + A2A_SPLITS[r][t]])
        _same(res["grad_a2a"], np.concatenate(parts), f"rank {r}")


def _spmd_allreduce(per_rank, op, comp):
    mesh = Mesh(np.asarray(jax.devices()[:2], dtype=object), ("i",))

    def body(xs):
        return jax_spmd.allreduce(xs[0], axis_name="i", op=op,
                                  compression=comp)[None]

    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("i"),),
                                out_specs=P("i"), check_vma=False))(
        jnp.stack(per_rank))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("name,op", [("sum", JaxReduceOp.SUM),
                                     ("avg", JaxReduceOp.AVERAGE)])
def test_two_rank_bf16_under_fp16_crosses_an_fp16_wire(two_rank, name, op):
    per_rank = [jnp.asarray(a).astype(jnp.bfloat16) for a in _of("wire")]
    want = _spmd_allreduce(per_rank, op, jax_compression.Compression.fp16)
    for r, res in enumerate(two_rank):
        _same(res[f"fp16_wire_{name}"], want[r], f"rank {r}")
    if name == "sum":
        # the bfloat16 wire (the surface's cast codec before the repair)
        # gives other bits
        assert (_bits(two_rank[0]["fp16_wire_sum"])
                != _bits(two_rank[0]["bf16_wire_sum"])).any()


def test_two_rank_engine_codec_on_the_surface_maps_to_none(two_rank):
    x = _of("x")
    for r, res in enumerate(two_rank):
        _same(res["engine_int8_sum"], x[0] + x[1], f"rank {r}")


# -- the int8 kernels' plain versions at the edges of the kernels' layout -----

# a lane's word of 16-bit inputs (8), half a block (a lane's words of
# float32 cover 128 elements a warp step), a block, a block plus one and
# plus a word, two blocks less one
EDGE_LENGTHS = [8, 9, 128, 511, 512, 1023, 1024, 1025, 1032, 2047]


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


def _edge_input(n: int, offset: int, key: str):
    rng = np.random.RandomState(n * 7 + offset)
    mag = 10.0 ** rng.uniform(-40, 10, size=n + offset)
    a = (rng.randn(n + offset) * mag).astype(np.float32)
    t_dt = {"f32": torch.float32, "bf16": torch.bfloat16}[key]
    j_dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[key]
    # the port takes a view at the offset, as a bucket piece is
    return torch.from_numpy(a).to(t_dt)[offset:], jnp.asarray(
        a[offset:]).astype(j_dt)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("key", ["f32", "bf16"])
@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_int8_edges_match_pallas_bitwise(interpret_mode, n, key, offset):
    x, jx = _edge_input(n, offset, key)
    q, s, m = quantize_int8_blocks(x)
    jq, js, jn = jax_quantize(jx)
    assert m == jn == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), _bits(np.asarray(js)))
    for t_dt, j_dt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_int8_blocks(q, s, m, t_dt)
        want = jax_dequantize(jq, js, jn, dtype=j_dt)
        np.testing.assert_array_equal(_np(got), _bits(np.asarray(want)))


def test_int8_wrappers_refuse_other_devices():
    x = torch.zeros(1025, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quantize_int8_blocks(x)
    q = torch.zeros((16, 128), dtype=torch.int8, device="meta")
    s = torch.zeros((2, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dequantize_int8_blocks(q, s, 1025)
    before = quantize_int8_blocks.launches
    quantize_int8_blocks_plain(torch.zeros(3))
    dequantize_int8_blocks_plain(torch.zeros((8, 128), dtype=torch.int8),
                                 torch.ones((1, 1)), 3)
    assert quantize_int8_blocks.launches == before

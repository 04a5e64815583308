"""The second slice of the PyTorch port on the CPU: the engine's int8
wire against the JAX package.

* Kernels A2/A3: the plain versions ``quantize_int8_blocks_plain`` /
  ``dequantize_int8_blocks_plain`` (what the wrappers take for a CPU
  tensor; the CUDA kernels are held bitwise against them on the card by
  ``chip_smoke.py``) are **bitwise** equal to
  ``horovod_tpu.ops.quantize_int8_blocks`` / ``dequantize_int8_blocks``
  run through their Pallas bodies in interpret mode (as
  ``tests/test_pallas_ops.py`` runs them): codes, scale bits and
  dequantized bits, for float32/bfloat16/float16 in and out, lengths
  1..40000 (40000 crosses a 256-row tile, so the reference's
  main + remainder split runs) and the NaN/inf/zero/subnormal blocks.
* The engine codecs are bitwise those of
  ``horovod_tpu.comm.compression.Compression`` (wire dtype and shape,
  context, round trip), and the payload fold of ``_stochastic_seed`` is
  bitwise the JAX one with the call counter set alike.
* Stochastic rounding: JAX off the TPU rounds deterministically
  (``pallas_ops.py:244-249``), so the port is held to the TPU's
  semantics instead: codes within 1 of the deterministic ones, error
  below one scale a block, mean error over 2**18 elements within 0.01
  scale of 0 (the mean of 2**18 terms each within (-1, 1) has a
  standard deviation below 0.002).
* Two ranks over gloo: ``allreduce(compression=int8)`` Sum and Average
  are **bitwise** ``horovod_tpu.comm.spmd.allreduce(compression=int8)``
  in ``jax.shard_map`` over a 2-device CPU mesh on the same per-rank
  inputs; ``int8_stochastic`` is within the error bound of
  ``test_fusion_compression.py`` and bitwise equal on both ranks; the
  other collectives equal numpy (float32 sums of two terms are exact in
  either order, so bitwise).
"""

import itertools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.comm import compression as jax_compression
from horovod_tpu.comm import spmd as jax_spmd
from horovod_tpu.comm.reduce_ops import ReduceOp as JaxReduceOp
from horovod_tpu.ops import dequantize_int8_blocks as jax_dequantize
from horovod_tpu.ops import quantize_int8_blocks as jax_quantize
import horovod_tpu_torch as hvd
from horovod_tpu_torch.comm import compression
from horovod_tpu_torch.comm import eager
from horovod_tpu_torch.comm.reduce_ops import Adasum
from horovod_tpu_torch.ops import quantize as quantize_mod
from horovod_tpu_torch.ops import (
    dequantize_int8_blocks,
    dequantize_int8_blocks_plain,
    quantize_int8_blocks,
    quantize_int8_blocks_plain,
)
from torch_port_util import (
    A2A_SPLITS,
    collective_inputs,
    collectives_worker,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

DTYPES = {
    "f32": (torch.float32, jnp.float32),
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "f16": (torch.float16, jnp.float16),
}
FLT_MIN = np.float32(2.0 ** -126)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


def _inputs(n: int, seed: int) -> np.ndarray:
    """float32 values over 50 decades, subnormals included."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-40, 10, size=n)
    return (rng.randn(n) * mag).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


def _assert_same(got: np.ndarray, want: np.ndarray, what: str = ""):
    """Bitwise, with any NaN equal to any NaN (torch and XLA give NaN
    other bits when they narrow it)."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    ok = ~np.isnan(g)
    np.testing.assert_array_equal(_bits(g[ok]), _bits(w[ok]), err_msg=what)


def _quantize_both(a: np.ndarray, key: str):
    t_dt, j_dt = DTYPES[key]
    q, s, n = quantize_int8_blocks_plain(torch.from_numpy(a).to(t_dt))
    jq, js, jn = jax_quantize(jnp.asarray(a).astype(j_dt))
    assert n == jn == a.size
    assert tuple(q.shape) == jq.shape and tuple(s.shape) == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _assert_same(s.numpy(), js)
    return (q, s, n), (jq, js, jn)


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 3000, 40000])
@pytest.mark.parametrize("in_key", list(DTYPES))
def test_plain_quantize_matches_pallas_bitwise(interpret_mode, n, in_key):
    _quantize_both(_inputs(n, seed=n), in_key)


@pytest.mark.parametrize("n", [1, 1025, 40000])
@pytest.mark.parametrize("out_key", list(DTYPES))
def test_plain_dequantize_matches_pallas_bitwise(interpret_mode, n, out_key):
    (q, s, m), (jq, js, jn) = _quantize_both(_inputs(n, seed=n + 1), "f32")
    t_dt, j_dt = DTYPES[out_key]
    got = dequantize_int8_blocks_plain(q, s, m, t_dt)
    want = jax_dequantize(jq, js, jn, dtype=j_dt)
    assert got.dtype == t_dt and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(_tbits(got), _bits(want))


def _block(vals) -> np.ndarray:
    a = np.zeros(1024, np.float32)
    a[:len(vals)] = np.asarray(vals, np.float32)
    return a


SPECIAL = {
    "nan": _block([1.0, np.nan, 2.0, -3.0]),
    "inf": _block([1.0, np.inf, 2.0]),
    "neg_inf": _block([1.0, -np.inf, 2.0]),
    "zero": _block([]),
    "subnormal_absmax": _block([3e-39, -2e-39, 1e-39]),
    # scale FLT_MIN: 1.1e-38 is subnormal and must give code 0, not 1
    "scale_flt_min": _block([FLT_MIN * np.float32(127.0), 1.1e-38, 1e-37]),
    "scale_subnormal": _block([1e-37, -5e-38]),
    "ties": _block([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]),
}


@pytest.mark.parametrize("case", list(SPECIAL))
def test_special_blocks_match_pallas(interpret_mode, case):
    # the special block between two ordinary ones
    rng = np.random.RandomState(9)
    a = np.concatenate([rng.randn(1024), SPECIAL[case], rng.randn(700)]
                       ).astype(np.float32)
    (q, s, n), (jq, js, jn) = _quantize_both(a, "f32")
    for key in DTYPES:
        t_dt, j_dt = DTYPES[key]
        got = dequantize_int8_blocks_plain(q, s, n, t_dt)
        want = jax_dequantize(jq, js, jn, dtype=j_dt)
        assert got.dtype == t_dt
        _assert_same(got.float().numpy(), np.asarray(want), key)
    if case in ("nan", "inf", "neg_inf", "zero", "subnormal_absmax",
                "scale_subnormal"):
        assert not q.reshape(-1, 1024)[1].any()


def test_wrappers_take_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_inputs(5000, seed=3))
    before = (quantize_int8_blocks.launches, dequantize_int8_blocks.launches)
    q, s, n = quantize_int8_blocks(x)
    pq, ps, _ = quantize_int8_blocks_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    sq, _, _ = quantize_int8_blocks(x, stochastic=True,
                                    seed=torch.tensor(7, dtype=torch.int32))
    assert torch.equal(sq, quantize_int8_blocks_plain(x, stochastic=True,
                                                      seed=7)[0])
    out = dequantize_int8_blocks(q, s, n, torch.bfloat16)
    assert torch.equal(out, dequantize_int8_blocks_plain(q, s, n,
                                                         torch.bfloat16))
    assert (quantize_int8_blocks.launches,
            dequantize_int8_blocks.launches) == before   # no kernel
    with pytest.raises(ValueError):
        dequantize_int8_blocks(q[:5], s, n)


def _dither_bits_reference(key: int, ctr: int) -> int:
    """The kernel's uint32 ``dither_bits`` in Python integers."""
    def mix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    key &= 0xFFFFFFFF
    ctr &= 0xFFFFFFFF
    return mix(mix((ctr * 0x9E3779B1 + key) & 0xFFFFFFFF) ^ key)


def test_dither_bits_match_uint32_arithmetic():
    keys = [0, 1, -1, 0x7FFFFFFF, -(2 ** 31), 123456789]
    ctrs = [0, 1, 2, 1023, 1024, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32]
    got = quantize_mod.dither_bits(
        torch.tensor(keys)[:, None], torch.tensor(ctrs)[None, :])
    want = [[_dither_bits_reference(k, c) for c in ctrs] for k in keys]
    assert got.tolist() == want
    u = quantize_mod.uniform(torch.tensor(5), 1 << 16)
    assert u.dtype == torch.float32 and 0.0 <= float(u.min())
    assert float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01


def test_stochastic_plain_is_unbiased_and_within_one_code():
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.randn(1 << 18) * 3).astype(np.float32))
    q, s, n = quantize_int8_blocks_plain(x)
    sq, ss, _ = quantize_int8_blocks_plain(x, stochastic=True, seed=12345)
    assert torch.equal(s, ss)
    assert int((sq.int() - q.int()).abs().max()) == 1
    scale = s.reshape(-1, 1)
    xb = x.reshape(-1, 1024)
    det = dequantize_int8_blocks_plain(q, s, n).reshape(-1, 1024)
    sto = dequantize_int8_blocks_plain(sq, ss, n).reshape(-1, 1024)
    assert bool(((det - xb).abs() <= scale / 2 * (1 + 1e-6)).all())
    assert bool(((sto - xb).abs() <= scale * (1 + 1e-6)).all())
    assert abs(float(((sto - xb) / scale).mean())) < 0.01
    other, _, _ = quantize_int8_blocks_plain(x, stochastic=True, seed=54321)
    assert not torch.equal(other, sq)       # the seed moves the dither


# -- the engine codecs ---------------------------------------------------------

@pytest.mark.parametrize("name", ["none", "fp16", "bf16", "int8"])
@pytest.mark.parametrize("key", ["f32", "bf16", "f16", "i32"])
def test_engine_codec_matches_jax(interpret_mode, name, key):
    rng = np.random.RandomState(4)
    a = (rng.randn(33, 70) * 50).astype(np.float32)
    if key == "i32":
        t, j = torch.from_numpy(a.astype(np.int32)), jnp.asarray(a, jnp.int32)
    else:
        t_dt, j_dt = DTYPES[key]
        t, j = torch.from_numpy(a).to(t_dt), jnp.asarray(a).astype(j_dt)
    ours = getattr(compression.Compression, name)
    ref = getattr(jax_compression.Compression, name)
    assert ours is compression.Compression.from_name(name)
    wire, ctx = ours.compress(t)
    r_wire, r_ctx = ref.compress(j)
    assert tuple(wire.shape) == r_wire.shape
    np.testing.assert_array_equal(_tbits(wire), _bits(r_wire))
    assert str(ours.wire_dtype(t.dtype)).replace("torch.", "") == \
        jnp.dtype(ref.wire_dtype(j.dtype)).name
    if name == "int8" and key != "i32":
        dtype, shape, n, scale = ctx
        r_dtype, r_shape, r_n, r_scale = r_ctx
        assert (shape, n) == (tuple(r_shape), r_n)
        assert str(dtype).replace("torch.", "") == jnp.dtype(r_dtype).name
        np.testing.assert_array_equal(_bits(scale.numpy()), _bits(r_scale))
    elif ctx is None:
        assert r_ctx is None
    else:
        assert str(ctx).replace("torch.", "") == jnp.dtype(r_ctx).name
    back = ours.decompress(wire, ctx)
    r_back = ref.decompress(r_wire, r_ctx)
    assert back.dtype == t.dtype and tuple(back.shape) == r_back.shape
    np.testing.assert_array_equal(_tbits(back), _bits(r_back))


def test_from_name_rejects_unknown():
    assert (compression.Compression.from_name("int8_stochastic")
            is compression.Int8StochasticCompressor)
    with pytest.raises(ValueError):
        compression.Compression.from_name("int4")
    with pytest.raises(ValueError):
        jax_compression.Compression.from_name("int4")


@pytest.mark.parametrize("key", ["f32", "bf16", "f16"])
def test_stochastic_seed_fold_matches_jax(monkeypatch, key):
    a = (np.random.RandomState(6).randn(5000) * 7).astype(np.float32)
    t_dt, j_dt = DTYPES[key]
    monkeypatch.setattr(compression, "_STOCH_CALL_COUNTER",
                        itertools.count(41))
    monkeypatch.setattr(jax_compression, "_STOCH_CALL_COUNTER",
                        itertools.count(41))
    t, j = torch.from_numpy(a).to(t_dt), jnp.asarray(a).astype(j_dt)
    for _ in range(3):        # the counter advances alike on both sides
        got = compression._stochastic_seed(t)
        want = jax_compression._stochastic_seed(j)
        assert got.dtype == torch.int32
        assert int(got) == int(want)
    assert int(compression._payload_fold(t)) == int(
        compression._stochastic_seed(t)) ^ (
        (0 ^ (44 * 0x9E3779B1)) & 0x7FFFFFFF)


def test_int8_stochastic_codec_round_trip():
    x = torch.from_numpy((np.random.RandomState(8).randn(3000) * 2)
                         .astype(np.float32))
    codec = compression.Compression.int8_stochastic
    wire, ctx = codec.compress(x)
    again, _ = codec.compress(x)
    assert wire.dtype == torch.int8 and tuple(wire.shape) == (3, 1024)
    assert not torch.equal(wire, again)     # a new call counter, new dither
    back = codec.decompress(wire, ctx)
    scale = ctx[3].reshape(-1).repeat_interleave(1024)[:3000]
    assert bool(((back - x).abs() <= scale * (1 + 1e-6)).all())


# -- world size 1 --------------------------------------------------------------

@pytest.fixture
def port_cpu():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("codec", ["int8", "int8_stochastic", "fp16"])
def test_allreduce_world_of_one_skips_compression(port_cpu, codec):
    x = torch.from_numpy(_inputs(3000, seed=2)).reshape(30, 100)
    before = quantize_int8_blocks.launches
    got = eager.allreduce(x, op=hvd.Average, prescale_factor=0.5,
                          postscale_factor=3.0,
                          compression=getattr(compression.Compression, codec))
    assert torch.equal(got, x * torch.tensor(1.5))
    same = eager.allreduce(x, compression=compression.Compression.int8)
    assert torch.equal(same, x) and same.data_ptr() != x.data_ptr()
    assert quantize_int8_blocks.launches == before
    with pytest.raises(ValueError, match="Adasum"):
        eager.allreduce(x, op=Adasum,
                        compression=compression.Compression.int8)


# -- two ranks over gloo -------------------------------------------------------

@pytest.fixture(scope="module")
def two_rank_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=collectives_worker,
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
    return [dict(np.load(tmp / f"coll{r}.npz")) for r in range(2)]


def _inputs_of(key):
    return [collective_inputs(r)[key] for r in range(2)]


def _spmd_allreduce(per_rank, op, comp, **scales):
    mesh = Mesh(np.asarray(jax.devices()[:2], dtype=object), ("i",))

    def body(xs):
        return jax_spmd.allreduce(xs[0], axis_name="i", op=op,
                                  compression=comp, **scales)[None]

    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("i"),),
                                out_specs=P("i"), check_vma=False))(
        jnp.stack(per_rank))
    return np.asarray(out)


@pytest.mark.parametrize("name,op,scales", [
    ("int8_sum", JaxReduceOp.SUM, {}),
    ("int8_avg", JaxReduceOp.AVERAGE, {}),
    ("int8_scaled", JaxReduceOp.SUM,
     dict(prescale_factor=0.5, postscale_factor=3.0)),
])
def test_two_rank_int8_allreduce_matches_spmd(two_rank_results, name, op,
                                              scales):
    want = _spmd_allreduce([jnp.asarray(a) for a in _inputs_of("int8")], op,
                           jax_compression.Compression.int8, **scales)
    for r in range(2):
        np.testing.assert_array_equal(_bits(two_rank_results[r][name]),
                                      _bits(want[r]), err_msg=f"rank {r}")


def test_two_rank_int8_bf16_average_matches_spmd(two_rank_results):
    per_rank = [jnp.asarray(a).astype(jnp.bfloat16)
                for a in _inputs_of("int8_bf16")]
    want = _spmd_allreduce(per_rank, JaxReduceOp.AVERAGE,
                           jax_compression.Compression.int8)
    for r in range(2):
        np.testing.assert_array_equal(
            two_rank_results[r]["int8_bf16"],
            want[r].astype(np.float32), err_msg=f"rank {r}")


def test_two_rank_int8_stochastic(two_rank_results):
    r0, r1 = two_rank_results
    x = np.stack(_inputs_of("int8"))
    want = x.sum(0)
    np.testing.assert_array_equal(_bits(r0["int8_stoch"]),
                                  _bits(r1["int8_stoch"]))
    # floor(x+u) errors are <= 1 scale unit per rank per phase
    amax = np.abs(x).max()
    assert np.abs(r0["int8_stoch"] - want).max() <= (2 + 1) * 2 * amax / 127
    assert not np.array_equal(r0["int8_stoch"], r0["int8_sum"])


def test_two_rank_fp16_and_grouped_allreduce(two_rank_results):
    for res in two_rank_results:
        a = _inputs_of("int8")
        want = ((a[0].astype(np.float16) + a[1].astype(np.float16))
                .astype(np.float32) / 2)
        np.testing.assert_array_equal(res["fp16_avg"], want)
        for key in ("group_a", "group_b", "group_c"):
            x = _inputs_of(key)
            assert res[key].dtype == x[0].dtype
            np.testing.assert_array_equal(res[key], x[0] + x[1])
        mx = [np.maximum(*_inputs_of(k)).reshape(-1)
              for k in ("group_a", "group_c")]
        np.testing.assert_array_equal(res["group_max"], np.concatenate(mx))


def test_two_rank_allgather_and_alltoall(two_rank_results):
    g = _inputs_of("gather")
    a = _inputs_of("a2a")
    for r, res in enumerate(two_rank_results):
        np.testing.assert_array_equal(res["gather"], np.concatenate(g))
        # rank r receives rows A2A_SPLITS[s][r] from each sender s
        parts = []
        for s in range(2):
            off = sum(A2A_SPLITS[s][:r])
            parts.append(a[s][off:off + A2A_SPLITS[s][r]])
        np.testing.assert_array_equal(res["a2a"], np.concatenate(parts))
        assert res["a2a_splits"].tolist() == [A2A_SPLITS[s][r]
                                              for s in range(2)]
        assert res["a2a_splits"].dtype == np.int32
        np.testing.assert_array_equal(
            res["a2a_equal"], np.concatenate([a[0][3 * r:3 * r + 3],
                                              a[1][3 * r:3 * r + 3]]))


def test_two_rank_reducescatter(two_rank_results):
    even, odd, ints = (_inputs_of(k) for k in ("rs_even", "rs_odd", "rs_int"))
    for r, res in enumerate(two_rank_results):
        s = even[0] + even[1]
        np.testing.assert_array_equal(res["rs_even_sum"], s[3 * r:3 * r + 3])
        np.testing.assert_array_equal(res["rs_even_avg"],
                                      s[3 * r:3 * r + 3] / 2)
        # uneven dim 0: rank 0 takes the extra row
        rows = slice(0, 3) if r == 0 else slice(3, 5)
        np.testing.assert_array_equal(res["rs_odd_sum"],
                                      (odd[0] + odd[1])[rows])
        np.testing.assert_array_equal(res["rs_int_avg"],
                                      ((ints[0] + ints[1]) // 2)[2 * r:2 * r + 2])


def test_two_rank_min_max_product(two_rank_results):
    mm, pr = _inputs_of("minmax"), _inputs_of("prod")
    for res in two_rank_results:
        np.testing.assert_array_equal(res["min"], np.minimum(*mm))
        np.testing.assert_array_equal(res["max"], np.maximum(*mm))
        np.testing.assert_array_equal(res["prod"], pr[0] * pr[1])

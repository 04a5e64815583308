"""The third slice of the PyTorch port on the CPU: the ring collectives
A4/A5/A6 against the JAX package's Pallas ring kernels.

The JAX kernels run their real bodies in the Pallas TPU interpreter on
the virtual CPU devices of ``conftest.py`` (as ``tests/test_ring.py``
runs them), one ``shard_map`` rank per device; the port takes the same
per-rank inputs as a list and its wrappers, given CPU tensors, run the
plain versions (the CUDA kernels are held bitwise against those on the
card by ``chip_smoke.py``).  Every comparison is bitwise and on every
rank:

* A5, Sum and Average, and A6 at (n, per-rank length) in {(8, 1024),
  (8, 4000), (8, 5), (3, 4000), (2, 1024), (5, 3001)}: ring-order sums,
  the reciprocal Average at n = 3, the fused multiply-add of A6's hops,
  float32 subnormals and a cancellation to a subnormal; n = 5 is a
  cluster ring size that is neither 2, 3 nor 8, and 3001 leaves a
  ragged last quantization block (zero padding inside a block);
* NaN, inf and -inf among values over 50 decades at n = 3 (any NaN equal
  to any NaN);
* a bfloat16 ``(10, 33)`` input, int32 (exact, its own dtype), n = 1;
* A4, the all-gather of ``(n*16, 128)`` at n in {2, 3, 8};
* A5 (Sum, Average), A6 and A4 at 12 and 16 ranks of 3001 (A4: the
  first 8 rows of 128 of each rank's; the JAX all-gather does not finish
  in interpret mode at 16 rows a rank of 16 ranks, ROADMAP Queue C),
  past the 8 devices of ``conftest.py``: the JAX rings run in one
  subprocess of n virtual CPU devices a ring size, the non-portable
  cluster sizes the port's kernels take on a card.

The wrappers take the plain versions for CPU tensors without counting a
launch, and raise on inputs they cannot take.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import types
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops.ring import ring_allgather_2d as jax_allgather
from horovod_tpu.ops.ring import ring_allreduce as jax_allreduce
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import ring as ring_mod
from horovod_tpu_torch.ops.quantize import fma_f32
from horovod_tpu_torch.ops import (
    ring_allgather_2d,
    ring_allgather_2d_plain,
    ring_allreduce,
    ring_allreduce_plain,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

AXIS = "x"
LANES = 128
CASES = [(8, 1024), (8, 4000), (8, 5), (3, 4000), (2, 1024), (5, 3001)]
MODES = {"sum": {}, "average": {"average": True},
         "quantized": {"quantized": True}}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


def _run(n, body, x, n_out=1, rows=1):
    """``body`` per rank on an n-device mesh, each rank given ``rows``
    rows of ``x`` (one row: its first dimension dropped); every output
    per rank."""
    mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))
    specs = (P(AXIS),) * n_out
    pick = (lambda xs: xs[0]) if rows == 1 else (lambda xs: xs)
    fn = jax.shard_map(lambda xs: tuple(o[None] for o in body(pick(xs))),
                       mesh=mesh, in_specs=(P(AXIS),), out_specs=specs,
                       check_vma=False)
    return [np.asarray(o) for o in jax.jit(fn)(jnp.asarray(x))]


def _inputs(n, per_rank):
    rng = np.random.RandomState(per_rank + n)
    x = rng.randn(n, per_rank).astype(np.float32)
    if per_rank >= 100:
        x[:, :10] = 3e-39                        # subnormal inputs
        x[:, 20] = 0.0                           # a sum below FLT_MIN
        x[0, 20], x[1, 20] = 1.5e-38, -1.4e-38
    return x


_JAX = {}


def _jax_case(n, per_rank):
    """Sum, Average and quantized per-rank outputs of the JAX ring, one
    compiled call per case, shared by the tests."""
    key = (n, per_rank)
    if key not in _JAX:
        x = _inputs(n, per_rank)
        outs = _run(n, lambda v: tuple(
            jax_allreduce(v, axis_name=AXIS, **kw) for kw in MODES.values()),
            x, n_out=len(MODES))
        _JAX[key] = (x, dict(zip(MODES, outs)))
    return _JAX[key]


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.itemsize])


def _special(n=3, per_rank=3000):
    """Values over 50 decades, subnormals included, and a NaN, an inf and
    a -inf in three different quantization blocks of the chunks."""
    rng = np.random.RandomState(17)
    mag = 10.0 ** rng.uniform(-40, 10, size=(n, per_rank))
    x = (rng.randn(n, per_rank) * mag).astype(np.float32)
    x[0, 5], x[1, 1030], x[2, 2100] = np.nan, np.inf, -np.inf
    return x


def test_special_values_match_jax():
    x = _special()
    outs = _run(3, lambda v: tuple(
        jax_allreduce(v, axis_name=AXIS, **kw) for kw in MODES.values()),
        x, n_out=len(MODES))
    for mode, want in zip(MODES, outs):
        got = ring_allreduce(_tensors(x), **MODES[mode])
        for r in range(3):
            g = got[r].numpy()
            np.testing.assert_array_equal(np.isnan(g), np.isnan(want[r]))
            ok = ~np.isnan(g)
            np.testing.assert_array_equal(_bits(g[ok]), _bits(want[r][ok]),
                                          err_msg=f"{mode} rank {r}")
        assert np.isnan(want[0]).any()
        assert mode == "quantized" or np.isinf(want[0]).any()


def _tensors(x):
    return [torch.from_numpy(np.array(row)) for row in x]


def _assert_bitwise(got, want, what):
    assert len(got) == len(want)
    for r, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bfloat16:
            gb = g.view(torch.int16).numpy().view(np.uint16)
        else:
            gb = _bits(g.numpy())
        np.testing.assert_array_equal(gb, _bits(w), err_msg=f"{what} rank {r}")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,per_rank", CASES)
def test_plain_ring_matches_jax_bitwise(n, per_rank, mode):
    x, want = _jax_case(n, per_rank)
    got = ring_allreduce(_tensors(x), **MODES[mode])
    _assert_bitwise(got, want[mode], f"{mode} n={n} per_rank={per_rank}")


@pytest.mark.parametrize("n,per_rank", CASES)
def test_quantized_identical_on_every_rank(n, per_rank):
    x, want = _jax_case(n, per_rank)
    got = ring_allreduce_plain(_tensors(x), quantized=True)
    for r in range(1, n):
        assert torch.equal(got[r], got[0])
        np.testing.assert_array_equal(want["quantized"][r],
                                      want["quantized"][0])
    err = np.abs(got[0].numpy() - x.sum(0))
    assert err.max() <= 2 * (n - 1) * np.abs(x).sum(0).max() / 127


# The JAX rings at n ranks in interpret mode, in a process of its own:
# the device count is fixed when a process first asks for its devices.
# Sum, Average, quantized and the all-gather in one compiled call.
_WIDE_CHILD = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from horovod_tpu.ops.ring import ring_allgather_2d, ring_allreduce

src, dst, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.device_count()
mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
modes = ({}, {"average": True}, {"quantized": True})


def body(v, blocks):
    outs = tuple(ring_allreduce(v[0], axis_name="x", **kw)[None]
                 for kw in modes)
    return outs + (ring_allgather_2d(blocks, axis_name="x")[None],)


fn = jax.shard_map(body, mesh=mesh, in_specs=(P("x"), P("x")),
                   out_specs=(P("x"),) * 4, check_vma=False)
data = np.load(src)
outs = jax.jit(fn)(jnp.asarray(data["x"]), jnp.asarray(data["blocks"]))
np.savez(dst, **dict(zip(("sum", "average", "quantized", "allgather"),
                         map(np.asarray, outs))))
"""
WIDE_PER_RANK = 3001
WIDE_ROWS = 8             # A4's rows a rank (the reference's row quantum)
_WIDE = {}


def _wide_jax(n, per_rank=WIDE_PER_RANK, rows=WIDE_ROWS):
    """The seeded inputs at n ranks, each rank's first ``(rows, 128)``
    of them for the all-gather, and the JAX rings' per-rank outputs by
    mode (the three of :data:`MODES` and ``"allgather"``): one
    subprocess a ring size, shared by the tests."""
    if n not in _WIDE:
        x = _inputs(n, per_rank)
        blocks = x[:, :rows * LANES].reshape(n * rows, LANES)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if not f.startswith("--xla_force_host_platform_device_count")]
        count = f"--xla_force_host_platform_device_count={n}"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   HVTPU_PALLAS_INTERPRET="1",
                   XLA_FLAGS=" ".join(flags + [count]),
                   PYTHONPATH=os.pathsep.join(
                       [repo, os.environ.get("PYTHONPATH", "")]))
        with tempfile.TemporaryDirectory() as tmp:
            src, dst = os.path.join(tmp, "x.npz"), os.path.join(tmp, "o.npz")
            np.savez(src, x=x, blocks=blocks)
            proc = subprocess.run(
                [sys.executable, "-c", _WIDE_CHILD, src, dst, str(n)],
                env=env, cwd=tmp, capture_output=True, text=True,
                timeout=400)
            assert proc.returncode == 0, proc.stderr[-4000:]
            with np.load(dst) as out:
                want = {k: out[k] for k in out.files}
        assert want["sum"].shape == (n, per_rank)
        assert want["allgather"].shape == (n, n * rows, LANES)
        _WIDE[n] = (x, blocks.reshape(n, rows, LANES), want)
    return _WIDE[n]


def test_quantized_past_eight_ranks_matches_jax():
    """A6 at 12 ranks (a ring the port runs on a non-portable cluster of
    12 CTAs on a card): the plain version bitwise the JAX ring on every
    rank, the same seeded inputs, subnormals and a ragged last block
    included."""
    n = 12
    x, _, want = _wide_jax(n)
    got = ring_allreduce_plain(_tensors(x), quantized=True)
    _assert_bitwise(got, want["quantized"],
                    f"quantized n={n} per_rank={WIDE_PER_RANK}")
    err = np.abs(got[0].numpy() - x.sum(0))
    assert err.max() <= 2 * (n - 1) * np.abs(x).sum(0).max() / 127


@pytest.mark.parametrize("mode", [*MODES, "allgather"])
@pytest.mark.parametrize("n", [12, 16])
def test_plain_rings_past_eight_ranks_match_jax(n, mode):
    """A5 (Sum, Average), A6 and A4 at 12 and 16 ranks, the rings the
    port runs on non-portable clusters on a card: the plain versions
    bitwise the JAX rings on every rank, from the same seeded inputs,
    subnormals included (A5, A6: a ragged last quantization block)."""
    x, blocks, want = _wide_jax(n)
    if mode == "allgather":
        got = ring_allgather_2d_plain([torch.from_numpy(b.copy())
                                       for b in blocks])
        np.testing.assert_array_equal(want[mode][0],
                                      blocks.reshape(-1, LANES))
    else:
        got = ring_allreduce_plain(_tensors(x), **MODES[mode])
    _assert_bitwise(got, want[mode], f"{mode} n={n}")


def test_ring_order_and_reciprocal_average_at_three_ranks():
    """At n = 3 the ring's sum is not numpy's, and Average is the sum
    times f32(1/3), not the sum over 3."""
    x, want = _jax_case(3, 4000)
    total = want["sum"][0]
    assert (total != x.sum(0)).any()
    bound = 3 * 2 ** -23 * np.abs(x).sum(0).max()
    np.testing.assert_allclose(total, x.astype(np.float64).sum(0), rtol=0,
                               atol=bound)
    times = total * np.float32(1 / 3)
    np.testing.assert_array_equal(_bits(want["average"][0]),
                                  _bits(np.where(np.abs(times) < 2.0 ** -126,
                                                 np.float32(0), times)))
    assert (want["average"][0] != total / np.float32(3)).any()


def test_bf16_shape_and_dtype_restore():
    x = np.random.RandomState(2).randn(8, 10, 33).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    (want,) = _run(8, lambda v: (jax_allreduce(v, axis_name=AXIS),), xb)
    got = ring_allreduce([torch.from_numpy(np.array(r)).to(torch.bfloat16)
                          for r in x])
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == (10, 33)
    _assert_bitwise(got, want.view(np.uint16), "bf16")


def test_int32_is_exact_and_keeps_its_dtype():
    x = np.arange(8 * 64, dtype=np.int32).reshape(8, 64) * 7919 - 2000
    want_sum, want_avg = _run(8, lambda v: (
        jax_allreduce(v, axis_name=AXIS),
        jax_allreduce(v, axis_name=AXIS, average=True)), x, n_out=2)
    ts = [torch.from_numpy(np.array(r)) for r in x]
    for got, want in ((ring_allreduce(ts), want_sum),
                      (ring_allreduce(ts, average=True), want_avg)):
        for r in range(8):
            assert got[r].dtype == torch.int32
            np.testing.assert_array_equal(got[r].numpy(), want[r])
    np.testing.assert_array_equal(want_avg[0], x.sum(0) // 8)


def test_one_rank_is_a_float32_round_trip():
    x = np.random.RandomState(3).randn(1, 300).astype(np.float32)
    outs = _run(1, lambda v: tuple(jax_allreduce(v, axis_name=AXIS, **kw)
                                   for kw in MODES.values()), x,
                n_out=len(MODES))
    t = torch.from_numpy(x[0].copy())
    for mode, want in zip(MODES, outs):
        got = ring_allreduce([t], **MODES[mode])
        _assert_bitwise(got, want, mode)
        assert got[0].data_ptr() != t.data_ptr()


@pytest.mark.parametrize("n", [8, 3, 2])
def test_allgather_matches_jax(n):
    x = np.random.RandomState(4 + n).randn(n * 16, 128).astype(np.float32)
    (want,) = _run(n, lambda v: (jax_allgather(v, axis_name=AXIS),), x,
                   rows=16)
    blocks = [torch.from_numpy(x[16 * r:16 * (r + 1)].copy())
              for r in range(n)]
    got = ring_allgather_2d(blocks)
    _assert_bitwise(got, want, f"allgather n={n}")
    np.testing.assert_array_equal(want[0], x)


def _launches():
    return (ring_allgather_2d.launches, ring_allgather_2d.cluster_launches,
            ring_allreduce.launches, ring_allreduce.cluster_launches,
            ring_allreduce.quantized_launches,
            ring_allreduce.quantized_cluster_launches)


def test_cpu_tensors_take_the_plain_versions():
    x = _tensors(np.random.RandomState(5).randn(3, 2000).astype(np.float32))
    before = _launches()
    for kw in MODES.values():
        got = ring_allreduce(x, **kw)
        want = ring_allreduce_plain(x, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    blocks = [t[:1024].reshape(8, 128) for t in x]
    assert all(torch.equal(g, w) for g, w in zip(
        ring_allgather_2d(blocks), ring_allgather_2d_plain(blocks)))
    assert _launches() == before              # no kernel on the CPU
    assert ring_allreduce([x[0][:0], x[1][:0]])[0].shape == (0,)


def test_inputs_the_ring_cannot_take_raise():
    a = torch.zeros(16)
    with pytest.raises(ValueError):
        ring_allreduce([])
    with pytest.raises(ValueError, match="rank 1"):
        ring_allreduce([a, torch.zeros(17)])
    with pytest.raises(ValueError, match="rank 1"):
        ring_allreduce([a, a.double()])
    with pytest.raises(ValueError, match="mixed devices"):
        ring_allreduce([a, torch.zeros(16, device="meta")])
    with pytest.raises(ValueError, match="unsupported device"):
        ring_allreduce([torch.zeros(16, device="meta")] * 2)
    with pytest.raises(ValueError, match="float32"):
        ring_allgather_2d([torch.zeros(8, 64)] * 2)
    with pytest.raises(ValueError, match="float32"):
        ring_allgather_2d([torch.zeros(8, 128, dtype=torch.float16)] * 2)
    # ranks on two cards in one process: such ranks run one a process
    # (ProcessRing); the check comes before any tensor is touched, so
    # stand-ins serve here
    cards = [types.SimpleNamespace(shape=(16,), dtype=torch.float32,
                                   device=torch.device("cuda", i))
             for i in range(2)]
    with pytest.raises(NotImplementedError, match="ProcessRing"):
        ring_allreduce(cards)
    with pytest.raises(NotImplementedError, match="ProcessRing"):
        ring_mod._ranks(cards, "ring_allgather_2d")


def test_chunk_layout_follows_the_reference():
    # padded to a multiple of n * 8 * 128, one chunk a rank
    assert ring_mod.chunk_elems(5, 8) == 1024
    assert ring_mod.chunk_elems(4000, 3) == 2048
    assert ring_mod.chunk_elems(25_557_032, 8) == 3_194_880
    assert ring_mod.SLICE % ring_mod.QBLOCK == 0


def _rounded_f32(v: Fraction) -> np.float32:
    """The float32 nearest the rational ``v``, ties to even."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.asarray(c).view(np.uint32)) & 1))


def test_fma_rounds_once():
    """A6's accumulate ``q * s + x`` (and the two-phase allreduce's) is
    one rounding, as the card's FMA and XLA's fused dequantize-and-add
    give.  Over 50 decades a float64 sum rounded again to float32 misses
    in some elements; the round-to-odd emulation must hit every one."""
    rng = np.random.RandomState(23)
    n = 200_000
    x = (rng.randn(n) * 10.0 ** rng.uniform(-30, 10, n)).astype(np.float32)
    s = (np.abs(rng.randn(n)) * 10.0 ** rng.uniform(-30, 10, n)).astype(
        np.float32)
    q = rng.randint(-127, 128, n).astype(np.int8)
    got = fma_f32(torch.from_numpy(q), torch.from_numpy(s),
                  torch.from_numpy(x)).numpy()
    twice = (q.astype(np.float64) * s + x).astype(np.float32)
    missed = np.flatnonzero(got != twice)
    assert len(missed) > 0                   # the inputs reach the hard cases
    for i in list(missed[:40]) + list(rng.randint(0, n, 40)):
        exact = Fraction(int(q[i])) * Fraction(float(s[i])) + Fraction(
            float(x[i]))
        assert got[i] == _rounded_f32(exact), i


def test_library_key_covers_the_shared_headers(tmp_path):
    """An edit to a header under csrc/ must rebuild every library: the
    key hashes each .cuh into each .cu's library name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["quant_common.cuh",
                                         "ring_common.cuh"]
    sources = sorted(csrc.glob("*.cu"))
    assert {s.name for s in sources} >= {"ring.cu", "ring_cluster.cu",
                                         "quantize_int8.cu"}
    for header in headers:
        before = {s.name: _build.lib_path(s) for s in sources}
        assert before == {s.name: _build.lib_path(s) for s in sources}
        header.write_bytes(header.read_bytes() + b"\n")
        after = {s.name: _build.lib_path(s) for s in sources}
        assert all(after[k] != before[k] for k in before)
    for name in ("ring.cu", "ring_cluster.cu", "quantize_int8.cu"):
        assert '#include "quant_common.cuh"' in (csrc / name).read_text()
    for name in ("ring.cu", "ring_cluster.cu"):
        assert '#include "ring_common.cuh"' in (csrc / name).read_text()

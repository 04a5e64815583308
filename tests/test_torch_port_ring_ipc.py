"""The ring collectives with one rank a process (``ProcessRing``) and the
``HVTPU_QUANTIZED_RING`` route, on the CPU.

Two and three spawned processes over gloo (``tests/torch_port_util.py``
``ring_ipc_worker``) each pass their own rank's tensor; the plain
versions walk the ring hop by hop over the group's point-to-point ops.
The JAX rings run their real Pallas bodies in the TPU interpreter on the
virtual CPU devices of ``conftest.py``, one ``shard_map`` rank a device,
as ``tests/test_torch_port_ring.py`` runs them.  Every comparison is
bitwise on every rank, any NaN equal to any NaN:

* A5 Sum and Average and A6 at (n, per-rank length) in {(2, 1024),
  (2, 3001), (3, 4000)}, the inputs of ``test_torch_port_ring.py``
  (subnormals and a cancellation below FLT_MIN), against
  ``horovod_tpu.ops.ring.ring_allreduce``; A4 against
  ``ring_allgather_2d``; int32, exact in its own dtype;
* the engine's ``allreduce(op=Sum|Average, compression=int8)`` at 2
  ranks with ``HVTPU_QUANTIZED_RING=1`` against
  ``horovod_tpu.comm.spmd.allreduce`` with the same variable, a spy
  showing that the ring ran; ``int8_stochastic`` and a group of one rank
  keep the two-phase codec; with the variable unset nothing changes.

The card wrapper is tested without a card by standing a fake library in
for ``csrc/ring.cu`` (as ``tests/test_torch_port_ring_cluster.py``
does): the rows, rank, blocks and epochs it passes, its buffers' growth
and release, and the errors it raises.  ``chip_smoke.py`` holds the
kernels bitwise against these plain versions across 2 and 3 processes
on one card.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.comm import compression as jax_compression
from horovod_tpu.comm import spmd as jax_spmd
from horovod_tpu.comm.reduce_ops import ReduceOp as JaxReduceOp
from horovod_tpu.ops.ring import ring_allgather_2d as jax_allgather
from horovod_tpu.ops.ring import ring_allreduce as jax_allreduce
from horovod_tpu_torch.core import state as core_state
from horovod_tpu_torch.ops import ring as ring_mod
from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce
from torch_port_util import (
    RING_IPC_CASES,
    RING_IPC_MODES,
    ring_ipc_blocks,
    ring_ipc_inputs,
    ring_ipc_ints,
    ring_ipc_route_input,
    ring_ipc_worker,
    spawn_world,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

AXIS = "x"


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


def _run(n, body, x, n_out=1, rows=1):
    """``body`` per rank on an n-device mesh, each rank given ``rows``
    rows of ``x`` (one row: its first dimension dropped)."""
    mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))
    pick = (lambda xs: xs[0]) if rows == 1 else (lambda xs: xs)
    fn = jax.shard_map(lambda xs: tuple(o[None] for o in body(pick(xs))),
                       mesh=mesh, in_specs=(P(AXIS),),
                       out_specs=(P(AXIS),) * n_out, check_vma=False)
    return [np.asarray(o) for o in jax.jit(fn)(jnp.asarray(x))]


def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _assert_bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype.kind == "f":
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(want), err_msg=what)
        got, want = got[~nan], want[~nan]
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


# -- the plain versions against the JAX rings ---------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank's results of ``ring_ipc_worker`` in a world of 2 and
    one of 3 processes, by world size."""
    out = {}
    for n in sorted(RING_IPC_CASES):
        tmp = tmp_path_factory.mktemp(f"ring_ipc{n}")
        codes, _ = spawn_world(ring_ipc_worker, n, tmp, timeout=120)
        assert codes == [0] * n, f"{n} ranks exited {codes}"
        out[n] = [dict(np.load(tmp / f"ring_ipc{r}.npz")) for r in range(n)]
    return out


@pytest.fixture(params=sorted(RING_IPC_CASES))
def world(request, worlds):
    return request.param, worlds[request.param]


def test_plain_allreduce_matches_jax_at_every_case(world):
    n, res = world
    for per_rank in RING_IPC_CASES[n]:
        x = ring_ipc_inputs(n, per_rank)
        outs = _run(n, lambda v: tuple(
            jax_allreduce(v, axis_name=AXIS, **kw)
            for kw in RING_IPC_MODES.values()), x, n_out=len(RING_IPC_MODES))
        for mode, want in zip(RING_IPC_MODES, outs):
            for r in range(n):
                _assert_bitwise(res[r][f"{mode}_{per_rank}"], want[r],
                                f"{mode} n={n} per_rank={per_rank} rank {r}")


def test_plain_allreduce_is_the_stacked_plain_ring(world):
    """Each rank's share is bitwise ``ring_allreduce_plain`` of every
    rank's input in one process."""
    n, res = world
    for per_rank in RING_IPC_CASES[n]:
        xs = [torch.from_numpy(row) for row in ring_ipc_inputs(n, per_rank)]
        for mode, kw in RING_IPC_MODES.items():
            want = ring_mod.ring_allreduce_plain(xs, **kw)
            for r in range(n):
                _assert_bitwise(res[r][f"{mode}_{per_rank}"],
                                want[r].numpy(), f"{mode} rank {r}")


def test_plain_allgather_matches_jax(world):
    n, res = world
    x = ring_ipc_blocks(n)
    (want,) = _run(n, lambda v: (jax_allgather(v, axis_name=AXIS),), x,
                   rows=16)
    for r in range(n):
        _assert_bitwise(res[r]["gather"], want[r], f"A4 n={n} rank {r}")
    np.testing.assert_array_equal(want[0], x)


def test_int32_is_exact_in_its_dtype(world):
    n, res = world
    x = ring_ipc_ints(n)
    want_sum, want_avg = _run(n, lambda v: (
        jax_allreduce(v, axis_name=AXIS),
        jax_allreduce(v, axis_name=AXIS, average=True)), x, n_out=2)
    for r in range(n):
        assert res[r]["int_sum"].dtype == np.int32
        np.testing.assert_array_equal(res[r]["int_sum"], want_sum[r])
        np.testing.assert_array_equal(res[r]["int_avg"], want_avg[r])
    np.testing.assert_array_equal(want_avg[0], x.sum(0) // n)


def test_cpu_tensors_launch_no_kernel(world):
    n, res = world
    for r in range(n):
        np.testing.assert_array_equal(res[r]["launches"], [0, 0, 0])


# -- the HVTPU_QUANTIZED_RING route, 2 ranks -----------------------------------

@pytest.fixture
def route(worlds):
    return worlds[2]


def _spmd_int8(op, comp):
    mesh = Mesh(np.asarray(jax.devices()[:2], dtype=object), ("i",))

    def body(xs):
        return jax_spmd.allreduce(xs[0], axis_name="i", op=op,
                                  compression=comp)[None]

    per_rank = [ring_ipc_route_input(r) for r in range(2)]
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("i"),),
                                out_specs=P("i"), check_vma=False))(
        jnp.stack(per_rank))
    return np.asarray(out)


@pytest.mark.parametrize("name,op", [("sum", JaxReduceOp.SUM),
                                     ("avg", JaxReduceOp.AVERAGE)])
def test_route_matches_the_reference_with_the_variable(route, monkeypatch,
                                                       name, op):
    monkeypatch.setenv("HVTPU_QUANTIZED_RING", "1")
    from horovod_tpu.ops import ring as jax_ring

    calls = []
    real = jax_ring.ring_allreduce
    monkeypatch.setattr(jax_ring, "ring_allreduce",
                        lambda *a, **kw: (calls.append(kw), real(*a, **kw))[1])
    want = _spmd_int8(op, jax_compression.Compression.int8)
    assert calls and calls[0].get("quantized") is True   # the JAX A6 ran
    for r in range(2):
        _assert_bitwise(route[r][f"on_{name}"], want[r], f"{name} rank {r}")
    # the port's ring ran: two plain A6 reductions on every rank
    for r in range(2):
        assert route[r]["ring_calls"][0] == 2
        assert route[r]["ring_quantized"].tolist() == [True, True]


@pytest.mark.parametrize("name,op", [("sum", JaxReduceOp.SUM),
                                     ("avg", JaxReduceOp.AVERAGE)])
def test_without_the_variable_nothing_changes(route, monkeypatch, name, op):
    monkeypatch.delenv("HVTPU_QUANTIZED_RING", raising=False)
    want = _spmd_int8(op, jax_compression.Compression.int8)
    for r in range(2):
        _assert_bitwise(route[r][f"off_{name}"], want[r], f"{name} rank {r}")
        assert route[r]["ring_calls"][2] == 0
    # the ring's result is not the two-phase codec's
    assert not np.array_equal(route[0]["on_sum"], route[0]["off_sum"])


def test_stochastic_and_one_rank_keep_the_two_phase_codec(route):
    for r in range(2):
        calls = route[r]["ring_calls"]
        assert calls[1] == 0 and calls[3] == 0     # no ring for either
        _assert_bitwise(route[r]["on_stoch"], route[r]["off_stoch"],
                        f"int8_stochastic rank {r}")
        _assert_bitwise(route[r]["on_solo"], route[r]["off_solo"],
                        f"one rank, rank {r}")
    np.testing.assert_array_equal(route[0]["on_stoch"], route[1]["on_stoch"])


# -- the card wrapper, against a fake library ---------------------------------

class FakeIpcLib:
    """Stands in for the ``ring`` library's per-process entry points:
    every rank's allocation is at ``base(r)``, its handle ``r`` in 64
    bytes and its B ``blocks[r]``; records every call in order."""

    NAMES = {700: b"cudaErrorIllegalAddress", 201: b"cudaErrorInvalidContext"}

    def __init__(self, rank, blocks):
        self.rank, self.blocks = rank, blocks
        self.calls = []
        self.err = {}                  # entry point -> error it returns
        self.allocs = 0

    @staticmethod
    def base(r, alloc=1):
        return (r + 1) << 40 | alloc << 32

    def _ret(self, name):
        return self.err.get(name, 0)

    def hvtpu_ring_ipc_blocks(self, out):
        self.calls.append(("blocks",))
        out._obj.value = self.blocks[self.rank]
        return self._ret("blocks")

    def hvtpu_ring_ipc_alloc(self, nbytes, ptr, handle):
        self.allocs += 1
        self.calls.append(("alloc", nbytes))
        ptr._obj.value = self.base(self.rank, self.allocs)
        ctypes.memmove(handle, bytes([self.rank, self.allocs]) * 32, 64)
        return self._ret("alloc")

    def hvtpu_ring_ipc_open(self, handle, ptr):
        r, alloc = handle.raw[0], handle.raw[1]
        self.calls.append(("open", r))
        ptr._obj.value = self.base(r, alloc)
        return self._ret("open")

    def hvtpu_ring_ipc_close(self, ptr):
        self.calls.append(("close", ptr))
        return self._ret("close")

    def hvtpu_ring_ipc_free(self, ptr):
        self.calls.append(("free", ptr))
        return self._ret("free")

    def _launch(self, name):
        def call(rows, *args):
            self.calls.append((name, list(rows), args))
            return self._ret(name)
        return call

    @property
    def hvtpu_ring_allreduce_rank(self):
        return self._launch("allreduce_rank")

    @property
    def hvtpu_ring_allgather_rank(self):
        return self._launch("allgather_rank")

    def hvtpu_ring_error_name(self, err):
        return self.NAMES.get(err)

    def launches(self):
        return [c for c in self.calls if c[0].endswith("_rank")]


@pytest.fixture
def fake_world(monkeypatch):
    """A ring of ``n`` ranks seen from rank ``rank``: the group's
    collectives answered by the fake, the card's stream and sync stubbed.
    Every rank's allocation is as large as this rank's."""

    def make(n, rank, blocks=None):
        blocks = blocks or [528] * n
        lib = FakeIpcLib(rank, blocks)
        monkeypatch.setattr(ring_mod, "_ipc_lib", lambda: lib)
        d = ring_mod.dist
        monkeypatch.setattr(d, "get_world_size", lambda group=None: n)
        monkeypatch.setattr(d, "get_rank", lambda group=None: rank)
        monkeypatch.setattr(d, "get_process_group_ranks",
                            lambda group: list(range(10, 10 + n)))

        def all_gather_object(out, obj, group=None):
            b, nbytes, handle = obj
            lib.calls.append(("exchange",))
            for r in range(n):
                out[r] = (blocks[r], nbytes,
                          bytes([r, lib.allocs]) * 32)

        monkeypatch.setattr(d, "all_gather_object", all_gather_object)
        monkeypatch.setattr(d, "barrier",
                            lambda group=None: lib.calls.append(("barrier",)))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: lib.calls.append(("sync",)))
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                            type("S", (), {"cuda_stream": 7}))
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
        return ring_mod.ProcessRing(), lib

    return make


def _flat(size, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(size).astype(
        np.float32))


def _counts():
    return (ring_allgather_2d.ipc_launches, ring_allreduce.ipc_launches,
            ring_allreduce.quantized_ipc_launches)


@pytest.mark.parametrize("n,rank", [(2, 0), (2, 1), (3, 1), (4, 0)])
def test_the_rows_point_at_this_rank_and_its_mapped_neighbours(fake_world,
                                                               n, rank):
    ring, lib = fake_world(n, rank, blocks=[600, 528, 700, 530][:n])
    assert (ring._left_peer, ring._right_peer) == (
        10 + (rank - 1) % n, 10 + (rank + 1) % n)
    x = _flat(5000)
    before = _counts()
    out = ring._sum_kernel(x, False)
    assert _counts() == (before[0], before[1] + 1, before[2])
    e = ring_mod.chunk_elems(5000, n)
    nslices = -(-e // ring_mod.SLICE)
    (name, rows, args), = lib.launches()
    assert name == "allreduce_rank"
    # n, rank, the least B over the ranks, epoch 1, size, chunk, slice,
    # A5, the stream
    assert args == (n, rank, 528, 1, 5000, e, ring_mod.SLICE, 0, 7)
    scale, flags, done = ring_mod.ProcessRing._layout(nslices)

    def row(base, xp=0, op=0):
        return [xp, op, base, base + scale, base + flags, base + done]

    left, right = (rank - 1) % n, (rank + 1) % n
    assert rows == (row(lib.base(left)) + row(lib.base(rank), x.data_ptr(),
                                              out.data_ptr())
                    + row(lib.base(right)))
    # each neighbour mapped once (at n = 2 the left is the right)
    assert sorted(c[1] for c in lib.calls if c[0] == "open") == sorted(
        {left, right})
    assert ring.mapped_bytes == len({left, right}) * ring.nbytes
    assert ring.nbytes == done + 8 * [600, 528, 700, 530][rank]


def test_epochs_rise_with_no_zeroing_between_calls(fake_world):
    ring, lib = fake_world(3, 2)
    x = _flat(3000)
    before = _counts()
    ring._sum_kernel(x, False)
    ring._sum_kernel(x, True)
    ring._gather_kernel(x[:2048].reshape(16, 128))
    ring._sum_kernel(x, True)
    launches = lib.launches()
    assert [c[0] for c in launches] == ["allreduce_rank"] * 2 + [
        "allgather_rank", "allreduce_rank"]
    assert [c[2][3] for c in launches] == [1, 2, 3, 4]       # epochs
    assert [c[2][7] for c in launches] == [0, 1, 0, 1]       # quantized
    # A4: size and chunk are the block's elements
    assert launches[2][2][4:6] == (2048, 2048)
    # one allocation, one exchange, nothing in between
    assert [c[0] for c in lib.calls[:lib.calls.index(launches[0])]] == [
        "blocks", "alloc", "exchange", "open", "open"]
    assert all(c[0].endswith("_rank") for c in lib.calls[5:])
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 2)


def test_buffers_grow_only_when_a_call_needs_more(fake_world):
    ring, lib = fake_world(2, 0)
    small = 2 * ring_mod.SLICE                   # one slice a chunk
    ring._sum_kernel(_flat(small), False)
    ring._sum_kernel(_flat(small // 2), False)   # fewer slices: no growth
    assert lib.allocs == 1 and ring.nslices == 1
    first = lib.base(0, 1)
    ring._sum_kernel(_flat(5 * small), False)    # 5 slices a chunk
    assert lib.allocs == 2 and ring.nslices == 5
    grow = lib.calls[lib.calls.index(lib.launches()[1]) + 1:
                     lib.calls.index(lib.launches()[2])]
    # no call in flight anywhere, then unmap the neighbour, free, anew
    assert [c[0] for c in grow] == ["sync", "barrier", "close", "free",
                                    "blocks", "alloc", "exchange", "open"]
    assert grow[2][1] == lib.base(1, 1) and grow[3][1] == first
    # fresh flags: the epochs start again
    assert [c[2][3] for c in lib.launches()] == [1, 2, 1]
    assert lib.launches()[2][1][8] == lib.base(0, 2)     # this rank's slots
    ring._sum_kernel(_flat(5 * small), False)
    assert lib.allocs == 2 and lib.launches()[3][2][3] == 2


def test_close_unmaps_before_it_frees(fake_world):
    ring, lib = fake_world(3, 0)
    ring._sum_kernel(_flat(3000), True)
    del lib.calls[:]
    ring.close()
    names = [c[0] for c in lib.calls]
    assert names == ["sync", "barrier", "close", "close", "free"]
    assert {c[1] for c in lib.calls[2:4]} == {lib.base(1), lib.base(2)}
    assert lib.calls[4][1] == lib.base(0)
    assert ring.nbytes == 0 and ring.mapped_bytes == 0
    ring.close()                                 # nothing left to close
    assert len(lib.calls) == 5
    # the ring allocates anew, at epoch 1
    ring._sum_kernel(_flat(3000), False)
    assert lib.allocs == 2 and lib.launches()[-1][2][3] == 1


def test_a_failed_launch_raises_with_the_rank_and_the_error(fake_world):
    ring, lib = fake_world(3, 1)
    lib.err["allreduce_rank"] = 700
    before = _counts()
    with pytest.raises(RuntimeError, match=r"rank 1 of 3 failed with "
                       r"cudaError 700 \(cudaErrorIllegalAddress\)"):
        ring._sum_kernel(_flat(3000), False)
    assert _counts() == before
    assert len(lib.launches()) == 1              # no retry, no fallback


@pytest.mark.parametrize("entry,match", [
    ("open", "opening rank 0's IPC handle"),
    ("alloc", "cudaMalloc"),
    ("blocks", "blocks")])
def test_a_failed_ipc_call_raises_with_the_rank_and_the_error(fake_world,
                                                              entry, match):
    ring, lib = fake_world(3, 1)
    lib.err[entry] = 201
    with pytest.raises(RuntimeError, match=match + r".*rank 1 of 3 failed "
                       r"with cudaError 201 \(cudaErrorInvalidContext\)"):
        ring._sum_kernel(_flat(3000), False)
    assert lib.launches() == []


def test_one_card_a_ring(fake_world):
    ring, lib = fake_world(2, 0)
    ring._sum_kernel(_flat(3000), False)
    ring.device = torch.device("cuda", 0)        # as a card call leaves it
    with pytest.raises(ValueError, match="holds buffers on cuda:0"):
        ring._reserve(torch.device("cuda", 1), 1)


def test_a_ring_a_group(monkeypatch):
    """``process_ring`` makes one ring a group at first use; a process
    set and the hierarchical route's views pass their own groups, so
    each gets its own; ``close_rings`` closes them in the order made."""
    made, closed = [], []

    class Ring:
        def __init__(self, group):
            made.append(group)
            self.group = group

        def close(self):
            closed.append(self.group)

    monkeypatch.setattr(ring_mod, "ProcessRing", Ring)
    monkeypatch.setattr(core_state, "_rings", [])
    a, b, c = object(), object(), object()
    rings = [core_state.process_ring(g) for g in (None, a, b, a, None, c)]
    assert made == [None, a, b, c]
    assert rings[1] is rings[3] and rings[0] is rings[4]
    core_state.close_rings([b, c])
    assert closed == [b, c]
    core_state.close_rings(abandon=True)         # forgotten, not closed
    assert closed == [b, c] and core_state._rings == []
    core_state.process_ring(a)
    core_state.close_rings()
    assert closed == [b, c, a]


def test_the_occupancy_sweep_patches_one_line():
    """ring.cu fixes its floor of CTAs an SM in one line, the line
    ``torch_port_ring_sweep.py --kernels global`` rewrites in its
    copies; the shipped floor is one of the copies."""
    import torch_port_ring_sweep as sweep

    text = (ring_mod._build.CSRC / "ring.cu").read_text()
    assert text.count(sweep.KCTAS) == 1
    assert text.count("__launch_bounds__(kThreads, kCtasPerSm)") == 3
    assert 3 in sweep.GLOBAL_CTAS and 1 in sweep.GLOBAL_CTAS
    # its rings lie past the cluster kernels' limit of 16 ranks, every
    # kind's
    assert all(k > ring_mod.CLUSTER_MAX_RANKS for k, _ in sweep.GLOBAL_RINGS)

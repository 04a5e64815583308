"""The ring's kernel dispatch and the cluster wrapper's checks, on the
CPU.

A4, A5 and A6 at 2 to 16 ranks (past 8, the portable cluster size, on
Hopper's non-portable clusters) run on ``csrc/ring_cluster.cu`` (one
thread block cluster a ring), past 16 on ``csrc/ring.cu`` (the
global-slot kernels).  The choice is a function of ``n`` alone,
whatever the kind; it is tested here without a card by standing fake launch
functions in for the compiled libraries, so each test sees which kernel
a call reaches, with what arguments, and that a failed launch raises.
The kernels' results are held bitwise against the plain versions on the
card by ``chip_smoke.py``; the plain versions against the JAX ring
kernels by ``test_torch_port_ring.py``.
"""

import contextlib

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import ring as ring_mod
from horovod_tpu_torch.ops import ring_allgather_2d, ring_allreduce
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)


@pytest.mark.parametrize("n", range(2, 17))
def test_route_is_a_function_of_n(n):
    # every kind on the cluster up to 16 ranks
    assert ring_mod.kernel_route(n) == "cluster"


@pytest.mark.parametrize("n", [17, 20, 64])
def test_quantized_route_past_sixteen_is_global(n):
    # every kind, A6 included, on the global-slot kernels past 16 ranks
    assert ring_mod.kernel_route(n) == "global"
    with pytest.raises(TypeError):
        ring_mod.kernel_route(n, quantized=True)    # the kind is not asked


@pytest.mark.parametrize("n", [0, 1])
def test_route_needs_two_ranks(n):
    with pytest.raises(ValueError, match="2 or more ranks"):
        ring_mod.kernel_route(n)


class FakeLib:
    """Stands in for the loaded libraries: records every launch, returns
    ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def fn(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(ring_mod, "_cluster_kernels", lambda: (
        lib.fn("cluster_allgather"), lib.fn("cluster_allreduce"),
        lib.fn("cluster_info"), lib.fn("cluster_quantized_allreduce")))
    monkeypatch.setattr(ring_mod, "_kernels", lambda: (
        lib.fn("global_allgather"), lib.fn("global_allreduce")))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    yield lib


def _counts():
    return (ring_allgather_2d.cluster_launches, ring_allgather_2d.launches,
            ring_allreduce.cluster_launches, ring_allreduce.launches,
            ring_allreduce.quantized_launches,
            ring_allreduce.quantized_cluster_launches)


def _flats(n, size=3000, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(size).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("n", [2, 3, 8, 9, 12, 16, 17, 20])
def test_allreduce_reaches_the_kernel_its_route_names(fake_card, n):
    flats = _flats(n)
    before = _counts()
    outs = ring_mod._ring_sum_kernel(flats, False)
    ((name, args),) = fake_card.calls
    e = ring_mod.chunk_elems(3000, n)
    if n <= 16:
        assert name == "cluster_allreduce"
        xs, os_, n_arg, size, chunk, stream = args
        assert (n_arg, size, chunk, stream) == (n, 3000, e, 7)
        # only the per-rank pointers: no slot or flag buffer
        assert list(xs) == [f.data_ptr() for f in flats]
        assert list(os_) == [o.data_ptr() for o in outs]
        delta = (0, 0, 1, 0, 0, 0)
    else:
        assert name == "global_allreduce"
        assert args[1:6] == (n, 3000, e, ring_mod.SLICE, 0)
        delta = (0, 0, 0, 1, 0, 0)
    assert tuple(a - b for a, b in zip(_counts(), before)) == delta


@pytest.mark.parametrize("n", [2, 3, 5, 8, 9, 12, 16, 17, 20])
def test_quantized_reaches_the_kernel_its_route_names(fake_card, n):
    flats = _flats(n)
    before = _counts()
    outs = ring_mod._ring_sum_kernel(flats, True)
    ((name, args),) = fake_card.calls
    e = ring_mod.chunk_elems(3000, n)
    if n <= 16:
        assert name == "cluster_quantized_allreduce"
        xs, os_, n_arg, size, chunk, stream = args
        assert (n_arg, size, chunk, stream) == (n, 3000, e, 7)
        # only the per-rank pointers: no slot, scale slot or flag buffer
        assert list(xs) == [f.data_ptr() for f in flats]
        assert list(os_) == [o.data_ptr() for o in outs]
        delta = (0, 0, 0, 0, 0, 1)
    else:
        assert name == "global_allreduce"
        assert args[1:6] == (n, 3000, e, ring_mod.SLICE, 1)
        delta = (0, 0, 0, 0, 1, 0)
    assert tuple(a - b for a, b in zip(_counts(), before)) == delta


@pytest.mark.parametrize("n", [2, 7, 8, 9, 12, 16, 17, 20])
def test_allgather_reaches_the_kernel_its_route_names(fake_card, n):
    blocks = [torch.zeros(24, 128) for _ in range(n)]
    before = _counts()
    outs = ring_mod._allgather_kernel(blocks)
    assert len(outs) == n and tuple(outs[0].shape) == (n * 24, 128)
    ((name, args),) = fake_card.calls
    if n <= 16:
        assert name == "cluster_allgather"
        assert args[2:] == (n, 24 * 128, 7)
        assert list(args[0]) == [b.data_ptr() for b in blocks]
        assert list(args[1]) == [o.data_ptr() for o in outs]
        delta = (1, 0, 0, 0, 0, 0)
    else:
        assert name == "global_allgather"
        assert args[1:6] == (n, 24 * 128, 24 * 128, ring_mod.SLICE, 0)
        delta = (0, 1, 0, 0, 0, 0)
    assert tuple(a - b for a, b in zip(_counts(), before)) == delta


@pytest.mark.parametrize("fn,n", [
    (lambda xs: ring_mod._ring_sum_kernel(xs, False), 3),
    (lambda xs: ring_mod._ring_sum_kernel(xs, True), 5),
    (lambda xs: ring_mod._ring_sum_kernel(xs, True), 9),
    (lambda xs: ring_mod._ring_sum_kernel(xs, True), 16),
    (lambda xs: ring_mod.cluster_allgather(
        [x[:2048].reshape(16, 128) for x in xs]), 4),
    (lambda xs: ring_mod._ring_sum_kernel(xs, False), 12),
    (lambda xs: ring_mod._allgather_kernel(
        [x[:2048].reshape(16, 128) for x in xs]), 16),
])
def test_a_failed_cluster_launch_raises(fake_card, fn, n):
    fake_card.err = 98            # cudaErrorInvalidDeviceFunction
    before = _counts()
    with pytest.raises(RuntimeError, match="cluster launch over .* "
                                           "cudaError 98"):
        fn(_flats(n))
    assert _counts() == before
    # one launch: nothing gives way to the global-slot kernel
    ((name, _),) = fake_card.calls
    assert name.startswith("cluster_")


def test_a_failed_cluster_query_raises(fake_card):
    fake_card.err = 1
    with pytest.raises(RuntimeError, match="cluster_info: cudaError 1"):
        ring_mod.cluster_info("A5", 8)


def _table(xs, outs, x_numel=64, out_numel=64, kind="A5"):
    return ring_mod._cluster_table("t", kind, xs, outs, x_numel, out_numel)


def test_cluster_table_holds_the_pointers():
    xs = [torch.zeros(64) for _ in range(3)]
    outs = [torch.zeros(64) for _ in range(3)]
    tx, to = _table(xs, outs)
    assert list(tx) == [x.data_ptr() for x in xs]
    assert list(to) == [o.data_ptr() for o in outs]


@pytest.mark.parametrize("kind", ring_mod.CLUSTER_KINDS)
@pytest.mark.parametrize("n", [1, 17, 20])
def test_cluster_table_takes_two_to_sixteen_ranks(kind, n):
    ts = [torch.zeros(64) for _ in range(n)]
    with pytest.raises(ValueError, match=f"{kind} takes 2 to 16 ranks"):
        _table(ts, ts, kind=kind)


@pytest.mark.parametrize("n", [9, 12, 16])
def test_quantized_cluster_table_holds_sixteen_pointers(n):
    xs = [torch.zeros(64) for _ in range(n)]
    outs = [torch.zeros(64) for _ in range(n)]
    for kind in ring_mod.CLUSTER_KINDS:
        tx, to = _table(xs, outs, kind=kind)
        assert list(tx) == [x.data_ptr() for x in xs]
        assert list(to) == [o.data_ptr() for o in outs]


def test_cluster_table_raises_on_what_the_kernel_cannot_take():
    good = [torch.zeros(64) for _ in range(2)]
    with pytest.raises(ValueError, match="2 inputs but 3 outputs"):
        _table(good, good + [torch.zeros(64)])
    with pytest.raises(ValueError, match="mixed devices"):
        _table(good, [good[0], torch.zeros(64, device="meta")])
    with pytest.raises(ValueError, match="rank 1's input must be 64"):
        _table([good[0], torch.zeros(64, dtype=torch.float64)], good)
    with pytest.raises(ValueError, match="rank 0's output must be 64"):
        _table(good, [torch.zeros(63), good[1]])
    with pytest.raises(ValueError, match="rank 1's input must be 64"):
        _table([good[0], torch.zeros(64, 2)[:, 0]], good)   # strided
    # a view 4 bytes into a buffer: the kernel moves 16 bytes a thread
    with pytest.raises(ValueError, match="rank 1's input is not 16-byte"):
        _table([good[0], torch.zeros(65)[1:]], good)
    with pytest.raises(ValueError, match="rank 0's output is not 16-byte"):
        _table(good, [torch.zeros(68)[3:67], good[1]])


@pytest.mark.parametrize("kind,n", [("A4", 2), ("A5", 3), ("A4", 8),
                                    ("A5", 8), ("A6", 2), ("A6", 8),
                                    ("A6", 9), ("A6", 12), ("A6", 16),
                                    ("A4", 9), ("A4", 12), ("A4", 16),
                                    ("A5", 9), ("A5", 12), ("A5", 16)])
def test_cluster_info_reads_what_the_library_reports(monkeypatch, kind, n):
    index = ring_mod.CLUSTER_KINDS.index(kind)

    def info_fn(k, ranks, info):
        assert (k, ranks) == (index, n)
        for i in range(7):
            info[i] = 100 * k + 10 * ranks + i
        return 0

    monkeypatch.setattr(ring_mod, "_cluster_kernels",
                        lambda: (None, None, info_fn, None))
    base = 100 * index + 10 * n
    assert ring_mod.cluster_info(kind, n) == dict(
        registers=base, spill_bytes=base + 1, shared_bytes=base + 2,
        ctas_per_sm=base + 3, clusters=base + 4, slice=base + 5,
        max_cluster_size=base + 6)


def test_the_kernel_file_compiles_one_slice():
    """ring_cluster.cu fixes each CTA at one shape, the lines the slice
    sweep rewrites in its copies: A4/A5 at one thread count and one hop
    sync, A6 at one thread count and one count of warps a quantization
    block.  A CTA's slice holds whole quantization blocks, as A5's chunks
    do, and an A6 CTA whole blocks of whole warps."""
    import torch_port_ring_sweep as sweep

    text = (ring_mod._build.CSRC / "ring_cluster.cu").read_text()
    assert text.count(sweep.KTHREADS) == 1
    assert text.count(sweep.KSYNC) == 1
    assert text.count(sweep.KQTHREADS) == 1
    assert text.count(sweep.KQBLOCKWARPS) == 1
    assert "template" not in text
    assert all(t * 16 % ring_mod.QBLOCK == 0 for t in sweep.THREADS)
    assert 64 in sweep.THREADS and 128 in sweep.THREADS
    assert text.count(sweep.KSLOTS) == 1
    # every thread count with each hop sync, the shipped one among them,
    # and more slots with mbarriers
    copies = sweep.a4a5_copies()
    assert set(copies) == {f"t{t}{s}" for t in sweep.THREADS
                           for s in ("", "_mbar")} | {
        f"t{t}_mbar_s{s}" for t, s in sweep.MBAR_SLOTS}
    assert all(set(c) == {sweep.KTHREADS, sweep.KSYNC, sweep.KSLOTS}
               for c in copies.values())
    assert copies["t128"] == {k: k for k in copies["t128"]}   # shipped
    for warps, threads in sweep.A6_SHAPES:
        assert warps in (1, 2) and threads % (32 * warps) == 0
    assert (1, 128) in sweep.A6_SHAPES and (2, 128) in sweep.A6_SHAPES
    # one limit for every kind: Hopper's non-portable cluster size
    assert ring_mod.CLUSTER_MAX_RANKS == 16
    assert not hasattr(ring_mod, "QUANTIZED_CLUSTER_MAX_RANKS")
    assert not hasattr(ring_mod, "cluster_max_ranks")
    # the kernel file's own limit, and the attribute past 8 ranks
    assert "constexpr int kPortableRanks = 8;" in text
    assert "constexpr int kMaxRanks = 16;" in text
    assert "kQMaxRanks" not in text
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in text

"""The port's input pipeline (``horovod_tpu_torch/data``) against the JAX
package's (``horovod_tpu/data``).

Tolerance: none.  The sharder, the sources and the loader deliver the
same sample ids and bitwise the same batches as the reference for
several seeds, sizes, batch sizes and ranks (both with
``device_put=False``; the port's copy onto the state's device in a
world of one on the CPU and in the gloo world); a save and
restore at cursor K and a resize from 2 to 3 ranks mid-epoch resume
alike and deliver every sample of the epoch exactly once.  A 2-rank
gloo world agrees on the shorter source by allreduce-Min and drops the
same batch under ``data.next:drop`` as the reference.  A failed copy onto the device
raises: the port has no fallback to host batches.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu import data as ref_data
from horovod_tpu.core import faults as ref_faults
from horovod_tpu_torch import data as port_data
from torch_port_util import data_rank, spawn_world
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

CASES = [  # (samples, batch, world, seed, shuffle)
    (37, 4, 1, 0, True), (37, 4, 3, 5, True), (64, 8, 2, 11, True),
    (10, 3, 4, 2, False), (5, 2, 3, 7, True)]


@pytest.mark.parametrize("n,batch,world,seed,shuffle", CASES)
def test_sharder_indices_equal_the_reference(n, batch, world, seed, shuffle):
    for epoch in (0, 3):
        assert np.array_equal(
            port_data.epoch_permutation(n, seed, epoch, shuffle),
            ref_data.epoch_permutation(n, seed, epoch, shuffle))
        ps = port_data.Sharder(n, batch, seed=seed, shuffle=shuffle)
        rs = ref_data.Sharder(n, batch, seed=seed, shuffle=shuffle)
        cursor = 0
        while cursor < n:
            assert ps.steps_remaining(cursor, world) \
                == rs.steps_remaining(cursor, world)
            nxt = None
            for r in range(world):
                pi, pc = ps.next_indices(epoch, cursor, r, world)
                ri, rc = rs.next_indices(epoch, cursor, r, world)
                assert np.array_equal(pi, ri) and pc == rc
                nxt = pc
            cursor = nxt


def test_sources_fetch_equal_the_reference():
    idx = np.array([3, 0, 7, 7, 2])
    arrays = {"x": np.arange(40, dtype=np.float32).reshape(10, 4),
              "y": (np.arange(10) % 3,)}
    p = port_data.ArraySource(arrays).fetch(idx)
    r = ref_data.ArraySource(arrays).fetch(idx)
    assert np.array_equal(p["x"], r["x"]) and np.array_equal(p["y"][0],
                                                             r["y"][0])
    p = port_data.SyntheticSource(50, (3, 2), seed=4).fetch(idx)
    r = ref_data.SyntheticSource(50, (3, 2), seed=4).fetch(idx)
    assert all(np.array_equal(p[k], r[k]) and p[k].dtype == r[k].dtype
               for k in ("x", "y"))


def _loader(pkg, n, batch, rank, world, seed, shuffle=True):
    """Rank ``rank`` of a world of ``world`` without a process group:
    the length agreed first, then the rank and size set."""
    src = pkg.SyntheticSource(n, (2, 3), seed=seed)
    ld = pkg.ElasticDataLoader(src, batch, seed=seed, shuffle=shuffle,
                               with_indices=True, device_put=False)
    ld._agreed_length()
    ld._rank, ld._size = rank, world
    return ld


def _take(ld, k=None):
    """Up to ``k`` batches of the current epoch as (ids, x as numpy)."""
    out = []
    for idx, b in ld:
        x = b["x"].numpy() if torch.is_tensor(b["x"]) else b["x"]
        out.append((idx.tolist(), x))
        if k is not None and len(out) == k:
            break
    return out


def _same(a, b):
    return len(a) == len(b) and all(
        ia == ib and np.array_equal(xa, xb) for (ia, xa), (ib, xb)
        in zip(a, b))


@pytest.mark.parametrize("n,batch,world,seed,shuffle", CASES)
def test_loader_batches_equal_the_reference(n, batch, world, seed, shuffle):
    for rank in range(world):
        p = _loader(port_data, n, batch, rank, world, seed, shuffle)
        r = _loader(ref_data, n, batch, rank, world, seed, shuffle)
        try:
            for _ in range(2):           # two epochs
                got, want = _take(p), _take(r)
                assert _same(got, want)
            assert p.state.state_dict() == r.state.state_dict()
        finally:
            p.close()
            r.close()


@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_port_batches_are_tensors_on_the_state_device(cpu_world):
    src = port_data.SyntheticSource(12, (2, 3), seed=0)
    ld = port_data.ElasticDataLoader(src, 4, seed=0, with_indices=True)
    want = _loader(ref_data, 12, 4, 0, 1, 0)
    try:
        assert _same(_take(ld), _take(want))
        idx, b = next(iter(ld))
        assert torch.is_tensor(b["x"]) and b["x"].device == cpu_world.device()
        assert ld.debug_state()["device"] == "cpu"
    finally:
        ld.close()
        want.close()


@pytest.mark.parametrize("k", [1, 3])
def test_restore_at_cursor_k_resumes_alike(k):
    for pkg in (port_data, ref_data):
        full = _loader(pkg, 29, 3, 0, 1, 4)
        first = _loader(pkg, 29, 3, 0, 1, 4)
        try:
            want = _take(full)
            head = _take(first, k)
            saved = first.state.state_dict()
            # the live loader's prefetch ran ahead: a restore to the
            # saved cursor discards what it parked (version bump)
            _take(first, 2)
            first.state.load_state_dict(saved)
            tail = _take(first)
            assert _same(head + tail, want)
        finally:
            full.close()
            first.close()
    port = _loader(port_data, 29, 3, 0, 1, 4)
    ref = _loader(ref_data, 29, 3, 0, 1, 4)
    try:
        port.state.load_state_dict({"epoch": 1, "cursor": 3 * k, "seed": 4})
        ref.state.load_state_dict({"epoch": 1, "cursor": 3 * k, "seed": 4})
        assert _same(_take(port), _take(ref))
    finally:
        port.close()
        ref.close()


def test_resize_from_2_to_3_ranks_mid_epoch():
    """Ranks 0-1 of 2 consume 3 steps, then 3 ranks resume from the
    committed cursor: both packages deliver the same ids and every
    sample of the epoch exactly once."""
    n, batch, seed = 41, 3, 6
    ids = {}
    for pkg in (port_data, ref_data):
        two = [_loader(pkg, n, batch, r, 2, seed) for r in range(2)]
        got = [_take(ld, 3) for ld in two]
        saved = two[0].state.state_dict()
        assert saved == two[1].state.state_dict()
        assert saved["cursor"] == 3 * 2 * batch
        three = [_loader(pkg, n, batch, r, 3, seed) for r in range(3)]
        for ld in three:
            ld.state.load_state_dict(saved)
        got += [_take(ld) for ld in three]
        for ld in two + three:
            ld.close()
        ids[pkg.__name__] = [i for run in got for i, _ in run]
        flat = sorted(i for step in ids[pkg.__name__] for i in step)
        assert flat == list(range(n))
    assert ids["horovod_tpu_torch.data"] == ids["horovod_tpu.data"]


def test_failed_device_copy_raises_instead_of_falling_back(cpu_world):
    if torch.cuda.is_available():
        pytest.skip("the card is there: the copy would succeed")
    ld = port_data.ElasticDataLoader(port_data.SyntheticSource(8, (2,)), 2)
    ld._agreed_length()
    ld._device = torch.device("cuda")     # a target the copy cannot reach
    try:
        with pytest.raises(RuntimeError, match="prefetch failed"):
            next(iter(ld))
        assert ld.debug_state()["device_put"] is True
    finally:
        ld.close()


def test_no_init_and_no_card_asks_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default copy target exists")
    ld = port_data.ElasticDataLoader(port_data.SyntheticSource(8, (2,)), 2)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(iter(ld))
    finally:
        ld.close()


@pytest.fixture(scope="module")
def gloo_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data2")
    codes, results = spawn_world(data_rank, 2, tmp, timeout=90)
    assert codes == [0, 0], codes
    return results


def _reference_rank(rank: int, world: int, spec: str = ""):
    if spec:
        ref_faults.install(spec, rank=rank)
    try:
        ld = ref_data.ElasticDataLoader(
            ref_data.SyntheticSource(17, (2,), seed=3), 2, seed=9,
            with_indices=True, device_put=False)
        ld._rank, ld._size = rank, world
        out = [(idx.tolist(), b["x"][:, 0].tolist()) for idx, b in ld]
        ld.close()
        return out
    finally:
        ref_faults.uninstall()


def test_two_ranks_agree_on_the_shorter_source(gloo_data):
    for rank, res in enumerate(gloo_data):
        plain = res["plain"]
        assert plain["n"] == 17 and plain["steps"] == 5
        assert [[i, x] for i, x, _ in plain["batches"]] \
            == [list(t) for t in _reference_rank(rank, 2)]
        assert {d for _, _, d in plain["batches"]} == {"cpu"}
        assert plain["state"] == {"epoch": 1, "cursor": 0, "seed": 9}
    seen = sorted(i for res in gloo_data for b in res["plain"]["batches"]
                  for i in b[0])
    assert seen == list(range(17))


def test_two_ranks_drop_the_same_batch(gloo_data):
    for rank, res in enumerate(gloo_data):
        drop = res["drop"]
        want = _reference_rank(rank, 2, "data.next:drop@count=2,times=1")
        assert [[i, x] for i, x, _ in drop["batches"]] \
            == [list(t) for t in want]
        assert len(drop["batches"]) == len(res["plain"]["batches"]) - 1
        assert drop["batches"][1][0] == res["plain"]["batches"][2][0]

"""The port's negotiation cores (``horovod_tpu_torch/native/fallback.py``
``PyController`` and the C++ core, ``native/core.py``
``NativeController``) against the JAX package's (``horovod_tpu/native/
fallback.py``), cycle by cycle, with no data plane.

Each scenario simulates 2, 3 and 4 ranks in one process: the port's two
cores and one reference core a rank, driven by the same calls.  At every cycle
each rank's ``drain_requests`` blob, the coordinator's
``compute_responses`` blob (rank 0 ingests every rank's blob in rank
order) and each rank's ``apply_responses`` result are compared byte for
byte.  The scenarios, each made from a seed:

* enqueue orders permuted across ranks and spread over cycles;
* repeated bursts that hit the response cache and go out as bypass
  frames, a periodic resync, then a forced resync on one rank;
* fusion groups at the fusion threshold and one element either side;
* a dtype and a shape mismatch, whose error responses name the rank;
* process sets, ``declare_group`` and join.
"""

import numpy as np
import pytest

from horovod_tpu.native import fallback as ref_fallback
from horovod_tpu_torch.native import core, fallback, wire
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

F32 = wire.DTYPE_IDS["float32"]
F16 = wire.DTYPE_IDS["float16"]


class Twins:
    """The port's two cores and one reference core a rank, driven
    together."""

    def __init__(self, size: int, threshold: int = 1 << 20,
                 resync_every: int = 64):
        self.size = size
        self.port = [fallback.PyController(r, size, threshold, 1024,
                                           resync_every=resync_every)
                     for r in range(size)]
        self.ref = [ref_fallback.PyController(r, size, threshold, 1024,
                                              resync_every=resync_every)
                    for r in range(size)]
        self.native = [core.NativeController(r, size, threshold, 1024,
                                              resync_every=resync_every)
                       for r in range(size)]
        self.seq = [0] * size
        self.requests = []    # every cycle's parsed request lists
        self.responses = []   # every cycle's parsed response list

    def call(self, rank: int, method: str, *args):
        a = getattr(self.port[rank], method)(*args)
        b = getattr(self.ref[rank], method)(*args)
        c = getattr(self.native[rank], method)(*args)
        assert a == b, (rank, method, args)
        assert c == a, ("native", rank, method, args)
        return a

    def enqueue(self, rank: int, name: str, shape=(4,), dtype=F32,
                op_type=wire.ALLREDUCE, red_op=wire.RED_SUM, psid=0,
                group_id=-1, root_rank=-1):
        self.seq[rank] += 1
        assert self.call(rank, "enqueue", self.seq[rank], name, op_type,
                         red_op, dtype, shape, psid, group_id, root_rank)

    def everyone(self, method: str, *args):
        for r in range(self.size):
            self.call(r, method, *args)

    def cycle(self) -> wire.ResponseList:
        blobs = [self.call(r, "drain_requests") for r in range(self.size)]
        self.requests.append([wire.parse_request_list(b) for b in blobs])
        for b in blobs:
            self.port[0].ingest(b)
            self.ref[0].ingest(b)
            self.native[0].ingest(b)
        resp = self.call(0, "compute_responses")
        for r in range(self.size):
            self.call(r, "apply_responses", resp)
        rl = wire.parse_response_list(resp)
        self.responses.append(rl)
        return rl

    def released(self):
        return [n for rl in self.responses for rs in rl.responses
                if not rs.error for n in rs.tensor_names]


SIZES = [2, 3, 4]


@pytest.mark.parametrize("size", SIZES)
def test_permuted_enqueue_orders(size):
    rng = np.random.RandomState(10 + size)
    t = Twins(size, threshold=64 * 4 * 3)
    names = [f"layer{i}.grad" for i in range(12)]
    shapes = {n: (int(rng.randint(1, 64)),) for n in names}
    plans = []
    for r in range(size):
        order = list(rng.permutation(names))
        cuts = sorted(rng.choice(np.arange(1, len(order)), 3, replace=False))
        plans.append(np.split(np.asarray(order, dtype=object), cuts))
    for c in range(len(plans[0]) + 3):
        for r in range(size):
            if c < len(plans[r]):
                for n in plans[r][c]:
                    t.enqueue(r, n, shapes[n])
        t.cycle()
    assert sorted(t.released()) == sorted(names)


@pytest.mark.parametrize("size", SIZES)
def test_cache_bypass_then_forced_resync(size):
    rng = np.random.RandomState(20 + size)
    t = Twins(size, resync_every=4)
    names = [f"w{i}" for i in range(6)]
    for step in range(9):
        for r in range(size):
            for n in rng.permutation(names):
                t.enqueue(r, str(n), (8, 3))
        if step == 6:
            t.call(size - 1, "force_resync")
        t.cycle()
        t.cycle()
    frames = [rl for cyc in t.requests for rl in cyc if rl.burst_len]
    assert any(rl.cache_bypass for rl in frames)
    assert any(rl.cache_resync for rl in frames)
    assert len(t.released()) == 9 * len(names)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_fusion_at_the_threshold(size, delta):
    threshold = 4 * 1000
    t = Twins(size, threshold=threshold)
    # two tensors whose float32 bytes sum to the threshold + delta elements
    for r in range(size):
        t.enqueue(r, "a", (600,))
        t.enqueue(r, "b", (400 + delta,))
    rl = t.cycle()
    groups = [rs.tensor_names for rs in rl.responses]
    assert groups == ([["a", "b"]] if delta <= 0 else [["a"], ["b"]])


@pytest.mark.parametrize("size", SIZES)
def test_mismatch_names_the_rank(size):
    t = Twins(size)
    for r in range(size):
        t.enqueue(r, "dt", (5,), dtype=F16 if r == 1 else F32)
        t.enqueue(r, "sh", (5, 2) if r == size - 1 else (5, 3))
        t.enqueue(r, "ok", (7,))
    rl = t.cycle()
    errors = {rs.tensor_names[0]: rs.error for rs in rl.responses
              if rs.error}
    assert "rank 1 submitted op=0 red_op=0 dtype=4" in errors["dt"]
    assert f"rank {size - 1} submitted" in errors["sh"]
    assert rl.cache_resync_needed
    # the burst's healthy member releases once the errors left its unit
    t.cycle()
    assert t.released() == ["ok"]


@pytest.mark.parametrize("size", SIZES)
def test_process_sets_groups_and_join(size):
    rng = np.random.RandomState(30 + size)
    t = Twins(size)
    members = sorted(rng.choice(size, 2, replace=False).tolist())
    t.everyone("register_process_set", 1, members)
    for r in members:
        t.enqueue(r, "in_set", (3,), psid=1)
    # a declared group of three releases only once complete
    for r in range(size):
        t.call(r, "declare_group", 7, 3)
        t.enqueue(r, "g0", (2,), group_id=7)
        t.enqueue(r, "g1", (2,), group_id=7)
    assert not t.cycle().responses    # the group is incomplete
    for r in range(size):
        t.enqueue(r, "g2", (2,), group_id=7)
        t.enqueue(r, "bc", (4,), op_type=wire.BROADCAST, root_rank=size - 1)
    rl = t.cycle()
    # the group releases whole, each rank's burst unit fused on its own
    assert {"in_set", "g0", "g1", "g2", "bc"} == set(t.released())
    assert ["g0", "g1"] in [rs.tensor_names for rs in rl.responses]
    # rank 0 joins; the others still reduce, then join too
    t.call(0, "set_joined")
    for r in range(1, size):
        t.enqueue(r, "late", (6,))
    t.cycle()
    assert "late" in t.released()
    for r in range(1, size):
        t.call(r, "set_joined")
    rl = t.cycle()
    assert rl.join_last_rank in range(1, size)
    for r in range(size):
        t.call(r, "set_shutdown")
    assert t.cycle().shutdown

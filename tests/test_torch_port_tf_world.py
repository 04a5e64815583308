"""The port's TensorFlow/Keras frontends across ranks over gloo, on the
CPU: the bodies of all 12 tests of ``tests/test_multiprocess_tf.py``
(``torch_port_tf_util.BODIES`` names each one's counterpart).

Two spawned worlds serve them, started together: one of 2 ranks runs
11 bodies in order, one of 4 ranks the process-set body.  Each body
writes its own result, and each is a case of ``test_body`` below, held
against the closed form its reference test asserts, computed here from
the same seeded per-rank inputs: the mean of the ranks' gradients by
the port's Average (a sum times the reciprocal 0.5), the root's values
after a broadcast, the gathered rows, the adjoints' sums and slices.
Every value that a 2-rank sum fixes is held bitwise; the
SyncBatchNormalization body is held against keras's BatchNormalization
over the full batch with the reference's tolerance (other formulas).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("tensorflow")
pytest.importorskip("keras")

import torch_port_tf_util as U  # noqa: E402
from torch_port_util import join_world, start_world  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

HALF = np.float32(0.5)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    handles = {n: start_world(U.tf_world_worker, n,
                              tmp_path_factory.mktemp(f"tf{n}"))
               for n in (2, 4)}
    # each rank imports tensorflow (~15 s alone, more under load)
    return {n: (h[2], join_world(h, timeout=300.0)[0])
            for n, h in handles.items()}


def _outs(worlds, name):
    world = U.WORLD_OF[name]
    out_dir, codes = worlds[world]
    outs = []
    for r in range(world):
        path = U.result_path(str(out_dir), name, r)
        assert os.path.exists(path), \
            f"rank {r} wrote no result for {name} (exit codes {codes})"
        with open(path) as f:
            res = json.load(f)
        assert res["ok"], res["error"]
        outs.append(res["out"])
    return outs


def same(got, want):
    """``got`` (from JSON) holds ``want``'s values bitwise."""
    want = np.asarray(want)
    got = np.asarray(got, dtype=want.dtype)
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), \
        (got, want)


def _tape_and_collectives(outs):
    x = [U.tape_inputs(r) for r in range(2)]
    for out in outs:
        same(out["sum"], x[0]["summand"] + x[1]["summand"])
        same(out["gather"], np.concatenate([x[0]["rows"], x[1]["rows"]]))
        same(out["tape_grad"], (x[0]["coeff"] + x[1]["coeff"]) * HALF)
        same(out["bvar"], x[1]["bvar"])
        same(out["bvar_int"], x[1]["bvar_int"])


def _bare_collective_gradients(outs):
    x = [U.bare_inputs(r) for r in range(2)]
    avg = (x[0]["coeff"] + x[1]["coeff"]) * HALF
    summed = np.broadcast_to(x[0]["gather_coeff"] + x[1]["gather_coeff"],
                             (3, 2))
    for r, out in enumerate(outs):
        same(out["bare"], avg)
        same(out["dtape"], avg)
        same(out["gather_grad"], summed[:1] if r == 0 else summed[1:])
        same(out["bcast_grad"], x[0]["k"] + x[1]["k"] if r == 0
             else np.zeros(2, np.float32))


def _keras_fit_lockstep(outs):
    # the broadcast and the averaged gradients keep the ranks identical
    # despite other data and other seeds; the logged loss is averaged
    w0, w1 = ([np.asarray(w, np.float32) for w in o["weights"]]
              for o in outs)
    for a, b in zip(w0, w1):
        same(b, a)
    same(outs[1]["loss"], np.asarray(outs[0]["loss"]))
    assert all(np.isfinite(a).all() for a in w0)


def _sync_batch_normalization(outs):
    import keras

    full = U.sbn_full()
    bn = keras.layers.BatchNormalization(momentum=0.9)
    ref = bn(full, training=True).numpy()
    for r, out in enumerate(outs):
        np.testing.assert_allclose(np.asarray(out["y"]),
                                   ref[r * 8:(r + 1) * 8],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["mean"], bn.moving_mean.numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(out["var"], bn.moving_variance.numpy(),
                                   rtol=1e-4)
        assert np.isfinite(out["g_gamma"]).all()
    # one global statistic on both ranks
    same(outs[1]["mean"], np.asarray(outs[0]["mean"], np.float32))
    same(outs[1]["var"], np.asarray(outs[0]["var"], np.float32))


def _keras_load_model_lockstep(outs):
    # 1 step before the save, 4 after the load, in lockstep
    assert [o["iterations"] for o in outs] == [5, 5]
    for a, b in zip(*(o["weights"] for o in outs)):
        same(b, np.asarray(a, np.float32))


def _op_matrix_alltoall_reducescatter_sparse(outs):
    for r, out in enumerate(outs):
        # rank 0 receives rank 0's first row and rank 1's first 3
        if r == 0:
            assert out["a2a"] == [0.0, 100.0, 101.0, 102.0]
            assert out["a2a_splits"] == [1, 3]
            assert out["rs_uneven_rows"] == 3
        else:
            assert out["a2a"] == [1.0, 2.0, 103.0]
            assert out["a2a_splits"] == [2, 1]
            assert out["rs_uneven_rows"] == 2
        assert out["rs"] == [[2.0, 2.0], [2.0, 2.0]]
        assert out["slices_vals"] == [1.0, 2.0]
        assert out["slices_idx"] == [0, 1]
        assert out["obj"] == {"w": [1, 2, 3], "rank": 0}


def _grouped_allgather_reducescatter(outs):
    x = [U.group_inputs(r) for r in range(2)]
    summed = np.broadcast_to(x[0]["coeff"] + x[1]["coeff"], (3, 2))
    rs0 = x[0]["rs0"] + x[1]["rs0"]
    rs1 = x[0]["rs1"] + x[1]["rs1"]
    c0, c1 = x[0]["c0"], x[0]["c1"]
    for r, out in enumerate(outs):
        same(out["g0"], np.concatenate([x[0]["rows"], x[1]["rows"]]))
        same(out["g1"], np.concatenate([x[0]["one"], x[1]["one"]]).ravel())
        # the upstream gradients summed over the ranks, sliced to the
        # rows this rank contributed
        same(out["grad0"], summed[:1] if r == 0 else summed[1:])
        same(out["grad1"], np.asarray([x[0]["k"] + x[1]["k"]]))
        same(out["rs0"], rs0[2 * r:2 * r + 2])
        same(out["rs1"], rs1[r:r + 1])
        # the adjoint: an allgather of the shards' gradients
        same(out["rsg0"], np.full((4, 2), c0, np.float32))
        same(out["rsg1"], np.full((2,), c1, np.float32))


def _alltoall_no_splits_ragged_grad(outs):
    # each rank receives 2 rows from rank 0 and 1 from rank 1; rank 0's
    # rows 0-1 reached rank 0 (x1), rows 2-3 rank 1 (x2)
    assert [o["rows"] for o in outs] == [3, 3]
    assert outs[0]["out"] == [0.0, 1.0, 0.0]
    assert outs[1]["out"] == [2.0, 3.0, 1.0]
    assert outs[0]["grad"] == [1.0, 1.0, 2.0, 2.0]
    assert outs[1]["grad"] == [1.0, 2.0]


def _graph_mode_fused_broadcast(outs):
    for out in outs:
        assert out["vs"] == [[float(i + 1)] * 4 for i in range(6)]
        assert out["iv"] == [0, 0]
        assert out["sum"] == [3.0]


def _v1_graph_optimizer_minimize(outs):
    for out in outs:
        assert out["last"] < out["first"] * 0.2     # it trained
    same(outs[1]["w"], np.asarray(outs[0]["w"], np.float32))
    np.testing.assert_allclose(outs[0]["w"], [1.0, -2.0, 0.5], atol=0.15)


def _v1_broadcast_hook_monitored_session(outs):
    for out in outs:
        assert out["a"] == [10.0] * 4    # rank 0's initial values
        assert out["b"] == [100.0] * 3


def _process_set_scoped_collectives(outs):
    x = [U.set_inputs(r) for r in range(4)]
    for r, out in enumerate(outs):
        p, q = [s for s in range(4) if s % 2 == r % 2]
        same(out["ar"], x[p]["ar"] + x[q]["ar"])
        same(out["gather"], np.concatenate([x[p]["gather"],
                                            x[q]["gather"]]))
        same(out["bcast"], x[q]["bcast"])
        same(out["tape"], (x[p]["coeff"] + x[q]["coeff"]) * HALF)
        assert out["obj"] == [["rank", p], ["rank", q]]


@pytest.mark.parametrize("name", list(U.BODIES))
def test_body(worlds, name):
    globals()["_" + name](_outs(worlds, name))


def test_the_worlds_exit_cleanly(worlds):
    assert {n: codes for n, (_, codes) in worlds.items()} == \
        {2: [0, 0], 4: [0, 0, 0, 0]}

"""The rank function of the port's TensorFlow/Keras worlds over gloo, and
the seeded inputs both the ranks and the parent test compute from.

Each body mirrors a test of ``tests/test_multiprocess_tf.py`` (named in
``BODIES``) and returns what its rank saw; the parent holds it against
the closed form that test asserts, computed from the same inputs.  This
module imports neither JAX nor the JAX package, so the spawned ranks
load neither; tensorflow is imported inside the rank."""

from __future__ import annotations

import json
import os
import traceback

import numpy as np

SHARED_SEED = 11


def rank_rng(rank: int, salt: int = 0) -> np.random.RandomState:
    return np.random.RandomState(1000 * salt + rank)


def f32(rng, *shape) -> np.ndarray:
    return rng.randn(*shape).astype(np.float32)


# -- the seeded inputs ----------------------------------------------------------

def tape_inputs(rank: int) -> dict:
    rng = rank_rng(rank, 1)
    return dict(summand=f32(rng, 5), rows=f32(rng, rank + 1, 2),
                coeff=f32(rng, 3), bvar=f32(rng, 4),
                bvar_int=rng.randint(-50, 50, size=(3,)).astype(np.int32))


def bare_inputs(rank: int) -> dict:
    rng = rank_rng(rank, 2)
    shared = np.random.RandomState(SHARED_SEED)
    return dict(w=f32(shared, 3), gather_coeff=f32(shared, 3, 1),
                coeff=f32(rng, 3), b=f32(rng, 2), k=f32(rng, 2))


def group_inputs(rank: int) -> dict:
    rng = rank_rng(rank, 3)
    shared = np.random.RandomState(SHARED_SEED + 1)
    return dict(rows=f32(rng, rank + 1, 2), one=f32(rng, 1, 1),
                coeff=f32(shared, 3, 1), k=f32(shared, 1)[0],
                rs0=f32(rng, 4, 2), rs1=f32(rng, 2),
                c0=f32(shared, 1)[0], c1=f32(shared, 1)[0])


def sbn_full() -> np.ndarray:
    return np.random.RandomState(0).rand(16, 4).astype(np.float32) * 2 + 3


def set_inputs(rank: int) -> dict:
    rng = rank_rng(rank, 4)
    return dict(ar=f32(rng, 3), gather=f32(rng, 1, 2), bcast=f32(rng, 2),
                coeff=f32(rng, 2))


# -- the bodies -------------------------------------------------------------------

def _tape_and_collectives(hvd, tf, r, out_dir):
    x = tape_inputs(r)
    out = {"sum": hvd.allreduce(tf.constant(x["summand"]),
                                op=hvd.Sum).numpy().tolist(),
           "gather": hvd.allgather(tf.constant(x["rows"])).numpy().tolist()}
    # tape averaging: rank-dependent gradients -> one average
    w = tf.Variable(np.ones(3, np.float32))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(w * tf.constant(x["coeff"]))
    (g,) = hvd.DistributedGradientTape(tape).gradient(loss, [w])
    out["tape_grad"] = g.numpy().tolist()
    v = tf.Variable(x["bvar"])
    vi = tf.Variable(x["bvar_int"])
    hvd.broadcast_variables([v, vi], root_rank=1)
    out["bvar"] = v.numpy().tolist()
    out["bvar_int"] = vi.numpy().tolist()
    return out


def _bare_collective_gradients(hvd, tf, r, out_dir):
    x = bare_inputs(r)
    out = {}
    # the gradient through a bare averaged allreduce of a replicated
    # weight under a rank-local loss equals the tape's average
    w = tf.Variable(x["w"])
    c = tf.constant(x["coeff"])
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(hvd.allreduce(w, op=hvd.Average) * c)
    out["bare"] = tape.gradient(loss, [w])[0].numpy().tolist()
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(w * c)
    (g,) = hvd.DistributedGradientTape(tape).gradient(loss, [w])
    out["dtape"] = g.numpy().tolist()
    # allgather: the upstream gradient summed, sliced to this rank's rows
    xg = tf.Variable(tf.fill((r + 1, 2), 1.0))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(hvd.allgather(xg)
                             * tf.constant(x["gather_coeff"]))
    out["gather_grad"] = tape.gradient(loss, [xg])[0].numpy().tolist()
    # broadcast: reduce to the root, zeros elsewhere
    b = tf.Variable(x["b"])
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(hvd.broadcast(b, root_rank=0)
                             * tf.constant(x["k"]))
    out["bcast_grad"] = tape.gradient(loss, [b])[0].numpy().tolist()
    return out


def _keras_fit_lockstep(hvd, tf, r, out_dir):
    import keras

    import horovod_tpu_torch.keras as hvd_keras

    rng = np.random.RandomState(r)     # different data on each rank
    x = rng.rand(64, 4).astype(np.float32)
    y = x @ np.arange(4, dtype=np.float32).reshape(4, 1)
    keras.utils.set_random_seed(100 + r)   # different init on each rank
    model = keras.Sequential([keras.layers.Dense(1)])
    model.compile(optimizer=hvd_keras.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.05)), loss="mse")
    hist = model.fit(x, y, epochs=2, batch_size=16, verbose=0, callbacks=[
        hvd_keras.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd_keras.callbacks.MetricAverageCallback()])
    return {"weights": [w.tolist() for w in model.get_weights()],
            "loss": hist.history["loss"]}


def _sync_batch_normalization(hvd, tf, r, out_dir):
    mine = sbn_full()[r * 8:(r + 1) * 8]
    sbn = hvd.SyncBatchNormalization(momentum=0.9)
    with tf.GradientTape() as tape:
        y = sbn(tf.constant(mine), training=True)
        loss = tf.reduce_sum(tf.square(y))
    g_gamma, _ = tape.gradient(loss, sbn.trainable_variables)
    return {"y": y.numpy().tolist(),
            "mean": sbn.moving_mean.numpy().tolist(),
            "var": sbn.moving_variance.numpy().tolist(),
            "g_gamma": g_gamma.numpy().tolist()}


def _keras_load_model_lockstep(hvd, tf, r, out_dir):
    import keras

    import horovod_tpu_torch.tensorflow.keras as hvd_tfk

    path = os.path.join(out_dir, "shared.keras")
    if r == 0:
        keras.utils.set_random_seed(0)
        m = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(1)])
        m.compile(optimizer=keras.optimizers.Adam(0.05), loss="mse")
        x0 = np.random.rand(32, 4).astype(np.float32)
        m.fit(x0, x0.sum(1, keepdims=True), epochs=1, verbose=0)
        m.save(path)
    hvd.allreduce(np.zeros(1), op=hvd.Sum)  # the save barrier
    m = hvd_tfk.load_model(path)
    assert m.optimizer._hvtpu_distributed
    rng = np.random.RandomState(10 + r)     # rank-dependent data
    x = rng.rand(64, 4).astype(np.float32)
    m.fit(x, x.sum(1, keepdims=True), batch_size=16, epochs=1, verbose=0)
    return {"weights": [w.tolist() for w in m.get_weights()],
            "iterations": int(m.optimizer.iterations)}


def _op_matrix_alltoall_reducescatter_sparse(hvd, tf, r, out_dir):
    out = {}
    splits = [1, 2] if r == 0 else [3, 1]
    t = tf.range(sum(splits), dtype=tf.float32) + 100.0 * r
    recv, rsplits = hvd.alltoall(t, splits=splits)
    out["a2a"] = recv.numpy().tolist()
    out["a2a_splits"] = rsplits.numpy().tolist()
    out["rs"] = hvd.reducescatter(tf.ones((4, 2)), op=hvd.Sum).numpy()\
        .tolist()
    out["rs_uneven_rows"] = int(
        hvd.reducescatter(tf.ones((5, 2)), op=hvd.Sum).shape[0])
    sl = tf.IndexedSlices(values=tf.constant([[float(r + 1)]]),
                          indices=tf.constant([r]),
                          dense_shape=tf.constant([2, 1]))
    red = hvd.allreduce(sl, op=hvd.Sum)
    out["slices_vals"] = red.values.numpy().ravel().tolist()
    out["slices_idx"] = red.indices.numpy().tolist()
    out["obj"] = hvd.broadcast_object(
        {"w": [1, 2, 3], "rank": r} if r == 0 else None, root_rank=0)
    return out


def _grouped_allgather_reducescatter(hvd, tf, r, out_dir):
    x = group_inputs(r)
    out = {}
    xs = [tf.Variable(x["rows"]), tf.Variable(x["one"])]
    with tf.GradientTape() as tape:
        gathered = hvd.grouped_allgather(xs)
        loss = (tf.reduce_sum(gathered[0] * tf.constant(x["coeff"]))
                + tf.reduce_sum(gathered[1] * x["k"]))
    out["g0"] = gathered[0].numpy().tolist()
    out["g1"] = gathered[1].numpy().ravel().tolist()
    grads = tape.gradient(loss, xs)
    out["grad0"] = grads[0].numpy().tolist()
    out["grad1"] = grads[1].numpy().ravel().tolist()
    ys = [tf.Variable(x["rs0"]), tf.Variable(x["rs1"])]
    with tf.GradientTape() as tape:
        red = hvd.grouped_reducescatter(ys, op=hvd.Sum)
        loss = (tf.reduce_sum(red[0] * x["c0"])
                + tf.reduce_sum(red[1] * x["c1"]))
    out["rs0"] = red[0].numpy().tolist()
    out["rs1"] = red[1].numpy().tolist()
    grads = tape.gradient(loss, ys)
    out["rsg0"] = grads[0].numpy().tolist()
    out["rsg1"] = grads[1].numpy().tolist()
    return out


def _alltoall_no_splits_ragged_grad(hvd, tf, r, out_dir):
    # rank 0 sends 4 rows (2 a peer), rank 1 sends 2 (1 a peer): each
    # receives 3, so an equal-splits replay would misroute or crash
    n = 4 if r == 0 else 2
    x = tf.range(float(n))
    with tf.GradientTape() as t:
        t.watch(x)
        out = hvd.alltoall(x)
        y = tf.reduce_sum(out * float(r + 1))
    return {"rows": int(out.shape[0]), "out": out.numpy().tolist(),
            "grad": t.gradient(y, x).numpy().tolist()}


def _graph_mode_fused_broadcast(hvd, tf, r, out_dir):
    vs = [tf.Variable(tf.fill((4,), float((r + 1) * (i + 1))))
          for i in range(6)]
    iv = tf.Variable(tf.constant([r, r], tf.int32))

    @tf.function
    def sync():
        hvd.broadcast_variables(vs + [iv], root_rank=0)

    sync()

    @tf.function
    def red():
        return hvd.allreduce(tf.constant([float(r + 1)]), op=hvd.Sum)

    return {"vs": [v.numpy().tolist() for v in vs],
            "iv": iv.numpy().tolist(), "sum": red().numpy().tolist()}


def _v1_graph_optimizer_minimize(hvd, tf, r, out_dir):
    tf1 = tf.compat.v1
    tf1.disable_eager_execution()
    g = tf.Graph()
    with g.as_default():
        # this rank's shard of one linear regression
        rng = np.random.RandomState(0)
        x_all = rng.rand(64, 3).astype(np.float32)
        y_all = x_all @ np.array([[1.0], [-2.0], [0.5]], np.float32)
        x_np, y_np = x_all[r::2], y_all[r::2]
        x = tf1.placeholder(tf.float32, [None, 3])
        y = tf1.placeholder(tf.float32, [None, 1])
        w = tf1.get_variable("w", initializer=tf.zeros([3, 1]))
        loss = tf1.reduce_mean(tf.square(x @ w - y))
        opt = hvd.DistributedOptimizer(
            tf1.train.GradientDescentOptimizer(0.5))
        train_op = opt.minimize(loss)
        bcast = [tf1.assign(w, hvd.broadcast(w, root_rank=0))]
        init = tf1.global_variables_initializer()
        with tf1.Session(graph=g) as sess:
            sess.run(init)
            sess.run(bcast)
            first = None
            for _ in range(40):
                _, lv = sess.run([train_op, loss],
                                 feed_dict={x: x_np, y: y_np})
                first = lv if first is None else first
            final_w = sess.run(w)
    return {"first": float(first), "last": float(lv),
            "w": final_w.ravel().tolist()}


def _v1_broadcast_hook_monitored_session(hvd, tf, r, out_dir):
    tf1 = tf.compat.v1
    tf1.disable_eager_execution()
    g = tf.Graph()
    with g.as_default():
        v1 = tf1.get_variable("a", initializer=tf.fill([2, 2],
                                                       float(10 + r)))
        v2 = tf1.get_variable("b", initializer=tf.fill([3],
                                                       float(100 + r)))
        hook = hvd.BroadcastGlobalVariablesHook(0)
        with tf1.train.MonitoredTrainingSession(hooks=[hook]) as sess:
            a, b = sess.run([v1, v2])
    return {"a": a.ravel().tolist(), "b": b.tolist()}


def _process_set_scoped_collectives(hvd, tf, r, out_dir):
    assert hvd.size() == 4
    x = set_inputs(r)
    evens = hvd.add_process_set([0, 2])
    odds = hvd.add_process_set([1, 3])
    mine = evens if r % 2 == 0 else odds
    out = {
        "ar": hvd.allreduce(tf.constant(x["ar"]), op=hvd.Sum,
                            process_set=mine).numpy().tolist(),
        "gather": hvd.allgather(tf.constant(x["gather"]),
                                process_set=mine).numpy().tolist(),
        "bcast": hvd.broadcast(tf.constant(x["bcast"]),
                               root_rank=mine.ranks[1],
                               process_set=mine).numpy().tolist(),
    }
    # the tape averages within the set only
    w = tf.Variable(np.ones(2, np.float32))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(w * tf.constant(x["coeff"]))
    (g,) = hvd.DistributedGradientTape(tape, process_set=mine).gradient(
        loss, [w])
    out["tape"] = g.numpy().tolist()
    out["obj"] = hvd.allgather_object(["rank", r], process_set=mine)
    return out


#: body -> the test of tests/test_multiprocess_tf.py it mirrors; the two
#: v1 bodies leave eager execution off, so they run last
BODIES = {
    "tape_and_collectives": "test_tf_tape_and_collectives_2proc",
    "bare_collective_gradients": "test_tf_bare_collective_gradients_2proc",
    "keras_fit_lockstep": "test_keras_fit_lockstep_2proc",
    "sync_batch_normalization": "test_sync_batch_normalization_2proc",
    "keras_load_model_lockstep": "test_keras_load_model_lockstep_2proc",
    "op_matrix_alltoall_reducescatter_sparse":
        "test_tf_op_matrix_alltoall_reducescatter_sparse_2proc",
    "grouped_allgather_reducescatter":
        "test_tf_grouped_allgather_reducescatter_2proc",
    "alltoall_no_splits_ragged_grad":
        "test_tf_alltoall_no_splits_ragged_grad_2proc",
    "graph_mode_fused_broadcast": "test_tf_graph_mode_fused_broadcast_2proc",
    "v1_graph_optimizer_minimize":
        "test_tf_v1_graph_optimizer_minimize_2proc",
    "v1_broadcast_hook_monitored_session":
        "test_tf_v1_broadcast_hook_monitored_session_2proc",
    "process_set_scoped_collectives":
        "test_tf_process_set_scoped_collectives_4proc",
}
WORLD_OF = {name: 4 if name == "process_set_scoped_collectives" else 2
            for name in BODIES}


def result_path(out_dir: str, name: str, rank: int) -> str:
    return os.path.join(out_dir, f"{name}.rank{rank}.json")


def tf_world_worker(rank: int, world: int, store_path: str,
                    out_dir: str) -> None:
    """Run this world's bodies in order, each writing its own result
    (``{"ok": ..., "out" or "error": ...}``)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import tensorflow as tf

    import horovod_tpu_torch.tensorflow as hvd

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        hvd.init(device="cpu")
        for name in BODIES:
            if WORLD_OF[name] != world:
                continue
            try:
                res = {"ok": True, "out": globals()["_" + name](
                    hvd, tf, rank, out_dir)}
            except Exception:  # noqa: BLE001 — recorded for the parent
                res = {"ok": False, "error": traceback.format_exc()}
            tmp = result_path(out_dir, "." + name, rank)
            with open(tmp, "w") as f:
                json.dump(res, f)
            os.replace(tmp, result_path(out_dir, name, rank))
        hvd.shutdown()
    finally:
        dist.destroy_process_group()

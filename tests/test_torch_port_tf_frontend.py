"""The port's TensorFlow and Keras frontends (``horovod_tpu_torch.
{tensorflow,keras,_keras,tensorflow.keras}``) against the JAX package's
(``horovod_tpu.{tensorflow,keras,...}``) at one rank, on the CPU.

Every test of ``tests/test_tf_frontend.py`` has a counterpart here, in
a class and under a name of its own: ``TestX::test_y`` mirrors
``tests/test_tf_frontend.py::TestX::test_y``.  Each runs the reference's
body once through each package, the reference initialized by the
``hvt`` fixture and the port by ``init(device="cpu")``, on the same
inputs (keras seeded alike before each run), keeps the reference's own
checks, and holds what the two runs return **bitwise**: outputs,
gradients, weights after fit steps, optimizer slots.

The reference runs its float64 cases under ``jax.enable_x64(True)``
(``reference_x64``), its documented route to true-fp64 collectives;
with x64 off it narrows float64 to float32 on the wire, where the port
reduces float64 in float64 (ROADMAP Queue C, kept on purpose).

One exception, by design: ``TestTfOps::test_build_info_surface``.  The
port's tf surface reports what its torch surface reports
(``xla_built()`` False, ``nccl_built()`` NCCL's version where torch has
NCCL, 0 on a CPU build), the opposite of the reference's.

Beyond the counterparts: a ``.keras`` file saved under one package's
wrapped optimizer loads under the other's ``load_model`` with its
``iterations`` and slots bitwise; the bridge leaves every input tf
tensor as it was; and ``chip_smoke.py``'s ``frontends`` phase runs on
the CPU in place of the card.
"""

import contextlib
import importlib
import logging
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
keras = pytest.importorskip("keras")

# chip_smoke.py, whose frontends phase is rehearsed at the end
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

import horovod_tpu  # noqa: E402
import horovod_tpu.keras as ref_keras  # noqa: E402
import horovod_tpu.keras.elastic  # noqa: E402,F401
import horovod_tpu.tensorflow as ref_tf  # noqa: E402
import horovod_tpu.tensorflow.keras  # noqa: E402,F401
import horovod_tpu_torch  # noqa: E402
import horovod_tpu_torch.keras as port_keras  # noqa: E402
import horovod_tpu_torch.keras.elastic  # noqa: E402,F401
import horovod_tpu_torch.tensorflow as port_tf  # noqa: E402
import horovod_tpu_torch.tensorflow.keras  # noqa: E402,F401
from torch_port_util import no_leaked_reference  # noqa: E402,F401


def _pkg(name, root):
    mod = lambda sub: importlib.import_module(f"{root}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, root=importlib.import_module(root),
        tf=mod("tensorflow"), keras=mod("keras"),
        tfk=mod("tensorflow.keras"), tf_elastic=mod("tensorflow.elastic"),
        k_elastic=mod("keras.elastic"), eager=mod("comm.eager"),
        process_set=mod("core.process_set"),
        mpi_ops=mod("tensorflow.mpi_ops"), logger=root)


REF = _pkg("ref", "horovod_tpu")
PORT = _pkg("port", "horovod_tpu_torch")
SEED = 1234


@pytest.fixture(scope="module")
def port_world():
    horovod_tpu_torch.init(device="cpu")
    yield
    horovod_tpu_torch.shutdown()


def _numpy(v):
    if isinstance(v, (tf.Tensor, tf.Variable)) or hasattr(v, "numpy"):
        return v.numpy()
    return v


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, _numpy(x)


def assert_bitwise(ref, port):
    """The same tree, every array of the same dtype, shape and bytes,
    every other leaf equal."""
    a, b = list(_leaves(ref)), list(_leaves(port))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        if isinstance(x, (np.ndarray, np.generic)) \
                or isinstance(y, (np.ndarray, np.generic)):
            x, y = np.asarray(x), np.asarray(y)
            assert (x.dtype, x.shape) == (y.dtype, y.shape), path
            assert x.tobytes() == y.tobytes(), (path, x, y)
        else:
            assert type(x) is type(y) and x == y, (path, x, y)


@contextlib.contextmanager
def reference_x64():
    """JAX's x64 mode for a run of the reference.  ``jax.enable_x64``
    holds on this thread alone, and the reference's graph-mode ops run on
    a TF executor thread, so the process-wide default is set as well,
    and restored on the way out."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jax.config.update("jax_enable_x64", was)


@pytest.fixture
def both(hvt, port_world, tmp_path, monkeypatch):
    """``both(body)``: ``body(m, ctx)`` once with the reference's modules
    and once with the port's (``m``), each with a directory and the
    monkeypatch (``ctx``) and keras seeded alike; the two results are
    held bitwise and returned."""
    def run(body, ref_x64=False):
        outs = []
        for m in (REF, PORT):
            ctx = SimpleNamespace(dir=tmp_path / m.name, mp=monkeypatch)
            ctx.dir.mkdir()
            keras.utils.set_random_seed(SEED)
            x64 = reference_x64() if ref_x64 and m is REF \
                else contextlib.nullcontext()
            with x64:
                outs.append(body(m, ctx))
        assert_bitwise(*outs)
        return outs

    return run


def _data(seed, n, d, out=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    return x, x @ rng.rand(d, out).astype(np.float32)


def _raises(exc, fn, match=None):
    with pytest.raises(exc, match=match) as e:
        fn()
    return type(e.value).__name__


class TestTfOps:
    def test_allreduce_eager(self, both):
        def body(m, ctx):
            out = m.tf.allreduce(tf.constant([1.0, 2.0]), op=m.tf.Sum)
            assert isinstance(out, tf.Tensor)
            np.testing.assert_allclose(out.numpy(), [1.0, 2.0])
            return out

        both(body)

    def test_allreduce_graph_mode(self, both):
        def body(m, ctx):
            @tf.function
            def step(t):
                return m.tf.allreduce(t, op=m.tf.Average)

            out = step(tf.constant([[2.0, 4.0]]))
            np.testing.assert_allclose(out.numpy(), [[2.0, 4.0]])
            assert out.shape == (1, 2)
            return out

        both(body)

    def test_allreduce_graph_mode_float64(self, both):
        # py_function's Tout contract: the declared float64 is restored
        def body(m, ctx):
            @tf.function
            def step(t):
                return m.tf.allreduce(t, op=m.tf.Sum)

            out = step(tf.constant([1.5, 2.5 + 1e-12], dtype=tf.float64))
            assert out.dtype == tf.float64
            np.testing.assert_allclose(out.numpy(), [1.5, 2.5 + 1e-12])
            return out

        both(body, ref_x64=True)

    def test_alltoall_graph_mode_float64(self, both):
        def body(m, ctx):
            @tf.function
            def step(t):
                return m.tf.alltoall(t, splits=tf.constant([2]))

            out, rsplits = step(
                tf.constant([1.5, 2.5 + 1e-12], dtype=tf.float64))
            assert out.dtype == tf.float64
            np.testing.assert_allclose(out.numpy(), [1.5, 2.5 + 1e-12])
            np.testing.assert_array_equal(rsplits.numpy(), [2])
            return out, rsplits

        both(body, ref_x64=True)

    def test_allreduce_eager_float64_and_bfloat16(self, both):
        def body(m, ctx):
            out = m.tf.allreduce(
                tf.constant([1.0, 2.0 + 1e-12], dtype=tf.float64),
                op=m.tf.Sum)
            assert out.dtype == tf.float64
            out16 = m.tf.allreduce(
                tf.constant([1.0, 2.0], dtype=tf.bfloat16), op=m.tf.Sum)
            assert out16.dtype == tf.bfloat16
            np.testing.assert_allclose(
                tf.cast(out16, tf.float32).numpy(), [1.0, 2.0])
            return out, out16

        both(body, ref_x64=True)

    def test_allgather_and_broadcast(self, both):
        def body(m, ctx):
            g = m.tf.allgather(tf.ones((3, 2)))
            assert g.shape == (3, 2)
            b = m.tf.broadcast(tf.constant([7.0]), root_rank=0)
            np.testing.assert_allclose(b.numpy(), [7.0])
            return g, b

        both(body)

    def test_alltoall_with_splits(self, both):
        def body(m, ctx):
            out, rsplits = m.tf.alltoall(
                tf.constant([1.0, 2.0, 3.0]), splits=tf.constant([3]))
            np.testing.assert_allclose(out.numpy(), [1.0, 2.0, 3.0])
            assert rsplits.numpy().tolist() == [3]
            return out, rsplits

        both(body)

    def test_indexed_slices_allreduce(self, both):
        def body(m, ctx):
            s = tf.IndexedSlices(
                values=tf.ones((2, 4)), indices=tf.constant([1, 3]),
                dense_shape=tf.constant([5, 4]))
            r = m.tf.allreduce(s, op=m.tf.Average)
            assert isinstance(r, tf.IndexedSlices)
            np.testing.assert_allclose(r.values.numpy(), np.ones((2, 4)))
            assert r.indices.numpy().tolist() == [1, 3]
            return r.values, r.indices, r.dense_shape

        both(body)

    def test_broadcast_variables(self, both):
        def body(m, ctx):
            v1 = tf.Variable([1.0, 2.0])
            v2 = tf.Variable([[3.0]])
            v3 = tf.Variable([4, 5, 6], dtype=tf.int32)
            m.tf.broadcast_variables([v1, v2, v3], root_rank=0)
            np.testing.assert_allclose(v1.numpy(), [1.0, 2.0])
            return v1, v2, v3

        both(body)

    def test_broadcast_object_fn(self, both):
        def body(m, ctx):
            bcast = m.tf.broadcast_object_fn(root_rank=0)
            got = bcast({"k": 7})
            assert got == {"k": 7}
            return got

        both(body)

    def test_broadcast_object_roundtrip(self, both):
        def body(m, ctx):
            obj = {"step": 12, "name": "x"}
            got = m.tf.broadcast_object(obj, root_rank=0)
            gathered = m.tf.allgather_object(obj)
            assert got == obj and gathered == [obj]
            return got, gathered

        both(body)

    def test_broadcast_global_variables_eager_rejected(self, both):
        def body(m, ctx):
            name = _raises(RuntimeError,
                           lambda: m.tf.broadcast_global_variables(0),
                           match="graph-mode only")
            assert hasattr(m.tf, "BroadcastGlobalVariablesHook")
            return name

        both(body)

    def test_elastic_module_attribute(self, both):
        def body(m, ctx):
            assert m.tf.elastic.run is m.root.elastic.run
            return hasattr(m.tf.elastic, "run")

        both(body)

    def test_tensorflow_keras_package_layout(self, both):
        def body(m, ctx):
            assert m.tfk.DistributedOptimizer is m.keras.DistributedOptimizer
            assert m.tfk.callbacks.BroadcastGlobalVariablesCallback is \
                m.keras.callbacks.BroadcastGlobalVariablesCallback
            assert m.tfk.elastic.KerasState is m.tf_elastic.\
                TensorFlowKerasState
            assert m.tfk.elastic.run is m.root.elastic.run
            return hasattr(m.k_elastic, "KerasState")

        both(body)

    def test_build_info_surface(self, hvt, port_world):
        # the one exception, by design: each tf surface reports its own
        # package's build (the reference is the XLA backend; the port's
        # tf surface answers what its torch surface answers)
        assert ref_tf.xla_built() and not ref_tf.nccl_built()
        for name in ("xla_built", "nccl_built", "mpi_built", "gloo_built",
                     "cuda_built", "rocm_built", "ddl_built", "ccl_built",
                     "gloo_enabled", "mpi_enabled",
                     "mpi_threads_supported"):
            assert getattr(port_tf, name)() == \
                getattr(horovod_tpu_torch.torch, name)(), name
        assert port_tf.xla_built() is False
        assert port_tf.gloo_enabled() is True     # init(device="cpu")
        for hvd in (ref_tf, port_tf):
            assert hvd.size() == 1 and hvd.rank() == 0


class TestRegisteredGradients:
    def test_allreduce_grad_is_allreduce_of_grad(self, both):
        def body(m, ctx):
            x = tf.constant([1.0, 2.0, 3.0])
            with tf.GradientTape() as t:
                t.watch(x)
                y = tf.reduce_sum(m.tf.allreduce(x * 2.0, op=m.tf.Sum))
            g = t.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [2.0, 2.0, 2.0])
            return y, g

        both(body)

    def test_allreduce_grad_in_graph_mode(self, both):
        def body(m, ctx):
            x = tf.constant([1.0, 2.0])

            @tf.function
            def f(x):
                with tf.GradientTape() as t:
                    t.watch(x)
                    y = tf.reduce_sum(
                        m.tf.allreduce(x, op=m.tf.Average) * 4.0)
                return t.gradient(y, x)

            g = f(x)
            np.testing.assert_allclose(g.numpy(), [4.0, 4.0])
            return g

        both(body)

    def test_allreduce_minmax_grad_rejected(self, both):
        def body(m, ctx):
            x = tf.constant([1.0])
            with tf.GradientTape() as t:
                t.watch(x)
                y = m.tf.allreduce(x, op=m.tf.Min)
            return y, _raises(NotImplementedError,
                              lambda: t.gradient(y, x), match="MIN")

        both(body)

    def test_allgather_grad_slices_own_rows(self, both):
        def body(m, ctx):
            x = tf.constant([[1.0], [1.0]])
            with tf.GradientTape() as t:
                t.watch(x)
                y = tf.reduce_sum(
                    m.tf.allgather(x) * tf.constant([[2.0], [5.0]]))
            g = t.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [[2.0], [5.0]])
            return y, g

        both(body)

    def test_broadcast_grad_reduces_to_root(self, both):
        def body(m, ctx):
            x = tf.constant([1.0, 1.0])
            with tf.GradientTape() as t:
                t.watch(x)
                y = tf.reduce_sum(m.tf.broadcast(x, root_rank=0) * 3.0)
            g = t.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [3.0, 3.0])
            return y, g

        both(body)

    def test_reducescatter_grad_is_allgather(self, both):
        def body(m, ctx):
            x = tf.constant([[1.0], [2.0]])
            with tf.GradientTape() as t:
                t.watch(x)
                y = tf.reduce_sum(m.tf.reducescatter(x, op=m.tf.Sum) * 7.0)
            g = t.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [[7.0], [7.0]])
            return y, g

        both(body)

    def test_alltoall_grad_routes_back(self, both):
        def body(m, ctx):
            x = tf.constant([1.0, 2.0, 3.0])
            with tf.GradientTape() as t:
                t.watch(x)
                out, _ = m.tf.alltoall(x, splits=[3])
                y = tf.reduce_sum(out * 5.0)
            g = t.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [5.0, 5.0, 5.0])
            return out, g

        both(body)

    def test_grouped_allreduce_grad(self, both):
        def body(m, ctx):
            xs = [tf.constant([1.0, 1.0]), tf.constant([1.0, 1.0, 1.0])]
            with tf.GradientTape() as t:
                t.watch(xs)
                outs = m.tf.grouped_allreduce(xs, op=m.tf.Sum)
                y = tf.reduce_sum(outs[0] * 2.0) + tf.reduce_sum(
                    outs[1] * 3.0)
            g0, g1 = t.gradient(y, xs)
            np.testing.assert_allclose(g0.numpy(), [2.0, 2.0])
            np.testing.assert_allclose(g1.numpy(), [3.0, 3.0, 3.0])
            return outs, g0, g1

        both(body)

    def test_alltoall_equal_splits_grad(self, both):
        def body(m, ctx):
            x = tf.constant([1.0, 2.0])
            with tf.GradientTape() as t:
                t.watch(x)
                out = m.tf.alltoall(x)
                y = tf.reduce_sum(out * 2.0)
            g = t.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [2.0, 2.0])
            return out, g

        both(body)

    def test_grouped_allgather_values_and_grad(self, both):
        def body(m, ctx):
            xs = [tf.constant([[1.0], [2.0]]), tf.constant([[3.0, 4.0]])]
            with tf.GradientTape() as t:
                t.watch(xs)
                outs = m.tf.grouped_allgather(xs)
                y = (tf.reduce_sum(outs[0] * tf.constant([[2.0], [5.0]]))
                     + tf.reduce_sum(outs[1] * 3.0))
            np.testing.assert_allclose(outs[0].numpy(), [[1.0], [2.0]])
            np.testing.assert_allclose(outs[1].numpy(), [[3.0, 4.0]])
            g0, g1 = t.gradient(y, xs)
            np.testing.assert_allclose(g0.numpy(), [[2.0], [5.0]])
            np.testing.assert_allclose(g1.numpy(), [[3.0, 3.0]])
            return outs, g0, g1

        both(body)

    def test_grouped_reducescatter_values_and_grad(self, both):
        def body(m, ctx):
            xs = [tf.constant([[1.0], [2.0]]), tf.constant([3.0, 4.0])]
            with tf.GradientTape() as t:
                t.watch(xs)
                outs = m.tf.grouped_reducescatter(xs, op=m.tf.Sum)
                y = (tf.reduce_sum(outs[0] * 7.0)
                     + tf.reduce_sum(outs[1] * 2.0))
            np.testing.assert_allclose(outs[0].numpy(), [[1.0], [2.0]])
            np.testing.assert_allclose(outs[1].numpy(), [3.0, 4.0])
            g0, g1 = t.gradient(y, xs)
            np.testing.assert_allclose(g0.numpy(), [[7.0], [7.0]])
            np.testing.assert_allclose(g1.numpy(), [2.0, 2.0])
            return outs, g0, g1

        both(body)

    def test_grouped_ops_graph_mode_fallback(self, both):
        def body(m, ctx):
            @tf.function
            def step(a, b):
                outs = m.tf.grouped_allgather([a, b])
                red = m.tf.grouped_reducescatter([a, b], op=m.tf.Sum)
                return outs[0], red[1]

            o0, r1 = step(tf.constant([[1.0]]), tf.constant([2.0]))
            np.testing.assert_allclose(o0.numpy(), [[1.0]])
            np.testing.assert_allclose(r1.numpy(), [2.0])
            return o0, r1

        both(body)


class TestDistributedGradientTape:
    def test_gradients_pass_through(self, both):
        def body(m, ctx):
            w = tf.Variable([[1.0], [2.0]])
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(tf.matmul(tf.ones((4, 2)), w))
            dtape = m.tf.DistributedGradientTape(tape)
            (g,) = dtape.gradient(loss, [w])
            np.testing.assert_allclose(g.numpy().ravel(), [4.0, 4.0])
            return g

        both(body)

    def test_none_gradient_preserved(self, both):
        def body(m, ctx):
            w = tf.Variable([1.0])
            unused = tf.Variable([1.0])
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(w * 2.0)
            dtape = m.tf.DistributedGradientTape(tape)
            g = dtape.gradient(loss, [w, unused])
            assert g[1] is None
            np.testing.assert_allclose(g[0].numpy(), [2.0])
            return g[0]

        both(body)

    def test_predivide_average_equivalence(self, both):
        def body(m, ctx):
            rng = np.random.RandomState(3)
            w = tf.Variable(rng.randn(5).astype(np.float32))
            c = tf.constant(rng.randn(5).astype(np.float32))
            with tf.GradientTape() as tape:
                loss = tf.reduce_sum(w * c)
            dtape = m.tf.DistributedGradientTape(
                tape, gradient_predivide_factor=2.0)
            (g,) = dtape.gradient(loss, [w])
            # predivide splits the averaging; a single rank: same value
            np.testing.assert_allclose(g.numpy(), c.numpy())
            return g

        both(body)

    def test_context_manager_and_watch(self, both):
        def body(m, ctx):
            x = tf.constant([2.0, 3.0])
            with m.tf.DistributedGradientTape(tf.GradientTape()) as dtape:
                dtape.watch(x)
                y = tf.reduce_sum(x * x)
            g = dtape.gradient(y, x)
            np.testing.assert_allclose(g.numpy(), [4.0, 6.0])
            return g

        both(body)

    def test_sparse_predivide_scaling(self, both):
        def body(m, ctx):
            emb = tf.Variable(tf.ones((4, 2)))
            with tf.GradientTape() as tape:
                rows = tf.gather(emb, [0, 2])
                loss = tf.reduce_sum(rows * 3.0)
            dtape = m.tf.DistributedGradientTape(
                tape, gradient_predivide_factor=2.0)
            (g,) = dtape.gradient(loss, [emb])
            assert isinstance(g, tf.IndexedSlices)
            np.testing.assert_allclose(g.values.numpy(),
                                       np.full((2, 2), 3.0))
            return g.values, g.indices

        both(body)


def _weights(model):
    return [np.asarray(w) for w in model.get_weights()]


class TestKerasOptimizer:
    def test_wrap_preserves_config(self, both):
        def body(m, ctx):
            opt = keras.optimizers.SGD(learning_rate=0.25, momentum=0.9)
            dopt = m.keras.DistributedOptimizer(opt)
            assert type(dopt).__name__ == "DistributedSGD"
            assert dopt._hvtpu_distributed
            assert isinstance(dopt, keras.optimizers.Optimizer)
            cfg = dopt.get_config()
            return float(np.asarray(dopt.learning_rate)), \
                cfg["momentum"], cfg["name"]

        both(body)

    def test_fit_converges(self, both):
        def body(m, ctx):
            x, y = _data(0, 128, 8)
            model = keras.Sequential([keras.layers.Dense(1)])
            dopt = m.keras.DistributedOptimizer(
                keras.optimizers.SGD(learning_rate=0.2))
            model.compile(optimizer=dopt, loss="mse")
            losses = model.fit(x, y, epochs=4, batch_size=32,
                               verbose=0).history["loss"]
            assert losses[-1] < losses[0] * 0.5
            return losses, _weights(model)

        both(body)

    def test_backward_passes_per_step_aggregates(self, both):
        def body(m, ctx):
            opt = m.keras.DistributedOptimizer(
                keras.optimizers.SGD(learning_rate=1.0),
                backward_passes_per_step=2)
            v = tf.Variable([10.0])
            seen = []
            for g, want in ((2.0, 10.0), (4.0, 7.0), (6.0, 7.0),
                            (0.0, 4.0)):
                opt.apply([tf.constant([g])], [v])
                np.testing.assert_allclose(v.numpy(), [want])
                seen.append(v.numpy().copy())
            return seen, int(opt.iterations.numpy())

        both(body)

    def test_backward_passes_skip_stateful_updates(self, both):
        def body(m, ctx):
            opt = m.keras.DistributedOptimizer(
                keras.optimizers.SGD(learning_rate=1.0, momentum=0.9),
                backward_passes_per_step=2)
            v = tf.Variable([10.0])
            opt.apply([tf.constant([2.0])], [v])
            opt.apply([tf.constant([2.0])], [v])   # sync: momentum
            after_first_sync = v.numpy().copy()
            assert int(opt.iterations.numpy()) == 1
            opt.apply([tf.constant([0.0])], [v])   # micro-step
            assert v.numpy()[0] == after_first_sync[0]
            assert int(opt.iterations.numpy()) == 1
            return after_first_sync, v, [np.asarray(s)
                                         for s in opt.variables]

        both(body)

    def test_backward_passes_per_step_in_fit(self, both):
        def body(m, ctx):
            x, y = _data(0, 64, 4)
            model = keras.Sequential([keras.layers.Dense(1)])
            dopt = m.keras.DistributedOptimizer(
                keras.optimizers.SGD(learning_rate=0.4),
                backward_passes_per_step=2)
            model.compile(optimizer=dopt, loss="mse")
            losses = model.fit(x, y, epochs=4, batch_size=16,
                               verbose=0).history["loss"]
            assert losses[-1] < losses[0]
            return losses, _weights(model), int(dopt.iterations.numpy())

        both(body)

    def test_v1_optimizer_wrap(self, both):
        def body(m, ctx):
            v1_opt = tf.compat.v1.train.GradientDescentOptimizer(0.1)
            dopt = m.tf.DistributedOptimizer(v1_opt)
            assert dopt.get_slot_names() == v1_opt.get_slot_names()
            return dopt.get_slot_names(), type(dopt).__name__

        both(body)

    def test_unsupported_optimizer_rejected(self, both):
        def body(m, ctx):
            return _raises(ValueError,
                           lambda: m.tf.DistributedOptimizer(object()),
                           match="unsupported optimizer")

        both(body)


class TestTensorFlowState:
    def test_variable_commit_restore_roundtrip(self, both):
        def body(m, ctx):
            v = tf.Variable([1.0, 2.0])
            w = tf.Variable([[3.0]])
            state = m.tf_elastic.TensorFlowState(variables=[v, w], batch=0)
            state.commit()
            v.assign([9.0, 9.0])
            w.assign([[9.0]])
            state.batch = 7
            state.restore()
            np.testing.assert_allclose(v.numpy(), [1.0, 2.0])
            np.testing.assert_allclose(w.numpy(), [[3.0]])
            assert state.batch == 0
            return v, w, state.batch

        both(body)

    def test_eager_requires_explicit_variables(self, both):
        def body(m, ctx):
            return _raises(ValueError, m.tf_elastic.TensorFlowState,
                           match="explicit")

        both(body)

    def test_refuses_partial_restore_on_var_count_mismatch(self, both):
        def body(m, ctx):
            state = m.tf_elastic.TensorFlowState(
                variables=[tf.Variable([1.0]), tf.Variable([2.0])])
            return _raises(
                ValueError,
                lambda: state._apply({"__vars__": [np.zeros(1)]}),
                match="partial restore")

        both(body)


class TestTensorFlowKerasState:
    def test_commit_restore_roundtrip(self, both):
        def body(m, ctx):
            model = keras.Sequential([keras.layers.Dense(2)])
            model.build((None, 3))
            state = m.tf_elastic.TensorFlowKerasState(model, epoch=0)
            w0 = _weights(model)
            state.commit()
            model.set_weights([w + 1.0 for w in model.get_weights()])
            state.epoch = 5
            state.restore()
            for a, b in zip(_weights(model), w0):
                np.testing.assert_array_equal(a, b)
            assert state.epoch == 0
            return _weights(model), state.epoch

        both(body)

    def test_sync_broadcasts(self, both):
        def body(m, ctx):
            model = keras.Sequential([keras.layers.Dense(2)])
            model.build((None, 3))
            state = m.tf_elastic.TensorFlowKerasState(model, epoch=3)
            state.sync()
            assert state.epoch == 3  # a world of one: the identity
            return _weights(model), state.epoch

        both(body)

    def test_restart_restores_momentum_into_fresh_optimizer(self, both):
        # the committed optimizer has momentum slots, the relaunched
        # process's fresh one does not: restore builds it and carries
        # the slots over
        def body(m, ctx):
            ctx.mp.setenv("HVTPU_ELASTIC_STATE_DIR", str(ctx.dir))

            def make():
                mdl = keras.Sequential([keras.layers.Dense(1)])
                mdl.build((None, 2))
                return mdl, keras.optimizers.SGD(0.1, momentum=0.9)

            model, opt = make()
            opt.build(model.trainable_variables)
            n_built = len(opt.variables)
            for v in opt.variables:
                if "momentum" in v.path:
                    v.assign(tf.fill(v.shape, 0.5))
            state = m.tf_elastic.TensorFlowKerasState(model, optimizer=opt,
                                                      epoch=1)
            state.commit()
            state.wait_durable()

            model2, opt2 = make()  # unbuilt: no momentum slots yet
            assert len(opt2.variables) < n_built
            state2 = m.tf_elastic.TensorFlowKerasState(
                model2, optimizer=opt2, epoch=0)
            state2.sync()  # loads the durable commit
            assert state2.epoch == 1
            mom = [v for v in opt2.variables if "momentum" in v.path]
            assert mom and all(np.allclose(np.asarray(v), 0.5)
                               for v in mom)
            assert all((a == b).all() for a, b in
                       zip(_weights(model2), _weights(model)))
            return [np.asarray(v) for v in opt2.variables], state2.epoch

        both(body)

    def test_refuses_partial_optimizer_restore(self, both):
        def body(m, ctx):
            model = keras.Sequential([keras.layers.Dense(1)])
            model.build((None, 2))
            opt = keras.optimizers.SGD(0.1, momentum=0.9)
            opt.build(model.trainable_variables)
            state = m.tf_elastic.TensorFlowKerasState(model, optimizer=opt)
            return _raises(
                ValueError,
                lambda: state._apply({"__opt_vars__": [np.zeros(1)]}),
                match="partial restore")

        both(body)


class TestSyncBatchNormalization:
    def test_single_rank_matches_vanilla_bn(self, both):
        def body(m, ctx):
            rng = np.random.RandomState(0)
            x = tf.constant(rng.rand(8, 4).astype(np.float32) * 3 + 1)
            sbn = m.tf.SyncBatchNormalization(momentum=0.9)
            bn = keras.layers.BatchNormalization(momentum=0.9)
            y_s = sbn(x, training=True)
            y_v = bn(x, training=True)
            np.testing.assert_allclose(y_s.numpy(), y_v.numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(sbn.moving_mean.numpy(),
                                       bn.moving_mean.numpy(), rtol=1e-5)
            np.testing.assert_allclose(sbn.moving_variance.numpy(),
                                       bn.moving_variance.numpy(),
                                       rtol=1e-5)
            return y_s, sbn.moving_mean, sbn.moving_variance

        both(body)

    def test_gradients_flow(self, both):
        def body(m, ctx):
            x = tf.constant(
                np.random.RandomState(1).rand(8, 3).astype(np.float32))
            sbn = m.tf.SyncBatchNormalization()
            with tf.GradientTape() as tape:
                y = sbn(x, training=True)
                loss = tf.reduce_sum(y * y)
            grads = tape.gradient(loss, sbn.trainable_variables)
            assert len(grads) == 2 and all(g is not None for g in grads)
            return y, grads

        both(body)

    def test_all_ranks_empty_batch_degrades_to_zeros(self, both):
        # a 2-rank world whose fused stats allreduce returns the packed
        # sums unchanged (every rank contributed zero rows)
        def body(m, ctx):
            sbn = m.tf.SyncBatchNormalization(momentum=0.5)
            sbn.build((None, 3))
            ctx.mp.setattr(m.process_set, "participant_count",
                           lambda ps: 2)
            ctx.mp.setattr(m.mpi_ops, "allreduce", lambda t, **kw: t)
            mean, variance = sbn._moments(tf.zeros((0, 3), tf.float32),
                                          None)
            assert np.all(mean.numpy() == 0.0)
            assert np.all(variance.numpy() == 0.0)
            y = sbn(tf.zeros((0, 3), tf.float32), training=True)
            assert y.shape == (0, 3)
            assert np.isfinite(sbn.moving_mean.numpy()).all()
            assert np.isfinite(sbn.moving_variance.numpy()).all()
            return mean, variance, sbn.moving_mean, sbn.moving_variance

        both(body)

    def test_config_roundtrips_process_set_id(self, both):
        def body(m, ctx):
            sbn = m.tf.SyncBatchNormalization(
                momentum=0.8, process_set=m.tf.global_process_set)
            cfg = sbn.get_config()
            assert cfg["process_set"] == 0  # serialized as the set id
            assert cfg["momentum"] == 0.8
            rebuilt = m.tf.SyncBatchNormalization.from_config(cfg)
            assert rebuilt._process_set == 0  # the engine resolves ids
            return cfg["process_set"], cfg["momentum"], \
                rebuilt._process_set

        both(body)


def _fit_adam(m, wrapped, epochs=2):
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(2)])
    opt = keras.optimizers.Adam(0.01)
    model.compile(optimizer=m.keras.DistributedOptimizer(opt)
                  if wrapped else opt, loss="mse")
    rng = np.random.RandomState(0)
    x = rng.rand(32, 4).astype(np.float32)
    y = rng.rand(32, 2).astype(np.float32)
    model.fit(x, y, epochs=epochs, verbose=0)
    return model, x, y


def _opt_state(opt):
    return int(opt.iterations), [np.asarray(v) for v in opt.variables]


class TestLoadModel:
    def test_load_model_wraps_and_preserves_state(self, both):
        def body(m, ctx):
            model, x, y = _fit_adam(m, wrapped=False)
            it0 = int(model.optimizer.iterations)
            path = str(ctx.dir / "m.keras")
            model.save(path)
            m2 = m.keras.load_model(path)
            assert type(m2.optimizer).__name__ == "DistributedAdam"
            assert m2.optimizer._hvtpu_distributed
            assert int(m2.optimizer.iterations) == it0
            slots = [v for v in m2.optimizer.variables
                     if "momentum" in v.path or "velocity" in v.path]
            assert slots and any(
                float(np.abs(np.asarray(v)).max()) > 0 for v in slots)
            loaded = _opt_state(m2.optimizer)
            m2.fit(x, y, epochs=1, verbose=0)
            assert int(m2.optimizer.iterations) == it0 + 1
            return loaded, _opt_state(m2.optimizer), _weights(m2)

        both(body)

    def test_load_model_roundtrips_wrapped_checkpoint(self, both):
        def body(m, ctx):
            model, x, y = _fit_adam(m, wrapped=True)
            path = str(ctx.dir / "wrapped.keras")
            model.save(path)
            m2 = m.keras.load_model(path)
            assert m2.optimizer._hvtpu_distributed
            assert int(m2.optimizer.iterations) == 2
            m2.fit(x, y, epochs=1, verbose=0)
            assert int(m2.optimizer.iterations) == 3
            return _opt_state(m2.optimizer), _weights(m2)

        both(body)

    def test_load_model_available_on_tf_keras_path(self, both):
        def body(m, ctx):
            assert m.tfk.load_model is m.keras.load_model
            return m.tfk.load_model.__name__

        both(body)

    def test_load_model_without_optimizer(self, both):
        def body(m, ctx):
            model = keras.Sequential([keras.layers.Input((2,)),
                                      keras.layers.Dense(1)])
            path = str(ctx.dir / "bare.keras")
            model.save(path)
            m2 = m.keras.load_model(path)
            assert getattr(m2, "optimizer", None) is None \
                or not getattr(m2.optimizer, "_hvtpu_distributed", False)
            return _weights(m2)

        both(body)


@pytest.mark.parametrize("saver,loader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_saves_port_loads", "port_saves_ref_loads"])
def test_load_model_across_packages(hvt, port_world, tmp_path, saver,
                                    loader):
    """A checkpoint of one package's wrapped optimizer loads under the
    other's ``load_model``: the optimizer comes back as the loader's
    ``Distributed*`` class with ``iterations`` and every slot bitwise."""
    keras.utils.set_random_seed(SEED)
    model, x, y = _fit_adam(saver, wrapped=True)
    path = str(tmp_path / "cross.keras")
    model.save(path)
    m2 = loader.keras.load_model(path)
    assert type(m2.optimizer).__name__ == "DistributedAdam"
    assert type(m2.optimizer).__module__ == f"{loader.root.__name__}._keras"
    assert_bitwise(_opt_state(model.optimizer), _opt_state(m2.optimizer))
    assert_bitwise(_weights(model), _weights(m2))


class TestElasticKerasCallbacks:
    def test_fit_maintains_state_and_commits(self, both):
        def body(m, ctx):
            model = keras.Sequential([keras.layers.Dense(1)])
            model.compile(optimizer=keras.optimizers.SGD(0.1), loss="mse")
            x, y = _data(0, 32, 4)
            state = m.tfk.elastic.KerasState(model, batch=0, epoch=0)
            commits = []
            orig = state.commit
            state.commit = lambda: (commits.append(True), orig())
            model.fit(x, y, batch_size=8, epochs=2, verbose=0, callbacks=[
                m.tfk.elastic.UpdateBatchStateCallback(state),
                m.tfk.elastic.UpdateEpochStateCallback(state),
                m.tfk.elastic.CommitStateCallback(state,
                                                  batches_per_commit=2)])
            assert state.epoch == 2
            assert state.batch == 0  # reset at epoch end
            # 4 batches an epoch: commits at batch 2 and 4, plus epoch end
            assert len(commits) >= 4
            assert state._saved["epoch"] == 2
            return len(commits), state.epoch, state.batch, _weights(model)

        both(body)

    def test_batch_callback_tracks_within_epoch(self, both):
        def body(m, ctx):
            s = SimpleNamespace(batch=0, epoch=0)
            cb = m.k_elastic.UpdateBatchStateCallback(s)
            cb.on_train_batch_end(5)
            assert s.batch == 6
            cb.on_epoch_end(0)
            assert s.batch == 0
            m.k_elastic.UpdateEpochStateCallback(s).on_epoch_end(3)
            assert s.epoch == 4
            return s.batch, s.epoch

        both(body)

    def test_batch_callback_resumed_epoch_replays(self, both, caplog):
        def body(m, ctx):
            s = SimpleNamespace(batch=3, epoch=1)
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger=m.logger):
                m.k_elastic.UpdateBatchStateCallback(s).on_epoch_begin(1)
            assert s.batch == 0
            said = [r.message for r in caplog.records]
            assert any("replays from its start" in r for r in said)
            # another epoch than the interrupted one: no warning
            s2 = SimpleNamespace(batch=3, epoch=1)
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger=m.logger):
                m.k_elastic.UpdateBatchStateCallback(s2).on_epoch_begin(2)
            assert s2.batch == 3 and not caplog.records
            return said, s.batch, s2.batch

        both(body)

    def test_commit_zero_batches_per_commit(self, both):
        def body(m, ctx):
            commits = []
            s = SimpleNamespace(commit=lambda: commits.append(True))
            cb = m.k_elastic.CommitStateCallback(s, batches_per_commit=0)
            for b in range(5):
                cb.on_batch_end(b)
            assert commits == []  # per-batch commits disabled
            cb.on_epoch_end(0)
            assert commits == [True]
            return commits

        both(body)

    def test_commit_skips_final_batch_duplicate(self, both):
        def body(m, ctx):
            commits = []
            s = SimpleNamespace(commit=lambda: commits.append(True))
            cb = m.k_elastic.CommitStateCallback(s, batches_per_commit=1)
            cb.params = {"steps": 4}
            for b in range(4):
                cb.on_batch_end(b)
            cb.on_epoch_end(0)
            # batches 0-2 commit; batch 3 (the last) skips; epoch end
            assert len(commits) == 4
            return commits

        both(body)


def _sgd_model():
    model = keras.Sequential([keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.SGD(learning_rate=0.1),
                  loss="mse")
    return model


class TestKerasCallbacks:
    def test_broadcast_callback_runs(self, both):
        def body(m, ctx):
            x, y = _data(1, 64, 4)
            model = _sgd_model()
            cb = m.keras.callbacks.BroadcastGlobalVariablesCallback(0)
            hist = model.fit(x, y, epochs=1, batch_size=32, verbose=0,
                             callbacks=[cb])
            assert cb.broadcast_done
            return hist.history, _weights(model)

        both(body)

    def test_metric_average_callback(self, both):
        # the averaged logs are float32 scalars in both packages
        def body(m, ctx):
            x, y = _data(1, 64, 4)
            model = _sgd_model()
            hist = model.fit(
                x, y, epochs=2, batch_size=32, verbose=0,
                callbacks=[m.keras.callbacks.MetricAverageCallback()])
            return hist.history, _weights(model)

        both(body)

    def test_lr_warmup_reaches_size_multiple(self, both):
        def body(m, ctx):
            x, y = _data(1, 64, 4)
            model = _sgd_model()
            cb = m.keras.callbacks.LearningRateWarmupCallback(
                warmup_epochs=2, initial_lr=0.1)
            model.fit(x, y, epochs=3, batch_size=32, verbose=0,
                      callbacks=[cb])
            lr = float(np.asarray(model.optimizer.learning_rate))
            # a world of one: the warmup multiplier ends at 1.0
            assert lr == pytest.approx(0.1)
            return lr, _weights(model)

        both(body)

    def test_lr_schedule_staircase(self, both):
        def body(m, ctx):
            x, y = _data(1, 64, 4)
            model = _sgd_model()
            cb = m.keras.callbacks.LearningRateScheduleCallback(
                multiplier=lambda epoch: 0.5 ** epoch, start_epoch=0,
                initial_lr=0.1)
            model.fit(x, y, epochs=3, batch_size=32, verbose=0,
                      callbacks=[cb])
            lr = float(np.asarray(model.optimizer.learning_rate))
            assert lr == pytest.approx(0.025)   # epoch 2: 0.25
            return lr, _weights(model)

        both(body)


class TestGraphModeBroadcastFusion:
    def test_fused_one_call_per_dtype(self, both):
        def body(m, ctx):
            calls = []
            real = m.eager.broadcast

            def spy(tensor, **kw):
                calls.append(tuple(tensor.shape))
                return real(tensor, **kw)

            ctx.mp.setattr(m.eager, "broadcast", spy)
            vs = [tf.Variable(tf.fill((4, 2), float(i))) for i in range(5)]
            vs.append(tf.Variable(tf.constant([1, 2, 3], tf.int32)))

            @tf.function
            def do():
                m.tf.broadcast_variables(vs, root_rank=0)

            do()
            # 5 f32 variables fused into ONE broadcast + 1 int32 single
            assert len(calls) == 2, calls
            return calls, vs

        both(body)

    def test_fused_graph_values_correct(self, both):
        def body(m, ctx):
            vs = [tf.Variable(tf.fill((3,), float(i + 1)))
                  for i in range(4)]

            @tf.function
            def do():
                m.tf.broadcast_variables(vs, root_rank=0)

            do()
            for i, v in enumerate(vs):
                np.testing.assert_allclose(v.numpy(),
                                           np.full((3,), i + 1.0))
            return vs

        both(body)


class TestGraphTopologyOps:
    def test_size_rank_ops_in_graph(self, both):
        def body(m, ctx):
            @tf.function
            def f():
                return (m.tf.size_op() + m.tf.rank_op()
                        + m.tf.local_rank_op() + m.tf.local_size_op())

            out = f()
            assert int(out.numpy()) == 1 + 0 + 0 + 1
            assert m.tf.is_homogeneous() is True
            return out

        both(body)


def test_size_op_and_global_process_set(both):
    def body(m, ctx):
        assert int(m.tf.size_op().numpy()) == 1
        assert m.tf.global_process_set.process_set_id == 0
        # a non-global id resolves through the live table: an unknown id
        # raises rather than answering the world size
        return m.tf.size_op(), _raises(
            ValueError, lambda: m.tf.size_op(process_set_id=42))

    both(body)


# -- the bridge ----------------------------------------------------------------

_BRIDGE_DTYPES = [tf.float32, tf.bfloat16, tf.float16, tf.float64, tf.int32,
                  tf.int64]


@pytest.mark.parametrize("dtype", _BRIDGE_DTYPES, ids=lambda d: d.name)
def test_bridge_leaves_every_input_unchanged(port_world, dtype):
    """Every op of the port's tf surface on a bridged tensor (which shares
    tf's buffer): the input's bytes are the same after it, and the output
    comes back in the input's dtype, transposed and empty inputs too."""
    rng = np.random.RandomState(7)
    base = tf.cast(tf.constant(rng.randn(4, 3) * 8), dtype)
    before = base.numpy().copy()
    for t in (base, tf.transpose(base), tf.zeros((0, 3), dtype)):
        t_before = t.numpy().copy()
        outs = [
            port_tf.allreduce(t, op=port_tf.Sum, prescale_factor=2.0,
                              postscale_factor=3.0),
            port_tf.allreduce(t, op=port_tf.Average),
            port_tf.allgather(t), port_tf.broadcast(t, root_rank=0),
            port_tf.reducescatter(t, op=port_tf.Sum),
            port_tf.alltoall(t, splits=[int(t.shape[0])])[0],
            *port_tf.grouped_allreduce([t, t], op=port_tf.Sum),
        ]
        assert all(o.dtype == dtype for o in outs)
        assert t.numpy().tobytes() == t_before.tobytes()
    assert base.numpy().tobytes() == before.tobytes()


def _no_current_device():
    raise AssertionError("the bridge asked CUDA for its current device")


def test_bridge_moves_onto_the_ports_device_and_back(port_world,
                                                     monkeypatch):
    """Eagerly and inside a ``tf.function`` (whose ops run on a TF
    executor thread), every tensor the bridge hands the engine is on the
    port's device, named by the state and never by
    ``torch.cuda.current_device()``, and every result comes back on its
    input's tf device."""
    import torch

    from horovod_tpu_torch.core import state as core_state

    monkeypatch.setattr(torch.cuda, "current_device", _no_current_device)
    port_tf.mpi_ops.bridged.clear()
    seen = []
    real = port_tf.mpi_ops.eager.allreduce

    def spy(x, **kw):
        seen.append(x.device)
        return real(x, **kw)

    monkeypatch.setattr(port_tf.mpi_ops.eager, "allreduce", spy)
    x = tf.constant([1.0, 2.0])

    @tf.function
    def step(t):
        return port_tf.allreduce(t, op=port_tf.Sum)

    outs = [port_tf.allreduce(x, op=port_tf.Sum), step(x)]
    want = core_state.global_state().device
    assert seen == [want, want]
    assert dict(port_tf.mpi_ops.bridged) == {str(want): 2}
    assert all(o.device == x.device for o in outs)


def test_bridge_never_falls_back_to_the_cpu(port_world, monkeypatch):
    """With the port on the card, a tensor the bridge cannot put there
    raises; it is never reduced on the CPU instead."""
    import torch

    from horovod_tpu_torch.core import state as core_state

    st = core_state.global_state()
    monkeypatch.setattr(st, "device", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "current_device", _no_current_device)
    port_tf.mpi_ops.bridged.clear()
    with pytest.raises((RuntimeError, AssertionError)):
        port_tf.allreduce(tf.constant([1.0]), op=port_tf.Sum)
    assert "cpu" not in port_tf.mpi_ops.bridged


# -- chip_smoke.py's frontends phase, rehearsed on the CPU ----------------------

def test_chip_smoke_frontends_phase_on_the_cpu(port_world, capsys):
    """The phase's run with the port on the CPU in place of the card: the
    bridge counts every gradient on the port's device, the weights match
    the run after ``init(device="cpu")``, and it prints one line."""
    import chip_smoke

    line = chip_smoke.frontends_phase(horovod_tpu_torch, "cpu rehearsal",
                                      device="cpu")
    grads = 2 * (len(chip_smoke.FRONTEND_WIDTHS) - 1)
    assert line["ran"] and line["weights_equal_cpu"]
    assert line["bridged"] == {"cpu": grads * chip_smoke.FRONTEND_STEPS}
    assert (line["tensorflow"], line["keras"]) == (tf.__version__,
                                                   keras.__version__)
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("frontends ")]
    assert len(out) == 1
    assert horovod_tpu_torch.is_initialized()
    assert str(horovod_tpu_torch.device()) == "cpu"


def test_chip_smoke_frontends_phase_without_tensorflow(monkeypatch, capsys):
    import chip_smoke

    found = {"tensorflow": None, "keras": "3.0.0"}
    monkeypatch.setattr(chip_smoke, "_module_version", found.get)
    line = chip_smoke.frontends_phase(None, "no card")
    assert line == {"tensorflow": None, "keras": "3.0.0", "ran": False}
    assert capsys.readouterr().out == (
        'frontends {"tensorflow": null, "keras": "3.0.0", "ran": false}\n')

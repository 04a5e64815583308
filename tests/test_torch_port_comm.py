"""Fusion, packing, compression, reduce ops, config and the single-rank
eager collectives of the PyTorch port, against the JAX package.

* Bucket plans over ResNet-50's 161 parameter names and shapes are
  identical to ``horovod_tpu.comm.fusion.plan_buckets`` at 3 thresholds.
* ``pack_flat`` / ``unpack_flat`` are bitwise ``horovod_tpu.comm.packing``'s
  (same promoted dtype, same bits, same round trip).
* fp16/bf16 compression round trips are bitwise those of
  ``horovod_tpu.torch.compression``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.comm import fusion as jax_fusion
from horovod_tpu.comm import packing as jax_packing
from horovod_tpu.comm import reduce_ops as jax_reduce_ops
from horovod_tpu.core.config import Config as JaxConfig
from horovod_tpu.torch import compression as ref_compression
import horovod_tpu_torch as hvd
from horovod_tpu_torch.comm import eager, fusion, packing, reduce_ops
from horovod_tpu_torch.core.config import Config
from horovod_tpu_torch.models import ResNet50
from horovod_tpu_torch.torch import compression
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

_TORCH_TO_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                 torch.float16: jnp.float16, torch.int32: jnp.int32}


@pytest.fixture(scope="module")
def resnet50_inventory():
    model = ResNet50(device="meta")
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def _plan_tuple(plan):
    return [[(e.name, e.index, tuple(e.shape), e.size, e.nbytes) for e in b]
            for b in plan.buckets]


@pytest.mark.parametrize("threshold", [1 << 20, 16 << 20, 64 << 20])
def test_bucket_plan_matches_jax_on_resnet50(resnet50_inventory, threshold):
    names = [n for n, _ in resnet50_inventory]
    t_leaves = [torch.empty(s, device="meta") for _, s in resnet50_inventory]
    j_leaves = [jax.ShapeDtypeStruct(s, jnp.float32)
                for _, s in resnet50_inventory]
    got = fusion.plan_buckets(names, t_leaves, threshold)
    want = jax_fusion.plan_buckets(names, j_leaves, threshold)
    assert len(names) == 161
    assert _plan_tuple(got) == _plan_tuple(want)
    assert got.num_buckets == want.num_buckets


def test_bucket_plan_mixed_dtypes_and_oversize():
    rng = np.random.RandomState(0)
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.int32]
    names, t_leaves, j_leaves = [], [], []
    for i in range(40):
        shape = tuple(int(d) for d in rng.randint(1, 300, size=rng.randint(1, 3)))
        dt = dtypes[i % len(dtypes)]
        names.append(f"layer{rng.randint(0, 1000):03d}.w{i}")
        t_leaves.append(torch.empty(shape, dtype=dt, device="meta"))
        j_leaves.append(jax.ShapeDtypeStruct(shape, _TORCH_TO_JNP[dt]))
    for threshold in (1, 4096, 100_000):
        got = fusion.plan_buckets(names, t_leaves, threshold)
        want = jax_fusion.plan_buckets(names, j_leaves, threshold)
        assert _plan_tuple(got) == _plan_tuple(want)


def _torch_from_np(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float32),
    (torch.bfloat16, torch.float16),
    (torch.int32, torch.float32),
    (torch.int32, torch.int32),
])
def test_pack_unpack_bitwise(dtypes):
    rng = np.random.RandomState(len(dtypes))
    t_in, j_in = [], []
    for i, dt in enumerate(dtypes):
        shape = (3 + i, 5) if i % 2 else (7 * (i + 1),)
        if dt == torch.int32:
            a = rng.randint(-1000, 1000, size=shape).astype(np.int32)
        else:
            a = (rng.randn(*shape) * 10).astype(np.float32)
        t = _torch_from_np(a, dt)
        t_in.append(t)
        j_in.append(jnp.asarray(a).astype(_TORCH_TO_JNP[dt]))
    flat, specs = packing.pack_flat(t_in)
    j_flat, _ = jax_packing.pack_flat(j_in)
    assert _TORCH_TO_JNP[flat.dtype] == j_flat.dtype
    np.testing.assert_array_equal(flat.float().numpy(),
                                  np.asarray(j_flat).astype(np.float32))
    outs = packing.unpack_flat(flat, specs)
    for t, o in zip(t_in, outs):
        assert o.dtype == t.dtype and o.shape == t.shape
        assert torch.equal(o, t)


def test_pack_flat_rejects_empty():
    with pytest.raises(ValueError):
        packing.pack_flat([])


@pytest.mark.parametrize("name", ["none", "fp16", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.int32])
def test_compression_round_trip_bitwise(name, dtype):
    rng = np.random.RandomState(3)
    a = (rng.randn(257) * 100).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    ours = getattr(compression.Compression, name)
    ref = getattr(ref_compression.Compression, name)
    wire, ctx = ours.compress(t)
    r_wire, r_ctx = ref.compress(t)
    assert wire.dtype == r_wire.dtype and ctx == r_ctx
    assert torch.equal(wire, r_wire)
    back = ours.decompress(wire, ctx)
    assert back.dtype == t.dtype
    assert torch.equal(back, ref.decompress(r_wire, r_ctx))


@pytest.mark.parametrize("op,average", [
    (None, None), (reduce_ops.Sum, None), (None, True), (None, False),
    (reduce_ops.Max, None),
])
def test_normalize_op_matches_jax(op, average):
    got = reduce_ops.normalize_op(op, average)
    want = jax_reduce_ops.normalize_op(None if op is None else int(op),
                                       average)
    assert int(got) == int(want) and got.name == want.name


def test_normalize_op_rejects_both():
    with pytest.raises(ValueError):
        reduce_ops.normalize_op(reduce_ops.Sum, True)


@pytest.mark.parametrize("env", [
    {},
    {"HVTPU_FUSION_THRESHOLD": "1048576", "HVTPU_RANK": "3",
     "HVTPU_SIZE": "8", "HVTPU_LOCAL_RANK": "1"},
    {"HOROVOD_FUSION_THRESHOLD": "2048", "HOROVOD_RANK": "1",
     "HOROVOD_SIZE": "2"},
    {"HVTPU_FUSION_THRESHOLD_MB": "1.5", "HOROVOD_FUSION_THRESHOLD": "7",
     "HVTPU_SIZE": "4", "HOROVOD_SIZE": "9"},
])
def test_config_env_matches_jax(monkeypatch, env):
    for prefix in ("HVTPU_", "HOROVOD_"):
        for k in ("FUSION_THRESHOLD", "FUSION_THRESHOLD_MB", "RANK", "SIZE",
                  "LOCAL_RANK"):
            monkeypatch.delenv(prefix + k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = Config.from_env(), JaxConfig.from_env()
    for field in ("fusion_threshold_bytes", "rank", "size", "local_rank"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.fixture
def port_cpu():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture
def hvt_jax(tmp_path, monkeypatch):
    import horovod_tpu as hvt_mod

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    hvt_mod.init()
    yield hvt_mod
    hvt_mod.shutdown()


def test_lifecycle_single_rank(port_cpu):
    assert hvd.is_initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 1, 0)
    assert hvd.device() == torch.device("cpu")
    assert hvd.global_process_set.size == 1
    hvd.barrier()


@pytest.mark.parametrize("op", [reduce_ops.Sum, reduce_ops.Average,
                                reduce_ops.Adasum])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eager_allreduce_single_rank_matches_jax(port_cpu, hvt_jax, op,
                                                 dtype):
    a = (np.random.RandomState(5).randn(33, 3) * 4).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    got = eager.allreduce(t, op=op, prescale_factor=0.5,
                          postscale_factor=4.0)
    want = hvt_jax.allreduce(jnp.asarray(a).astype(_TORCH_TO_JNP[dtype]),
                             op=jax_reduce_ops.ReduceOp(int(op)),
                             prescale_factor=0.5, postscale_factor=4.0)
    assert got.dtype == dtype and got.shape == t.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    assert got.data_ptr() != t.data_ptr()  # a new tensor


def test_eager_allreduce_integer_average_floors(port_cpu):
    t = torch.tensor([7, -7, 3], dtype=torch.int32)
    assert torch.equal(eager.allreduce(t), t)
    assert torch.equal(eager.average_(t.clone() * 2 + 1, 2),
                       torch.tensor([7, -7, 3], dtype=torch.int32))


def test_eager_allreduce_rejects_unported_op(port_cpu):
    # every op is ported, Adasum too: none is refused, and at a world of
    # one each returns its input
    for op in (reduce_ops.Min, reduce_ops.Max, reduce_ops.Product,
               reduce_ops.Adasum):
        out = eager.allreduce(torch.arange(3.0), op=op)
        assert torch.equal(out, torch.arange(3.0))   # world of one


@pytest.mark.parametrize("predivide", [1.0, 2.0, 49.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_tensor_groups_match_jax_eager_bitwise(monkeypatch, hvt_jax,
                                                      predivide, dtype):
    """At world size 1 a group of one tensor goes through
    ``comm/eager.allreduce`` as the JAX controller sends it
    (``eager/controller.py:2252-2265``): no fp16 wire, one multiply by
    prescale * postscale.  A threshold of 1 byte makes every bucket a
    single tensor."""
    from horovod_tpu.comm import eager as jax_eager
    from horovod_tpu.comm.compression import Compression as JaxCompression
    from torch_port_util import narrow_resnet, synthetic_batches
    import torch.nn.functional as F

    monkeypatch.setenv("HVTPU_FUSION_THRESHOLD", "1")
    hvd.init(device="cpu")
    try:
        model = narrow_resnet(seed=3)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            compression=hvd.Compression.fp16,
            gradient_predivide_factor=predivide)
        assert all(len(b) == 1 for b in opt.buckets)
        x, y = synthetic_batches(1, batch=4, seed=5)[0]
        params = [p for p in model.parameters() if p.requires_grad]
        loss = F.cross_entropy(model(torch.from_numpy(x)),
                               torch.from_numpy(y))
        grads = [g.to(dtype) for g in torch.autograd.grad(loss, params)]
        red = opt.reduction
        changed = 0
        for g in grads:
            (got,) = red.reduce([g])
            want = jax_eager.allreduce(
                jnp.asarray(g.float().numpy()).astype(_TORCH_TO_JNP[dtype]),
                op=jax_reduce_ops.ReduceOp(int(red.op)),
                prescale_factor=red.prescale,
                postscale_factor=red.postscale,
                compression=JaxCompression.fp16)
            assert got.dtype == dtype and got.shape == g.shape
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want).astype(np.float32))
            # the fused path would have rounded through fp16
            fused = red.scale(g.reshape(-1), red.prescale).to(torch.float16)
            changed += not torch.equal(fused.to(dtype).reshape(g.shape), g)
        assert changed > 0
    finally:
        hvd.shutdown()


def test_broadcast_single_rank(port_cpu):
    t = torch.arange(6.0)
    out = hvd.broadcast(t, root_rank=0)
    assert torch.equal(out, t) and out.data_ptr() != t.data_ptr()
    assert hvd.broadcast_(t, 0) is t
    obj = {"a": [1, 2], "b": torch.ones(2)}
    back = hvd.broadcast_object(obj)
    assert back["a"] == [1, 2] and torch.equal(back["b"], obj["b"])


def test_ops_before_init_raise():
    from horovod_tpu_torch.core.exceptions import NotInitializedError

    assert not hvd.is_initialized()
    with pytest.raises(NotInitializedError):
        hvd.rank()
    with pytest.raises(NotInitializedError):
        eager.allreduce(torch.ones(2))

"""The grouped passes of kernel A1, ``scale_cast_pack`` and
``unpack_cast_scale``, on the CPU.

The CUDA kernel (``horovod_tpu_torch/csrc/scale_cast.cu``) runs only on
the card, where ``chip_smoke.py`` holds it bitwise against the plain
versions.  Here:

* the plain versions, which the wrappers take for CPU tensors, are held
  bitwise against the JAX engine's staged composition
  (``eager/controller.py`` ``_apply_scale`` with its Pallas body in
  interpret mode, the codec's ``compress`` / ``decompress``, and
  ``comm/packing.py`` ``pack_flat`` / ``unpack_flat``), for float32,
  bfloat16, float16 and mixed groups, the none/fp16/bf16 wires, three
  scales, sizes 1-1025 and a narrow ResNet's shapes;
* the kernel's tables, as the wrappers build them, are run through a
  model of the kernel written in PyTorch (each entry's pointers read
  with ctypes), at a table size of 3 so that a group takes several
  launches;
* at scale 1 the grouped passes are bitwise the staged composition
  without ``_apply_scale``, which the reference skips there;
* ``GroupReduction`` takes the grouped passes for every group of several
  float32/bfloat16/float16 tensors under the none/fp16/bf16 codecs, in
  both directions at any scale; its results are bitwise the per-tensor
  composition's.

Inputs are made with numpy from a seed; results are compared as
unsigned-integer views.
"""

import ctypes
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.comm.compression import Compression as JaxCompression
from horovod_tpu.comm.packing import pack_flat as jax_pack_flat
from horovod_tpu.comm.packing import unpack_flat as jax_unpack_flat
from horovod_tpu.eager.controller import _apply_scale as jax_apply_scale
from horovod_tpu_torch.comm.compression import Compression
from horovod_tpu_torch.comm.packing import pack_flat, unpack_flat
from horovod_tpu_torch.comm.reduce_ops import ReduceOp
from horovod_tpu_torch.core.process_set import global_process_set
from horovod_tpu_torch.ops import scale_cast
from horovod_tpu_torch.ops import (
    fused_scale_cast,
    fused_scale_cast_plain,
    scale_cast_pack,
    unpack_cast_scale,
    unpack_cast_scale_plain,
)
from horovod_tpu_torch.torch.optimizer import GroupReduction
from torch_port_util import narrow_resnet
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

DTYPES = {
    "f32": (torch.float32, jnp.float32, np.uint32, torch.int32),
    "bf16": (torch.bfloat16, jnp.bfloat16, np.uint16, torch.int16),
    "f16": (torch.float16, jnp.float16, np.uint16, torch.int16),
}
TORCH_KEY = {v[0]: k for k, v in DTYPES.items()}
WIRES = {
    "none": (None, Compression.none, JaxCompression.none),
    "fp16": ("f16", Compression.fp16, JaxCompression.fp16),
    "bf16": ("bf16", Compression.bf16, JaxCompression.bf16),
}
SIZES = [1, 127, 1024, 1025]
SHAPES = [(1,), (127,), (32, 32), (1025,)]
GROUPS = {
    "f32": ["f32"] * 4,
    "bf16": ["bf16"] * 4,
    "f16": ["f16"] * 4,
    "mixed": ["f32", "bf16", "bf16", "f32"],
}
SCALES = [0.5, 1.0 / 3.0, 2.0]


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


def _values(n: int, rng) -> np.ndarray:
    """float32 values spread over 12 decades, so the narrow dtypes see
    overflow to inf, subnormals and ties."""
    mag = 10.0 ** rng.uniform(-8, 4, size=n)
    return (rng.randn(n) * mag).astype(np.float32)


def _pair(shape, key: str, rng):
    """The same values as a torch tensor and a JAX array of ``key``."""
    x = _values(int(np.prod(shape)), rng).reshape(shape)
    t = torch.from_numpy(x).to(DTYPES[key][0])
    j = jnp.asarray(x).astype(DTYPES[key][1])
    np.testing.assert_array_equal(_bits(t), _bits(j))
    return t, j


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        key = TORCH_KEY[a.dtype]
        return a.view(DTYPES[key][3]).numpy().view(DTYPES[key][2])
    key = {jnp.dtype(v[1]): k for k, v in DTYPES.items()}[jnp.dtype(a.dtype)]
    return np.asarray(a).view(DTYPES[key][2])


def _jax_pre(arrays, scale, codec):
    """The reference's staged path up to the wire: ``_apply_scale``, the
    codec's compress, ``pack_flat``."""
    wires, ctxs = [], []
    for a in arrays:
        w, ctx = codec.compress(jax_apply_scale(a, scale))
        wires.append(w)
        ctxs.append(ctx)
    flat, specs = jax_pack_flat(wires)
    return flat, specs, ctxs


def _jax_post(flat, specs, ctxs, scale, codec):
    """The reference's staged path after the wire: ``unpack_flat``, the
    codec's decompress, ``_apply_scale``."""
    return [jax_apply_scale(codec.decompress(p, ctx), scale)
            for p, ctx in zip(jax_unpack_flat(flat, specs), ctxs)]


def _check_specs(specs, jax_specs):
    assert len(specs) == len(jax_specs)
    for (shape, dtype, n), (jshape, jdtype, jn) in zip(specs, jax_specs):
        assert (shape, n) == (tuple(jshape), jn)
        assert jnp.dtype(DTYPES[TORCH_KEY[dtype]][1]) == jnp.dtype(jdtype)


def _post_inputs(keys, shapes, wire: str, rng):
    """A flat buffer of the group's promoted wire dtype (new values, as an
    allreduce returns them), its specs and contexts, on both sides."""
    wire_key = WIRES[wire][0]
    wire_keys = [wire_key or k for k in keys]
    flat_key = "f16" if wire_key == "f16" else "bf16" if wire_key else (
        "f32" if "f32" in keys else keys[0])
    sizes = [int(np.prod(s)) for s in shapes]
    flat_t, flat_j = _pair((sum(sizes),), flat_key, rng)
    specs = [(s, DTYPES[w][0], n)
             for s, w, n in zip(shapes, wire_keys, sizes)]
    jspecs = [(s, DTYPES[w][1], n)
              for s, w, n in zip(shapes, wire_keys, sizes)]
    ctxs = [DTYPES[k][0] if wire_key else None for k in keys]
    jctxs = [jnp.dtype(DTYPES[k][1]) if wire_key else None for k in keys]
    return flat_t, flat_j, specs, jspecs, ctxs, jctxs


# -- the plain versions against the JAX staged composition --------------------

@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("group", list(GROUPS))
def test_pack_matches_jax_staged(interpret_mode, group, wire, scale):
    rng = np.random.RandomState(len(group) + 7 * list(WIRES).index(wire))
    pairs = [_pair(s, k, rng) for s, k in zip(SHAPES, GROUPS[group])]
    flat, specs = scale_cast_pack([t for t, _ in pairs], scale,
                                  WIRES[wire][1])
    jflat, jspecs, _ = _jax_pre([j for _, j in pairs], scale, WIRES[wire][2])
    _check_specs(specs, jspecs)
    assert flat.shape == (sum(SIZES),)
    np.testing.assert_array_equal(_bits(flat), _bits(jflat))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("group", list(GROUPS))
def test_unpack_matches_jax_staged(interpret_mode, group, wire, scale):
    rng = np.random.RandomState(100 + len(group) + list(WIRES).index(wire))
    keys = GROUPS[group]
    flat, jflat, specs, jspecs, ctxs, jctxs = _post_inputs(keys, SHAPES,
                                                          wire, rng)
    got = unpack_cast_scale(flat, specs, ctxs, scale)
    want = _jax_post(jflat, jspecs, jctxs, scale, WIRES[wire][2])
    for g, w, k, s in zip(got, want, keys, SHAPES):
        assert g.dtype == DTYPES[k][0] and tuple(g.shape) == s
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("group", list(GROUPS))
def test_scale_1_matches_jax_staged_without_scale(interpret_mode, group,
                                                  wire):
    """At scale 1 the reference skips ``_apply_scale``; the grouped
    passes multiply by 1, which is exact, so both directions are bitwise
    the codec and the pack alone."""
    rng = np.random.RandomState(200 + len(group) + list(WIRES).index(wire))
    keys, jcodec = GROUPS[group], WIRES[wire][2]
    pairs = [_pair(s, k, rng) for s, k in zip(SHAPES, keys)]
    flat, specs = scale_cast_pack([t for t, _ in pairs], 1.0, WIRES[wire][1])
    jflat, jspecs = jax_pack_flat([jcodec.compress(j)[0] for _, j in pairs])
    _check_specs(specs, jspecs)
    np.testing.assert_array_equal(_bits(flat), _bits(jflat))
    flat, jflat, specs, jspecs, ctxs, jctxs = _post_inputs(keys, SHAPES,
                                                          wire, rng)
    got = unpack_cast_scale(flat, specs, ctxs, 1.0)
    want = [jcodec.decompress(p, ctx)
            for p, ctx in zip(jax_unpack_flat(jflat, jspecs), jctxs)]
    for g, w, k in zip(got, want, keys):
        assert g.dtype == DTYPES[k][0]
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_narrow_resnet_shapes_match_jax_staged(interpret_mode):
    """The main path's configuration on a narrow ResNet's 53 float32
    gradients: prescale 1/2, fp16 wire, postscale 2."""
    rng = np.random.RandomState(5)
    shapes = [tuple(p.shape) for p in narrow_resnet().parameters()]
    assert len(shapes) == 53
    pairs = [_pair(s, "f32", rng) for s in shapes]
    flat, specs = scale_cast_pack([t for t, _ in pairs], 0.5,
                                  Compression.fp16)
    jflat, jspecs, jctxs = _jax_pre([j for _, j in pairs], 0.5,
                                    JaxCompression.fp16)
    _check_specs(specs, jspecs)
    np.testing.assert_array_equal(_bits(flat), _bits(jflat))
    ctxs = [torch.float32] * len(shapes)
    got = unpack_cast_scale(flat, specs, ctxs, 2.0)
    want = _jax_post(jflat, jspecs, jctxs, 2.0, JaxCompression.fp16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_plain_versions_refuse_other_dtypes():
    ints = [torch.ones(3, dtype=torch.int32), torch.ones(2)]
    with pytest.raises(TypeError):
        scale_cast_pack(ints, 0.5, Compression.none)
    with pytest.raises(TypeError, match="int8"):  # its wire is not a cast
        scale_cast_pack([torch.ones(2)], 0.5, Compression.int8)
    flat, specs = pack_flat([torch.ones(2, dtype=torch.float64)])
    with pytest.raises(TypeError):
        unpack_cast_scale(flat, specs, [None], 2.0)


# -- the kernel's tables, through a model of the kernel -----------------------

_CODE_DTYPE = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


def _memory(ptr: int, n: int, code: int) -> torch.Tensor:
    dtype = _CODE_DTYPE[code]
    size = torch.empty(0, dtype=dtype).element_size()
    buf = (ctypes.c_uint8 * (n * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=n)


def _kernel_model(launched):
    """What csrc/scale_cast.cu computes from a table, in PyTorch:
    ``dst = Dst(Own(f32(Own(Spec(src))) * scale))`` per entry, after the
    checks the C entry point makes."""

    def fn(table_ptr, srcs, dsts, count, total, scale, stream):
        buf = (ctypes.c_uint8 * (count * 40)).from_address(table_ptr)
        table = np.frombuffer(buf, dtype=scale_cast._ENTRY).copy()
        table["src"] = (ctypes.c_uint64 * count).from_address(srcs)
        table["dst"] = (ctypes.c_uint64 * count).from_address(dsts)
        n = table["n"].astype(np.int64)
        assert 1 <= count and (table["start"] == np.cumsum(n) - n).all()
        assert total == int(n.sum()) > 0
        launched.append(count)
        for e in table:
            if e["n"] == 0:
                continue
            codes = [int(e[k]) for k in ("src_dt", "spec_dt", "own_dt",
                                         "dst_dt")]
            own = _CODE_DTYPE[codes[2]]
            v = _memory(int(e["src"]), int(e["n"]), codes[0]).float()
            v = v.to(_CODE_DTYPE[codes[1]]).to(own).float()
            v = (v * torch.tensor(scale, dtype=torch.float32)).to(own)
            _memory(int(e["dst"]), int(e["n"]), codes[3]).copy_(
                v.to(_CODE_DTYPE[codes[3]]))
        return 0

    return fn


@pytest.fixture
def model_kernel(monkeypatch):
    """The wrappers' launch path with the kernel replaced by its model,
    3 entries a table, on CPU memory; yields the launched table sizes."""
    launched = []
    monkeypatch.setattr(scale_cast, "_library",
                        lambda: (_kernel_model(launched), 3))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    scale_cast._pack_plan.cache_clear()
    scale_cast._unpack_plan.cache_clear()
    yield launched
    scale_cast._pack_plan.cache_clear()
    scale_cast._unpack_plan.cache_clear()


CARD = torch.device("cuda", 0)   # what the wrappers are told; CPU memory


def _on_device_0(layout):
    return tuple((d, s, c, 0) for d, s, c, _ in layout)


def test_launch_tables_split_at_the_parameter_limit():
    sizes = [5, 0, 7, 1, 2, 9, 4]
    codes = [(0, 0, 0, 2)] * len(sizes)
    launches = scale_cast.launch_tables(sizes, codes, 3)
    assert [(lo, hi, total) for lo, hi, _, total in launches] == [
        (0, 3, 12), (3, 6, 12), (6, 7, 4)]
    for lo, hi, table, _ in launches:
        assert table.dtype.itemsize == 40 and len(table) == hi - lo
        assert list(table["n"]) == sizes[lo:hi]
        assert list(table["start"]) == list(np.cumsum(sizes[lo:hi])
                                            - sizes[lo:hi])
        assert (table["dst_dt"] == 2).all() and (table["src"] == 0).all()


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("group", ["f32", "mixed"])
def test_tables_through_the_kernel_model(model_kernel, group, wire):
    rng = np.random.RandomState(3)
    keys = GROUPS[group] + ["bf16", "f32", "f16"]
    shapes = SHAPES + [(0,), (3, 5), (2,)]  # a zero-length entry, odd offsets
    tensors = [_pair(s, k, rng)[0] for s, k in zip(shapes, keys)]
    codec = WIRES[wire][1]
    before = fused_scale_cast.launches

    launches, flat_dtype, total, specs, offsets, dev = scale_cast._pack_plan(
        _on_device_0(scale_cast._layout(tensors)), codec)
    flat = torch.empty(total, dtype=flat_dtype)
    scale_cast._launch(launches, scale_cast._addresses(tensors),
                       offsets + np.uint64(flat.data_ptr()), 0.5, CARD,
                       "test")
    want, want_specs = scale_cast.scale_cast_pack_plain(tensors, 0.5, codec)
    assert list(specs) == want_specs and flat.dtype == want.dtype
    np.testing.assert_array_equal(_bits(flat), _bits(want))

    ctxs = [None if codec is Compression.none else t.dtype
            for t in tensors]
    launches, total, out_layout, offsets = scale_cast._unpack_plan(
        flat.dtype, 0, tuple(specs), tuple(ctxs))
    outs = [torch.full_like(t, 7.0) for t in tensors]
    assert _on_device_0(scale_cast._layout(outs)) == out_layout
    scale_cast._launch(launches, offsets + np.uint64(flat.data_ptr()),
                       scale_cast._addresses(outs), 2.0, CARD, "test")
    for o, w in zip(outs, scale_cast.unpack_cast_scale_plain(
            flat, specs, ctxs, 2.0)):
        np.testing.assert_array_equal(_bits(o), _bits(w))
    # 7 entries, one of them empty, at 3 a table: 3 + 3 + 1, both ways
    assert model_kernel == [3, 3, 1, 3, 3, 1]
    assert fused_scale_cast.launches - before == 6
    fused_scale_cast.launches = before


def test_tables_refuse_what_the_kernel_cannot_take(model_kernel):
    t = torch.ones(4)
    with pytest.raises(ValueError, match="one CUDA device"):
        scale_cast._pack_plan(scale_cast._layout([t]), Compression.none)
    layout = ((torch.float32, t.shape, False, 0),)
    with pytest.raises(ValueError, match="contiguous"):
        scale_cast._pack_plan(layout, Compression.none)
    with pytest.raises(TypeError):
        scale_cast._pack_plan(((torch.int32, t.shape, True, 0),),
                              Compression.none)
    with pytest.raises(TypeError):
        scale_cast._unpack_plan(torch.float16, 0, (((4,), torch.float16, 4),),
                                ("float32",))


class _OnCard(torch.Tensor):
    """A CPU tensor that tells the wrappers it lies on the card, so that
    they take the kernel's path (the kernel's model, ``model_kernel``)."""

    @property
    def device(self):
        return CARD


def test_unpack_bumps_the_versions_of_outs(model_kernel):
    """The kernel writes ``outs`` (``p.grad`` in the optimizer) through
    their addresses; ``unpack_cast_scale`` bumps their version counters,
    as the ``copy_`` it replaces did, so autograd's checks see them
    change."""
    rng = np.random.RandomState(15)
    grads = _grads(GROUPS["mixed"], rng)
    flat, specs = scale_cast.scale_cast_pack_plain(grads, 0.5,
                                                   Compression.fp16)
    ctxs = [g.dtype for g in grads]
    outs = [torch.empty_like(g) for g in grads]
    versions = [o._version for o in outs]
    before = fused_scale_cast.launches
    got = unpack_cast_scale(flat.as_subclass(_OnCard), specs, ctxs, 2.0,
                            outs)
    assert model_kernel == [3, 1]   # the kernel's path: 4 entries, 3 a table
    fused_scale_cast.launches = before
    assert all(g is o for g, o in zip(got, outs))
    assert all(o._version > v for o, v in zip(outs, versions))
    for o, w in zip(outs, unpack_cast_scale_plain(flat, specs, ctxs, 2.0)):
        np.testing.assert_array_equal(_bits(o), _bits(w))


# -- GroupReduction takes the grouped passes where the reference runs A1 ------

@pytest.fixture
def port_cpu():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _recording(reduction, calls):
    def pack(tensors, scale, codec):
        calls.append(("pack", len(tensors), scale, codec))
        return scale_cast_pack(tensors, scale, codec)

    def unpack(flat, specs, ctxs, scale, outs=None):
        calls.append(("unpack", len(specs), scale, outs is not None))
        return unpack_cast_scale(flat, specs, ctxs, scale, outs)

    return dataclasses.replace(reduction, pack=pack, unpack=unpack)


def _per_tensor(tensors, pre, post, codec):
    """The reference's per-tensor composition in the port's pieces, at
    world size 1 (the sum of one rank is the rank's buffer)."""
    wires, ctxs = [], []
    for t in tensors:
        if pre != 1.0:
            t = fused_scale_cast_plain(t.reshape(-1), pre).reshape(t.shape)
        w, ctx = codec.compress(t)
        wires.append(w)
        ctxs.append(ctx)
    flat, specs = pack_flat(wires)
    outs = []
    for piece, ctx in zip(unpack_flat(flat, specs), ctxs):
        g = codec.decompress(piece, ctx)
        if post != 1.0:
            g = fused_scale_cast_plain(g.reshape(-1), post).reshape(g.shape)
        outs.append(g)
    return outs


def _grads(keys, rng):
    return [_pair(s, k, rng)[0] for s, k in zip(SHAPES, keys)]


@pytest.mark.parametrize("wire", list(WIRES))
def test_group_reduction_calls_the_grouped_passes(port_cpu, monkeypatch,
                                                  wire):
    rng = np.random.RandomState(11)
    codec = WIRES[wire][1]
    holder = types.SimpleNamespace(reduction=GroupReduction(
        ReduceOp.SUM, 0.5, 2.0, codec, global_process_set))
    calls = []
    monkeypatch.setattr(holder, "reduction",
                        _recording(holder.reduction, calls))
    red = holder.reduction
    grads = _grads(GROUPS["mixed"], rng)
    got = red.reduce(grads)
    assert calls == [("pack", 4, 0.5, codec), ("unpack", 4, 2.0, False)]
    for g, w in zip(got, _per_tensor(grads, 0.5, 2.0, codec)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))

    # finish writes into the tensors it is given
    calls.clear()
    outs = [torch.empty_like(g) for g in grads]
    done = red.finish(red.launch(grads), outs)
    assert all(d is o for d, o in zip(done, outs))
    assert calls[-1] == ("unpack", 4, 2.0, True)
    for o, w in zip(outs, got):
        np.testing.assert_array_equal(_bits(o), _bits(w))

    # a single-tensor group: comm/eager.allreduce, no grouped pass
    calls.clear()
    red.reduce(grads[:1])
    assert calls == []


@pytest.mark.parametrize("pre,post", [(1.0, 2.0), (0.5, 1.0), (1.0, 1.0)])
def test_group_reduction_at_scale_1_is_the_per_tensor_route(port_cpu, pre,
                                                            post):
    """A direction whose scale is 1 (both, in the optimizer's default
    Average configuration) takes the grouped pass too, and is bitwise
    the per-tensor route, which skips the multiply there."""
    rng = np.random.RandomState(12)
    calls = []
    red = _recording(GroupReduction(ReduceOp.SUM, pre, post,
                                    Compression.fp16, global_process_set),
                     calls)
    grads = _grads(GROUPS["bf16"], rng)
    got = red.reduce(grads)
    assert calls == [("pack", 4, pre, Compression.fp16),
                     ("unpack", 4, post, False)]
    for g, w in zip(got, _per_tensor(grads, pre, post, Compression.fp16)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("odd", [torch.int32, torch.float64])
def test_group_with_another_dtype_is_reduced_tensor_by_tensor(port_cpu, odd):
    rng = np.random.RandomState(13)
    calls = []
    red = _recording(GroupReduction(ReduceOp.SUM, 0.5, 2.0, Compression.none,
                                    global_process_set), calls)
    grads = _grads(["f32", "bf16"], rng) + [
        torch.from_numpy(rng.randint(-50, 50, size=(9,))).to(odd)]
    got = red.reduce(grads)
    assert calls == []
    assert not red.grouped(grads)
    # the integer keeps the truncating scale of controller._apply_scale
    want = grads[2] * torch.tensor(0.5, dtype=odd) * torch.tensor(2.0,
                                                                  dtype=odd)
    assert torch.equal(got[2], want)
    for g, w in zip(got[:2], _per_tensor(grads[:2], 0.5, 2.0,
                                         Compression.none)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_optimizer_reduces_into_the_gradients(monkeypatch):
    """The optimizer's bucket reduction writes the grouped postscale
    straight into ``p.grad``: the gradients keep their storage and
    hold the per-tensor composition's values."""
    monkeypatch.setenv("HVTPU_FUSION_THRESHOLD", "4096")
    hvd.init(device="cpu")
    try:
        _reduce_into_the_gradients(monkeypatch)
    finally:
        hvd.shutdown()


def _reduce_into_the_gradients(monkeypatch):
    model = narrow_resnet(seed=4)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16, gradient_predivide_factor=2.0)
    calls = []
    monkeypatch.setattr(opt, "reduction", _recording(opt.reduction, calls))
    multi = sum(len(b) > 1 for b in opt.buckets)
    assert 1 < multi < len(opt.buckets)   # single-tensor buckets too
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=(4,)))
    torch.nn.functional.cross_entropy(model(x), y).backward()
    params = list(model.parameters())
    local = [p.grad.clone() for p in params]
    ptrs = [p.grad.data_ptr() for p in params]
    opt.synchronize()
    assert [c[0] for c in calls] == ["pack"] * multi + ["unpack"] * multi
    assert all(c[3] for c in calls if c[0] == "unpack")  # into p.grad
    assert [p.grad.data_ptr() for p in params] == ptrs
    by_param = dict(zip(params, local))
    for bucket in opt.buckets:
        if len(bucket) == 1:
            continue
        want = _per_tensor([by_param[p] for p in bucket], 0.5, 2.0,
                           Compression.fp16)
        for p, w in zip(bucket, want):
            np.testing.assert_array_equal(_bits(p.grad), _bits(w))


def test_sweep_script_imports_no_jax():
    """``torch_port_scale_cast_sweep.py`` runs on the card beside
    ``chip_smoke.py``: it imports nothing of JAX or the JAX package."""
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / (
        "torch_port_scale_cast_sweep.py")
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    assert "chip_smoke" in mods
    assert [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "horovod_tpu")] == []


def test_sweep_patches_match_the_source():
    """Every variant of the sweep patches text that ``scale_cast.cu``
    holds exactly once, and the shipped variant is the source as is."""
    import torch_port_scale_cast_sweep as sweep
    from horovod_tpu_torch.ops import _build

    text = (_build.CSRC / "scale_cast.cu").read_text()
    assert sweep.VARIANTS["shipped"] == {}
    for patches in sweep.VARIANTS.values():
        assert all(text.count(old) == 1 for old in patches)


def test_build_copies_patches_each_copy(tmp_path, monkeypatch):
    """``_build.build_copies`` writes one patched copy a variant, with the
    headers beside it, and refuses a patch whose text the source does
    not hold exactly once (nvcc stood in for by ``true``)."""
    import shutil

    from horovod_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "nvcc", lambda: shutil.which("true"))
    line = "constexpr int kThreads = 256;"
    built = _build.build_copies(
        "scale_cast", {"a": {}, "b": {line: "constexpr int kThreads = 128;"}},
        tmp_path, ["-Xptxas", "-v"])
    assert sorted(built) == ["a", "b"]
    source = (_build.CSRC / "scale_cast.cu").read_text()
    assert (tmp_path / "a" / "scale_cast.cu").read_text() == source
    b = (tmp_path / "b" / "scale_cast.cu").read_text()
    assert line not in b and b == source.replace(
        line, "constexpr int kThreads = 128;")
    assert built["b"][0] == tmp_path / "b" / "libscale_cast.so"
    for header in _build.CSRC.glob("*.cuh"):
        assert (tmp_path / "a" / header.name).read_bytes() == (
            header.read_bytes())
    with pytest.raises(RuntimeError, match="exactly once"):
        _build.build_copies("scale_cast", {"c": {"no such text": ""}},
                            tmp_path)

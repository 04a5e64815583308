"""The zero-copy fusion-buffer plane of the port
(``horovod_tpu_torch/comm/packing.py`` ``assign_offsets``,
``ExchangeBuffer``, ``FusionBufferPool``, and the controller's group
unpack), on the CPU, against the JAX package's ``comm/packing.py`` and
its controller's ``_GroupUnpack`` / ``_LazyPiece``.

* Seeded spec lists over eight dtypes: the same offsets and sizes, with
  and without an explicit alignment.
* Seeded sequences of writes into an ``ExchangeBuffer`` (right slot,
  wrong dtype, wrong byte count, a slot filled twice, resets): the same
  answers, the same ``complete()``, and the same bytes in every view and
  in the typed view of a uniform group; a mixed group's typed view is
  refused by both.
* Seeded sequences of acquires and releases on two pools of capacity 3:
  the same buffer handed back (by identity) at every step, so the same
  LRU evictions, and the same ``stats()``.
* The group unpack: the reduced flat buffer of a group (float32,
  bfloat16, float16; a shared postscale, scale 1, and postscales that
  differ by piece) unpacked by the port's ``_GroupUnpack`` through the
  plain A1 version (``unpack_cast_scale`` on a CPU tensor), bitwise the
  reference's slice then ``_apply_scale`` (its Pallas body in interpret
  mode); the in-place ops' tensors receive their pieces and the buffer
  goes back to the pool.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.comm import packing as jax_packing
from horovod_tpu.eager.controller import _GroupUnpack as JaxGroupUnpack
from horovod_tpu.eager.controller import _LazyPiece as JaxLazyPiece
from horovod_tpu_torch.comm import packing
from horovod_tpu_torch.eager.controller import _GroupUnpack, _LazyPiece
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

DTYPES = [
    (torch.float64, np.float64), (torch.float32, np.float32),
    (torch.float16, np.float16), (torch.bfloat16, ml_dtypes.bfloat16),
    (torch.int64, np.int64), (torch.int32, np.int32),
    (torch.int16, np.int16), (torch.int8, np.int8),
]


def _specs(rng, n: int, dtypes=None):
    """``n`` (shape, dtype) pairs: shapes of 0-3 dims, 0-40 elements."""
    out = []
    for _ in range(n):
        k = dtypes[0] if dtypes else DTYPES[rng.randint(len(DTYPES))]
        shape = tuple(int(d) for d in rng.randint(1, 5, rng.randint(0, 4)))
        if rng.rand() < 0.1:
            shape = (0,)
        out.append((shape, k))
    return out


def _both(specs):
    """The same spec list in the port's and the reference's forms."""
    port = [(s, t, int(np.prod(s)) * t.itemsize) for s, (t, _n) in specs]
    ref = [(s, np.dtype(n), int(np.prod(s)) * np.dtype(n).itemsize)
           for s, (_t, n) in specs]
    return port, ref


def _bits(a) -> bytes:
    if torch.is_tensor(a):
        return a.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("seed", range(6))
def test_assign_offsets_match_reference(seed):
    rng = np.random.RandomState(seed)
    port, ref = _both(_specs(rng, rng.randint(1, 12)))
    assert packing.assign_offsets(port) == jax_packing.assign_offsets(ref)
    align = int(rng.choice([1, 4, 16, 64]))
    assert (packing.assign_offsets(port, align=align)
            == jax_packing.assign_offsets(ref, align=align))
    xb, jxb = packing.ExchangeBuffer(port), jax_packing.ExchangeBuffer(ref)
    assert (xb.offsets, xb.nbytes) == (jxb.offsets, jxb.nbytes)
    assert xb.buf.dtype == torch.uint8 and xb.buf.numel() == jxb.buf.size
    assert [(s, n) for s, _d, n in xb.element_specs()] == \
        [(s, n) for s, _d, n in jxb.element_specs()]


def _value(shape, dtypes, rng):
    t, n = dtypes
    x = (rng.randn(*shape) * 50) if shape else np.float64(rng.randn() * 50)
    a = np.asarray(x).astype(n)
    return torch.from_numpy(a.astype(np.float32)).to(t) \
        if t == torch.bfloat16 else torch.from_numpy(np.array(a)), a


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_exchange_buffer_writes_match_reference(seed, uniform):
    rng = np.random.RandomState(100 + seed)
    dts = [DTYPES[rng.randint(len(DTYPES))]] if uniform else None
    specs = _specs(rng, rng.randint(2, 7), dts)
    port, ref = _both(specs)
    xb, jxb = packing.ExchangeBuffer(port), jax_packing.ExchangeBuffer(ref)
    for step in range(4 * len(specs)):
        i = int(rng.randint(len(specs)))
        shape, dt = specs[i]
        kind = rng.choice(["right", "right", "dtype", "nbytes"])
        if kind == "dtype":
            dt = DTYPES[(DTYPES.index(dt) + 1) % len(DTYPES)]
        elif kind == "nbytes":
            shape = (int(np.prod(shape)) + 1,)
        t, a = _value(shape, dt, rng)
        assert xb.write(i, t) == jxb.write(i, a), (step, kind)
        assert xb.complete() == jxb.complete()
        if rng.rand() < 0.1:
            xb.reset()
            jxb.reset()
    # fill what is left, then compare the bytes
    for i, (shape, dt) in enumerate(specs):
        t, a = _value(shape, dt, rng)
        assert xb.write(i, t) == jxb.write(i, a)
    assert xb.complete() and jxb.complete()
    for v, jv in zip(xb.views(), jxb.views()):
        assert tuple(v.shape) == jv.shape
        assert _bits(v) == _bits(jv)
    if uniform or len({d for _s, d in specs}) == 1:
        assert _bits(xb.typed_view()) == _bits(jxb.typed_view())
        assert xb.typed_view().data_ptr() == xb.buf.data_ptr()
    else:
        for b in (xb, jxb):
            with pytest.raises(ValueError):
                b.typed_view()


@pytest.mark.parametrize("seed", range(4))
def test_pool_reuse_and_lru_evictions_match_reference(seed):
    rng = np.random.RandomState(200 + seed)
    layouts = [_both(_specs(rng, rng.randint(1, 3))) for _ in range(4)]
    pool = packing.FusionBufferPool(capacity=3)
    jpool = jax_packing.FusionBufferPool(capacity=3)
    # every buffer stays referenced, so no id() is reused
    held, ids, jids, seen = [], {}, {}, []
    for step in range(40):
        if held and rng.rand() < 0.5:
            psid, xb, jxb = held.pop(rng.randint(len(held)))
            pool.release(psid, xb)
            jpool.release(psid, jxb)
        else:
            psid = int(rng.randint(2))
            port, ref = layouts[rng.randint(len(layouts))]
            xb, jxb = pool.acquire(psid, port), jpool.acquire(psid, ref)
            seen.append((xb, jxb))
            # the same buffer (by identity) comes back from both pools
            assert (ids.setdefault(id(xb), len(ids))
                    == jids.setdefault(id(jxb), len(jids))), step
            assert not xb.complete() and not jxb.complete()
            held.append((psid, xb, jxb))
        assert pool.stats() == jpool.stats(), step


def test_pool_capacity_knob(monkeypatch):
    monkeypatch.setenv(packing.POOL_KNOB, "5")
    assert packing.FusionBufferPool().capacity == 5
    monkeypatch.delenv(packing.POOL_KNOB)
    assert packing.FusionBufferPool().capacity == 16 == \
        jax_packing.FusionBufferPool().capacity


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")


UNPACK_DTYPES = {
    "f32": (torch.float32, jnp.float32, np.float32),
    "bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16),
    "f16": (torch.float16, jnp.float16, np.float16),
}
SHAPES = [(5,), (3, 7), (1,), (2, 2, 3), (130,)]


@pytest.mark.parametrize("posts", ["shared", "one", "mixed"])
@pytest.mark.parametrize("key", list(UNPACK_DTYPES))
def test_group_unpack_matches_reference_slice_then_apply_scale(
        interpret_mode, key, posts):
    tdt, jdt, ndt = UNPACK_DTYPES[key]
    rng = np.random.RandomState(sum(map(ord, key + posts)))
    scales = {"shared": [0.37] * len(SHAPES), "one": [1.0] * len(SHAPES),
              "mixed": [1.0, 0.5, 3.0, 1.0, 1.0 / 3.0]}[posts]
    n = sum(int(np.prod(s)) for s in SHAPES)
    mag = 10.0 ** rng.uniform(-6, 4, size=n)
    flat = (rng.randn(n) * mag).astype(np.float32).astype(ndt)
    port, ref = _both([(s, (tdt, ndt)) for s in SHAPES])
    # in-place destinations for every other piece (the *_async_ ops)
    outs = [torch.zeros(s, dtype=tdt) if i % 2 == 0 else None
            for i, s in enumerate(SHAPES)]
    pool = packing.FusionBufferPool()
    pack = pool.acquire(0, port)
    group = _GroupUnpack(torch.from_numpy(flat.astype(np.float32)).to(tdt)
                         if tdt == torch.bfloat16
                         else torch.from_numpy(flat.copy()),
                         pack.element_specs(), pack, pool, 0, scales, outs)
    got = [_LazyPiece(group, i).materialize(None) for i in range(len(SHAPES))]
    assert all(ev is None for _t, ev in got)
    assert pool.stats()["pooled"] == 1     # back after the unpack
    jpool = jax_packing.FusionBufferPool()
    jpack = jpool.acquire(0, ref)
    jgroup = JaxGroupUnpack(jnp.asarray(flat), jpack.element_specs(), jpack,
                            jpool, 0)
    want = [JaxLazyPiece(jgroup, i, s).materialize()
            for i, s in enumerate(scales)]
    for i, ((t, _ev), w) in enumerate(zip(got, want)):
        assert t.dtype == tdt and tuple(t.shape) == w.shape
        assert _bits(t) == _bits(w), f"piece {i}"
        if outs[i] is not None and scales[i] == scales[0] == scales[-1]:
            # a shared postscale is folded in: the piece IS the out
            assert t.data_ptr() == outs[i].data_ptr()

"""The port's wire v5 (``horovod_tpu_torch/native/wire.py``) against the
JAX package's (``horovod_tpu/native/wire.py``), byte for byte.

Every ``RequestList`` and ``ResponseList`` below, seeded and drawn by
``hypothesis``, is serialized by the port and parsed by the reference,
and the other way round: the bytes are identical, and each side parses
the other's bytes back into the same fields.  The lists cover every
entry field, burst ids and lengths, ``cache_bits`` frames with the
bypass, resync and predicted flags, ``cache_resync_needed``,
``join_last_rank``, error responses, tuned parameters and confirm
hashes; ``mark_predicted``, ``attempt_tag`` / ``split_attempt``,
``bits_to_words`` / ``words_to_bits`` and ``fnv1a64`` are held too.
This parity test stands in for the hvtpulint wire-twin check, which
looks at ``horovod_tpu/native`` only.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from horovod_tpu.native import wire as ref
from horovod_tpu_torch.native import wire as port
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

U32 = st.integers(0, 2 ** 32 - 1)
U64 = st.integers(0, 2 ** 64 - 1)
I32 = st.integers(-2 ** 31, 2 ** 31 - 1)
I64 = st.integers(-2 ** 63, 2 ** 63 - 1)
NAME = st.text(max_size=24)
SHAPE = st.lists(st.integers(0, 2 ** 40), max_size=5).map(tuple)


@st.composite
def entries(draw):
    return dict(seq=draw(U64), name=draw(NAME), type=draw(st.integers(0, 7)),
                red_op=draw(st.integers(0, 5)),
                dtype=draw(st.integers(0, 8)), shape=draw(SHAPE),
                process_set_id=draw(I32), group_id=draw(I64),
                root_rank=draw(I32))


@st.composite
def request_lists(draw):
    reqs = draw(st.lists(st.fixed_dictionaries(dict(
        rank=I32, entry=entries(), cached=st.booleans(), cache_bit=U32)),
        max_size=6))
    return dict(rank=draw(I32), requests=reqs,
                cache_hits=draw(st.lists(U32, max_size=6)),
                joined=draw(st.booleans()), shutdown=draw(st.booleans()),
                cache_bypass=draw(st.booleans()),
                cache_resync=draw(st.booleans()),
                cache_bits=draw(st.lists(U64, max_size=4)),
                predicted=draw(st.booleans()),
                burst_id=draw(U32), burst_len=draw(U32))


@st.composite
def response_lists(draw):
    resps = []
    for _ in range(draw(st.integers(0, 4))):
        names = draw(st.lists(NAME, max_size=4))
        resps.append(dict(
            type=draw(st.integers(0, 7)), red_op=draw(st.integers(0, 5)),
            dtype=draw(st.integers(0, 8)), process_set_id=draw(I32),
            root_rank=draw(I32), tensor_names=names,
            tensor_shapes=[draw(SHAPE) for _ in names],
            total_bytes=draw(I64), error=draw(st.text(max_size=40))))
    return dict(responses=resps, join_last_rank=draw(I32),
                shutdown=draw(st.booleans()),
                cache_resync_needed=draw(st.booleans()),
                tuned_fusion_threshold=draw(I64),
                tuned_cycle_time_us=draw(I32),
                confirm_hashes=draw(st.lists(U64, max_size=4)))


def _requests(mod, d):
    reqs = [mod.Request(rank=r["rank"], entry=mod.Entry(**r["entry"]),
                        cached=r["cached"], cache_bit=r["cache_bit"])
            for r in d["requests"]]
    return mod.RequestList(**{**d, "requests": reqs})


def _responses(mod, d):
    return mod.ResponseList(**{**d, "responses": [
        mod.Response(**r) for r in d["responses"]]})


def _fields(obj):
    return dataclasses.asdict(obj)


def _check_requests(d):
    a = port.serialize_request_list(_requests(port, d))
    b = ref.serialize_request_list(_requests(ref, d))
    assert a == b
    assert _fields(ref.parse_request_list(a)) == _fields(_requests(ref, d))
    assert _fields(port.parse_request_list(b)) == _fields(_requests(port, d))
    assert port.mark_predicted(a) == ref.mark_predicted(b)
    assert port.mark_predicted(a) == port.serialize_request_list(
        _requests(port, {**d, "predicted": True}))


def _check_responses(d):
    a = port.serialize_response_list(_responses(port, d))
    b = ref.serialize_response_list(_responses(ref, d))
    assert a == b
    assert _fields(ref.parse_response_list(a)) == _fields(_responses(ref, d))
    assert _fields(port.parse_response_list(b)) == \
        _fields(_responses(port, d))
    assert port.fnv1a64(a) == ref.fnv1a64(b)


@settings(max_examples=150, deadline=None)
@given(request_lists())
def test_request_lists_are_byte_identical(d):
    _check_requests(d)


@settings(max_examples=150, deadline=None)
@given(response_lists())
def test_response_lists_are_byte_identical(d):
    _check_responses(d)


def _seeded_lists(seed: int):
    """A request list and a response list made with numpy from a seed:
    a bypass frame, a resync frame with full entries, a join and an
    error response."""
    rng = np.random.RandomState(seed)
    ent = [dict(seq=int(rng.randint(1, 1 << 30)), name=f"grad.{i}",
                type=int(rng.randint(0, 8)), red_op=int(rng.randint(0, 6)),
                dtype=int(rng.randint(0, 9)),
                shape=tuple(int(x) for x in rng.randint(0, 99, rng.randint(4))),
                process_set_id=int(rng.randint(0, 3)),
                group_id=int(rng.randint(-1, 5)),
                root_rank=int(rng.randint(-1, 4))) for i in range(5)]
    bits = sorted(set(int(b) for b in rng.randint(0, 300, size=7)))
    req = dict(rank=int(rng.randint(0, 4)),
               requests=[dict(rank=1, entry=e, cached=bool(i % 2),
                              cache_bit=i) for i, e in enumerate(ent)],
               cache_hits=[int(b) for b in bits[:3]],
               joined=bool(seed % 2), shutdown=bool(seed % 3 == 0),
               cache_bypass=bool(seed % 2), cache_resync=not seed % 2,
               cache_bits=port.bits_to_words(bits), predicted=seed == 2,
               burst_id=seed + 1, burst_len=len(bits))
    resp = dict(responses=[dict(
        type=e["type"], red_op=e["red_op"], dtype=e["dtype"],
        process_set_id=e["process_set_id"], root_rank=e["root_rank"],
        tensor_names=[e["name"], e["name"] + ".b"],
        tensor_shapes=[e["shape"], (3, 4)], total_bytes=int(rng.randint(99)),
        error="" if i else "cross-rank tensor mismatch for 'grad.0': rank 1")
        for i, e in enumerate(ent)],
        join_last_rank=int(rng.randint(-1, 4)), shutdown=bool(seed % 2),
        cache_resync_needed=bool(seed % 3), tuned_fusion_threshold=-1,
        tuned_cycle_time_us=int(rng.randint(-1, 5000)),
        confirm_hashes=[port.fnv1a64(bytes(rng.bytes(9)))])
    return req, resp, bits


@pytest.mark.parametrize("seed", range(4))
def test_seeded_lists_are_byte_identical(seed):
    req, resp, bits = _seeded_lists(seed)
    _check_requests(req)
    _check_responses(resp)
    assert port.words_to_bits(port.bits_to_words(bits)) == bits
    assert port.bits_to_words(bits) == ref.bits_to_words(bits)
    assert port.words_to_bits(req["cache_bits"]) == \
        ref.words_to_bits(req["cache_bits"])


@given(st.binary(max_size=64))
def test_fnv1a64_matches(data):
    assert port.fnv1a64(data) == ref.fnv1a64(data)


@given(NAME, st.integers(-2, 40))
def test_attempt_tags_match(name, attempt):
    tagged = port.attempt_tag(name, attempt)
    assert tagged == ref.attempt_tag(name, attempt)
    assert port.split_attempt(tagged) == ref.split_attempt(tagged)


def test_constants_match():
    for k in ("REQUEST_MAGIC", "RESPONSE_MAGIC", "WIRE_VERSION", "ALLREDUCE",
              "JOIN", "RED_ADASUM", "DTYPE_IDS", "DTYPE_SIZES"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port.WIRE_VERSION == 5
    e = dict(name="w", type=1, red_op=2, dtype=5, shape=(3, 0, 7),
             process_set_id=2, root_rank=1)
    assert port.Entry(**e).signature() == ref.Entry(**e).signature()
    assert port.Entry(**e).nbytes == ref.Entry(**e).nbytes

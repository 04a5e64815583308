"""The coordination wire format, version 5 (counterpart of
``horovod_tpu/native/wire.py``, copied so the port imports nothing of the
JAX package).

Parity surface: ``horovod/common/message.cc`` (+ ``wire/message.fbs``)
— Request/RequestList/Response/ResponseList.  The bytes are identical to
the JAX package's ``native/wire.py`` (and so to its C++ core,
``horovod_tpu/native/src/message.cc``) for every list:
``tests/test_torch_port_wire.py`` serializes with each and parses with
the other.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

REQUEST_MAGIC = 0x52545648  # "HVTR"
RESPONSE_MAGIC = 0x50545648  # "HVTP"
# v2: ResponseList carries coordinator-tuned (fusion threshold, cycle
# time) so every rank applies identical autotuned parameters (parity:
# ParameterManager broadcasting tuned params from the coordinator).
# v3: RequestList grows the steady-state `cache_bits` frame (bypass
# cycles negotiate via a per-rank cache-bit vector instead of
# serialized requests; parity: the coordinated cache bitvector of
# Controller::CoordinateCacheAndState) plus bypass/resync flags, and
# ResponseList carries `cache_resync_needed` so the coordinator can
# force every rank back to a full-request cycle.
# v5 (v4 was an ABI-only bump): RequestList carries the atomic
# burst-unit delimiter (`burst_id`/`burst_len` right after the flags
# byte, covering the leading requests or cache bits of this drain) and
# a `predicted` flag (bit 4) marking the blob as a post-hoc
# confirmation of a locally predicted schedule; ResponseList carries
# `confirm_hashes` (FNV-1a 64 of each suppressed fully-predicted
# component's would-be response bytes) so predictors verify without a
# response round trip.
WIRE_VERSION = 5

# OpType (native/src/common.h)
ALLREDUCE, ALLGATHER, BROADCAST, ALLTOALL, REDUCESCATTER, ADASUM, BARRIER, JOIN = range(8)
# RedOp
RED_SUM, RED_AVERAGE, RED_MIN, RED_MAX, RED_PRODUCT, RED_ADASUM = range(6)
# DataType
DTYPE_IDS = {
    "uint8": 0, "int8": 1, "int32": 2, "int64": 3,
    "float16": 4, "bfloat16": 5, "float32": 6, "float64": 7, "bool": 8,
}
DTYPE_NAMES = {v: k for k, v in DTYPE_IDS.items()}
DTYPE_SIZES = {0: 1, 1: 1, 2: 4, 3: 8, 4: 2, 5: 2, 6: 4, 7: 8, 8: 1}


@dataclasses.dataclass
class Entry:
    seq: int = 0
    name: str = ""
    type: int = ALLREDUCE
    red_op: int = RED_SUM
    dtype: int = 6
    shape: Tuple[int, ...] = ()
    process_set_id: int = 0
    group_id: int = -1
    root_rank: int = -1

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.num_elements * DTYPE_SIZES[self.dtype]

    def signature(self) -> str:
        """Must match ResponseCache::Signature (controller.cc)."""
        dims = "".join(f"{d}," for d in self.shape)
        return (f"{self.name}|{self.type}|{self.red_op}|{self.dtype}|"
                f"{self.process_set_id}|{self.root_rank}|{dims}")


@dataclasses.dataclass
class Request:
    rank: int = 0
    entry: Entry = dataclasses.field(default_factory=Entry)
    cached: bool = False
    cache_bit: int = 0


@dataclasses.dataclass
class RequestList:
    rank: int = 0
    requests: List[Request] = dataclasses.field(default_factory=list)
    cache_hits: List[int] = dataclasses.field(default_factory=list)
    joined: bool = False
    shutdown: bool = False
    # Steady-state bypass cycle: ``requests`` is empty and the drained
    # ops travel as set bits in ``cache_bits`` (u64 words, bit b set =>
    # this rank drained a request whose signature holds cache bit b).
    cache_bypass: bool = False
    # This blob is a periodic full resync: requests carry FULL entries
    # (no per-request bit compression) so the coordinator's message
    # table and stall inspector re-anchor on ground truth.
    cache_resync: bool = False
    cache_bits: List[int] = dataclasses.field(default_factory=list)
    # Post-hoc confirmation of a locally predicted schedule: the rank
    # already executed predict_responses(cache_bits) and is not waiting
    # for a ResponseList (it only expects a confirm hash).
    predicted: bool = False
    # Atomic burst unit: this drain's first `burst_len` requests (or,
    # on a bypass blob, its first `burst_len` cache bits in ascending
    # order) form one indivisible unit — the coordinator releases and
    # fuses them together, never across the unit boundary.  0 = no
    # unit (empty drains, membership frames, resync re-announcements).
    burst_id: int = 0
    burst_len: int = 0


# Confirm-hash function for suppressed predicted components.  Must
# match Fnv1a64() in native/src/message.cc byte-for-byte.
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


# --- retry attempt tags ----------------------------------------------
# The consensus abort-and-retry plane (comm/wirefault.py) reruns a
# dead collective under ATTEMPT-TAGGED wire keys so a late packet from
# an aborted attempt can never be mistaken for the live one.  The tag
# rides INSIDE the existing variable-length name/key strings — entry
# names, KV exchange keys — so the wire format itself is unchanged
# (same WIRE_VERSION, byte-identical twins).  Attempt 0 is untagged:
# the healthy path serializes exactly the bytes it always did.
_ATTEMPT_SEP = "#a"


def attempt_tag(name: str, attempt: int) -> str:
    """Tag a wire key / tensor name with a retry attempt number
    (attempt 0 → the name unchanged)."""
    if attempt <= 0:
        return name
    return f"{name}{_ATTEMPT_SEP}{attempt}"


def split_attempt(name: str) -> Tuple[str, int]:
    """Inverse of :func:`attempt_tag`: ``(base_name, attempt)``."""
    base, sep, tail = name.rpartition(_ATTEMPT_SEP)
    if sep and tail.isdigit():
        return base, int(tail)
    return name, 0


# Byte offset of the RequestList flags byte: magic u32 + version u32 +
# rank i32 + joined u8 + shutdown u8.
_FLAGS_OFFSET = 4 + 4 + 4 + 1 + 1


def mark_predicted(blob: bytes) -> bytes:
    """Flip the `predicted` flag on an already-serialized RequestList.

    Turns a drained bypass blob into the compact post-hoc confirmation
    the drainer posts after executing a locally predicted schedule
    (byte-identical to serializing with predicted=True)."""
    return (blob[:_FLAGS_OFFSET]
            + bytes([blob[_FLAGS_OFFSET] | 4])
            + blob[_FLAGS_OFFSET + 1:])


def bits_to_words(bits: List[int]) -> List[int]:
    """Pack bit ids into a little-endian u64-word bitvector."""
    words: List[int] = []
    for b in bits:
        w, o = b >> 6, b & 63
        while len(words) <= w:
            words.append(0)
        words[w] |= 1 << o
    return words


def words_to_bits(words: List[int]) -> List[int]:
    """Unpack a u64-word bitvector into ascending bit ids."""
    bits: List[int] = []
    for w, word in enumerate(words):
        base = w << 6
        while word:
            o = (word & -word).bit_length() - 1
            bits.append(base + o)
            word &= word - 1
    return bits


@dataclasses.dataclass
class Response:
    type: int = ALLREDUCE
    red_op: int = RED_SUM
    dtype: int = 6
    process_set_id: int = 0
    root_rank: int = -1
    tensor_names: List[str] = dataclasses.field(default_factory=list)
    tensor_shapes: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    total_bytes: int = 0
    error: str = ""


@dataclasses.dataclass
class ResponseList:
    responses: List[Response] = dataclasses.field(default_factory=list)
    join_last_rank: int = -1
    shutdown: bool = False
    # Coordinator could not expand a bypass cache bit (cache divergence,
    # e.g. an elastic restart mixing generations): every rank must send
    # a full-resync request blob next cycle, re-announcing in-flight ops.
    cache_resync_needed: bool = False
    # coordinator-tuned parameters (-1 = unset)
    tuned_fusion_threshold: int = -1
    tuned_cycle_time_us: int = -1
    # One FNV-1a 64 hash per suppressed fully-predicted burst
    # component (in release order): every announcing rank predicted the
    # identical schedule, so the coordinator emits the hash of the
    # would-be response bytes instead of the responses themselves.
    confirm_hashes: List[int] = dataclasses.field(default_factory=list)


class _W:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v): self.parts.append(struct.pack("<B", v))
    def u32(self, v): self.parts.append(struct.pack("<I", v))
    def i32(self, v): self.parts.append(struct.pack("<i", v))
    def i64(self, v): self.parts.append(struct.pack("<q", v))
    def u64(self, v): self.parts.append(struct.pack("<Q", v))

    def s(self, v: str):
        b = v.encode("utf-8")
        self.u32(len(b))
        self.parts.append(b)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _R:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, fmt: str, n: int):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += n
        return v

    def u8(self): return self._take("<B", 1)
    def u32(self): return self._take("<I", 4)
    def i32(self): return self._take("<i", 4)
    def i64(self): return self._take("<q", 8)
    def u64(self): return self._take("<Q", 8)

    def s(self) -> str:
        n = self.u32()
        v = self.data[self.off:self.off + n].decode("utf-8")
        self.off += n
        return v


def _write_entry(w: _W, e: Entry):
    w.u64(e.seq)
    w.s(e.name)
    w.u8(e.type)
    w.u8(e.red_op)
    w.u8(e.dtype)
    w.u8(len(e.shape))
    for d in e.shape:
        w.i64(d)
    w.i32(e.process_set_id)
    w.i64(e.group_id)
    w.i32(e.root_rank)


def _read_entry(r: _R) -> Entry:
    e = Entry()
    e.seq = r.u64()
    e.name = r.s()
    e.type = r.u8()
    e.red_op = r.u8()
    e.dtype = r.u8()
    ndim = r.u8()
    e.shape = tuple(r.i64() for _ in range(ndim))
    e.process_set_id = r.i32()
    e.group_id = r.i64()
    e.root_rank = r.i32()
    return e


def serialize_request_list(rl: RequestList) -> bytes:
    w = _W()
    w.u32(REQUEST_MAGIC)
    w.u32(WIRE_VERSION)
    w.i32(rl.rank)
    w.u8(1 if rl.joined else 0)
    w.u8(1 if rl.shutdown else 0)
    w.u8((1 if rl.cache_bypass else 0) | (2 if rl.cache_resync else 0)
         | (4 if rl.predicted else 0))
    w.u32(rl.burst_id)
    w.u32(rl.burst_len)
    w.u32(len(rl.cache_bits))
    for word in rl.cache_bits:
        w.u64(word)
    w.u32(len(rl.cache_hits))
    for b in rl.cache_hits:
        w.u32(b)
    w.u32(len(rl.requests))
    for rq in rl.requests:
        w.i32(rq.rank)
        w.u8(1 if rq.cached else 0)
        w.u32(rq.cache_bit)
        _write_entry(w, rq.entry)
    return w.bytes()


def parse_request_list(data: bytes) -> RequestList:
    r = _R(data)
    if r.u32() != REQUEST_MAGIC:
        raise ValueError("bad request magic")
    if r.u32() != WIRE_VERSION:
        raise ValueError("bad wire version")
    rl = RequestList()
    rl.rank = r.i32()
    rl.joined = r.u8() != 0
    rl.shutdown = r.u8() != 0
    flags = r.u8()
    rl.cache_bypass = bool(flags & 1)
    rl.cache_resync = bool(flags & 2)
    rl.predicted = bool(flags & 4)
    rl.burst_id = r.u32()
    rl.burst_len = r.u32()
    rl.cache_bits = [r.u64() for _ in range(r.u32())]
    rl.cache_hits = [r.u32() for _ in range(r.u32())]
    n = r.u32()
    for _ in range(n):
        rq = Request()
        rq.rank = r.i32()
        rq.cached = r.u8() != 0
        rq.cache_bit = r.u32()
        rq.entry = _read_entry(r)
        rl.requests.append(rq)
    return rl


def serialize_response_list(rl: ResponseList) -> bytes:
    w = _W()
    w.u32(RESPONSE_MAGIC)
    w.u32(WIRE_VERSION)
    w.i32(rl.join_last_rank)
    w.u8(1 if rl.shutdown else 0)
    w.u8(1 if rl.cache_resync_needed else 0)
    w.i64(rl.tuned_fusion_threshold)
    w.i32(rl.tuned_cycle_time_us)
    w.u32(len(rl.confirm_hashes))
    for h in rl.confirm_hashes:
        w.u64(h)
    w.u32(len(rl.responses))
    for rs in rl.responses:
        w.u8(rs.type)
        w.u8(rs.red_op)
        w.u8(rs.dtype)
        w.i32(rs.process_set_id)
        w.i32(rs.root_rank)
        w.i64(rs.total_bytes)
        w.s(rs.error)
        w.u32(len(rs.tensor_names))
        for n in rs.tensor_names:
            w.s(n)
        for shape in rs.tensor_shapes:
            w.u8(len(shape))
            for d in shape:
                w.i64(d)
    return w.bytes()


def parse_response_list(data: bytes) -> ResponseList:
    r = _R(data)
    if r.u32() != RESPONSE_MAGIC:
        raise ValueError("bad response magic")
    if r.u32() != WIRE_VERSION:
        raise ValueError("bad wire version")
    rl = ResponseList()
    rl.join_last_rank = r.i32()
    rl.shutdown = r.u8() != 0
    rl.cache_resync_needed = r.u8() != 0
    rl.tuned_fusion_threshold = r.i64()
    rl.tuned_cycle_time_us = r.i32()
    rl.confirm_hashes = [r.u64() for _ in range(r.u32())]
    n = r.u32()
    for _ in range(n):
        rs = Response()
        rs.type = r.u8()
        rs.red_op = r.u8()
        rs.dtype = r.u8()
        rs.process_set_id = r.i32()
        rs.root_rank = r.i32()
        rs.total_bytes = r.i64()
        rs.error = r.s()
        nt = r.u32()
        rs.tensor_names = [r.s() for _ in range(nt)]
        rs.tensor_shapes = [
            tuple(r.i64() for _ in range(r.u8())) for _ in range(nt)
        ]
        rl.responses.append(rs)
    return rl

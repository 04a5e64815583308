// Wire format for controller coordination messages.
//
// Parity: horovod/common/message.cc + horovod/common/wire/message.fbs
// (Request / RequestList / Response / ResponseList, FlatBuffers).  We
// use a hand-rolled little-endian length-prefixed format instead of
// FlatBuffers: the blobs ride the torch.distributed key-value store
// (which replaces MPI_Gatherv/MPI_Bcast of the reference controller),
// so all we need is compact, versioned, deterministic bytes.
#pragma once

#include <cstring>
#include <stdexcept>

#include "common.h"

namespace hvt {

constexpr uint32_t kRequestMagic = 0x52545648;   // "HVTR"
constexpr uint32_t kResponseMagic = 0x50545648;  // "HVTP"
// v2: ResponseList carries coordinator-tuned (fusion threshold, cycle
// time) so every rank applies identical autotuned parameters.
// v3: RequestList grows the steady-state `cache_bits` frame (bypass
// cycles send a per-rank cache-bit vector instead of serialized
// requests) + bypass/resync flags; ResponseList carries
// `cache_resync_needed` to force full-request cycles on divergence.
// v5 (v4 was an ABI-only bump): RequestList carries the atomic
// burst-unit delimiter (burst_id/burst_len right after the flags byte)
// and a `predicted` confirmation flag (bit 4); ResponseList carries
// `confirm_hashes` (FNV-1a 64 of each suppressed fully-predicted
// component's would-be response bytes).
constexpr uint32_t kWireVersion = 5;

// A request as sent rank -> coordinator. Parity: message.h Request.
struct Request {
  int32_t rank = 0;
  Entry entry;          // metadata of the op this rank declares ready
  bool cached = false;  // true: only cache_bit below is meaningful
  uint32_t cache_bit = 0;
};

// A rank's per-cycle message. Parity: RequestList (with its `shutdown`
// flag; we add `joined` like EnqueueJoin's special request).
struct RequestList {
  int32_t rank = 0;
  std::vector<Request> requests;
  std::vector<uint32_t> cache_hits;  // bit ids of cached pending requests
  bool joined = false;
  bool shutdown = false;
  // Steady-state bypass cycle: `requests` is empty and the drained ops
  // travel as set bits in `cache_bits` (u64 words, little-endian bit
  // order within a word).
  bool cache_bypass = false;
  // Periodic full resync: requests carry FULL entries so the
  // coordinator's message table / stall inspector re-anchor on truth.
  bool cache_resync = false;
  // Post-hoc confirmation of a locally predicted schedule: the rank
  // already executed PredictResponses(cache_bits) and only expects a
  // confirm hash back, not a ResponseList.
  bool predicted = false;
  // Atomic burst unit: this drain's first burst_len requests (or, on a
  // bypass blob, its first burst_len cache bits in ascending order)
  // form one indivisible unit — released and fused together, never
  // across the boundary.  0 = no unit (empty drains, membership
  // frames, resync re-announcements).
  uint32_t burst_id = 0;
  uint32_t burst_len = 0;
  std::vector<uint64_t> cache_bits;
};

// Confirm-hash function for suppressed predicted components.  Must
// match wire.py's fnv1a64 byte-for-byte.
uint64_t Fnv1a64(const uint8_t* data, size_t n);

// Pack ascending bit ids into a u64-word bitvector / back.  The byte
// layout (and therefore the bit order produced by UnpackBits) must
// match wire.py's bits_to_words/words_to_bits exactly.
std::vector<uint64_t> PackBits(const std::vector<uint32_t>& bits);
std::vector<uint32_t> UnpackBits(const std::vector<uint64_t>& words);

// Coordinator decision for one fused batch. Parity: message.h Response:
// one Response may carry many tensor names that execute as a single
// fused collective.
struct Response {
  OpType type = OpType::kAllreduce;
  RedOp red_op = RedOp::kSum;
  DataType dtype = DataType::kFloat32;
  int32_t process_set_id = 0;
  int32_t root_rank = -1;
  std::vector<std::string> tensor_names;
  // Per-tensor shapes, parallel to tensor_names.  The reference carries
  // shapes only in Requests; we echo them in Responses so every rank can
  // rebuild the full cache entry from the response blob alone — that is
  // what keeps ResponseCache bit ids identical across ranks even for
  // process-set-restricted ops.
  std::vector<std::vector<int64_t>> tensor_shapes;
  int64_t total_bytes = 0;
  std::string error;  // non-empty => error response (parity: Response::ERROR)
};

// Parity: ResponseList + `shutdown` flag.
struct ResponseList {
  std::vector<Response> responses;
  int32_t join_last_rank = -1;  // >=0 once every rank joined
  bool shutdown = false;
  // Coordinator could not expand a bypass cache bit: every rank must
  // send a full-resync request blob next cycle (re-announcing its
  // in-flight ops) so the message table heals.
  bool cache_resync_needed = false;
  // coordinator-tuned parameters (-1 = unset)
  int64_t tuned_fusion_threshold = -1;
  int32_t tuned_cycle_time_us = -1;
  // One FNV-1a 64 hash per suppressed fully-predicted burst component
  // (in release order): every announcing rank predicted the identical
  // schedule, so the coordinator emits the hash of the would-be
  // response bytes instead of the responses themselves.
  std::vector<uint64_t> confirm_hashes;
};

// ---------------------------------------------------------------------------
// byte writer/reader
// ---------------------------------------------------------------------------

class Writer {
 public:
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void u32(uint32_t v) { raw(&v, 4); }
  void i32(int32_t v) { raw(&v, 4); }
  void i64(int64_t v) { raw(&v, 8); }
  void u64(uint64_t v) { raw(&v, 8); }
  void f64(double v) { raw(&v, 8); }
  void str(const std::string& s) {
    u32(static_cast<uint32_t>(s.size()));
    raw(s.data(), s.size());
  }
  void raw(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf.insert(buf.end(), b, b + n);
  }
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), end_(p + n) {}
  uint8_t u8() { return *take(1); }
  uint32_t u32() { uint32_t v; memcpy(&v, take(4), 4); return v; }
  int32_t i32() { int32_t v; memcpy(&v, take(4), 4); return v; }
  int64_t i64() { int64_t v; memcpy(&v, take(8), 8); return v; }
  uint64_t u64() { uint64_t v; memcpy(&v, take(8), 8); return v; }
  double f64() { double v; memcpy(&v, take(8), 8); return v; }
  std::string str() {
    uint32_t n = u32();
    const uint8_t* p = take(n);
    return std::string(reinterpret_cast<const char*>(p), n);
  }

 private:
  const uint8_t* take(size_t n) {
    if (p_ + n > end_) throw std::runtime_error("hvt wire: short read");
    const uint8_t* r = p_;
    p_ += n;
    return r;
  }
  const uint8_t* p_;
  const uint8_t* end_;
};

std::vector<uint8_t> SerializeRequestList(const RequestList& rl);
RequestList ParseRequestList(const uint8_t* data, size_t len);
std::vector<uint8_t> SerializeResponseList(const ResponseList& rl);
ResponseList ParseResponseList(const uint8_t* data, size_t len);

}  // namespace hvt

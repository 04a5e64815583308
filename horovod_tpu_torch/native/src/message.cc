#include "message.h"

namespace hvt {

// Parity: message.cc Request::SerializeToString (FlatBuffers there).
static void WriteEntry(Writer& w, const Entry& e) {
  w.u64(e.seq);
  w.str(e.name);
  w.u8(static_cast<uint8_t>(e.type));
  w.u8(static_cast<uint8_t>(e.red_op));
  w.u8(static_cast<uint8_t>(e.dtype));
  w.u8(static_cast<uint8_t>(e.shape.size()));
  for (int64_t d : e.shape) w.i64(d);
  w.i32(e.process_set_id);
  w.i64(e.group_id);
  w.i32(e.root_rank);
}

static Entry ReadEntry(Reader& r) {
  Entry e;
  e.seq = r.u64();
  e.name = r.str();
  e.type = static_cast<OpType>(r.u8());
  e.red_op = static_cast<RedOp>(r.u8());
  e.dtype = static_cast<DataType>(r.u8());
  uint8_t ndim = r.u8();
  e.shape.resize(ndim);
  for (uint8_t i = 0; i < ndim; ++i) e.shape[i] = r.i64();
  e.process_set_id = r.i32();
  e.group_id = r.i64();
  e.root_rank = r.i32();
  return e;
}

std::vector<uint64_t> PackBits(const std::vector<uint32_t>& bits) {
  std::vector<uint64_t> words;
  for (uint32_t b : bits) {
    size_t w = b >> 6;
    if (words.size() <= w) words.resize(w + 1, 0);
    words[w] |= (uint64_t(1) << (b & 63));
  }
  return words;
}

std::vector<uint32_t> UnpackBits(const std::vector<uint64_t>& words) {
  std::vector<uint32_t> bits;
  for (size_t w = 0; w < words.size(); ++w) {
    uint64_t word = words[w];
    while (word) {
      int o = __builtin_ctzll(word);
      bits.push_back(static_cast<uint32_t>((w << 6) + o));
      word &= word - 1;
    }
  }
  return bits;
}

uint64_t Fnv1a64(const uint8_t* data, size_t n) {
  uint64_t h = 0xCBF29CE484222325ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 0x100000001B3ull;
  }
  return h;
}

std::vector<uint8_t> SerializeRequestList(const RequestList& rl) {
  Writer w;
  w.u32(kRequestMagic);
  w.u32(kWireVersion);
  w.i32(rl.rank);
  w.u8(rl.joined ? 1 : 0);
  w.u8(rl.shutdown ? 1 : 0);
  w.u8((rl.cache_bypass ? 1 : 0) | (rl.cache_resync ? 2 : 0) |
       (rl.predicted ? 4 : 0));
  w.u32(rl.burst_id);
  w.u32(rl.burst_len);
  w.u32(static_cast<uint32_t>(rl.cache_bits.size()));
  for (uint64_t word : rl.cache_bits) w.u64(word);
  w.u32(static_cast<uint32_t>(rl.cache_hits.size()));
  for (uint32_t b : rl.cache_hits) w.u32(b);
  w.u32(static_cast<uint32_t>(rl.requests.size()));
  for (const Request& rq : rl.requests) {
    w.i32(rq.rank);
    w.u8(rq.cached ? 1 : 0);
    w.u32(rq.cache_bit);
    WriteEntry(w, rq.entry);
  }
  return std::move(w.buf);
}

RequestList ParseRequestList(const uint8_t* data, size_t len) {
  Reader r(data, len);
  if (r.u32() != kRequestMagic) throw std::runtime_error("bad request magic");
  if (r.u32() != kWireVersion) throw std::runtime_error("bad wire version");
  RequestList rl;
  rl.rank = r.i32();
  rl.joined = r.u8() != 0;
  rl.shutdown = r.u8() != 0;
  uint8_t flags = r.u8();
  rl.cache_bypass = (flags & 1) != 0;
  rl.cache_resync = (flags & 2) != 0;
  rl.predicted = (flags & 4) != 0;
  rl.burst_id = r.u32();
  rl.burst_len = r.u32();
  uint32_t nwords = r.u32();
  rl.cache_bits.resize(nwords);
  for (uint32_t i = 0; i < nwords; ++i) rl.cache_bits[i] = r.u64();
  uint32_t nhits = r.u32();
  rl.cache_hits.resize(nhits);
  for (uint32_t i = 0; i < nhits; ++i) rl.cache_hits[i] = r.u32();
  uint32_t nreq = r.u32();
  rl.requests.resize(nreq);
  for (uint32_t i = 0; i < nreq; ++i) {
    rl.requests[i].rank = r.i32();
    rl.requests[i].cached = r.u8() != 0;
    rl.requests[i].cache_bit = r.u32();
    rl.requests[i].entry = ReadEntry(r);
  }
  return rl;
}

std::vector<uint8_t> SerializeResponseList(const ResponseList& rl) {
  Writer w;
  w.u32(kResponseMagic);
  w.u32(kWireVersion);
  w.i32(rl.join_last_rank);
  w.u8(rl.shutdown ? 1 : 0);
  w.u8(rl.cache_resync_needed ? 1 : 0);
  w.i64(rl.tuned_fusion_threshold);
  w.i32(rl.tuned_cycle_time_us);
  w.u32(static_cast<uint32_t>(rl.confirm_hashes.size()));
  for (uint64_t h : rl.confirm_hashes) w.u64(h);
  w.u32(static_cast<uint32_t>(rl.responses.size()));
  for (const Response& rs : rl.responses) {
    w.u8(static_cast<uint8_t>(rs.type));
    w.u8(static_cast<uint8_t>(rs.red_op));
    w.u8(static_cast<uint8_t>(rs.dtype));
    w.i32(rs.process_set_id);
    w.i32(rs.root_rank);
    w.i64(rs.total_bytes);
    w.str(rs.error);
    w.u32(static_cast<uint32_t>(rs.tensor_names.size()));
    for (const std::string& n : rs.tensor_names) w.str(n);
    for (const std::vector<int64_t>& shape : rs.tensor_shapes) {
      w.u8(static_cast<uint8_t>(shape.size()));
      for (int64_t d : shape) w.i64(d);
    }
  }
  return std::move(w.buf);
}

ResponseList ParseResponseList(const uint8_t* data, size_t len) {
  Reader r(data, len);
  if (r.u32() != kResponseMagic) throw std::runtime_error("bad response magic");
  if (r.u32() != kWireVersion) throw std::runtime_error("bad wire version");
  ResponseList rl;
  rl.join_last_rank = r.i32();
  rl.shutdown = r.u8() != 0;
  rl.cache_resync_needed = r.u8() != 0;
  rl.tuned_fusion_threshold = r.i64();
  rl.tuned_cycle_time_us = r.i32();
  uint32_t nconfirm = r.u32();
  rl.confirm_hashes.resize(nconfirm);
  for (uint32_t i = 0; i < nconfirm; ++i) rl.confirm_hashes[i] = r.u64();
  uint32_t n = r.u32();
  rl.responses.resize(n);
  for (uint32_t i = 0; i < n; ++i) {
    Response& rs = rl.responses[i];
    rs.type = static_cast<OpType>(r.u8());
    rs.red_op = static_cast<RedOp>(r.u8());
    rs.dtype = static_cast<DataType>(r.u8());
    rs.process_set_id = r.i32();
    rs.root_rank = r.i32();
    rs.total_bytes = r.i64();
    rs.error = r.str();
    uint32_t nt = r.u32();
    rs.tensor_names.resize(nt);
    for (uint32_t j = 0; j < nt; ++j) rs.tensor_names[j] = r.str();
    rs.tensor_shapes.resize(nt);
    for (uint32_t j = 0; j < nt; ++j) {
      uint8_t ndim = r.u8();
      rs.tensor_shapes[j].resize(ndim);
      for (uint8_t k = 0; k < ndim; ++k) rs.tensor_shapes[j][k] = r.i64();
    }
  }
  return rl;
}

}  // namespace hvt

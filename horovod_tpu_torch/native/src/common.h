// horovod_tpu_torch native core — shared types.
//
// Re-implementation of the reference's C++ core vocabulary
// (reference: horovod/common/common.h — TensorTableEntry, Status,
// DataType, and horovod/common/message.h — RequestType/ResponseType).
// The data plane (actual collectives) lives in torch.distributed; this
// library is the *control plane* for the eager path: queueing, readiness
// coordination, fusion planning, caching, stall detection.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace hvt {

// Parity: horovod/common/common.h DataType (wire dtype ids are part of
// the request signature, so keep a stable numbering).
enum class DataType : uint8_t {
  kUint8 = 0,
  kInt8 = 1,
  kInt32 = 2,
  kInt64 = 3,
  kFloat16 = 4,
  kBFloat16 = 5,
  kFloat32 = 6,
  kFloat64 = 7,
  kBool = 8,
};

inline int64_t DataTypeSize(DataType t) {
  switch (t) {
    case DataType::kUint8:
    case DataType::kInt8:
    case DataType::kBool:
      return 1;
    case DataType::kFloat16:
    case DataType::kBFloat16:
      return 2;
    case DataType::kInt32:
    case DataType::kFloat32:
      return 4;
    default:
      return 8;
  }
}

// Parity: horovod/common/message.h Request::RequestType (+ our BARRIER,
// which the reference spells as a zero-byte allreduce).
enum class OpType : uint8_t {
  kAllreduce = 0,
  kAllgather = 1,
  kBroadcast = 2,
  kAlltoall = 3,
  kReducescatter = 4,
  kAdasum = 5,
  kBarrier = 6,
  kJoin = 7,
};

// Reduction semantics rider for allreduce-family ops.
enum class RedOp : uint8_t {
  kSum = 0,
  kAverage = 1,
  kMin = 2,
  kMax = 3,
  kProduct = 4,
  kAdasum = 5,
};

struct Status {
  bool ok = true;
  std::string message;
  static Status OK() { return {}; }
  static Status Error(std::string msg) { return {false, std::move(msg)}; }
};

// One pending eager operation. Parity: horovod/common/common.h
// TensorTableEntry minus the framework tensor pointers — payloads stay
// on the Python side keyed by `seq`; the control plane only needs
// metadata.
struct Entry {
  uint64_t seq = 0;       // process-local enqueue sequence id (handle)
  std::string name;       // globally-meaningful tensor name
  OpType type = OpType::kAllreduce;
  RedOp red_op = RedOp::kSum;
  DataType dtype = DataType::kFloat32;
  std::vector<int64_t> shape;
  int32_t process_set_id = 0;
  int64_t group_id = -1;  // -1: ungrouped (parity: group_table.cc NULL_GROUP_ID)
  int32_t root_rank = -1; // broadcast only
  double enqueue_time_s = 0.0;  // steady-clock seconds, for stall checks

  int64_t num_elements() const {
    int64_t n = 1;
    for (int64_t d : shape) n *= d;
    return n;
  }
  int64_t nbytes() const { return num_elements() * DataTypeSize(dtype); }
};

}  // namespace hvt

// C ABI surface for ctypes bindings (horovod_tpu_torch/native/core.py).
//
// The library is built with -fvisibility=hidden and a linker version
// script that exports hvt_* alone (native/_build.py): only the extern
// "C" blocks (here and in gaussian_process.cc) are visible, so another
// copy of this core loaded into the same process can neither bind to
// this one's internals (GlobalPool(), the controller classes) nor lend
// it its own.
//
// Parity: the reference exposes its C++ core to Python through the
// per-framework pybind modules (horovod/torch/mpi_ops_v2.cc,
// horovod/common/basics.py ctypes on the shared lib).  We expose a
// framework-neutral C ABI and bind it once with ctypes — no pybind11 in
// this environment (see repo constraints).
//
// Memory protocol: functions that return variable-size blobs take a
// caller buffer + capacity and return the needed size; callers retry
// with a bigger buffer if needed (Python wrapper handles this).
#include <cstring>
#include <sstream>

#include "controller.h"
#include "thread_pool.h"
#include "timeline.h"

using namespace hvt;

namespace {

// Controller + staged blobs.  Drain/compute are side-effecting, so the
// two-call size-probe protocol stages the produced blob on the first
// (buf == nullptr) call and only copies it out on the second.
struct ControllerHandle {
  Controller ctrl;
  std::vector<uint8_t> staged_requests;
  std::vector<uint8_t> staged_responses;
  std::vector<uint8_t> staged_predict;
  std::vector<uint8_t> staged_stalls;
  template <typename... A>
  explicit ControllerHandle(A&&... a) : ctrl(std::forward<A>(a)...) {}
};

ControllerHandle* Handle(void* h) { return static_cast<ControllerHandle*>(h); }

Controller* Ctrl(void* h) { return &static_cast<ControllerHandle*>(h)->ctrl; }

// Two-call protocol helper: produce() is only invoked when staging.
template <typename Produce>
int64_t Staged(std::vector<uint8_t>* staged, uint8_t* buf, int64_t cap,
               Produce produce) {
  if (buf == nullptr) {
    *staged = produce();
    return static_cast<int64_t>(staged->size());
  }
  int64_t n = static_cast<int64_t>(staged->size());
  if (cap < n) return n;  // too small: keep staged so the caller can retry
  if (n > 0) memcpy(buf, staged->data(), n);
  staged->clear();
  return n;
}

}  // namespace

#pragma GCC visibility push(default)
extern "C" {

// ---- versioning ----------------------------------------------------------
// v2: + hvt_gp_* (gaussian_process.cc)
// v3: wire v3 cache_bits bypass frame + hvt_controller_set_resync_every
// v4: cross-rank mismatch diagnostics (named-rank error responses +
//     forced cache resync on disagreement)
// v5: wire v5 atomic burst units (burst_id/burst_len delimiter,
//     predicted confirmation flag, confirm_hashes) +
//     hvt_controller_drain_requests gains a limit argument +
//     hvt_controller_force_resync (mispredict re-anchor)
int hvt_abi_version() { return 5; }

// ---- controller ----------------------------------------------------------
void* hvt_controller_new(int rank, int size, int64_t fusion_threshold,
                         int64_t cache_capacity, double stall_warn_s,
                         double stall_abort_s) {
  return new ControllerHandle(rank, size, fusion_threshold,
                              static_cast<size_t>(cache_capacity),
                              stall_warn_s, stall_abort_s);
}

void hvt_controller_free(void* c) {
  delete static_cast<ControllerHandle*>(c);
}

// Returns 0 on success, nonzero on error (duplicate name).
int hvt_controller_enqueue(void* c, uint64_t seq, const char* name,
                           int op_type, int red_op, int dtype,
                           const int64_t* shape, int ndim,
                           int process_set_id, int64_t group_id,
                           int root_rank) {
  Entry e;
  e.seq = seq;
  e.name = name;
  e.type = static_cast<OpType>(op_type);
  e.red_op = static_cast<RedOp>(red_op);
  e.dtype = static_cast<DataType>(dtype);
  e.shape.assign(shape, shape + ndim);
  e.process_set_id = process_set_id;
  e.group_id = group_id;
  e.root_rank = root_rank;
  Status st;
  Ctrl(c)->Enqueue(std::move(e), &st);
  return st.ok ? 0 : 1;
}

void hvt_controller_declare_group(void* c, int64_t group_id, int size) {
  Ctrl(c)->DeclareGroup(group_id, size);
}

void hvt_controller_register_process_set(void* c, int psid,
                                         const int32_t* ranks, int n) {
  Ctrl(c)->RegisterProcessSet(
      psid, std::vector<int32_t>(ranks, ranks + n));
}

void hvt_controller_set_joined(void* c) {
  Ctrl(c)->SetJoined();
}

// limit > 0 caps the drained entries at the caller's known steady
// burst size (atomic-burst cap; 0 = drain everything).
int64_t hvt_controller_drain_requests(void* c, uint8_t* buf, int64_t cap,
                                      int64_t limit) {
  return Staged(&Handle(c)->staged_requests, buf, cap,
                [c, limit] { return Ctrl(c)->DrainRequests(limit); });
}

void hvt_controller_ingest(void* c, const uint8_t* data, int64_t len) {
  Ctrl(c)->Ingest(data, static_cast<size_t>(len));
}

int64_t hvt_controller_compute_responses(void* c, uint8_t* buf, int64_t cap) {
  return Staged(&Handle(c)->staged_responses, buf, cap,
                [c] { return Ctrl(c)->ComputeResponses(); });
}

// Applies responses; writes up to `cap` finished seq ids into out_seqs.
// Returns the number of finished seqs (callers size out_seqs generously:
// one per outstanding handle).
int64_t hvt_controller_apply_responses(void* c, const uint8_t* data,
                                       int64_t len, uint64_t* out_seqs,
                                       int64_t cap) {
  std::vector<uint64_t> fin;
  Ctrl(c)->ApplyResponses(data, static_cast<size_t>(len),
                                              &fin);
  int64_t n = static_cast<int64_t>(fin.size());
  for (int64_t i = 0; i < n && i < cap; ++i) out_seqs[i] = fin[i];
  return n;
}

int64_t hvt_controller_pending_count(void* c) {
  return Ctrl(c)->pending_count();
}

int64_t hvt_controller_pending_bytes(void* c) {
  return Ctrl(c)->pending_bytes();
}

int64_t hvt_controller_cache_size(void* c) {
  return static_cast<int64_t>(Ctrl(c)->cache_size());
}

void hvt_controller_set_fusion_threshold(void* c, int64_t bytes) {
  Ctrl(c)->set_fusion_threshold(bytes);
}

void hvt_controller_set_tuned(void* c, int64_t fusion_threshold,
                              int32_t cycle_time_us) {
  Ctrl(c)->SetTuned(fusion_threshold, cycle_time_us);
}

void hvt_controller_set_shutdown(void* c) { Ctrl(c)->SetShutdown(); }

void hvt_controller_set_resync_every(void* c, int64_t n) {
  Ctrl(c)->SetResyncEvery(n);
}

void hvt_controller_force_resync(void* c) { Ctrl(c)->ForceResync(); }

// Steady-state schedule prediction (two-call size-probe protocol like
// drain/compute).  Returns 0 when a bit is unknown (caller must not
// predict); a real empty ResponseList still serializes to >0 bytes.
int64_t hvt_controller_predict_responses(void* c, const uint32_t* bits,
                                         int64_t n, uint8_t* buf,
                                         int64_t cap) {
  return Staged(&Handle(c)->staged_predict, buf, cap, [c, bits, n] {
    return Ctrl(c)->PredictResponses(
        std::vector<uint32_t>(bits, bits + n));
  });
}

// Eagerly retire predicted-executed in-flight entries; `names` is a
// '\n'-joined list.  Writes up to `cap` finished seqs; returns count.
int64_t hvt_controller_finish_names(void* c, const char* names,
                                    int64_t len, uint64_t* out_seqs,
                                    int64_t cap) {
  std::vector<std::string> parts;
  const char* p = names;
  const char* end = names + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (nl == nullptr) nl = end;
    parts.emplace_back(p, nl - p);
    p = nl + 1;
  }
  std::vector<uint64_t> fin = Ctrl(c)->FinishNames(parts);
  int64_t n = static_cast<int64_t>(fin.size());
  for (int64_t i = 0; i < n && i < cap; ++i) out_seqs[i] = fin[i];
  return n;
}

// JSON stall report (parity: stall_inspector.cc warning text, but
// machine-readable): [{"name":..,"waiting_s":..,"present":[..],
// "missing":[..]}, ...]
int64_t hvt_controller_check_stalls(void* c, char* buf, int64_t cap) {
  return Staged(
      &Handle(c)->staged_stalls, reinterpret_cast<uint8_t*>(buf), cap, [c] {
        std::ostringstream ss;
        ss << '[';
        bool first = true;
        for (const StallEntry& se : Ctrl(c)->CheckStalls()) {
          if (!first) ss << ',';
          first = false;
          ss << "{\"name\":\"" << se.name
             << "\",\"waiting_s\":" << se.waiting_s << ",\"present\":[";
          for (size_t i = 0; i < se.present_ranks.size(); ++i) {
            if (i) ss << ',';
            ss << se.present_ranks[i];
          }
          ss << "],\"missing\":[";
          for (size_t i = 0; i < se.missing_ranks.size(); ++i) {
            if (i) ss << ',';
            ss << se.missing_ranks[i];
          }
          ss << "]}";
        }
        ss << ']';
        const std::string s = ss.str();
        return std::vector<uint8_t>(s.begin(), s.end());
      });
}

// ---- parallel memcpy (fusion staging; parity: thread_pool.cc use in
// MemcpyInFusionBuffer) --------------------------------------------------
void hvt_parallel_gather(uint8_t* dst, const uint8_t** srcs,
                         const int64_t* sizes, int64_t n) {
  std::vector<int64_t> offsets(n);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    off += sizes[i];
  }
  GlobalPool().ParallelFor(n, [&](int64_t i) {
    memcpy(dst + offsets[i], srcs[i], sizes[i]);
  });
}

void hvt_parallel_scatter(const uint8_t* src, uint8_t** dsts,
                          const int64_t* sizes, int64_t n) {
  std::vector<int64_t> offsets(n);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    off += sizes[i];
  }
  GlobalPool().ParallelFor(n, [&](int64_t i) {
    memcpy(dsts[i], src + offsets[i], sizes[i]);
  });
}

int hvt_pool_num_threads() { return GlobalPool().num_threads(); }

// ---- timeline ------------------------------------------------------------
void* hvt_timeline_new(const char* path, int rank) {
  TimelineWriter* t = new TimelineWriter(path, rank);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}

void hvt_timeline_free(void* t) { delete static_cast<TimelineWriter*>(t); }

void hvt_timeline_event(void* t, const char* name, char ph,
                        const char* category, double ts_us, double dur_us) {
  static_cast<TimelineWriter*>(t)->Event(name, ph, category, ts_us, dur_us);
}

void hvt_timeline_mark_cycle(void* t, double ts_us) {
  static_cast<TimelineWriter*>(t)->MarkCycle(ts_us);
}

void hvt_timeline_flush(void* t) { static_cast<TimelineWriter*>(t)->Flush(); }

}  // extern "C"
#pragma GCC visibility pop

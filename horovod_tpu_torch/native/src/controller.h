// Eager mini-controller: readiness coordination, response cache, fusion
// planning, group gating, join, stall inspection.
//
// Parity map (reference -> here):
//   horovod/common/tensor_queue.cc  TensorQueue            -> TensorQueue
//   horovod/common/controller.cc    Controller::ComputeResponseList,
//                                   MessageTable            -> Controller
//   horovod/common/controller.cc    Controller::FuseResponses -> FuseResponses
//   horovod/common/response_cache.cc ResponseCache          -> ResponseCache
//   horovod/common/group_table.cc   GroupTable              -> GroupTable
//   horovod/common/stall_inspector.cc StallInspector        -> StallInspector
//
// Design departure (SURVEY.md §7.0): the reference's controller runs on a
// background thread inside each rank and talks MPI/Gloo.  Here the
// controller is a passive state machine driven by the Python cycle loop
// (horovod_tpu_torch/eager/controller.py); the transport between ranks
// is the torch.distributed store, and the data plane is torch.distributed
// collectives.  Everything order-sensitive (cache mutation, fusion
// order) happens in response-apply order, which is identical on every
// rank — that is what keeps rank-local state consistent without any
// extra coordination traffic.
#pragma once

#include <atomic>
#include <deque>
#include <list>
#include <map>
#include <mutex>
#include <set>
#include <unordered_map>

#include "message.h"

namespace hvt {

double NowSeconds();  // monotonic

// --------------------------------------------------------------------------
// TensorQueue (parity: tensor_queue.cc)
// --------------------------------------------------------------------------
class TensorQueue {
 public:
  // Returns false if a pending entry with the same name already exists
  // (parity: AddToTensorQueue's DUPLICATE_NAME_ERROR).
  bool Add(Entry e);
  // Pop up to the full pending list for this cycle (parity:
  // PopMessagesFromQueue); entries move to in-flight keyed by name.
  // limit > 0 caps the drain at that many entries (atomic-burst cap:
  // one wire unit == one application burst even when the next burst
  // already started queueing).
  std::vector<Entry> Drain(size_t limit = 0);
  // Remove finished entries by name; returns their seq ids (parity:
  // GetTensorEntriesFromResponse + PopMessagesFromQueue bookkeeping).
  std::vector<uint64_t> Finish(const std::vector<std::string>& names);
  // Copies of the entries currently in flight (drained but not yet
  // answered) — re-announced on a coordinator-requested cache resync.
  std::vector<Entry> InFlightSnapshot() const;
  int64_t pending_count() const;
  int64_t pending_bytes() const;

 private:
  mutable std::mutex mu_;
  std::deque<Entry> pending_;
  std::unordered_map<std::string, Entry> in_flight_;
  std::set<std::string> pending_names_;
};

// --------------------------------------------------------------------------
// ResponseCache (parity: response_cache.cc)
// --------------------------------------------------------------------------
// Caches the full signature of repeated requests so steady-state cycles
// exchange small bit ids instead of serialized requests.  All mutation
// happens in response-apply order => identical on all ranks.
class ResponseCache {
 public:
  explicit ResponseCache(size_t capacity) : capacity_(capacity) {}

  static std::string Signature(const Entry& e);
  // -1 if absent, else bit id. Does NOT touch LRU order (enqueue-side
  // lookups happen in rank-local order; only Apply-side touches are
  // replicated).
  int64_t Lookup(const std::string& signature) const;
  // Insert-or-touch in apply order; evicts LRU when over capacity.
  // Returns the bit id.
  uint32_t Put(const std::string& signature, const Entry& e);
  bool GetEntryForBit(uint32_t bit, Entry* out) const;
  size_t size() const { return lru_.size(); }
  size_t capacity() const { return capacity_; }

 private:
  struct CacheItem {
    std::string signature;
    Entry entry;
    uint32_t bit;
  };
  size_t capacity_;
  std::list<CacheItem> lru_;  // front = most recent
  std::unordered_map<std::string, std::list<CacheItem>::iterator> by_sig_;
  std::unordered_map<uint32_t, std::list<CacheItem>::iterator> by_bit_;
  std::set<uint32_t> free_bits_;
  uint32_t next_bit_ = 0;
};

// --------------------------------------------------------------------------
// GroupTable (parity: group_table.cc)
// --------------------------------------------------------------------------
class GroupTable {
 public:
  void DeclareGroup(int64_t group_id, int32_t size) { sizes_[group_id] = size; }
  int32_t GroupSize(int64_t group_id) const {
    auto it = sizes_.find(group_id);
    return it == sizes_.end() ? -1 : it->second;
  }

 private:
  std::unordered_map<int64_t, int32_t> sizes_;
};

// --------------------------------------------------------------------------
// StallInspector (parity: stall_inspector.cc)
// --------------------------------------------------------------------------
struct StallEntry {
  std::string name;
  double waiting_s = 0;
  std::vector<int32_t> present_ranks;
  std::vector<int32_t> missing_ranks;
};

// --------------------------------------------------------------------------
// Controller
// --------------------------------------------------------------------------
class Controller {
 public:
  Controller(int32_t rank, int32_t size, int64_t fusion_threshold_bytes,
             size_t cache_capacity, double stall_warn_s, double stall_abort_s);

  // ---- rank-local side ----
  uint64_t Enqueue(Entry e, Status* status);
  void DeclareGroup(int64_t group_id, int32_t size) {
    group_table_.DeclareGroup(group_id, size);
  }
  void RegisterProcessSet(int32_t psid, std::vector<int32_t> ranks);
  void SetJoined() { joined_ = true; }
  // Announce this rank wants to shut down (emitted in every
  // subsequent DrainRequests).  The rank keeps cycling — serving
  // coordination — until the coordinator sees EVERY rank's
  // announcement and broadcasts ResponseList.shutdown (global
  // quiesce); meanwhile pending collectives that NEED an announced
  // rank fail promptly with an error response instead of stalling
  // (parity: horovod_shutdown's negotiated DONE + the "Horovod has
  // been shut down" error for stragglers).
  void SetShutdown() { shutdown_ = true; }
  // Coordinator-side: publish autotuned params in every ResponseList
  // so all ranks apply identical values (parity: ParameterManager
  // broadcasting tuned params from the coordinator).
  void SetTuned(int64_t fusion_threshold, int32_t cycle_time_us) {
    std::lock_guard<std::mutex> g(mu_);
    tuned_threshold_ = fusion_threshold;
    tuned_cycle_us_ = cycle_time_us;
  }
  // Steady-state bypass cadence: every Nth all-cache-hit cycle sends a
  // full-resync request blob instead of the compact bit vector (0
  // disables bypass entirely).  Cycle-thread + init-time only.
  void SetResyncEvery(int64_t n) { resync_every_ = n; }
  // Rank-side re-anchor (mispredict recovery / quiesce rollback): the
  // next DrainRequests emits a full-entry resync frame — re-announcing
  // in-flight ops — exactly as if the coordinator had requested
  // cache_resync_needed.
  void ForceResync() {
    resync_flush_ = true;
    bypass_streak_ = 0;
  }
  // Serialize this cycle's RequestList (drains the queue into
  // in-flight); limit > 0 caps the drained entries (atomic-burst cap).
  std::vector<uint8_t> DrainRequests(int64_t limit = 0);
  // Apply an agreed ResponseList: update cache + queue; out_finished gets
  // the seq ids completed by this response list, in response order.
  ResponseList ApplyResponses(const uint8_t* data, size_t len,
                              std::vector<uint64_t>* out_finished);

  // Steady-state schedule prediction: the ResponseList the
  // coordinator will emit for a pure bypass cycle of exactly `bits`
  // (deterministic in the replicated cache + fusion threshold).
  // Empty vector when a bit is unknown.
  std::vector<uint8_t> PredictResponses(const std::vector<uint32_t>& bits);
  // Eagerly retire predicted-executed in-flight entries by name.
  std::vector<uint64_t> FinishNames(const std::vector<std::string>& names);

  // ---- coordinator side (rank 0; parity: MessageTable at rank 0) ----
  void Ingest(const uint8_t* data, size_t len);
  // Decide globally-ready set, fuse, clear consumed coordination state.
  // (parity: Controller::ComputeResponseList + FuseResponses)
  std::vector<uint8_t> ComputeResponses();

  std::vector<StallEntry> CheckStalls() const;

  int64_t pending_count() const { return queue_.pending_count(); }
  int64_t pending_bytes() const { return queue_.pending_bytes(); }
  size_t cache_size() const { return cache_.size(); }
  int32_t rank() const { return rank_; }
  int32_t size() const { return size_; }
  void set_fusion_threshold(int64_t b) { fusion_threshold_ = b; }
  int64_t fusion_threshold() const { return fusion_threshold_; }

 private:
  // (rank, burst_id) reference into units_: the atomic burst unit this
  // coordination belongs to on that rank's stream.
  using UnitRef = std::pair<int32_t, uint32_t>;

  struct PendingCoordination {
    Entry entry;                 // from the first rank that reported it
    std::set<int32_t> ranks;     // ranks that reported ready
    double first_seen_s = 0;
    int32_t first_rank = -1;     // who contributed `entry`
    // ranks whose submission disagreed with `entry` on the agreement
    // surface (SameParams), with what they submitted — turned into a
    // named-rank error response instead of a silent mis-fuse/stall.
    std::map<int32_t, Entry> mismatched;
    // burst units referencing this occurrence; release is gated on
    // every one being completely ready (see BuildResponseList).
    std::set<UnitRef> units;
    // ranks whose announcement carried the PREDICTED confirmation flag
    std::set<int32_t> predicted;
    // creation index — deterministic component emission order
    uint64_t seq = 0;
  };

  static std::string TableKey(const Entry& e);
  // Cross-rank agreement surface; group_id and allgather/alltoall
  // dim 0 deliberately excluded (rank-local bookkeeping / legitimate
  // per-rank raggedness).  Must match fallback._same_params.
  static bool SameParams(const Entry& a, const Entry& b);
  // Submission summary for mismatch diagnostics; byte-identical to
  // fallback._entry_desc.
  static std::string EntryDesc(const Entry& e);
  // Record one rank's announcement, tracking per-rank conflicts.
  // occurrence=true (burst-unit announcements) opens a NEW occurrence
  // relative to ones this rank already announced; occurrence=false
  // matches idempotently (legacy / resync re-announcements).  Must
  // match fallback._table_add.
  PendingCoordination* TableAdd(Entry e, int32_t rank, double now,
                                bool occurrence, std::string* out_key);
  // Pop a released coordination off its occurrence queue and drop its
  // key from every burst unit that referenced it.
  void ReleaseFront(const std::string& key, const PendingCoordination& pc);
  int32_t RequiredRanks(int32_t psid) const;
  std::vector<int32_t> ProcessSetRanks(int32_t psid) const;
  int32_t PresentCount(const PendingCoordination& pc) const;
  ResponseList BuildResponseList();
  void FuseResponses(std::vector<Response>* responses) const;

  int32_t rank_, size_;
  int64_t fusion_threshold_;
  double stall_warn_s_, stall_abort_s_;

  TensorQueue queue_;
  ResponseCache cache_;
  GroupTable group_table_;
  // set by the frontend thread, read lock-free by the cycle thread's
  // DrainRequests — atomics, not a data race
  std::atomic<bool> joined_{false};
  std::atomic<bool> shutdown_{false};

  // cycle-thread-only bypass bookkeeping (drain/apply both run on the
  // Python cycle loop's thread)
  int64_t resync_every_ = 64;
  int64_t bypass_streak_ = 0;
  bool resync_flush_ = false;
  // per-rank monotonic burst-unit counter (drain side)
  uint32_t burst_seq_ = 0;

  // coordinator state.  Each key holds an OCCURRENCE QUEUE of pending
  // coordinations (front = oldest): with prediction on, a rank's
  // fire-and-forget confirmations can announce the same tensor names
  // for several bursts before the coordinator catches up.
  bool resync_needed_ = false;
  int64_t tuned_threshold_ = -1;
  int32_t tuned_cycle_us_ = -1;
  std::map<std::string, std::deque<PendingCoordination>>
      message_table_;  // by (psid, name), ordered for determinism
  // (rank, burst_id) -> table keys forming that rank's atomic unit
  std::map<UnitRef, std::set<std::string>> units_;
  uint64_t pc_seq_ = 0;
  std::set<int32_t> joined_ranks_;
  int32_t last_joined_rank_ = -1;
  std::set<int32_t> shutdown_ranks_;
  std::unordered_map<int32_t, std::vector<int32_t>> process_sets_;
  mutable std::mutex mu_;
};

}  // namespace hvt

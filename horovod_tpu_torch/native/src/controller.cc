#include "controller.h"

#include <algorithm>
#include <chrono>
#include <sstream>
#include <tuple>

namespace hvt {

double NowSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// --------------------------------------------------------------------------
// TensorQueue
// --------------------------------------------------------------------------

bool TensorQueue::Add(Entry e) {
  std::lock_guard<std::mutex> g(mu_);
  // Parity: tensor_queue.cc AddToTensorQueue rejects duplicate names —
  // the same tensor cannot be pending twice.
  if (pending_names_.count(e.name) || in_flight_.count(e.name)) return false;
  pending_names_.insert(e.name);
  pending_.push_back(std::move(e));
  return true;
}

std::vector<Entry> TensorQueue::Drain(size_t limit) {
  std::lock_guard<std::mutex> g(mu_);
  size_t n = pending_.size();
  if (limit > 0 && limit < n) n = limit;
  std::vector<Entry> out(pending_.begin(), pending_.begin() + n);
  for (const Entry& e : out) {
    in_flight_.emplace(e.name, e);
    pending_names_.erase(e.name);
  }
  pending_.erase(pending_.begin(), pending_.begin() + n);
  return out;
}

std::vector<uint64_t> TensorQueue::Finish(
    const std::vector<std::string>& names) {
  std::lock_guard<std::mutex> g(mu_);
  std::vector<uint64_t> seqs;
  for (const std::string& n : names) {
    auto it = in_flight_.find(n);
    if (it != in_flight_.end()) {
      seqs.push_back(it->second.seq);
      in_flight_.erase(it);
    }
  }
  return seqs;
}

std::vector<Entry> TensorQueue::InFlightSnapshot() const {
  std::lock_guard<std::mutex> g(mu_);
  std::vector<Entry> out;
  out.reserve(in_flight_.size());
  for (const auto& kv : in_flight_) out.push_back(kv.second);
  return out;
}

int64_t TensorQueue::pending_count() const {
  std::lock_guard<std::mutex> g(mu_);
  return static_cast<int64_t>(pending_.size());
}

int64_t TensorQueue::pending_bytes() const {
  std::lock_guard<std::mutex> g(mu_);
  int64_t b = 0;
  for (const Entry& e : pending_) b += e.nbytes();
  return b;
}

// --------------------------------------------------------------------------
// ResponseCache
// --------------------------------------------------------------------------

std::string ResponseCache::Signature(const Entry& e) {
  // Parity: response_cache.cc keys on (name, op params, dtype, shape,
  // device); device is implicit here (one logical device per rank).
  std::ostringstream ss;
  ss << e.name << '|' << int(e.type) << '|' << int(e.red_op) << '|'
     << int(e.dtype) << '|' << e.process_set_id << '|' << e.root_rank << '|';
  for (int64_t d : e.shape) ss << d << ',';
  return ss.str();
}

int64_t ResponseCache::Lookup(const std::string& signature) const {
  auto it = by_sig_.find(signature);
  if (it == by_sig_.end()) return -1;
  return it->second->bit;
}

uint32_t ResponseCache::Put(const std::string& signature, const Entry& e) {
  auto it = by_sig_.find(signature);
  if (it != by_sig_.end()) {
    // Touch: move to front (most recently used).
    lru_.splice(lru_.begin(), lru_, it->second);
    return it->second->bit;
  }
  // Evict if at capacity (parity: response_cache.cc capacity_,
  // HOROVOD_CACHE_CAPACITY).
  if (lru_.size() >= capacity_ && !lru_.empty()) {
    const CacheItem& victim = lru_.back();
    free_bits_.insert(victim.bit);
    by_sig_.erase(victim.signature);
    by_bit_.erase(victim.bit);
    lru_.pop_back();
  }
  uint32_t bit;
  if (!free_bits_.empty()) {
    bit = *free_bits_.begin();
    free_bits_.erase(free_bits_.begin());
  } else {
    bit = next_bit_++;
  }
  lru_.push_front(CacheItem{signature, e, bit});
  by_sig_[signature] = lru_.begin();
  by_bit_[bit] = lru_.begin();
  return bit;
}

bool ResponseCache::GetEntryForBit(uint32_t bit, Entry* out) const {
  auto it = by_bit_.find(bit);
  if (it == by_bit_.end()) return false;
  *out = it->second->entry;
  return true;
}

// --------------------------------------------------------------------------
// Controller
// --------------------------------------------------------------------------

Controller::Controller(int32_t rank, int32_t size,
                       int64_t fusion_threshold_bytes, size_t cache_capacity,
                       double stall_warn_s, double stall_abort_s)
    : rank_(rank),
      size_(size),
      fusion_threshold_(fusion_threshold_bytes),
      stall_warn_s_(stall_warn_s),
      stall_abort_s_(stall_abort_s),
      cache_(cache_capacity) {
  // Global process set 0 = all ranks (parity: process_set.cc id 0).
  std::vector<int32_t> all(size);
  for (int32_t i = 0; i < size; ++i) all[i] = i;
  process_sets_[0] = std::move(all);
}

void Controller::RegisterProcessSet(int32_t psid, std::vector<int32_t> ranks) {
  std::lock_guard<std::mutex> g(mu_);
  std::sort(ranks.begin(), ranks.end());
  process_sets_[psid] = std::move(ranks);
}

int32_t Controller::RequiredRanks(int32_t psid) const {
  auto it = process_sets_.find(psid);
  return it == process_sets_.end() ? size_
                                   : static_cast<int32_t>(it->second.size());
}

std::vector<int32_t> Controller::ProcessSetRanks(int32_t psid) const {
  auto it = process_sets_.find(psid);
  if (it != process_sets_.end()) return it->second;
  std::vector<int32_t> all(size_);
  for (int32_t i = 0; i < size_; ++i) all[i] = i;
  return all;
}

uint64_t Controller::Enqueue(Entry e, Status* status) {
  static_cast<void>(rank_);
  e.enqueue_time_s = NowSeconds();
  uint64_t seq = e.seq;
  if (!queue_.Add(std::move(e))) {
    *status = Status::Error("duplicate tensor name in queue");
    return 0;
  }
  *status = Status::OK();
  return seq;
}

std::vector<uint8_t> Controller::DrainRequests(int64_t limit) {
  RequestList rl;
  rl.rank = rank_;
  rl.joined = joined_;
  rl.shutdown = shutdown_;
  bool resync_flush = resync_flush_;
  resync_flush_ = false;
  // In-flight ops BEFORE this drain: re-announced on a coordinator-
  // requested resync (their first announcement may have hit an
  // unexpandable cache bit at the coordinator).
  std::vector<Entry> prior_in_flight;
  if (resync_flush) {
    prior_in_flight = queue_.InFlightSnapshot();
    std::sort(prior_in_flight.begin(), prior_in_flight.end(),
              [](const Entry& a, const Entry& b) {
                return TableKey(a) < TableKey(b);
              });
  }
  std::vector<Entry> entries =
      queue_.Drain(limit > 0 ? static_cast<size_t>(limit) : 0);
  std::vector<int64_t> bits;
  bits.reserve(entries.size());
  bool all_hit = !entries.empty();
  for (const Entry& e : entries) {
    int64_t bit = cache_.Lookup(ResponseCache::Signature(e));
    bits.push_back(bit);
    if (bit < 0) all_hit = false;
  }
  // derive from the captured flags so the blob is internally
  // consistent even if SetJoined/SetShutdown race the drain
  bool membership = rl.joined || rl.shutdown;
  // Steady-state bypass: every drained op is a cache hit, no
  // membership change in flight, and the periodic full-resync cycle is
  // not due — the whole drain travels as one compact bit vector
  // (parity: the coordinated cache bitvector of
  // Controller::CoordinateCacheAndState).
  if (all_hit && !membership && !resync_flush && resync_every_ > 0 &&
      bypass_streak_ + 1 < resync_every_) {
    bypass_streak_++;
    rl.cache_bypass = true;
    rl.burst_id = ++burst_seq_;
    rl.burst_len = static_cast<uint32_t>(bits.size());
    std::vector<uint32_t> sorted_bits;
    sorted_bits.reserve(bits.size());
    for (int64_t b : bits) sorted_bits.push_back(static_cast<uint32_t>(b));
    std::sort(sorted_bits.begin(), sorted_bits.end());
    rl.cache_bits = PackBits(sorted_bits);
    return SerializeRequestList(rl);
  }
  bypass_streak_ = 0;
  // Periodic resync (streak exhausted) or coordinator-forced flush:
  // full entries keep the coordinator's message table and stall
  // inspector authoritative even if caches diverge.
  bool resync = resync_flush || (all_hit && !membership);
  rl.cache_resync = resync;
  if (!entries.empty()) {
    // Fresh entries form one atomic burst unit; resync re-announcements
    // (prior_in_flight) ride behind them, OUTSIDE the unit, and match
    // idempotently at ingest.
    rl.burst_id = ++burst_seq_;
    rl.burst_len = static_cast<uint32_t>(entries.size());
  }
  for (size_t i = 0; i < entries.size(); ++i) {
    Entry& e = entries[i];
    int64_t bit = bits[i];
    Request rq;
    rq.rank = rank_;
    if (bit >= 0) rl.cache_hits.push_back(static_cast<uint32_t>(bit));
    if (bit >= 0 && !resync) {
      // Mixed cycle: transmit the bit id + seq only; the coordinator
      // expands the bit via its own (identical) cache.
      rq.cached = true;
      rq.cache_bit = static_cast<uint32_t>(bit);
      rq.entry.seq = e.seq;
      rq.entry.name = e.name;  // kept for local Finish() + debuggability
    } else {
      rq.entry = std::move(e);
    }
    rl.requests.push_back(std::move(rq));
  }
  for (Entry& e : prior_in_flight) {
    Request rq;
    rq.rank = rank_;
    rq.entry = std::move(e);
    rl.requests.push_back(std::move(rq));
  }
  return SerializeRequestList(rl);
}

bool Controller::SameParams(const Entry& a, const Entry& b) {
  if (a.type != b.type || a.red_op != b.red_op || a.dtype != b.dtype ||
      a.root_rank != b.root_rank) {
    return false;
  }
  if (a.type == OpType::kAllgather || a.type == OpType::kAlltoall) {
    // Dim 0 is legitimately per-rank (ragged gathers, variable
    // splits); rank-count and trailing dims must still agree.
    if (a.shape.size() != b.shape.size()) return false;
    for (size_t i = 1; i < a.shape.size(); ++i) {
      if (a.shape[i] != b.shape[i]) return false;
    }
    return true;
  }
  return a.shape == b.shape;
}

std::string Controller::EntryDesc(const Entry& e) {
  std::ostringstream ss;
  ss << "op=" << int(e.type) << " red_op=" << int(e.red_op)
     << " dtype=" << int(e.dtype) << " shape=[";
  for (size_t i = 0; i < e.shape.size(); ++i) {
    if (i) ss << ',';
    ss << e.shape[i];
  }
  ss << "] root_rank=" << e.root_rank;
  return ss.str();
}

Controller::PendingCoordination* Controller::TableAdd(Entry e, int32_t rank,
                                                      double now,
                                                      bool occurrence,
                                                      std::string* out_key) {
  std::string key = TableKey(e);
  if (out_key) *out_key = key;
  std::deque<PendingCoordination>& q = message_table_[key];
  PendingCoordination* pc = nullptr;
  if (occurrence) {
    // Burst-unit announcement: a NEW occurrence relative to ones this
    // rank already announced, so back-to-back confirmed bursts of the
    // same tensor names queue instead of collapsing into one release.
    for (PendingCoordination& cand : q) {
      if (!cand.ranks.count(rank)) {
        pc = &cand;
        break;
      }
    }
  } else {
    // Legacy/idempotent matching (unit-less frames and resync
    // re-announcements): a re-announcing rank lands on the occurrence
    // it already joined, never opening a duplicate.
    for (PendingCoordination& cand : q) {
      if (cand.ranks.count(rank)) {
        pc = &cand;
        break;
      }
    }
    if (pc == nullptr && !q.empty()) pc = &q.front();
  }
  if (pc == nullptr) {
    // Parity: MessageTable insertion on first Request for a name.
    PendingCoordination fresh;
    fresh.entry = std::move(e);
    fresh.first_seen_s = now;
    fresh.first_rank = rank;
    fresh.ranks.insert(rank);
    fresh.seq = pc_seq_++;
    q.push_back(std::move(fresh));
    return &q.back();
  }
  pc->ranks.insert(rank);
  if (rank != pc->first_rank && !pc->mismatched.count(rank) &&
      !SameParams(e, pc->entry)) {
    pc->mismatched.emplace(rank, std::move(e));
  }
  return pc;
}

void Controller::ReleaseFront(const std::string& key,
                              const PendingCoordination& pc) {
  // Drop the key from every burst unit that referenced this occurrence
  // (so an error-released member doesn't deadlock the rest of its
  // unit), then pop the occurrence queue.
  for (const UnitRef& ref : pc.units) {
    auto it = units_.find(ref);
    if (it != units_.end()) {
      it->second.erase(key);
      if (it->second.empty()) units_.erase(it);
    }
  }
  auto qit = message_table_.find(key);
  if (qit != message_table_.end() && !qit->second.empty()) {
    qit->second.pop_front();
    if (qit->second.empty()) message_table_.erase(qit);
  }
}

std::string Controller::TableKey(const Entry& e) {
  // Coordination is scoped per process set: the same tensor name may be
  // pending simultaneously in disjoint sets (parity: each ProcessSet in
  // process_set.cc owns its own controller + MessageTable).  '\x01'
  // cannot appear in a psid decimal string, so keys are unambiguous,
  // and std::map's byte order matches Python's sorted() on the same
  // strings (UTF-8 byte order == code-point order).
  return std::to_string(e.process_set_id) + '\x01' + e.name;
}

void Controller::Ingest(const uint8_t* data, size_t len) {
  RequestList rl = ParseRequestList(data, len);
  std::lock_guard<std::mutex> g(mu_);
  double now = NowSeconds();
  if (rl.joined && joined_ranks_.insert(rl.rank).second) {
    // Track the temporally-last joiner (parity: hvd.join() returns the
    // last rank that joined, not the largest rank id).
    last_joined_rank_ = rl.rank;
  }
  if (rl.shutdown) shutdown_ranks_.insert(rl.rank);
  const bool has_unit = rl.burst_id > 0 && rl.burst_len > 0;
  const UnitRef ref{rl.rank, rl.burst_id};
  std::set<std::string> unit_keys;
  if (rl.cache_bypass) {
    // Expand the rank's cache-bit vector through the coordinator's own
    // (identical) cache.  An unknown bit means the caches diverged
    // (e.g. elastic generations mixing): request a full resync from
    // every rank via the next ResponseList.
    std::vector<uint32_t> bits = UnpackBits(rl.cache_bits);
    for (size_t idx = 0; idx < bits.size(); ++idx) {
      Entry cached;
      if (!cache_.GetEntryForBit(bits[idx], &cached)) {
        resync_needed_ = true;
        continue;
      }
      cached.seq = 0;
      bool in_unit = has_unit && idx < rl.burst_len;
      std::string key;
      PendingCoordination* pc =
          TableAdd(std::move(cached), rl.rank, now, in_unit, &key);
      if (in_unit) {
        pc->units.insert(ref);
        unit_keys.insert(key);
        if (rl.predicted) pc->predicted.insert(rl.rank);
      }
    }
    if (has_unit && !unit_keys.empty()) units_[ref] = std::move(unit_keys);
    return;
  }
  for (size_t idx = 0; idx < rl.requests.size(); ++idx) {
    const Request& rq = rl.requests[idx];
    Entry e = rq.entry;
    if (rq.cached) {
      // Expand the bit back into the full entry via the coordinator's
      // own (identical) cache.
      Entry cached;
      if (cache_.GetEntryForBit(rq.cache_bit, &cached)) {
        cached.seq = e.seq;
        e = cached;
      }
    }
    bool in_unit = has_unit && idx < rl.burst_len;
    std::string key;
    PendingCoordination* pc = TableAdd(std::move(e), rl.rank, now, in_unit, &key);
    if (in_unit) {
      pc->units.insert(ref);
      unit_keys.insert(key);
      if (rl.predicted) pc->predicted.insert(rl.rank);
    }
  }
  if (has_unit && !unit_keys.empty()) units_[ref] = std::move(unit_keys);
}

int32_t Controller::PresentCount(const PendingCoordination& pc) const {
  // Joined ranks count as implicitly ready for every pending tensor in
  // their process sets (parity: operations.cc EnqueueJoin / JoinOp —
  // a joined rank participates with a zero contribution, so remaining
  // ranks' collectives never stall on it).
  int32_t present = 0;
  for (int32_t r : ProcessSetRanks(pc.entry.process_set_id)) {
    if (pc.ranks.count(r) || joined_ranks_.count(r)) present++;
  }
  return present;
}

ResponseList Controller::BuildResponseList() {
  // Caller holds mu_.
  ResponseList out;
  out.tuned_fusion_threshold = tuned_threshold_;
  out.tuned_cycle_time_us = tuned_cycle_us_;
  out.cache_resync_needed = resync_needed_;
  resync_needed_ = false;

  // 1. collect globally-ready keys (every member rank reported, or is
  //    joined).  Only the FRONT occurrence of each key is eligible, so
  //    per-key release order always matches announcement order.
  //    message_table_ is a std::map → deterministic (process set,
  //    name) order, the analog of FuseResponses' stable ordering.
  std::map<std::string, PendingCoordination*> fronts;
  for (auto& kv : message_table_) {
    if (!kv.second.empty()) fronts[kv.first] = &kv.second.front();
  }
  std::vector<std::string> ready;
  for (auto& kv : fronts) {
    const PendingCoordination& pc = *kv.second;
    if (PresentCount(pc) >= RequiredRanks(pc.entry.process_set_id)) {
      ready.push_back(kv.first);
    }
  }

  // 2. group gating (parity: group_table.cc — a grouped tensor only
  //    executes when the whole group is ready).
  std::unordered_map<int64_t, int32_t> group_ready_counts;
  for (const std::string& n : ready) {
    const Entry& e = fronts[n]->entry;
    if (e.group_id >= 0) group_ready_counts[e.group_id]++;
  }
  std::map<std::string, PendingCoordination*> candidates;
  std::vector<std::string> mismatch_keys;
  for (const std::string& n : ready) {
    PendingCoordination* pc = fronts[n];
    const Entry& e = pc->entry;
    if (e.group_id >= 0) {
      int32_t want = group_table_.GroupSize(e.group_id);
      if (want > 0 && group_ready_counts[e.group_id] < want) continue;
    }
    if (!pc->mismatched.empty()) {
      mismatch_keys.push_back(n);
    } else {
      candidates[n] = pc;
    }
  }

  // 3. atomic-unit admission: a ready op releases only when every
  //    burst unit containing it is COMPLETELY ready, and the
  //    transitive closure over shared unit refs partitions the
  //    releasable work into connected components.  Fusion runs per
  //    component (fresh open-group state each time), so the
  //    coordinator can never form a fusion group across a burst
  //    boundary — a peer's split burst holds its whole component back
  //    instead of diverging the fused groupings that
  //    PredictResponses() reconstructed locally.
  struct Component {
    uint64_t seq;
    std::vector<std::string> keys;  // sorted
  };
  std::vector<Component> components;
  std::set<std::string> assigned;
  for (auto& kv : candidates) {
    const std::string& seed = kv.first;
    if (assigned.count(seed)) continue;
    std::set<std::string> comp;
    bool comp_ok = true;
    std::vector<std::string> stack{seed};
    while (!stack.empty() && comp_ok) {
      std::string k = stack.back();
      stack.pop_back();
      if (comp.count(k)) continue;
      auto cit = candidates.find(k);
      if (cit == candidates.end()) {
        comp_ok = false;
        break;
      }
      comp.insert(k);
      for (const UnitRef& ref : cit->second->units) {
        auto uit = units_.find(ref);
        if (uit == units_.end()) continue;
        for (const std::string& k2 : uit->second) {
          auto c2 = candidates.find(k2);
          if (c2 == candidates.end() || !c2->second->units.count(ref)) {
            comp_ok = false;
            break;
          }
          if (!comp.count(k2)) stack.push_back(k2);
        }
        if (!comp_ok) break;
      }
    }
    if (!comp_ok) continue;  // a unit is split-pending: hold the component
    uint64_t min_seq = UINT64_MAX;
    for (const std::string& k : comp) {
      min_seq = std::min(min_seq, candidates[k]->seq);
      assigned.insert(k);
    }
    components.push_back(
        Component{min_seq, std::vector<std::string>(comp.begin(), comp.end())});
  }
  // Mismatch errors bypass unit gating (fail fast; the forced resync
  // re-anchors the survivors) as singleton components.
  for (const std::string& key : mismatch_keys) {
    components.push_back(Component{fronts[key]->seq, {key}});
  }
  // Creation order == per-rank announcement order on every stream, so
  // component emission order matches every predictor's confirmation
  // FIFO.
  std::sort(components.begin(), components.end(),
            [](const Component& a, const Component& b) {
              return a.seq < b.seq;
            });

  // 4. one Response per tensor, fused PER COMPONENT.  Responses carry
  //    the BARE tensor name; the set scope travels in process_set_id.
  //    A component whose every member rank announced as a PREDICTED
  //    confirmation is suppressed down to a confirm hash.
  for (const Component& component : components) {
    std::vector<Response> comp_responses;
    bool suppress = true;
    for (const std::string& n : component.keys) {
      // Take the front occurrence off its queue; ReleaseFront below
      // needs the units copy after the pop.
      PendingCoordination pc = std::move(message_table_[n].front());
      const Entry& e = pc.entry;
      Response rs;
      rs.type = e.type;
      rs.red_op = e.red_op;
      rs.dtype = e.dtype;
      rs.process_set_id = e.process_set_id;
      rs.root_rank = e.root_rank;
      rs.tensor_names.push_back(e.name);
      rs.tensor_shapes.push_back(e.shape);
      rs.total_bytes = e.nbytes();
      if (!pc.mismatched.empty()) {
        // Cross-rank disagreement: fail LOUDLY on every member rank,
        // naming each offender and what it submitted (text must match
        // fallback.PyController byte-for-byte).  The error broadcast
        // also forces a full cache resync, re-anchoring the bypass
        // AND predict planes.
        std::ostringstream ss;
        ss << "cross-rank tensor mismatch for '" << e.name << "': rank "
           << pc.first_rank << " submitted " << EntryDesc(e);
        for (const auto& kv : pc.mismatched) {
          ss << "; rank " << kv.first << " submitted "
             << EntryDesc(kv.second);
        }
        rs.error = ss.str();
        out.cache_resync_needed = true;
        suppress = false;
        comp_responses.push_back(std::move(rs));
        ReleaseFront(n, pc);
        continue;
      }
      // Zero substitution from joined ranks is only sound for additive
      // semantics; reject ops it would silently corrupt (min/max/
      // product zeroed, adasum NaN from zero norms, broadcast root
      // with no data, int8 wire needing the two-phase quantized kernel
      // on every rank).
      bool used_joined = false;
      for (int32_t r : ProcessSetRanks(e.process_set_id)) {
        if (!pc.ranks.count(r) && joined_ranks_.count(r)) used_joined = true;
      }
      if (used_joined) {
        if (e.type == OpType::kBroadcast && e.root_rank >= 0 &&
            !pc.ranks.count(e.root_rank) && joined_ranks_.count(e.root_rank)) {
          rs.error = "broadcast root rank " + std::to_string(e.root_rank) +
                     " has joined";
        } else if ((e.type == OpType::kAllreduce ||
                    e.type == OpType::kReducescatter) &&
                   (e.red_op == RedOp::kMin || e.red_op == RedOp::kMax ||
                    e.red_op == RedOp::kProduct ||
                    e.red_op == RedOp::kAdasum)) {
          rs.error = "reduction op " +
                     std::to_string(static_cast<int>(e.red_op)) +
                     " does not support joined-rank zero contribution";
        } else if ((e.type == OpType::kAllreduce ||
                    e.type == OpType::kReducescatter) &&
                   e.dtype == DataType::kInt8) {
          rs.error =
              "int8 wire format does not support joined-rank zero "
              "contribution";
        }
      }
      std::vector<int32_t> mv = ProcessSetRanks(e.process_set_id);
      std::set<int32_t> members(mv.begin(), mv.end());
      if (!rs.error.empty() || used_joined || pc.predicted != members) {
        suppress = false;
      }
      comp_responses.push_back(std::move(rs));
      ReleaseFront(n, pc);
    }
    FuseResponses(&comp_responses);
    bool any_error = false;
    for (const Response& r : comp_responses) {
      if (!r.error.empty()) any_error = true;
    }
    if (suppress && !comp_responses.empty() && !any_error) {
      // Every member rank announced this whole component as a
      // PREDICTED confirmation: each already executed the identical
      // locally predicted schedule, so emit only the hash of the
      // would-be response bytes — the response-side half of killing
      // the round trip.
      ResponseList bare;
      bare.responses = std::move(comp_responses);
      std::vector<uint8_t> blob = SerializeResponseList(bare);
      out.confirm_hashes.push_back(Fnv1a64(blob.data(), blob.size()));
    } else {
      for (Response& r : comp_responses) {
        out.responses.push_back(std::move(r));
      }
    }
  }

  // 4b. pending tensors that can never complete because a REQUIRED
  //     rank announced shutdown fail promptly with an error response
  //     (parity: the reference's "Horovod has been shut down" error)
  //     instead of stalling the remaining ranks to the transport
  //     timeout.
  if (!shutdown_ranks_.empty()) {
    std::vector<std::string> keys;
    for (const auto& kv : message_table_) keys.push_back(kv.first);
    for (const std::string& key : keys) {
      auto qit = message_table_.find(key);
      if (qit == message_table_.end() || qit->second.empty()) continue;
      const PendingCoordination& front = qit->second.front();
      int32_t dead_rank = -1;
      for (int32_t r : ProcessSetRanks(front.entry.process_set_id)) {
        if (!front.ranks.count(r) && !joined_ranks_.count(r) &&
            shutdown_ranks_.count(r)) {
          dead_rank = r;
          break;
        }
      }
      if (dead_rank < 0) continue;
      PendingCoordination pc = std::move(qit->second.front());
      const Entry& e = pc.entry;
      Response rs;
      rs.type = e.type;
      rs.red_op = e.red_op;
      rs.dtype = e.dtype;
      rs.process_set_id = e.process_set_id;
      rs.root_rank = e.root_rank;
      rs.tensor_names.push_back(e.name);
      rs.tensor_shapes.push_back(e.shape);
      rs.error = "rank " + std::to_string(dead_rank) + " has shut down";
      out.responses.push_back(std::move(rs));
      ReleaseFront(key, pc);
    }
  }

  // 4. join: once every rank joined, emit the last joiner (parity:
  //    operations.cc join handling returns the last joined rank).
  if (static_cast<int32_t>(joined_ranks_.size()) >= size_ && size_ > 0) {
    out.join_last_rank = last_joined_rank_;
    joined_ranks_.clear();
    last_joined_rank_ = -1;
  }
  // Global quiesce only when EVERY rank announced shutdown (parity:
  // horovod_shutdown coordinating via DONE requests — a finishing
  // rank's controller keeps serving peers until all agree to stop).
  if (static_cast<int32_t>(shutdown_ranks_.size()) >= size_ && size_ > 0) {
    out.shutdown = true;
  }
  return out;
}

void Controller::FuseResponses(std::vector<Response>* responses) const {
  // Compatibility-GROUP fusion (parity: Controller::FuseResponses,
  // strengthened): every fusible response merges into the open group
  // for its (type, red_op, dtype, process set) key — not just
  // adjacent ones — so an unrelated response (another process set's
  // release landing in the same compute) cannot split an otherwise-
  // stable fusion group.  That order-independence is what makes
  // steady-state schedule prediction sound (see PredictResponses).
  // Output order is group-opening order; a group that would exceed
  // the fusion threshold closes and a new one opens at the end.
  // Allreduce/adasum only (allgather fusion needs size tables).
  std::vector<Response> fused;
  std::map<std::tuple<int, int, int, int32_t>, size_t> open_group;
  for (Response& r : *responses) {
    bool can_fuse =
        (r.type == OpType::kAllreduce || r.type == OpType::kAdasum) &&
        r.error.empty();
    if (can_fuse) {
      auto key = std::make_tuple(static_cast<int>(r.type),
                                 static_cast<int>(r.red_op),
                                 static_cast<int>(r.dtype),
                                 r.process_set_id);
      auto it = open_group.find(key);
      if (it != open_group.end() &&
          fused[it->second].total_bytes + r.total_bytes <=
              fusion_threshold_) {
        Response& g = fused[it->second];
        g.tensor_names.insert(g.tensor_names.end(),
                              r.tensor_names.begin(),
                              r.tensor_names.end());
        g.tensor_shapes.insert(g.tensor_shapes.end(),
                               r.tensor_shapes.begin(),
                               r.tensor_shapes.end());
        g.total_bytes += r.total_bytes;
        continue;
      }
      open_group[key] = fused.size();
    }
    fused.push_back(std::move(r));
  }
  *responses = std::move(fused);
}

std::vector<uint8_t> Controller::PredictResponses(
    const std::vector<uint32_t>& bits) {
  // The ResponseList the coordinator WILL emit for a pure bypass
  // cycle carrying exactly `bits` — a deterministic function of the
  // (replicated) response cache and the fusion threshold.  Empty
  // result = unknown bit (caller must not predict).  Only sound under
  // the Python controller's gating; see eager/controller.py.
  std::lock_guard<std::mutex> g(mu_);
  std::vector<Entry> entries;
  entries.reserve(bits.size());
  for (uint32_t b : bits) {
    Entry e;
    if (!cache_.GetEntryForBit(b, &e)) return {};
    entries.push_back(std::move(e));
  }
  std::sort(entries.begin(), entries.end(),
            [](const Entry& a, const Entry& b) {
              return TableKey(a) < TableKey(b);
            });
  ResponseList out;
  for (const Entry& e : entries) {
    Response rs;
    rs.type = e.type;
    rs.red_op = e.red_op;
    rs.dtype = e.dtype;
    rs.process_set_id = e.process_set_id;
    rs.root_rank = e.root_rank;
    rs.tensor_names.push_back(e.name);
    rs.tensor_shapes.push_back(e.shape);
    rs.total_bytes = e.nbytes();
    out.responses.push_back(std::move(rs));
  }
  FuseResponses(&out.responses);
  return SerializeResponseList(out);
}

std::vector<uint64_t> Controller::FinishNames(
    const std::vector<std::string>& names) {
  // Eagerly retire in-flight entries executed from a PREDICTED
  // schedule (duplicate-name guard would otherwise trip on the next
  // step's re-enqueue before the real response streams in).
  return queue_.Finish(names);
}

std::vector<uint8_t> Controller::ComputeResponses() {
  std::lock_guard<std::mutex> g(mu_);
  return SerializeResponseList(BuildResponseList());
}

ResponseList Controller::ApplyResponses(const uint8_t* data, size_t len,
                                        std::vector<uint64_t>* out_finished) {
  ResponseList rl = ParseResponseList(data, len);
  for (const Response& rs : rl.responses) {
    // Cache insertion in response order — identical on every rank, so
    // bit ids stay globally consistent (see header comment).  The entry
    // is rebuilt entirely from the response (incl. echoed shapes), so
    // the signature matches what Enqueue computes next cycle.
    for (size_t i = 0; i < rs.tensor_names.size(); ++i) {
      if (rs.type == OpType::kBarrier || rs.type == OpType::kJoin) continue;
      Entry e;
      e.name = rs.tensor_names[i];
      e.type = rs.type;
      e.red_op = rs.red_op;
      e.dtype = rs.dtype;
      if (i < rs.tensor_shapes.size()) e.shape = rs.tensor_shapes[i];
      e.process_set_id = rs.process_set_id;
      e.root_rank = rs.root_rank;
      cache_.Put(ResponseCache::Signature(e), e);
    }
    std::vector<uint64_t> seqs = queue_.Finish(rs.tensor_names);
    out_finished->insert(out_finished->end(), seqs.begin(), seqs.end());
  }
  if (rl.cache_resync_needed) {
    // Coordinator failed to expand a bypass bit: next drain is a full
    // resync re-announcing whatever is still outstanding (set AFTER
    // the Finish pops above, so completed ops are not re-announced).
    resync_flush_ = true;
  }
  if (rl.join_last_rank >= 0) joined_ = false;
  return rl;
}

std::vector<StallEntry> Controller::CheckStalls() const {
  std::lock_guard<std::mutex> g(mu_);
  std::vector<StallEntry> out;
  double now = NowSeconds();
  for (const auto& kv : message_table_) {
    if (kv.second.empty()) continue;
    const PendingCoordination& pc = kv.second.front();
    double waited = now - pc.first_seen_s;
    if (waited < stall_warn_s_) continue;
    StallEntry se;
    se.name = pc.entry.name;
    se.waiting_s = waited;
    for (int32_t r : ProcessSetRanks(pc.entry.process_set_id)) {
      // Joined ranks are implicitly present (they zero-contribute).
      if (pc.ranks.count(r) || joined_ranks_.count(r))
        se.present_ranks.push_back(r);
      else
        se.missing_ranks.push_back(r);
    }
    out.push_back(std::move(se));
  }
  return out;
}

}  // namespace hvt

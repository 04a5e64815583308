"""The negotiation core in Python (counterpart of
``horovod_tpu/native/fallback.py`` ``PyController``, copied so the port
imports nothing of the JAX package).

It implements the protocol of the C++ core (``native/src/controller.cc``,
the port's copy of the JAX package's): the same wire bytes through
:mod:`horovod_tpu_torch.native.wire`, the same ordering, fusion, response
cache, burst units and stall bookkeeping.  ``make_controller`` returns it
under ``HVTPU_FORCE_PY_CONTROLLER``.
``tests/test_torch_port_negotiation.py`` runs it beside the JAX
package's twin and the C++ core cycle by cycle and compares every
request and response blob byte for byte.  Parity anchors as in
controller.h.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import wire


class _ResponseCache:
    """LRU keyed by signature; mutation only in apply order (see the
    consistency argument in native/src/controller.h)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lru: "collections.OrderedDict[str, Tuple[int, wire.Entry]]" = (
            collections.OrderedDict()
        )  # sig -> (bit, entry); last = most recent
        self._by_bit: Dict[int, str] = {}
        self._free_bits: List[int] = []
        self._next_bit = 0

    def lookup(self, sig: str) -> int:
        item = self._lru.get(sig)
        return -1 if item is None else item[0]

    def put(self, sig: str, entry: wire.Entry) -> int:
        if sig in self._lru:
            bit = self._lru[sig][0]
            self._lru.move_to_end(sig)
            return bit
        if len(self._lru) >= self.capacity and self._lru:
            victim_sig, (victim_bit, _) = next(iter(self._lru.items()))
            del self._lru[victim_sig]
            del self._by_bit[victim_bit]
            # Match C++: freed bits are reused smallest-first.
            self._free_bits.append(victim_bit)
            self._free_bits.sort()
        if self._free_bits:
            bit = self._free_bits.pop(0)
        else:
            bit = self._next_bit
            self._next_bit += 1
        self._lru[sig] = (bit, entry)
        self._by_bit[bit] = sig
        return bit

    def entry_for_bit(self, bit: int) -> Optional[wire.Entry]:
        sig = self._by_bit.get(bit)
        return None if sig is None else self._lru[sig][1]

    def __len__(self):
        return len(self._lru)


class PyController:
    """Python twin of native Controller (controller.cc)."""

    def __init__(self, rank: int, size: int, fusion_threshold: int,
                 cache_capacity: int = 1024, stall_warn_s: float = 60.0,
                 stall_abort_s: float = 0.0, resync_every: int = 64):
        self.rank = rank
        self.size = size
        self.fusion_threshold = fusion_threshold
        self.stall_warn_s = stall_warn_s
        self.stall_abort_s = stall_abort_s
        self.resync_every = resync_every
        self._lock = threading.Lock()
        self._pending: List[wire.Entry] = []
        self._pending_names: Set[str] = set()
        self._in_flight: Dict[str, wire.Entry] = {}
        self._cache = _ResponseCache(cache_capacity)
        self._groups: Dict[int, int] = {}
        self._joined = False
        self._shutdown = False
        # steady-state bypass bookkeeping (see drain_requests)
        self._bypass_streak = 0
        self._resync_flush = False
        # per-rank monotonic burst-unit counter (drain side)
        self._burst_seq = 0
        # coordinator state.  Each key holds an OCCURRENCE QUEUE of
        # pending coordinations (front = oldest): with prediction on, a
        # rank's fire-and-forget confirmations can announce the same
        # tensor names for several bursts before the coordinator
        # catches up, so one-slot-per-key would collapse distinct
        # bursts into one release.
        self._message_table: Dict[str, List[dict]] = {}
        # (rank, burst_id) -> set of table keys forming that rank's
        # atomic burst unit; a ready op releases only when every unit
        # containing it is completely ready, and fusion runs per
        # connected unit component — never across a burst boundary.
        self._units: Dict[Tuple[int, int], Set[str]] = {}
        # monotonic creation index for deterministic component ordering
        self._pc_seq = 0
        self._joined_ranks: Set[int] = set()
        self._last_joined_rank = -1
        self._tuned_threshold = -1
        self._tuned_cycle_us = -1
        self._shutdown_ranks: Set[int] = set()
        self._resync_needed = False
        self._process_sets: Dict[int, List[int]] = {0: list(range(size))}
        # (name, skew_s, last_rank) per released op, drained by the
        # eager controller into the arrival-skew metrics (bounded:
        # oldest entries drop if nobody drains, e.g. native twin hosts
        # or manual tests).
        self._skew_events: List[Tuple[str, float, int]] = []

    # ---- rank-local side ----
    def enqueue(self, seq: int, name: str, op_type: int, red_op: int,
                dtype: int, shape: Sequence[int], process_set_id: int = 0,
                group_id: int = -1, root_rank: int = -1) -> bool:
        with self._lock:
            if name in self._pending_names or name in self._in_flight:
                return False
            e = wire.Entry(
                seq=seq, name=name, type=op_type, red_op=red_op,
                dtype=dtype, shape=tuple(shape),
                process_set_id=process_set_id, group_id=group_id,
                root_rank=root_rank,
            )
            e._enqueue_time = time.monotonic()  # type: ignore[attr-defined]
            self._pending.append(e)
            self._pending_names.add(name)
            return True

    def declare_group(self, group_id: int, size: int):
        self._groups[group_id] = size

    def register_process_set(self, psid: int, ranks: Sequence[int]):
        with self._lock:
            self._process_sets[psid] = sorted(ranks)

    def set_joined(self):
        self._joined = True

    def set_tuned(self, fusion_threshold: int, cycle_time_us: int):
        """Publish autotuned params in subsequent ResponseLists
        (coordinator only; parity: ParameterManager broadcast)."""
        with self._lock:
            self._tuned_threshold = int(fusion_threshold)
            self._tuned_cycle_us = int(cycle_time_us)

    def set_shutdown(self):
        """Announce this rank wants to shut down (next drain_requests)."""
        self._shutdown = True

    def set_resync_every(self, n: int):
        self.resync_every = int(n)

    def force_resync(self):
        """Rank-side re-anchor (mispredict recovery / quiesce rollback):
        the next drain_requests emits a full-entry resync frame —
        re-announcing in-flight ops — exactly as if the coordinator had
        requested cache_resync_needed."""
        with self._lock:
            self._resync_flush = True
            self._bypass_streak = 0

    def drain_requests(self, limit: int = 0) -> bytes:
        with self._lock:
            rl = wire.RequestList(rank=self.rank, joined=self._joined,
                                  shutdown=self._shutdown)
            resync_flush = self._resync_flush
            self._resync_flush = False
            # In-flight ops BEFORE this drain: re-announced on a
            # coordinator-requested resync (their first announcement
            # may have hit an unexpandable cache bit there).
            prior_in_flight = (
                sorted(self._in_flight.values(),
                       key=lambda e: self._table_key(e))
                if resync_flush else [])
            if limit > 0 and len(self._pending) > limit:
                # Atomic-burst cap: a caller that knows the steady burst
                # size drains exactly one burst even when the next one
                # already started queueing, so each wire unit maps to
                # exactly one application burst.
                entries = self._pending[:limit]
                del self._pending[:limit]
            else:
                entries = list(self._pending)
                self._pending.clear()
            bits: List[int] = []
            for e in entries:
                self._in_flight[e.name] = e
                self._pending_names.discard(e.name)
                bits.append(self._cache.lookup(e.signature()))
            all_hit = bool(entries) and all(b >= 0 for b in bits)
            # derive from the captured flags so the blob is internally
            # consistent even if set_joined/set_shutdown race the drain
            membership = rl.joined or rl.shutdown
            # Steady-state bypass: every drained op is a cache hit, no
            # membership change in flight, and the periodic full-resync
            # cycle is not due — the whole drain travels as one compact
            # bit vector (parity: the coordinated cache bitvector of
            # Controller::CoordinateCacheAndState).
            if (all_hit and not membership and not resync_flush
                    and self.resync_every > 0
                    and self._bypass_streak + 1 < self.resync_every):
                self._bypass_streak += 1
                rl.cache_bypass = True
                self._burst_seq += 1
                rl.burst_id = self._burst_seq
                rl.burst_len = len(bits)
                rl.cache_bits = wire.bits_to_words(sorted(bits))
                return wire.serialize_request_list(rl)
            self._bypass_streak = 0
            # Periodic resync (streak exhausted) or coordinator-forced
            # flush: full entries keep the coordinator's message table
            # and stall inspector authoritative even if caches diverge.
            resync = resync_flush or (all_hit and not membership)
            rl.cache_resync = resync
            if entries:
                # Fresh entries form one atomic burst unit; resync
                # re-announcements (prior_in_flight) ride behind them,
                # OUTSIDE the unit, and match idempotently at ingest.
                self._burst_seq += 1
                rl.burst_id = self._burst_seq
                rl.burst_len = len(entries)
            for e, bit in zip(entries, bits):
                rq = wire.Request(rank=self.rank)
                if bit >= 0:
                    rl.cache_hits.append(bit)
                if bit >= 0 and not resync:
                    rq.cached = True
                    rq.cache_bit = bit
                    rq.entry = wire.Entry(seq=e.seq, name=e.name)
                else:
                    rq.entry = e
                rl.requests.append(rq)
            for e in prior_in_flight:
                rl.requests.append(wire.Request(rank=self.rank, entry=e))
            return wire.serialize_request_list(rl)

    def apply_responses(self, blob: bytes) -> List[int]:
        rl = wire.parse_response_list(blob)
        finished: List[int] = []
        with self._lock:
            for rs in rl.responses:
                if rs.type not in (wire.BARRIER, wire.JOIN):
                    for i, name in enumerate(rs.tensor_names):
                        shape = (rs.tensor_shapes[i]
                                 if i < len(rs.tensor_shapes) else ())
                        e = wire.Entry(
                            name=name, type=rs.type, red_op=rs.red_op,
                            dtype=rs.dtype, shape=tuple(shape),
                            process_set_id=rs.process_set_id,
                            root_rank=rs.root_rank,
                        )
                        self._cache.put(e.signature(), e)
                for name in rs.tensor_names:
                    e = self._in_flight.pop(name, None)
                    if e is not None:
                        finished.append(e.seq)
            if rl.cache_resync_needed:
                # Coordinator failed to expand a bypass bit: next drain
                # is a full resync re-announcing whatever is still
                # outstanding (set AFTER the pops above, so completed
                # ops are not re-announced).
                self._resync_flush = True
            if rl.join_last_rank >= 0:
                self._joined = False
        return finished

    # ---- coordinator side ----
    @staticmethod
    def _table_key(e: wire.Entry) -> str:
        """Coordination scoped per process set (same tensor name may be
        pending in disjoint sets); must match Controller::TableKey —
        sorted() on these strings == std::map byte order."""
        return f"{e.process_set_id}\x01{e.name}"

    @staticmethod
    def _same_params(a: wire.Entry, b: wire.Entry) -> bool:
        """The cross-rank agreement surface: every member rank must
        submit identical (type, red_op, dtype, shape, root) or the
        collective would mis-fuse / corrupt data.  Exclusions, which
        must match Controller::SameParams exactly: group_id (rank-local
        bookkeeping; ranks may number groups differently) and DIM 0
        for allgather/alltoall (ragged gathers and variable splits are
        legitimately per-rank; trailing dims and rank-count must still
        agree — reference parity: controller.cc only checks
        non-first dimensions for allgather)."""
        if (a.type != b.type or a.red_op != b.red_op
                or a.dtype != b.dtype or a.root_rank != b.root_rank):
            return False
        sa, sb = tuple(a.shape), tuple(b.shape)
        if a.type in (wire.ALLGATHER, wire.ALLTOALL):
            return len(sa) == len(sb) and sa[1:] == sb[1:]
        return sa == sb

    @staticmethod
    def _entry_desc(e: wire.Entry) -> str:
        """Human-readable submission summary for mismatch diagnostics;
        must match Controller::EntryDesc byte-for-byte."""
        dims = ",".join(str(int(d)) for d in e.shape)
        return (f"op={e.type} red_op={e.red_op} dtype={e.dtype} "
                f"shape=[{dims}] root_rank={e.root_rank}")

    def _table_add(self, e: wire.Entry, rank: int, now: float,
                   occurrence: bool = False) -> Tuple[str, dict]:
        """Record one rank's announcement in the message table,
        tracking conflicting submissions per rank (must match
        Controller::TableAdd).

        ``occurrence=True`` (burst-unit announcements) treats the
        announcement as a NEW occurrence relative to any this rank
        already announced, so back-to-back confirmed bursts of the same
        tensor names queue instead of collapsing into one release.
        ``occurrence=False`` (unit-less frames and resync
        re-announcements past ``burst_len``) matches idempotently: a
        rank re-announcing an in-flight op lands on the occurrence it
        already joined, never opening a duplicate."""
        key = self._table_key(e)
        q = self._message_table.get(key)
        if q is None:
            q = self._message_table[key] = []
        pc: Optional[dict] = None
        if occurrence:
            for cand in q:
                if rank not in cand["ranks"]:
                    pc = cand
                    break
        else:
            for cand in q:
                if rank in cand["ranks"]:
                    pc = cand
                    break
            if pc is None and q:
                pc = q[0]
        if pc is None:
            # "arrived" (first announcement time per rank) is local
            # bookkeeping for arrival-skew attribution — not part of
            # the C++ parity surface.
            pc = {
                "entry": e, "ranks": {rank}, "first_seen": now,
                "first_rank": rank, "mismatch": {},
                "arrived": {rank: now},
                "units": set(), "predicted": set(),
                "seq": self._pc_seq,
            }
            self._pc_seq += 1
            q.append(pc)
            return key, pc
        pc["ranks"].add(rank)
        pc["arrived"].setdefault(rank, now)
        if (rank != pc["first_rank"] and rank not in pc["mismatch"]
                and not self._same_params(e, pc["entry"])):
            pc["mismatch"][rank] = e
        return key, pc

    def ingest(self, blob: bytes):
        rl = wire.parse_request_list(blob)
        now = time.monotonic()
        with self._lock:
            if rl.joined and rl.rank not in self._joined_ranks:
                # Temporally-last joiner (parity: hvd.join() return value).
                self._joined_ranks.add(rl.rank)
                self._last_joined_rank = rl.rank
            if rl.shutdown:
                self._shutdown_ranks.add(rl.rank)
            ref = ((rl.rank, rl.burst_id)
                   if rl.burst_id > 0 and rl.burst_len > 0 else None)
            unit_keys: Set[str] = set()
            if rl.cache_bypass:
                # Expand the rank's cache-bit vector through the
                # coordinator's own (identical) cache.  An unknown bit
                # means the caches diverged (e.g. elastic generations
                # mixing): request a full resync from every rank.
                for idx, bit in enumerate(wire.words_to_bits(rl.cache_bits)):
                    cached = self._cache.entry_for_bit(bit)
                    if cached is None:
                        self._resync_needed = True
                        continue
                    e = wire.Entry(**{**cached.__dict__, "seq": 0})
                    in_unit = ref is not None and idx < rl.burst_len
                    key, pc = self._table_add(e, rl.rank, now,
                                              occurrence=in_unit)
                    if in_unit:
                        pc["units"].add(ref)
                        unit_keys.add(key)
                        if rl.predicted:
                            pc["predicted"].add(rl.rank)
                if ref is not None and unit_keys:
                    self._units[ref] = unit_keys
                return
            for idx, rq in enumerate(rl.requests):
                e = rq.entry
                if rq.cached:
                    cached = self._cache.entry_for_bit(rq.cache_bit)
                    if cached is not None:
                        e = wire.Entry(**{**cached.__dict__, "seq": rq.entry.seq})
                in_unit = ref is not None and idx < rl.burst_len
                key, pc = self._table_add(e, rl.rank, now,
                                          occurrence=in_unit)
                if in_unit:
                    pc["units"].add(ref)
                    unit_keys.add(key)
                    if rl.predicted:
                        pc["predicted"].add(rl.rank)
            if ref is not None and unit_keys:
                self._units[ref] = unit_keys

    def _required_ranks(self, psid: int) -> int:
        ranks = self._process_sets.get(psid)
        return self.size if ranks is None else len(ranks)

    def _member_ranks(self, psid: int) -> List[int]:
        return self._process_sets.get(psid, list(range(self.size)))

    def _present_count(self, pc: dict) -> int:
        """Joined ranks count as implicitly ready (parity: EnqueueJoin /
        JoinOp — joined ranks zero-contribute, so the rest never stall)."""
        return sum(
            1 for r in self._member_ranks(pc["entry"].process_set_id)
            if r in pc["ranks"] or r in self._joined_ranks
        )

    def _release_front(self, key: str, pc: dict):
        """Pop a released coordination off its occurrence queue and drop
        its key from every burst unit that referenced it (so an
        error-released member doesn't deadlock the rest of its unit)."""
        q = self._message_table.get(key)
        if q and q[0] is pc:
            q.pop(0)
            if not q:
                del self._message_table[key]
        for ref in pc["units"]:
            s = self._units.get(ref)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._units[ref]

    def compute_responses(self) -> bytes:
        with self._lock:
            out = wire.ResponseList(
                tuned_fusion_threshold=self._tuned_threshold,
                tuned_cycle_time_us=self._tuned_cycle_us,
            )
            out.cache_resync_needed = self._resync_needed
            self._resync_needed = False
            # deterministic (psid, name) order == std::map iteration;
            # only the FRONT occurrence of each key is eligible, so
            # per-key release order always matches announcement order.
            fronts = {key: q[0]
                      for key, q in self._message_table.items() if q}
            ready = [
                key for key in sorted(fronts)
                if self._present_count(fronts[key])
                >= self._required_ranks(fronts[key]["entry"].process_set_id)
            ]
            group_counts: Dict[int, int] = collections.Counter(
                fronts[n]["entry"].group_id
                for n in ready
                if fronts[n]["entry"].group_id >= 0
            )
            candidates: Dict[str, dict] = {}
            mismatch_keys: List[str] = []
            for key in ready:
                pc = fronts[key]
                e = pc["entry"]
                if e.group_id >= 0:
                    want = self._groups.get(e.group_id, -1)
                    if want > 0 and group_counts[e.group_id] < want:
                        continue
                if pc["mismatch"]:
                    mismatch_keys.append(key)
                else:
                    candidates[key] = pc
            # Atomic-unit admission: a ready op releases only when every
            # burst unit containing it is COMPLETELY ready, and the
            # transitive closure over shared unit refs partitions the
            # releasable work into connected components.  Fusion runs
            # per component (fresh open-group state each time), so the
            # coordinator can never form a fusion group across a burst
            # boundary — a peer's split burst holds its whole component
            # back instead of diverging the fused groupings that
            # predict_responses() reconstructed locally.
            components: List[Tuple[int, List[str]]] = []
            assigned: Set[str] = set()
            for key in sorted(candidates):
                if key in assigned:
                    continue
                comp: Set[str] = set()
                ok = True
                stack = [key]
                while stack:
                    k = stack.pop()
                    if k in comp:
                        continue
                    pc = candidates.get(k)
                    if pc is None:
                        ok = False
                        break
                    comp.add(k)
                    for ref in pc["units"]:
                        for k2 in self._units.get(ref, ()):
                            if (k2 not in candidates
                                    or ref not in candidates[k2]["units"]):
                                ok = False
                                break
                            if k2 not in comp:
                                stack.append(k2)
                        if not ok:
                            break
                    if not ok:
                        break
                if not ok:
                    continue  # a unit is split-pending: hold the component
                assigned |= comp
                components.append(
                    (min(candidates[k]["seq"] for k in comp), sorted(comp)))
            # Mismatch errors bypass unit gating (fail fast; the forced
            # resync re-anchors the survivors) as singleton components.
            for key in mismatch_keys:
                components.append((fronts[key]["seq"], [key]))
            # Creation order == per-rank announcement order on every
            # stream, so component emission order matches every
            # predictor's confirmation FIFO.
            components.sort()
            emitted: List[wire.Response] = []
            for _, comp_keys in components:
                responses: List[wire.Response] = []
                suppress = True
                for key in comp_keys:
                    pc = fronts[key]
                    e = pc["entry"]
                    rs = wire.Response(
                        type=e.type, red_op=e.red_op, dtype=e.dtype,
                        process_set_id=e.process_set_id,
                        root_rank=e.root_rank,
                        tensor_names=[e.name],
                        tensor_shapes=[tuple(e.shape)],
                        total_bytes=e.nbytes,
                    )
                    if pc["mismatch"]:
                        # Cross-rank disagreement: fail LOUDLY on every
                        # member rank, naming each offender and what it
                        # submitted (parity: the reference controller's
                        # "Mismatched ..." error responses; text must
                        # match Controller::BuildResponseList
                        # byte-for-byte).  The error broadcast also
                        # forces a full cache resync, re-anchoring the
                        # bypass AND predict planes.
                        parts = [f"rank {pc['first_rank']} submitted "
                                 f"{self._entry_desc(e)}"]
                        for r in sorted(pc["mismatch"]):
                            parts.append(
                                f"rank {r} submitted "
                                f"{self._entry_desc(pc['mismatch'][r])}")
                        rs.error = (f"cross-rank tensor mismatch for "
                                    f"'{e.name}': " + "; ".join(parts))
                        out.cache_resync_needed = True
                        suppress = False
                        responses.append(rs)
                        self._release_front(key, pc)
                        continue
                    # Zero substitution from joined ranks is only sound
                    # for additive semantics (must match Controller's
                    # C++ texts byte-for-byte for the cross-check tests).
                    used_joined = any(
                        r not in pc["ranks"] and r in self._joined_ranks
                        for r in self._member_ranks(e.process_set_id)
                    )
                    if used_joined:
                        if (e.type == wire.BROADCAST and e.root_rank >= 0
                                and e.root_rank not in pc["ranks"]
                                and e.root_rank in self._joined_ranks):
                            rs.error = (f"broadcast root rank "
                                        f"{e.root_rank} has joined")
                        elif (e.type in (wire.ALLREDUCE, wire.REDUCESCATTER)
                              and e.red_op in (wire.RED_MIN, wire.RED_MAX,
                                               wire.RED_PRODUCT,
                                               wire.RED_ADASUM)):
                            rs.error = (f"reduction op {e.red_op} does "
                                        "not support joined-rank zero "
                                        "contribution")
                        elif (e.type in (wire.ALLREDUCE, wire.REDUCESCATTER)
                              and e.dtype == wire.DTYPE_IDS["int8"]):
                            rs.error = ("int8 wire format does not support "
                                        "joined-rank zero contribution")
                    arrived = pc.get("arrived") or {}
                    if len(arrived) >= 2:
                        last_rank = max(arrived, key=arrived.get)
                        skew = max(arrived.values()) - min(arrived.values())
                        self._skew_events.append((e.name, skew, last_rank))
                        if len(self._skew_events) > 1024:
                            del self._skew_events[:-1024]
                    members = self._member_ranks(e.process_set_id)
                    if (rs.error or used_joined
                            or pc["predicted"] != set(members)):
                        suppress = False
                    responses.append(rs)
                    self._release_front(key, pc)
                fused = self._fuse(responses)
                if suppress and fused and not any(r.error for r in fused):
                    # Every member rank announced this whole component
                    # as a PREDICTED confirmation: each already executed
                    # the identical locally predicted schedule, so emit
                    # only the hash of the would-be response bytes —
                    # the response-side half of killing the round trip.
                    blob = wire.serialize_response_list(
                        wire.ResponseList(responses=fused))
                    out.confirm_hashes.append(wire.fnv1a64(blob))
                else:
                    emitted.extend(fused)
            out.responses = emitted
            # pending tensors that can never complete because a REQUIRED
            # rank announced shutdown fail promptly (must match
            # Controller::BuildResponseList step 3b byte-for-byte)
            if self._shutdown_ranks:
                for key in sorted(self._message_table):
                    q = self._message_table.get(key)
                    if not q:
                        continue
                    pc = q[0]
                    e = pc["entry"]
                    dead_rank = -1
                    for r in self._member_ranks(e.process_set_id):
                        if (r not in pc["ranks"]
                                and r not in self._joined_ranks
                                and r in self._shutdown_ranks):
                            dead_rank = r
                            break
                    if dead_rank < 0:
                        continue
                    out.responses.append(wire.Response(
                        type=e.type, red_op=e.red_op, dtype=e.dtype,
                        process_set_id=e.process_set_id,
                        root_rank=e.root_rank,
                        tensor_names=[e.name],
                        tensor_shapes=[tuple(e.shape)],
                        error=f"rank {dead_rank} has shut down",
                    ))
                    self._release_front(key, pc)
            if len(self._joined_ranks) >= self.size and self.size > 0:
                out.join_last_rank = self._last_joined_rank
                self._joined_ranks.clear()
                self._last_joined_rank = -1
            # global quiesce only when EVERY rank announced shutdown
            # (must match Controller::BuildResponseList)
            if len(self._shutdown_ranks) >= self.size and self.size > 0:
                out.shutdown = True
            return wire.serialize_response_list(out)

    def _fuse(self, responses: List[wire.Response]) -> List[wire.Response]:
        """Compatibility-GROUP fusion: every fusible response merges
        into the open group for its (type, red_op, dtype, process set)
        key — not just adjacent ones — so an unrelated response
        (another process set's release landing in the same compute)
        cannot split an otherwise-stable fusion group.  That
        order-independence is what makes steady-state schedule
        prediction sound (see predict_responses).  Output order is
        group-opening order; a group that would exceed the fusion
        threshold closes and a new one opens at the end."""
        fused: List[wire.Response] = []
        open_group: Dict[Tuple[int, int, int, int], int] = {}
        for r in responses:
            can_fuse = r.type in (wire.ALLREDUCE, wire.ADASUM) and not r.error
            if can_fuse:
                key = (r.type, r.red_op, r.dtype, r.process_set_id)
                gi = open_group.get(key)
                if (gi is not None
                        and fused[gi].total_bytes + r.total_bytes
                        <= self.fusion_threshold):
                    g = fused[gi]
                    g.tensor_names.extend(r.tensor_names)
                    g.tensor_shapes.extend(r.tensor_shapes)
                    g.total_bytes += r.total_bytes
                    continue
                open_group[key] = len(fused)
            fused.append(r)
        return fused

    # ---- steady-state schedule prediction ----
    def predict_responses(self, bits: Sequence[int]) -> Optional[bytes]:
        """The ResponseList the coordinator WILL emit for a pure
        bypass cycle carrying exactly ``bits`` — a deterministic
        function of the (replicated) response cache and the fusion
        threshold, so a rank in steady state can execute without
        waiting for the round trip.  Returns None when any bit is
        unknown.  Only sound under the caller's gating (never-tuned
        threshold, no interleaved unscheduled work, additive ops);
        see eager/controller.py."""
        with self._lock:
            entries = []
            for b in bits:
                e = self._cache.entry_for_bit(b)
                if e is None:
                    return None
                entries.append(e)
            entries.sort(key=self._table_key)
            out = wire.ResponseList()
            out.responses = self._fuse([
                wire.Response(
                    type=e.type, red_op=e.red_op, dtype=e.dtype,
                    process_set_id=e.process_set_id,
                    root_rank=e.root_rank,
                    tensor_names=[e.name],
                    tensor_shapes=[tuple(e.shape)],
                    total_bytes=e.nbytes,
                ) for e in entries
            ])
            return wire.serialize_response_list(out)

    def finish(self, names: Sequence[str]) -> List[int]:
        """Eagerly retire in-flight entries executed from a PREDICTED
        schedule, so re-enqueues of the same tensor name don't trip
        the duplicate-name guard before the real (matching) response
        streams in."""
        with self._lock:
            out = []
            for n in names:
                e = self._in_flight.pop(n, None)
                if e is not None:
                    out.append(e.seq)
            return out

    # ---- introspection ----
    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def pending_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._pending)

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def set_fusion_threshold(self, nbytes: int):
        self.fusion_threshold = nbytes

    def take_arrival_skew(self) -> List[Tuple[str, float, int]]:
        """Drain (name, skew_s, last_rank) events recorded when ops
        released from the message table (coordinator side only; the
        eager controller feeds them into the arrival-skew metrics).
        The native twin has no equivalent — callers getattr-guard."""
        with self._lock:
            out, self._skew_events = self._skew_events, []
            return out

    def pending_summary(self, limit: int = 32) -> List[dict]:
        """Coordinator's pending-coordination table for the /debug
        endpoint: which ops are waiting and on whom."""
        now = time.monotonic()
        out: List[dict] = []
        with self._lock:
            for key in sorted(self._message_table):
                if len(out) >= limit:
                    break
                q = self._message_table[key]
                if not q:
                    continue
                pc = q[0]
                members = self._member_ranks(pc["entry"].process_set_id)
                present = [r for r in members
                           if r in pc["ranks"] or r in self._joined_ranks]
                out.append({
                    "name": pc["entry"].name,
                    "process_set_id": pc["entry"].process_set_id,
                    "waiting_s": round(now - pc["first_seen"], 6),
                    "ranks_present": present,
                    "ranks_missing": [r for r in members
                                      if r not in present],
                })
        return out

    def check_stalls(self) -> List[dict]:
        now = time.monotonic()
        out = []
        with self._lock:
            for key in sorted(self._message_table):
                q = self._message_table[key]
                if not q:
                    continue
                pc = q[0]
                waited = now - pc["first_seen"]
                if waited < self.stall_warn_s:
                    continue
                members = self._member_ranks(pc["entry"].process_set_id)
                present = [r for r in members
                           if r in pc["ranks"] or r in self._joined_ranks]
                out.append({
                    "name": pc["entry"].name,
                    "waiting_s": waited,
                    "present": present,
                    "missing": [r for r in members if r not in present],
                })
        return out

    def close(self):
        pass

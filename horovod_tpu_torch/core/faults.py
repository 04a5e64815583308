"""Deterministic, seeded fault injection for the coordination layer.

Counterpart of ``horovod_tpu/core/faults.py``: the same grammar, the same
per-``(seed, rank, clause)`` firing schedule and the same error texts, so
one ``HVTPU_FAULT_SPEC`` produces the same faults in either package.  The
recovery paths of the port (the stall watchdog, the coordination-KV
retry, the wire abort-and-retry) would only ever be exercised by
accident without it.

Driven by ``HVTPU_FAULT_SPEC`` (armed by ``init()``) or :func:`install`.
Grammar::

    SPEC   := CLAUSE (";" CLAUSE)*
    CLAUSE := SITE ":" ACTION ("@" SEL ("," SEL)*)?
    SITE   := kv.get | kv.put | heartbeat | collective.pre
            | collective.post | worker.step | data.next
            | ckpt.write | ckpt.fsync | ckpt.rename
            | wire.send | wire.recv | collective.exec
    ACTION := drop | delay(MS) | error | kill | preempt
            | corrupt | corrupt(nan) | corrupt(bitflip)
            | torn | bitflip | partition(MS)
            | slow(MS) | flap(MS)
    SEL    := rank=R[|R...] | pset=ID | count=N | prob=P | times=K

Examples::

    kv.put:error@prob=0.01               # 1% of store writes fail (seeded)
    heartbeat:drop@rank=0,count=5,times=20   # beats 5..24 suppressed
    collective.pre:delay(250)@rank=2     # rank 2 lags every collective
    collective.pre:corrupt(nan)@count=7,times=1   # the 7th collective's
                                         # input gets a NaN in element 0
    wire.send:drop@rank=0,count=2        # rank 0's 2nd wire send is lost
                                         # (comm/wirefault.py's consensus
                                         # abort-and-retry recovers it)

Selector semantics:

- ``rank=R`` — only these ranks fire (``|``-separated list).
- ``pset=ID`` — only operations on that process set (sites that carry
  no process-set id never match a pset-selected clause).
- ``count=N`` — fire from the Nth matching invocation on (1-based,
  counted per process per clause).
- ``prob=P`` — fire with probability P from a per-``(seed, rank,
  clause)`` RNG, so a given seed reproduces the same fault schedule.
- ``times=K`` — at most K firings (default: 1 for ``kill``,
  ``preempt``, ``partition`` and ``flap``, unlimited otherwise).  Finite
  ``times`` persist across incarnations through a marker file under
  ``HVTPU_FAULT_STATE_DIR`` (defaulting to ``HVTPU_ELASTIC_STATE_DIR``).

Where the port fires each site: ``collective.pre`` / ``collective.post``
in the sync ops (``comm/eager.py``) and ``collective.pre`` at an async
op's enqueue (``eager/controller.py``); ``kv.get`` / ``kv.put`` in
``core/retry.py``'s wrappers and the controller's ``KVTransport``;
``heartbeat`` in the amortized watchdog's beat; ``wire.send`` /
``wire.recv`` / ``collective.exec`` in ``comm/stall.py``'s dispatch.
Sites owned by planes the port does not have yet (``worker.step``,
``data.next``, ``ckpt.*``) parse, but nothing fires them.

``corrupt`` poisons the tensor on its own device (no host copy), the
same bits the reference poisons: a NaN in element 0 for float16,
float32 and float64 in ``nan`` mode; otherwise the top bit of element
0's last byte.  bfloat16 takes the second branch in ``nan`` mode too,
as in the reference, whose ``np.issubdtype(bfloat16, np.floating)`` is
False.

A ``flap`` or ``partition`` window opening is noted in the flight
recorder, and a ``kill`` dumps a postmortem before the process exits 1,
as in the reference.

The ``preempt`` action delivers a preemption notice to
``core/preempt.py`` (``preempt.notice("fault")``): the graceful drain
takes it from there, and the firing is persisted like a kill so a
relaunched rank does not re-preempt forever.

Zero overhead when no spec is installed: hot call sites guard on the
module-level ``ACTIVE`` flag (one attribute read) and never call
``inject``.
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
from typing import Dict, List, Optional, Sequence

import torch

from . import clock

logger = logging.getLogger("horovod_tpu_torch")

#: Every site of the reference's grammar (see the module docstring for
#: the ones the port fires).  ``inject`` rejects unknown sites at parse
#: time so a typo'd spec fails loudly at init.
#: ``collective.pre``/``collective.post`` are TENSOR sites: ``corrupt``
#: clauses there poison the collective's input/result on the selected
#: ranks.  ``ckpt.write``/``ckpt.fsync``/``ckpt.rename`` are STORAGE
#: sites: ``torn`` and ``bitflip`` apply only there.
SITES = ("kv.get", "kv.put", "heartbeat", "collective.pre",
         "collective.post", "worker.step", "data.next",
         "ckpt.write", "ckpt.fsync", "ckpt.rename",
         "wire.send", "wire.recv", "collective.exec")

_STORAGE_SITES = ("ckpt.write", "ckpt.fsync", "ckpt.rename")

#: WIRE sites: the data plane's collective exchange itself
#: (comm/stall.py dispatch).  ``drop`` there loses one send/recv/
#: execution (surfacing as a transport-shaped error the consensus
#: abort-and-retry plane in comm/wirefault.py classifies as
#: retryable), ``slow(MS)`` adds serialization delay on the sick link,
#: and ``flap(MS)`` takes the WHOLE wire link down for a window —
#: every wire-site operation on this rank inside the window is
#: dropped, the link-level analog of ``partition(MS)``.
_WIRE_SITES = ("wire.send", "wire.recv", "collective.exec")

#: Coordination-plane sites a ``partition(MS)`` clause silences as a
#: unit.  Unlike ``drop`` (one lost operation), a fired partition opens
#: a wall-clock window during which EVERY kv.get/kv.put/heartbeat on
#: this rank is suppressed — the from-the-rank's-point-of-view shape of
#: a real network partition, which is what the lease-based self-fencing
#: in core/retry.py and the partitioned-vs-dead classification in
#: comm/stall.py exist to survive.
_PARTITION_SITES = ("kv.get", "kv.put", "heartbeat")

ACTIONS = ("drop", "delay", "error", "kill", "preempt", "corrupt",
           "torn", "bitflip", "partition", "slow", "flap")

#: Module-level fast path: False means ``inject`` is never entered.
ACTIVE = False

_registry: Optional["FaultRegistry"] = None
_lock = threading.Lock()

# Thread-local registry override (fabric simulator): each virtual-rank
# thread gets its own FaultRegistry so clauses with rank= selectors fire
# per VIRTUAL rank inside one process.  _tls_installs keeps the ACTIVE
# fast path truthful while any thread-local registry is armed.
_tls = threading.local()
_tls_installs = 0  # every mutation holds _lock (module-level, so the
# thread-safety pass cannot track it; uninstall()/use() enforce this)


class FaultSpecError(ValueError):
    """Malformed ``HVTPU_FAULT_SPEC`` / ``--fault-spec`` string."""


class InjectedFault(RuntimeError):
    """Raised by the ``error`` action.

    The message carries the grpc-style ``UNAVAILABLE`` marker so the
    coordination-KV retry policy (core/retry.py) classifies an injected
    KV failure as transient — an ``error``-injected ``kv.put`` therefore
    exercises the retry path end to end instead of instantly failing
    the job.
    """

    def __init__(self, clause: "FaultClause", site: str):
        super().__init__(
            f"UNAVAILABLE (hvtpu injected fault: {clause.source} "
            f"at site {site})")
        self.clause = clause


_DELAY_RE = re.compile(r"^delay\((\d+(?:\.\d+)?)\)$")
_CORRUPT_RE = re.compile(r"^corrupt(?:\((nan|bitflip)\))?$")
_PARTITION_RE = re.compile(r"^partition\((\d+(?:\.\d+)?)\)$")
_SLOW_RE = re.compile(r"^slow\((\d+(?:\.\d+)?)\)$")
_FLAP_RE = re.compile(r"^flap\((\d+(?:\.\d+)?)\)$")


class FaultClause:
    """One parsed ``site:action[@selectors]`` clause."""

    __slots__ = ("site", "action", "delay_ms", "corrupt_mode",
                 "partition_ms", "flap_ms", "ranks", "pset", "count",
                 "prob", "times", "index", "source", "_fired", "_seen",
                 "_rng")

    def __init__(self, site: str, action: str, delay_ms: float,
                 ranks: Optional[frozenset], pset: Optional[int],
                 count: int, prob: Optional[float], times: int,
                 index: int, source: str, corrupt_mode: str = "nan",
                 partition_ms: float = 0.0, flap_ms: float = 0.0):
        self.site = site
        self.action = action
        self.delay_ms = delay_ms
        self.corrupt_mode = corrupt_mode
        self.partition_ms = partition_ms
        self.flap_ms = flap_ms
        self.ranks = ranks          # None = all ranks
        self.pset = pset            # None = any process set
        self.count = count          # fire from the count-th match (1-based)
        self.prob = prob            # None = always (subject to count)
        self.times = times          # 0 = unlimited
        self.index = index
        self.source = source
        self._fired = 0             # firings so far (this process + disk)
        self._seen = 0              # matching invocations so far
        self._rng: Optional[random.Random] = None

    def bind(self, rank: int, seed: int, persisted_fired: int):
        """Per-process arming: seed the clause RNG from (seed, rank,
        clause index) so every rank draws an independent but
        reproducible stream, and credit firings persisted by earlier
        incarnations against the ``times`` budget."""
        self._rng = random.Random(f"{seed}/{rank}/{self.index}")
        self._fired = persisted_fired

    def matches(self, rank: int, pset) -> bool:
        if self.ranks is not None and rank not in self.ranks:
            return False
        if self.pset is not None and (pset is None or int(pset) != self.pset):
            return False
        return True

    def should_fire(self) -> bool:
        """Called only for matching invocations; owns the count/prob/
        times bookkeeping (caller holds the registry lock)."""
        if self.times and self._fired >= self.times:
            return False
        self._seen += 1
        if self._seen < self.count:
            return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        self._fired += 1
        return True


def parse_spec(spec: str) -> List[FaultClause]:
    """Parse a fault-spec string into clauses; raises
    :class:`FaultSpecError` with the offending fragment on bad input."""
    clauses: List[FaultClause] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if ":" not in raw:
            raise FaultSpecError(
                f"fault clause {raw!r}: expected 'site:action[@sel,...]'")
        site, rest = raw.split(":", 1)
        site = site.strip()
        if site not in SITES:
            raise FaultSpecError(
                f"fault clause {raw!r}: unknown site {site!r} "
                f"(known: {', '.join(SITES)})")
        action_s, _, sel_s = rest.partition("@")
        action_s = action_s.strip()
        delay_ms = 0.0
        corrupt_mode = "nan"
        partition_ms = 0.0
        flap_ms = 0.0
        m = _DELAY_RE.match(action_s)
        mc = _CORRUPT_RE.match(action_s)
        mp = _PARTITION_RE.match(action_s)
        ms = _SLOW_RE.match(action_s)
        mf = _FLAP_RE.match(action_s)
        if m:
            action, delay_ms = "delay", float(m.group(1))
        elif mc:
            action, corrupt_mode = "corrupt", mc.group(1) or "nan"
        elif mp:
            action, partition_ms = "partition", float(mp.group(1))
        elif ms:
            action, delay_ms = "slow", float(ms.group(1))
        elif mf:
            action, flap_ms = "flap", float(mf.group(1))
        elif action_s in ("drop", "error", "kill", "preempt",
                          "torn", "bitflip"):
            action = action_s
        else:
            raise FaultSpecError(
                f"fault clause {raw!r}: unknown action {action_s!r} "
                "(known: drop, delay(MS), error, kill, preempt, "
                "corrupt[(nan|bitflip)], torn, bitflip, partition(MS), "
                "slow(MS), flap(MS))")
        if action in ("torn", "bitflip") and site in _WIRE_SITES:
            raise FaultSpecError(
                f"fault clause {raw!r}: action {action!r} damages a "
                f"STORED byte stream and only applies at storage sites "
                f"({', '.join(_STORAGE_SITES)}); wire sites "
                f"({', '.join(_WIRE_SITES)}) carry no durable bytes to "
                f"tear — use drop, slow(MS) or flap(MS) there")
        if action in ("torn", "bitflip") and site not in _STORAGE_SITES:
            raise FaultSpecError(
                f"fault clause {raw!r}: action {action!r} only applies "
                f"at storage sites ({', '.join(_STORAGE_SITES)})")
        if action == "corrupt" and site in _WIRE_SITES:
            raise FaultSpecError(
                f"fault clause {raw!r}: action 'corrupt' poisons tensor "
                f"payloads and only applies at tensor sites "
                f"(collective.pre, collective.post); wire sites carry "
                f"no tensor to poison — use drop, slow(MS) or flap(MS)")
        if action == "partition" and site not in _PARTITION_SITES:
            raise FaultSpecError(
                f"fault clause {raw!r}: action 'partition' only applies "
                f"at coordination sites ({', '.join(_PARTITION_SITES)})")
        if action in ("slow", "flap") and site not in _WIRE_SITES:
            raise FaultSpecError(
                f"fault clause {raw!r}: action {action!r} only applies "
                f"at wire sites ({', '.join(_WIRE_SITES)})")
        ranks = pset = prob = None
        count = 1
        # one-shot by default: a rank dies (kill), departs (preempt),
        # loses the network (partition) or its wire link (flap) at
        # most once per job unless times= says otherwise
        times = 1 if action in ("kill", "preempt", "partition",
                                "flap") else 0
        for sel in filter(None, (s.strip() for s in sel_s.split(","))):
            if "=" not in sel:
                raise FaultSpecError(
                    f"fault clause {raw!r}: selector {sel!r} is not "
                    "key=value")
            k, v = (t.strip() for t in sel.split("=", 1))
            try:
                if k == "rank":
                    ranks = frozenset(int(r) for r in v.split("|"))
                elif k == "pset":
                    pset = int(v)
                elif k == "count":
                    count = int(v)
                    if count < 1:
                        raise ValueError
                elif k == "prob":
                    prob = float(v)
                    if not 0.0 <= prob <= 1.0:
                        raise ValueError
                elif k == "times":
                    times = int(v)
                    if times < 0:
                        raise ValueError
                else:
                    raise FaultSpecError(
                        f"fault clause {raw!r}: unknown selector {k!r} "
                        "(known: rank, pset, count, prob, times)")
            except FaultSpecError:
                raise
            except ValueError:
                raise FaultSpecError(
                    f"fault clause {raw!r}: bad selector value "
                    f"{sel!r}") from None
        clauses.append(FaultClause(
            site, action, delay_ms, ranks, pset, count, prob, times,
            index=len(clauses), source=raw, corrupt_mode=corrupt_mode,
            partition_ms=partition_ms, flap_ms=flap_ms))
    return clauses


class FaultRegistry:
    """The armed per-process fault set.

    ``inject(site)`` walks the (tiny) clause list for that site and
    executes the first firing clause's action.  Returns True when the
    operation should be DROPPED (the caller suppresses it), False
    otherwise; ``error`` raises :class:`InjectedFault`; ``kill``
    hard-exits the process.
    """

    def __init__(self, clauses: Sequence[FaultClause], rank: int = 0,
                 seed: int = 0, state_dir: Optional[str] = None,
                 exit_fn=None):
        self.rank = rank
        self.seed = seed
        self.state_dir = state_dir
        # sim seam: ``kill`` calls exit_fn(1) instead of os._exit so a
        # virtual rank can die without taking the host process with it
        self._exit_fn = exit_fn
        self._lock = threading.Lock()
        # a fired partition(MS) clause opens a window on the (possibly
        # virtual) clock during which EVERY _PARTITION_SITES operation
        # on this registry is dropped — one clause, full silence
        self._partition_until = 0.0  # hvtpulint: guarded-by(_lock)
        # a fired flap(MS) clause opens the same kind of window over
        # the WIRE sites: the rank's data-plane link is down, every
        # wire.send/wire.recv/collective.exec in the window is dropped
        self._flap_until = 0.0  # hvtpulint: guarded-by(_lock)
        self._by_site: Dict[str, List[FaultClause]] = {}
        for c in clauses:
            c.bind(rank, seed, self._load_fired(c))
            self._by_site.setdefault(c.site, []).append(c)

    # -- cross-incarnation persistence ---------------------------------
    def _marker(self, clause: FaultClause) -> Optional[str]:
        if not self.state_dir or not clause.times:
            return None
        return os.path.join(self.state_dir, "faults_fired",
                            f"clause_{clause.index}")

    def _load_fired(self, clause: FaultClause) -> int:
        path = self._marker(clause)
        if not path:
            return 0
        try:
            with open(path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _persist_fired(self, clause: FaultClause) -> None:
        path = self._marker(clause)
        if not path:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(str(clause._fired))
        except OSError:
            logger.warning("fault harness: could not persist firing "
                           "count to %s", path, exc_info=True)

    # -- the injection point -------------------------------------------
    def _select(self, site: str, pset, tensor_site: bool,
                storage_site: bool = False) -> Optional[FaultClause]:
        """First firing clause for ``site``.  ``corrupt`` clauses only
        fire at tensor sites (``inject_tensor``) — plain ``inject``
        call sites carry no data to poison, and silently consuming the
        firing there would make the clause look like a no-op.  The
        same argument gates ``torn``/``bitflip`` to storage call sites
        (``inject_storage``): only there is a byte stream to damage."""
        with self._lock:
            for clause in self._by_site.get(site, ()):
                if clause.action == "corrupt" and not tensor_site:
                    continue
                if (clause.action in ("torn", "bitflip")
                        and not storage_site):
                    continue
                if clause.matches(self.rank, pset) and clause.should_fire():
                    return clause
        return None

    def _execute(self, fired: FaultClause, site: str,
                 detail: Optional[str]) -> bool:
        """Run a fired clause's non-tensor action; returns True for
        ``drop`` (caller suppresses the operation)."""
        # Persist BEFORE executing: a kill must be counted by the next
        # incarnation even though this process never returns.
        self._persist_fired(fired)
        logger.warning(
            "hvtpu fault injection: firing [%s] at site %s (rank %d%s)",
            fired.source, site, self.rank,
            f", op {detail}" if detail else "")
        if fired.action in ("delay", "slow"):
            clock.sleep(fired.delay_ms / 1000.0)
            return False
        if fired.action == "drop":
            return True
        if fired.action == "flap":
            until = clock.monotonic() + fired.flap_ms / 1000.0
            with self._lock:
                self._flap_until = max(self._flap_until, until)
            from ..obs import flight as _flight

            if _flight.ACTIVE:
                _flight.note("link_flap_start", rank=self.rank,
                             window_ms=fired.flap_ms, site=site)
            return True  # the triggering op is the window's first loss
        if fired.action == "partition":
            until = clock.monotonic() + fired.partition_ms / 1000.0
            with self._lock:
                self._partition_until = max(self._partition_until, until)
            from ..obs import flight as _flight

            if _flight.ACTIVE:
                _flight.note("partition_start", rank=self.rank,
                             window_ms=fired.partition_ms, site=site)
            return True  # the triggering op is the window's first loss
        if fired.action == "error":
            raise InjectedFault(fired, site)
        if fired.action == "preempt":
            # deliver a preemption notice instead of dying: the
            # graceful-drain path (core/preempt.py) takes it from here
            # — persisted above like kill, so the relaunched rank does
            # not re-preempt forever.
            from . import preempt as _preempt

            _preempt.notice("fault")
            return False
        # kill: flush and hard-exit — simulate a worker dying mid-op
        # (exit 1 = crash, NOT the reset code: the launcher must treat
        # this as an unplanned death, exactly like a real one).  The
        # flight recorder flushes its black box first: a killed rank
        # still leaves a postmortem behind.
        import sys

        from ..obs import flight as _flight

        _flight.dump_postmortem("fault_kill", site=site)
        print(f"hvtpu fault injection: killing rank {self.rank} "
              f"([{fired.source}] at {site})", file=sys.stderr, flush=True)
        sys.stdout.flush()
        if self._exit_fn is not None:
            self._exit_fn(1)
            return False
        os._exit(1)

    def partition_remaining(self) -> float:
        """Seconds left in an open partition window (0.0 when none)."""
        with self._lock:
            until = self._partition_until
        return max(0.0, until - clock.monotonic())

    def flap_remaining(self) -> float:
        """Seconds left in an open wire-flap window (0.0 when none)."""
        with self._lock:
            until = self._flap_until
        return max(0.0, until - clock.monotonic())

    def inject(self, site: str, pset=None, detail: Optional[str] = None
               ) -> bool:
        # An open partition window silences every coordination site on
        # this rank before any per-clause selection runs.
        if site in _PARTITION_SITES:
            with self._lock:
                partitioned = (self._partition_until
                               and clock.monotonic() < self._partition_until)
            if partitioned:
                return True
        # Likewise a flapping wire link drops every wire-site op.
        if site in _WIRE_SITES:
            with self._lock:
                flapping = (self._flap_until
                            and clock.monotonic() < self._flap_until)
            if flapping:
                return True
        fired = self._select(site, pset, tensor_site=False)
        if fired is None:
            return False
        return self._execute(fired, site, detail)

    def inject_storage(self, site: str, detail: Optional[str] = None
                       ) -> Optional[str]:
        """Storage-site injection point (``ckpt.*`` in the durable
        commit protocol, core/durable.py).  Returns the damage the
        caller must apply to the physical operation:

        - ``"torn"`` — truncate the payload mid-write;
        - ``"bitflip"`` — flip one bit of the written bytes;
        - ``"drop"`` — suppress the operation entirely (an elided
          fsync or rename IS a torn commit);
        - ``None`` — proceed normally (after any delay; ``error``
          raises, ``kill`` never returns)."""
        fired = self._select(site, None, tensor_site=False,
                             storage_site=True)
        if fired is None:
            return None
        if fired.action in ("torn", "bitflip"):
            self._persist_fired(fired)
            logger.warning(
                "hvtpu fault injection: %s storage damage [%s] at site "
                "%s (rank %d%s)", fired.action, fired.source, site,
                self.rank, f", op {detail}" if detail else "")
            return fired.action
        if self._execute(fired, site, detail):
            return "drop"
        return None

    def inject_tensor(self, site: str, tensor, pset=None,
                      detail: Optional[str] = None):
        """Tensor-site injection point: like :meth:`inject`, but the
        operation carries data, so ``corrupt`` clauses can poison it
        (NaN in element 0, or a flipped sign bit for ``bitflip``/
        non-float dtypes).  Returns the (possibly poisoned) tensor;
        ``drop`` is a no-op here — a collective cannot be suppressed
        without desyncing its peers."""
        fired = self._select(site, pset, tensor_site=True)
        if fired is None:
            return tensor
        if fired.action != "corrupt":
            self._execute(fired, site, detail)
            return tensor
        self._persist_fired(fired)
        logger.warning(
            "hvtpu fault injection: corrupting (%s) [%s] at site %s "
            "(rank %d%s)", fired.corrupt_mode, fired.source, site,
            self.rank, f", op {detail}" if detail else "")
        return _poison(tensor, fired.corrupt_mode)


# The NaN the reference writes (``flat[0] = np.nan``), as bits of each
# dtype numpy counts as floating; bfloat16 is not among them.
_NAN_BITS = {
    torch.float16: (torch.int16, 0x7E00),
    torch.float32: (torch.int32, 0x7FC00000),
    torch.float64: (torch.int64, 0x7FF8000000000000),
}


def _poison(tensor, mode: str):
    """Poison one element of a copy of ``tensor``, on its own device:
    NaN for float16/32/64 in ``nan`` mode, a flipped top bit of element
    0's last byte otherwise.  The NaN is written as bits, so a card and
    the CPU write the same one."""
    if tensor.numel() == 0:
        return tensor
    x = tensor.detach().clone(memory_format=torch.contiguous_format)
    flat = x.view(-1)
    # in-place ops on one-element views, the value a kernel argument:
    # no host round trip, and no synchronization on a card
    if mode == "nan" and x.dtype in _NAN_BITS:
        itype, bits = _NAN_BITS[x.dtype]
        flat.view(itype)[:1].fill_(bits)
    else:
        k = x.element_size() - 1
        flat.view(torch.uint8)[k:k + 1].bitwise_xor_(0x80)
    return x


def install(spec: str, rank: int = 0, seed: int = 0,
            state_dir: Optional[str] = None) -> Optional[FaultRegistry]:
    """Arm the process-wide registry from a spec string (empty/None
    uninstalls).  Called by ``core.state.init`` once the true rank is
    known; idempotent re-install replaces the previous registry."""
    global _registry, ACTIVE
    with _lock:
        if not spec or not spec.strip():
            _registry = None
            ACTIVE = _tls_installs > 0
            return None
        _registry = FaultRegistry(
            parse_spec(spec), rank=rank, seed=seed, state_dir=state_dir)
        ACTIVE = True
        return _registry


def install_from_config(cfg, rank: int) -> Optional[FaultRegistry]:
    """Arm from a Config snapshot (HVTPU_FAULT_SPEC / HVTPU_FAULT_SEED);
    the persistence dir falls back to the elastic state dir so one-shot
    faults survive relaunches without extra wiring."""
    spec = getattr(cfg, "fault_spec", None)
    if not spec:
        return None
    state_dir = (os.environ.get("HVTPU_FAULT_STATE_DIR")
                 or os.environ.get("HVTPU_ELASTIC_STATE_DIR"))
    return install(spec, rank=rank,
                   seed=int(getattr(cfg, "fault_seed", 0) or 0),
                   state_dir=state_dir)


def uninstall() -> None:
    global _registry, ACTIVE
    with _lock:
        _registry = None
        ACTIVE = _tls_installs > 0


def use(reg: Optional[FaultRegistry]) -> None:
    """Install ``reg`` as the CALLING THREAD's fault registry (None to
    uninstall).  The fabric simulator arms one registry per virtual-rank
    thread this way; :func:`inject` / :func:`inject_tensor` on that
    thread then route to it instead of the process-wide registry, and
    the module ``ACTIVE`` fast path stays truthful while any
    thread-local registry is armed."""
    global _tls_installs, ACTIVE
    prev = getattr(_tls, "registry", None)
    _tls.registry = reg
    with _lock:
        if reg is not None and prev is None:
            _tls_installs += 1
        elif reg is None and prev is not None:
            _tls_installs = max(0, _tls_installs - 1)
        ACTIVE = _registry is not None or _tls_installs > 0


def _current() -> Optional[FaultRegistry]:
    reg = getattr(_tls, "registry", None)
    return reg if reg is not None else _registry


def inject(site: str, pset=None, detail: Optional[str] = None) -> bool:
    """Fire any armed clause for ``site``.  Returns True when the
    caller should DROP the operation; may sleep (delay), raise
    :class:`InjectedFault` (error), or never return (kill).  A no-op
    returning False when nothing is installed — but hot paths should
    guard on ``faults.ACTIVE`` and skip the call entirely."""
    reg = _current()
    if reg is None:
        return False
    return reg.inject(site, pset=pset, detail=detail)


def inject_tensor(site: str, tensor, pset=None,
                  detail: Optional[str] = None):
    """Tensor-site variant of :func:`inject`: returns the (possibly
    ``corrupt``-poisoned) tensor; other actions behave as in
    :func:`inject` except ``drop``, which is a no-op at tensor sites.
    Hot paths guard on ``faults.ACTIVE`` before calling."""
    reg = _current()
    if reg is None:
        return tensor
    return reg.inject_tensor(site, tensor, pset=pset, detail=detail)


def inject_storage(site: str, detail: Optional[str] = None
                   ) -> Optional[str]:
    """Storage-site variant of :func:`inject` for the ``ckpt.*`` sites:
    returns the damage mode the caller must apply (``"torn"`` /
    ``"bitflip"`` / ``"drop"``) or None to proceed; ``delay`` sleeps,
    ``error`` raises, ``kill`` never returns.  Checkpoint writes are
    never a hot path, but callers still guard on ``faults.ACTIVE``."""
    reg = _current()
    if reg is None:
        return None
    return reg.inject_storage(site, detail=detail)


def partition_remaining() -> float:
    """Seconds left in the calling thread's open ``partition(MS)``
    window (0.0 when none is armed/open) — test and sim probe."""
    reg = _current()
    if reg is None:
        return 0.0
    return reg.partition_remaining()


def flap_remaining() -> float:
    """Seconds left in the calling thread's open ``flap(MS)`` wire
    window (0.0 when none is armed/open) — test and sim probe."""
    reg = _current()
    if reg is None:
        return 0.0
    return reg.flap_remaining()

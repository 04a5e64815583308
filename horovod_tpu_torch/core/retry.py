"""Generic bounded retry with exponential backoff + full jitter.

Counterpart of ``horovod_tpu/core/retry.py``: one policy engine for every
"transiently unreachable" surface, and the wrappers that put the
coordination store under it.

- **coordination KV** (``ResilientKV``, ``FencedKV``): the stall
  inspector's heartbeats and votes ride a ``torch.distributed`` store
  through ``core/kv.py``'s adapter, which speaks the JAX coordination
  client's method names so these wrappers keep the reference's code.  A
  transient failure retries with backoff and only an exhausted budget
  surfaces.  Retries and exhaustions are counted in the metrics registry
  (``hvtpu_kv_retries_total``, ``hvtpu_kv_retry_exhausted_total``) and
  noted in the flight recorder.
- **gloo teardown races** (``GLOO_TEARDOWN``): a named policy for
  relaunching a localhost gloo run whose transport dropped a connection.

Backoff follows the AWS "full jitter" scheme: sleep is uniform in
``[0, min(max_delay, base * 2**attempt)]``.

Env knobs (the reference's):

- ``HVTPU_KV_RETRY_ATTEMPTS``   (default 4)  total attempts per KV op
- ``HVTPU_KV_RETRY_BASE_MS``    (default 50) first-retry backoff cap
- ``HVTPU_KV_RETRY_MAX_MS``     (default 2000) per-sleep cap
- ``HVTPU_KV_RETRY_DEADLINE_S`` (default 30) wall-clock budget per op

"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Any, Callable, Optional, Tuple

import torch.distributed as dist

from ..obs import flight
from ..obs import metrics as obs_metrics
from . import clock
from . import faults

_M_KV_RETRIES = obs_metrics.counter(
    "hvtpu_kv_retries_total",
    "Coordination-KV operations retried after a transient failure.")
_M_KV_EXHAUSTED = obs_metrics.counter(
    "hvtpu_kv_retry_exhausted_total",
    "Coordination-KV operations that failed even after exhausting the "
    "retry budget (the error then surfaces to the caller).")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry schedule + classification.

    ``retryable`` classifies exceptions; ``retry_result`` (optional)
    classifies RETURN VALUES that should be retried (subprocess results
    carrying an infra-crash signature, say).  ``max_attempts`` counts
    total attempts including the first; ``deadline_s`` bounds the whole
    call in wall-clock time.  ``base_delay_s`` of 0 retries immediately
    (the gloo policy: the race is gone on re-run, waiting buys nothing).
    """

    name: str
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: Optional[float] = None
    retryable: Callable[[BaseException], bool] = lambda e: True
    retry_result: Optional[Callable[[Any], bool]] = None

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter sleep before retry ``attempt`` (1-based)."""
        if self.base_delay_s <= 0:
            return 0.0
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (attempt - 1)))
        return rng.uniform(0.0, cap)


class RetryExhausted(Exception):
    """Raised only for result-based exhaustion when the caller asked
    for it; exception-based exhaustion re-raises the original error so
    existing ``except`` clauses keep matching."""


def call(policy: RetryPolicy, fn: Callable, *args,
         on_retry: Optional[Callable[[int, Optional[BaseException]],
                                     None]] = None,
         rng: Optional[random.Random] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``policy``.

    On a retryable exception: sleep (full jitter) and re-attempt until
    ``max_attempts`` or ``deadline_s`` runs out, then re-raise the
    LAST exception (no wrapper type — callers' handlers keep working).
    With ``retry_result``, a True-classified return value is retried
    the same way and the final value is returned once the budget is
    spent.  ``on_retry(attempt, exc_or_None)`` fires before each sleep.
    """
    rng = rng or random.Random()
    start = clock.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            result = fn(*args, **kwargs)
        except Exception as e:
            budget_left = (
                attempt < policy.max_attempts
                and (policy.deadline_s is None
                     or clock.monotonic() - start < policy.deadline_s))
            if not policy.retryable(e) or not budget_left:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            clock.sleep(policy.backoff_s(attempt, rng))
            continue
        if (policy.retry_result is not None
                and policy.retry_result(result)
                and attempt < policy.max_attempts
                and (policy.deadline_s is None
                     or clock.monotonic() - start < policy.deadline_s)):
            if on_retry is not None:
                on_retry(attempt, None)
            clock.sleep(policy.backoff_s(attempt, rng))
            continue
        return result


def retrying(policy: RetryPolicy):
    """Decorator form of :func:`call`."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call(policy, fn, *args, **kwargs)
        return wrapped
    return deco


# ---------------------------------------------------------------------------
# named policies
# ---------------------------------------------------------------------------

# Transient coordination-service failure signatures (grpc status names
# + socket-level shapes).  NOT_FOUND is deliberately absent: a missing
# key is a legitimate answer for try_get, not a failure to retry.
_KV_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED",
    "failed to connect", "Connection reset", "connection reset",
    "Broken pipe", "Socket closed", "coordination service",
)


def kv_retryable(e: BaseException) -> bool:
    # the reference's rule, plus the store's own transport error type
    # (a TCPStore whose connection broke raises DistNetworkError)
    if isinstance(e, (TimeoutError, dist.DistNetworkError)):
        return True
    msg = str(e)
    return any(m in msg for m in _KV_TRANSIENT_MARKERS)


def kv_blocking_retryable(e: BaseException) -> bool:
    """Blocking-get variant: a NOT_FOUND/timeout just means the peer
    hasn't posted yet — poll again until the caller's deadline."""
    return kv_retryable(e) or "NOT_FOUND" in str(e)


def kv_policy(deadline_s: Optional[float] = None) -> RetryPolicy:
    """The coordination-KV policy, env-tunable (module docstring)."""
    return RetryPolicy(
        name="kv",
        max_attempts=int(os.environ.get("HVTPU_KV_RETRY_ATTEMPTS", "4")),
        base_delay_s=float(
            os.environ.get("HVTPU_KV_RETRY_BASE_MS", "50")) / 1000.0,
        max_delay_s=float(
            os.environ.get("HVTPU_KV_RETRY_MAX_MS", "2000")) / 1000.0,
        deadline_s=(float(os.environ.get("HVTPU_KV_RETRY_DEADLINE_S",
                                         "30"))
                    if deadline_s is None else deadline_s),
        retryable=kv_retryable,
    )


#: gloo CPU-transport teardown-race signatures (a rank dies
#: mid-collective; peers see the torn socket).
GLOO_INFRA_MARKERS: Tuple[str, ...] = (
    "Connection closed by peer", "Socket closed",
    "collective transport failure", "connection reset by peer",
)


def is_gloo_infra_error(text: str) -> bool:
    """True when ``text`` (an exception string or a process's combined
    output) carries a gloo teardown-race signature rather than a
    framework failure."""
    return any(m in text for m in GLOO_INFRA_MARKERS)


def gloo_teardown_policy(max_attempts: int = 5,
                         retry_result: Optional[Callable[[Any], bool]]
                         = None) -> RetryPolicy:
    """Bounded relaunch for the gloo CPU teardown race: immediate
    re-run (the race is load-timing, not state), exception-classified
    by :func:`is_gloo_infra_error`; pass ``retry_result`` to also
    classify completed-subprocess results (rc + output blob)."""
    return RetryPolicy(
        name="gloo-teardown",
        max_attempts=max_attempts,
        base_delay_s=0.0,
        retryable=lambda e: is_gloo_infra_error(str(e)),
        retry_result=retry_result,
    )


GLOO_TEARDOWN = gloo_teardown_policy()


# ---------------------------------------------------------------------------
# resilient coordination-KV wrapper
# ---------------------------------------------------------------------------


class ResilientKV:
    """Coordination-service client wrapper: fault injection (sites
    ``kv.get`` / ``kv.put``) + bounded retry with backoff on transient
    failures, counting into the metrics registry.

    Dropped-op semantics (the ``drop`` fault action): a dropped read is
    a miss (``KeyError`` for try_get — the same "no such key" contract
    the raw client's error has, which every caller already treats as
    absent; ``[]`` for dir_get; ``TimeoutError`` for blocking_get), a
    dropped write/delete silently does nothing.  ``blocking_key_value_get``
    is NOT retried here — its callers own a deadline loop already.

    Attributes the wrapped client lacks stay missing (``key_value_dir_get``
    presence is how comm/stall.py picks amortized vs strict mode), and
    unknown attributes delegate, so the wrapper is drop-in.
    """

    def __init__(self, client, rank: int = 0,
                 policy: Optional[RetryPolicy] = None):
        self._kv = client
        self._rank = rank
        self._policy = policy or kv_policy()
        self._rng = random.Random(0x6B76 + rank)
        if hasattr(client, "key_value_dir_get"):
            # instance attribute, so ``getattr(kv, "key_value_dir_get",
            # None)`` stays None for clients without a dir get
            self.key_value_dir_get = self._dir_get

    def _on_retry(self, attempt: int, exc) -> None:
        _M_KV_RETRIES.inc()
        if flight.ACTIVE:
            flight.note("kv_retry", rank=self._rank, attempt=attempt,
                        error=type(exc).__name__)

    def _call(self, fn, *args):
        try:
            return call(self._policy, fn, *args,
                        on_retry=self._on_retry, rng=self._rng)
        except Exception as e:
            if kv_retryable(e):
                _M_KV_EXHAUSTED.inc()
                if flight.ACTIVE:
                    flight.note("kv_retry_exhausted", rank=self._rank,
                                error=str(e)[:200])
            raise

    # Fault injection happens INSIDE the retried closures below, so an
    # ``error``-injected op (whose message carries UNAVAILABLE) is
    # retried exactly like a real coordinator blip — and heals once the
    # clause's budget is spent.  ``drop`` never raises, so it is never
    # retried: a dropped write stays dropped.

    # -- mutations (site kv.put) ---------------------------------------
    def key_value_set(self, key: str, value: str):
        def _put():
            if faults.ACTIVE and faults.inject("kv.put", detail=key):
                return None
            return self._kv.key_value_set(key, value)

        return self._call(_put)

    def key_value_delete(self, key: str):
        if faults.ACTIVE and faults.inject("kv.put", detail=key):
            return None
        # best-effort by contract (callers swallow failures); one shot
        return self._kv.key_value_delete(key)

    # -- reads (site kv.get) -------------------------------------------
    def key_value_try_get(self, key: str):
        def _get():
            if faults.ACTIVE and faults.inject("kv.get", detail=key):
                raise KeyError(f"{key} (dropped by fault injection)")
            return self._kv.key_value_try_get(key)

        return self._call(_get)

    def _dir_get(self, prefix: str):
        def _get():
            if faults.ACTIVE and faults.inject("kv.get", detail=prefix):
                return []
            return self._kv.key_value_dir_get(prefix)

        return self._call(_get)

    def blocking_key_value_get(self, key: str, timeout_ms: int):
        if faults.ACTIVE and faults.inject("kv.get", detail=key):
            raise TimeoutError(f"{key} (dropped by fault injection)")
        return self._kv.blocking_key_value_get(key, timeout_ms)

    def __getattr__(self, name):
        return getattr(self._kv, name)


def resilient_kv(client, rank: int = 0,
                 policy: Optional[RetryPolicy] = None):
    """Wrap ``client`` (idempotently) in :class:`ResilientKV`."""
    if client is None or isinstance(client, ResilientKV):
        return client
    return ResilientKV(client, rank=rank, policy=policy)


# ---------------------------------------------------------------------------
# generation-fenced coordination-KV wrapper
# ---------------------------------------------------------------------------

#: Distinct worker exit status for "this rank fenced itself": its
#: generation was superseded (a newer incarnation owns the keyspace) or
#: its KV lease expired (it could not prove liveness to the
#: coordination plane).  The elastic launcher classifies this separately
#: from a crash — a fenced rank did the RIGHT thing by dying, so it
#: costs no restart-budget strike and no host-blacklist strike
#: (docs/robustness.md exit-code table).
FENCE_EXIT_CODE = 89

#: Fencing-token stamp framing: ``\\x1fF<epoch>.<generation>\\x1f<payload>``.
#: \\x1f (ASCII unit separator) never occurs in the JSON/ascii payloads
#: the control protocols exchange, so unstamped values pass through
#: untouched and stamped ones are unambiguous.
_STAMP_LEAD = "\x1fF"
_STAMP_SEP = "\x1f"

#: Raw beacon key carrying the highest fencing token any writer has
#: advertised.  Deliberately OUTSIDE every protocol namespace and never
#: itself stamped: its value IS a token.
FENCE_BEACON_KEY = "hvtfence/beacon"

_M_FENCED_WRITES = obs_metrics.counter(
    "hvtpu_kv_fenced_writes_total",
    "Stale KV values from fenced (superseded-generation) writers "
    "rejected by readers.")
_M_FENCE_EXITS = obs_metrics.counter(
    "hvtpu_fence_exits_total",
    "Ranks that self-fenced (generation superseded or KV lease "
    "expired) and exited with FENCE_EXIT_CODE.")


def _parse_token(text) -> Optional[Tuple[int, int]]:
    """``"epoch.generation"`` -> (epoch, generation), else None."""
    if not isinstance(text, str):
        return None
    epoch, _, gen = text.partition(".")
    try:
        return int(epoch), int(gen)
    except ValueError:
        return None


def unstamp(value):
    """Split a possibly-stamped KV value into ``(token, payload)``.

    ``token`` is ``(job_epoch, generation)`` or None for unstamped
    values (pre-fencing writers, non-string payloads).  Total: never
    raises — malformed stamps are treated as unstamped payloads.
    Readers outside the fenced seams (e.g. the fleet arbiter's health
    poll) call this to stay stamp-tolerant.
    """
    if not isinstance(value, str) or not value.startswith(_STAMP_LEAD):
        return None, value
    end = value.find(_STAMP_SEP, len(_STAMP_LEAD))
    if end < 0:
        return None, value
    token = _parse_token(value[len(_STAMP_LEAD):end])
    if token is None:
        return None, value
    return token, value[end + len(_STAMP_SEP):]


class FencedError(RuntimeError):
    """Raised by a fenced :class:`FencedKV` whose ``exit_fn`` returned
    (tests, sim ranks): no operation may proceed past a fence."""


class FencedKV(ResilientKV):
    """Generation-fenced :class:`ResilientKV`: every write is stamped
    with this writer's ``(job_epoch, generation)`` fencing token, and
    reads reject values stamped by a SUPERSEDED token — closing the
    split-brain window where a rank that exhausted its KV retries (or
    thawed after a partition) keeps writing stale heartbeats, drain
    plans, or quorum votes into the live keyspace.

    Three fence triggers, all terminal for this rank:

    - **supersession observed on read**: a value or the beacon key
      carries a HIGHER token than ours — a newer incarnation owns the
      keyspace, we are the zombie;
    - **lease expiry**: ``lease_s > 0`` and no KV operation has
      actually reached the server for longer than the lease — we
      cannot prove liveness, so we must assume we were given up on
      (peers hold a ``partition_suspect`` grace first: comm/stall.py);
    - **explicit** :meth:`fence` from the owner (tests, drain logic).

    Fencing exits via ``exit_fn`` (default ``os._exit``) with
    :data:`FENCE_EXIT_CODE`; if ``exit_fn`` returns (unit tests, sim
    virtual ranks whose exit_fn raises), every subsequent operation
    raises :class:`FencedError` so a fenced client can never write.

    Equal tokens — the only case in a healthy single-generation job —
    cost one string startswith per read and one prefix concat per
    write.  ``HVTPU_KV_FENCE_DISABLE=1`` removes even that (the
    factory returns a plain ResilientKV).
    """

    def __init__(self, client, rank: int = 0,
                 policy: Optional[RetryPolicy] = None, *,
                 job_epoch: Optional[int] = None,
                 generation: Optional[int] = None,
                 lease_s: Optional[float] = None,
                 check_every: Optional[int] = None,
                 exit_fn=None, journal=None):
        super().__init__(client, rank=rank, policy=policy)
        if job_epoch is None:
            job_epoch = int(os.environ.get("HVTPU_JOB_EPOCH", "0") or 0)
        if generation is None:
            generation = int(
                os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0)
        if lease_s is None:
            lease_s = float(os.environ.get("HVTPU_KV_LEASE_S", "0") or 0)
        if check_every is None:
            check_every = int(
                os.environ.get("HVTPU_KV_FENCE_CHECK_EVERY", "32") or 32)
        self._token: Tuple[int, int] = (job_epoch, generation)
        self._lease_s = lease_s
        self._check_every = max(1, check_every)
        self._exit_fn = exit_fn
        self._journal = journal
        self._journal_prefixes: Tuple[str, ...] = ()
        self._fenced = False
        self._fence_reason = ""
        # "last proven reachable": bumped on every op that the server
        # actually answered (including NOT_FOUND — an answer).  seq
        # disambiguates refresh-vs-not without clock comparisons.
        self._lease_ok = clock.monotonic()
        self._lease_seq = 0
        self._ops_since_check = 0
        self._recheck = False
        self._advertise()

    # -- token plumbing -------------------------------------------------
    @property
    def token(self) -> Tuple[int, int]:
        return self._token

    def token_str(self) -> str:
        return f"{self._token[0]}.{self._token[1]}"

    def _stamp(self, value):
        if not isinstance(value, str):
            return value
        return f"{_STAMP_LEAD}{self.token_str()}{_STAMP_SEP}{value}"

    # -- journal of self-authored durable keys --------------------------
    def add_journal_prefix(self, prefix: str) -> None:
        """Record future writes under ``prefix`` in this rank's key
        journal (core/journal.py) for replay into a fresh KV after
        coordinator loss."""
        if prefix not in self._journal_prefixes:
            self._journal_prefixes = self._journal_prefixes + (prefix,)

    def _journal_write(self, key: str, value) -> None:
        if self._journal is None or not isinstance(value, str):
            return
        if any(key.startswith(p) for p in self._journal_prefixes):
            self._journal.record(key, value)

    # -- fencing --------------------------------------------------------
    def fence(self, reason: str):
        """Terminal: this rank may no longer touch the keyspace."""
        if not self._fenced:
            self._fenced = True
            self._fence_reason = reason
            _M_FENCE_EXITS.inc()
            if flight.ACTIVE:
                flight.note("fence_exit", rank=self._rank,
                            token=self.token_str(), reason=reason)
            flight.dump_postmortem("fenced", rank=self._rank,
                                   token=self.token_str(),
                                   detail=reason)
            import sys

            print(f"hvtpu fence: rank {self._rank} token "
                  f"{self.token_str()} self-fencing ({reason}); "
                  f"exiting {FENCE_EXIT_CODE}",
                  file=sys.stderr, flush=True)
            if self._exit_fn is not None:
                self._exit_fn(FENCE_EXIT_CODE)
            else:
                os._exit(FENCE_EXIT_CODE)
        # exit_fn returned (unit test / already-exiting sim rank):
        # refuse the operation that discovered the fence.
        raise FencedError(
            f"KV client fenced ({self._fence_reason}): rank {self._rank} "
            f"token {self.token_str()}")

    def _observe(self, token: Optional[Tuple[int, int]]) -> bool:
        """Classify a read value's token: True means REJECT the value
        (stale writer); a newer token fences US."""
        if token is None or token == self._token:
            return False
        if token > self._token:
            self.fence(f"generation superseded (saw token "
                       f"{token[0]}.{token[1]})")
        _M_FENCED_WRITES.inc()
        if flight.ACTIVE:
            flight.note("fenced_write_rejected", rank=self._rank,
                        stale=f"{token[0]}.{token[1]}",
                        token=self.token_str())
        return True

    # -- lease ----------------------------------------------------------
    def _touch_lease(self) -> None:
        self._lease_ok = clock.monotonic()
        self._lease_seq += 1

    def lease_remaining(self) -> float:
        """Seconds until the lease expires (inf with no lease armed)."""
        if self._lease_s <= 0:
            return float("inf")
        return self._lease_s - (clock.monotonic() - self._lease_ok)

    def _lease_check(self) -> None:
        if self._lease_s <= 0:
            return
        age = clock.monotonic() - self._lease_ok
        if age > self._lease_s:
            self.fence(f"kv lease expired (unreachable {age:.3f}s > "
                       f"lease {self._lease_s:.3f}s)")

    # -- beacon ---------------------------------------------------------
    def _raw_beacon_get(self):
        # through fault injection (a partitioned rank cannot read the
        # beacon) but NOT through retry: the beacon is advisory.
        if faults.ACTIVE and faults.inject("kv.get",
                                           detail=FENCE_BEACON_KEY):
            raise KeyError(FENCE_BEACON_KEY)
        return self._kv.key_value_try_get(FENCE_BEACON_KEY)

    def _check_beacon(self) -> None:
        try:
            seen = _parse_token(self._raw_beacon_get())
        except KeyError:
            # NOT_FOUND: the server answered "no beacon yet" — claim
            # it.  (A partition-dropped read lands here too; the
            # publish below is then dropped the same way, harmlessly.)
            seen = None
        except Exception:
            return
        if seen is None:
            self._publish_beacon()
        elif seen > self._token:
            self.fence(f"generation superseded (beacon "
                       f"{seen[0]}.{seen[1]})")
        elif seen < self._token:
            self._publish_beacon()

    def _publish_beacon(self) -> None:
        try:
            if faults.ACTIVE and faults.inject("kv.put",
                                               detail=FENCE_BEACON_KEY):
                return
            self._kv.key_value_set(FENCE_BEACON_KEY, self.token_str())
        except Exception:
            pass

    def _advertise(self) -> None:
        """Init-time beacon handshake: fence immediately if a newer
        incarnation already advertised, else advertise ourselves."""
        self._check_beacon()

    # -- op shells -------------------------------------------------------
    def _pre_op(self) -> None:
        if self._fenced:
            raise FencedError(
                f"KV client fenced ({self._fence_reason}): rank "
                f"{self._rank} token {self.token_str()}")
        self._ops_since_check += 1
        if self._recheck or self._ops_since_check >= self._check_every:
            self._ops_since_check = 0
            self._recheck = False
            self._check_beacon()

    def _guarded(self, fn):
        """Run one retried op; when it never reached the server
        (dropped by a partition window / transport failure), evaluate
        the lease and schedule a beacon re-check for the next op (a
        thawed zombie fences BEFORE its first post-thaw write)."""
        before = self._lease_seq
        try:
            return self._call(fn)
        finally:
            if self._lease_seq == before:
                self._recheck = True
                self._lease_check()

    # -- mutations (site kv.put) ----------------------------------------
    def key_value_set(self, key: str, value: str):
        self._pre_op()
        stamped = self._stamp(value)
        self._journal_write(key, value)

        def _put():
            if faults.ACTIVE and faults.inject("kv.put", detail=key):
                return None
            r = self._kv.key_value_set(key, stamped)
            self._touch_lease()
            return r

        return self._guarded(_put)

    def key_value_delete(self, key: str):
        self._pre_op()
        if self._journal is not None:
            self._journal.forget(key)
        if faults.ACTIVE and faults.inject("kv.put", detail=key):
            return None
        r = self._kv.key_value_delete(key)
        self._touch_lease()
        return r

    # -- reads (site kv.get) --------------------------------------------
    def key_value_try_get(self, key: str):
        self._pre_op()

        def _get():
            if faults.ACTIVE and faults.inject("kv.get", detail=key):
                raise KeyError(f"{key} (dropped by fault injection)")
            try:
                r = self._kv.key_value_try_get(key)
            except Exception as e:
                if not kv_retryable(e):
                    self._touch_lease()  # NOT_FOUND is an answer
                raise
            self._touch_lease()
            return r

        raw = self._guarded(_get)
        token, payload = unstamp(raw)
        if self._observe(token):
            raise KeyError(f"{key} (fenced stale write rejected)")
        return payload

    def _dir_get(self, prefix: str):
        self._pre_op()

        def _get():
            if faults.ACTIVE and faults.inject("kv.get", detail=prefix):
                return None
            r = self._kv.key_value_dir_get(prefix)
            self._touch_lease()
            return r

        raw = self._guarded(_get)
        if raw is None:  # dropped
            return []
        out = []
        for k, v in raw:
            token, payload = unstamp(v)
            if self._observe(token):
                continue  # stale entry: invisible, like a miss
            out.append((k, payload))
        return out

    def blocking_key_value_get(self, key: str, timeout_ms: int):
        self._pre_op()
        if faults.ACTIVE and faults.inject("kv.get", detail=key):
            self._recheck = True
            self._lease_check()
            raise TimeoutError(f"{key} (dropped by fault injection)")
        try:
            raw = self._kv.blocking_key_value_get(key, timeout_ms)
        except Exception as e:
            if kv_retryable(e):
                self._recheck = True
                self._lease_check()
            else:
                self._touch_lease()
            raise
        self._touch_lease()
        token, payload = unstamp(raw)
        if self._observe(token):
            raise TimeoutError(f"{key} (fenced stale write rejected)")
        return payload


def fenced_kv(client, rank: int = 0,
              policy: Optional[RetryPolicy] = None, **kwargs):
    """Wrap ``client`` (idempotently) in :class:`FencedKV`.

    A plain :class:`ResilientKV` is re-wrapped around its inner client
    (fencing subsumes resilience); ``HVTPU_KV_FENCE_DISABLE=1`` falls
    back to :func:`resilient_kv` for bisection/escape-hatch use.
    """
    if client is None or isinstance(client, FencedKV):
        return client
    if os.environ.get("HVTPU_KV_FENCE_DISABLE", "").lower() in (
            "1", "true", "on"):
        return resilient_kv(client, rank=rank, policy=policy)
    if isinstance(client, ResilientKV):
        client = client._kv
    return FencedKV(client, rank=rank, policy=policy, **kwargs)

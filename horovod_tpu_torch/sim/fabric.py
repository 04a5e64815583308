"""In-memory coordination-KV fabric with per-link latency models.

The port's control plane talks to its coordination store through a
tiny client surface (``core/kv.py``'s ``StoreKV``, the names of the JAX
coordination client) — ``key_value_set`` / ``blocking_key_value_get`` /
``key_value_try_get`` / ``key_value_delete`` / ``key_value_dir_get``,
plus the raw-bytes extensions.  Every component routes through that
surface (ResilientKV, FencedKV, the stall inspector, the drain
coordinator, the audit exchange, the wire consensus; the controller's
blobs through :mod:`.transport`), so substituting it is enough to host
the WHOLE plane on the simulator: no mocks of framework logic.

:class:`SimFabric` is the central store; :meth:`SimFabric.client`
returns a per-rank client facade whose every operation

1. parks the calling task for the rank's *request* link delay
   (latency + payload/bandwidth + seeded jitter),
2. applies the operation to the store at the virtual arrival instant
   (writes wake parked blocking gets immediately — the coordination
   service's watch semantics), and
3. parks again for the *response* leg before returning.

Timeout semantics match the production client: a blocking get that
expires raises ``TimeoutError`` with a ``DEADLINE_EXCEEDED`` marker
(what ``core/retry.py`` classifies as retryable), a ``try_get`` miss
raises ``KeyError`` with ``NOT_FOUND`` (an *answer*, not a transient),
and a delete with a trailing ``/`` clears the whole prefix (the
directory-GC idiom KVTransport uses between lockstep cycles).

Capability tiers mirror the client zoo the framework already handles:
``caps="str"`` is the minimal legacy surface, ``"dir"`` adds
``key_value_dir_get`` (what unlocks the amortized stall inspector and
single-RPC request gathers), ``"bytes"`` adds the raw-bytes triple
(what KVTransport's base64-free fast path detects).  Scenarios pick a
tier to run the same protocol over each capability level.

Chaos does NOT live here: ``kv.get`` / ``kv.put`` fault clauses fire
at the REAL injection sites inside ResilientKV and KVTransport, so an
injected brownout exercises the production retry/backoff code, not a
simulator re-implementation.  The fabric's own knobs
(``HVTPU_SIM_LATENCY_US``, ``HVTPU_SIM_BANDWIDTH_GBPS``,
``HVTPU_SIM_JITTER_FRAC``) shape the *healthy* network instead.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional, Tuple

from .kernel import SimKernel, WaitToken

__all__ = ["LinkModel", "EdgeModel", "SimFabric"]


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be a number, got {raw!r}") from None


class LinkModel:
    """One rank's link to the coordination service: fixed latency plus
    payload serialisation time plus seeded jitter."""

    __slots__ = ("latency_s", "bandwidth_bps", "jitter_frac", "_rng")

    def __init__(self, latency_s: float, bandwidth_bps: float,
                 jitter_frac: float, rng):
        self.latency_s = max(0.0, float(latency_s))
        self.bandwidth_bps = max(1.0, float(bandwidth_bps))
        self.jitter_frac = max(0.0, float(jitter_frac))
        self._rng = rng

    def delay(self, nbytes: int) -> float:
        base = self.latency_s + nbytes / self.bandwidth_bps
        if not self.jitter_frac:
            return base
        return base * (1.0 + self.jitter_frac * self._rng.random())


class EdgeModel:
    """One directed DATA-plane edge ``src → dst`` between ranks.

    Where :class:`LinkModel` shapes a rank's path to the coordination
    service, an edge shapes the peer-to-peer wire the ring collectives
    ride (the ``lossy-link`` scenario's hop model).  On top of the
    latency/bandwidth/jitter triple it carries a seeded per-send loss
    probability and an optional periodic FLAP window during which the
    edge drops everything — the two failure shapes "Demystifying NCCL"
    reports from production fabrics."""

    __slots__ = ("latency_s", "bandwidth_bps", "jitter_frac",
                 "loss_prob", "flap_period_s", "flap_down_s",
                 "flap_start_s", "_rng")

    def __init__(self, latency_s: float, bandwidth_bps: float,
                 jitter_frac: float, rng, loss_prob: float = 0.0,
                 flap_period_s: float = 0.0, flap_down_s: float = 0.0,
                 flap_start_s: float = 0.0):
        self.latency_s = max(0.0, float(latency_s))
        self.bandwidth_bps = max(1.0, float(bandwidth_bps))
        self.jitter_frac = max(0.0, float(jitter_frac))
        self.loss_prob = min(1.0, max(0.0, float(loss_prob)))
        self.flap_period_s = max(0.0, float(flap_period_s))
        self.flap_down_s = max(0.0, float(flap_down_s))
        self.flap_start_s = max(0.0, float(flap_start_s))
        self._rng = rng

    def delay(self, nbytes: int) -> float:
        base = self.latency_s + nbytes / self.bandwidth_bps
        if not self.jitter_frac:
            return base
        return base * (1.0 + self.jitter_frac * self._rng.random())

    def up(self, now: float) -> bool:
        """False while inside a flap's down window (the first
        ``flap_down_s`` of each period, starting at ``flap_start_s``)."""
        if self.flap_period_s <= 0.0 or now < self.flap_start_s:
            return True
        phase = (now - self.flap_start_s) % self.flap_period_s
        return phase >= self.flap_down_s

    def lost(self, now: float) -> bool:
        """One send's fate at virtual instant ``now``: dropped by the
        flap window, or by the seeded per-send loss draw."""
        if not self.up(now):
            return True
        return bool(self.loss_prob
                    and self._rng.random() < self.loss_prob)


class SimFabric:
    """The simulated coordination service: one store, per-rank links,
    park-and-notify blocking gets, and operation counters."""

    def __init__(self, kernel: SimKernel, *,
                 latency_us: Optional[float] = None,
                 bandwidth_gbps: Optional[float] = None,
                 jitter_frac: Optional[float] = None):
        self.kernel = kernel
        if latency_us is None:
            latency_us = _env_float("HVTPU_SIM_LATENCY_US", 50.0)
        if bandwidth_gbps is None:
            bandwidth_gbps = _env_float("HVTPU_SIM_BANDWIDTH_GBPS", 1.0)
        if jitter_frac is None:
            jitter_frac = _env_float("HVTPU_SIM_JITTER_FRAC", 0.1)
        self._latency_s = latency_us / 1e6
        self._bandwidth_bps = bandwidth_gbps * 1e9 / 8.0
        self._jitter_frac = jitter_frac
        self._store: Dict[str, object] = {}
        self._waiters: Dict[str, List[WaitToken]] = {}
        self._links: Dict[int, LinkModel] = {}
        self._edges: Dict[Tuple[int, int], EdgeModel] = {}
        self._down = False
        self.ops = collections.Counter()

    # -- outage ---------------------------------------------------------
    def set_down(self, down: bool = True) -> None:
        """Coordinator outage switch: while down, every server-side
        operation spends its request-leg delay and then raises an
        ``UNAVAILABLE``-marked error (what ``core/retry.py`` classifies
        as retryable) instead of touching the store.  Models the
        coordinator HOST dying — clients keep timing out until the
        driver relaunches against a fresh fabric."""
        self._down = bool(down)

    @property
    def down(self) -> bool:
        return self._down

    def _check_up(self, key: str) -> None:
        if self._down:
            self.ops["unavailable"] += 1
            raise ConnectionError(
                f"UNAVAILABLE: coordination service unreachable "
                f"({key!r})")

    # -- links ----------------------------------------------------------
    def link(self, rank: int) -> LinkModel:
        model = self._links.get(rank)
        if model is None:
            model = LinkModel(
                self._latency_s, self._bandwidth_bps, self._jitter_frac,
                self.kernel.rng(f"link/{rank}"))
            self._links[rank] = model
        return model

    def set_link(self, rank: int, *, latency_s: Optional[float] = None,
                 bandwidth_bps: Optional[float] = None,
                 jitter_frac: Optional[float] = None) -> LinkModel:
        """Override one rank's link (straggler / brownout shaping)."""
        base = self.link(rank)
        self._links[rank] = LinkModel(
            base.latency_s if latency_s is None else latency_s,
            base.bandwidth_bps if bandwidth_bps is None else bandwidth_bps,
            base.jitter_frac if jitter_frac is None else jitter_frac,
            self.kernel.rng(f"link/{rank}"))
        return self._links[rank]

    # -- data-plane edges ----------------------------------------------
    def edge(self, src: int, dst: int) -> EdgeModel:
        model = self._edges.get((src, dst))
        if model is None:
            model = EdgeModel(
                self._latency_s, self._bandwidth_bps, self._jitter_frac,
                self.kernel.rng(f"edge/{src}/{dst}"))
            self._edges[(src, dst)] = model
        return model

    def set_edge(self, src: int, dst: int, *,
                 latency_s: Optional[float] = None,
                 bandwidth_bps: Optional[float] = None,
                 jitter_frac: Optional[float] = None,
                 loss_prob: Optional[float] = None) -> EdgeModel:
        """Override one directed edge (sick-link shaping); unset
        fields keep the edge's current values."""
        base = self.edge(src, dst)
        model = EdgeModel(
            base.latency_s if latency_s is None else latency_s,
            base.bandwidth_bps if bandwidth_bps is None
            else bandwidth_bps,
            base.jitter_frac if jitter_frac is None else jitter_frac,
            self.kernel.rng(f"edge/{src}/{dst}"),
            loss_prob=base.loss_prob if loss_prob is None else loss_prob,
            flap_period_s=base.flap_period_s,
            flap_down_s=base.flap_down_s,
            flap_start_s=base.flap_start_s)
        self._edges[(src, dst)] = model
        return model

    def flap(self, src: int, dst: int, *, period_s: float,
             down_s: float, start_s: float = 0.0) -> EdgeModel:
        """Make the edge flap: down for the first ``down_s`` of every
        ``period_s`` window, beginning at virtual time ``start_s``."""
        base = self.edge(src, dst)
        base.flap_period_s = max(0.0, float(period_s))
        base.flap_down_s = max(0.0, float(down_s))
        base.flap_start_s = max(0.0, float(start_s))
        return base

    def edge_up(self, src: int, dst: int) -> bool:
        return self.edge(src, dst).up(self.kernel.now)

    def edge_lost(self, src: int, dst: int) -> bool:
        """Decide one send's fate on the edge NOW (counts toward the
        fabric's op counters so scenarios can audit loss volume)."""
        lost = self.edge(src, dst).lost(self.kernel.now)
        if lost:
            self.ops["edge_lost"] += 1
        else:
            self.ops["edge_send"] += 1
        return lost

    def edge_delay(self, src: int, dst: int, nbytes: int) -> float:
        return self.edge(src, dst).delay(nbytes)

    # -- client facades -------------------------------------------------
    def client(self, rank: int, caps: str = "bytes"):
        """A per-rank client at capability tier ``caps`` ∈ {"str",
        "dir", "bytes"}."""
        if caps == "str":
            return _StrKV(self, rank)
        if caps == "dir":
            return _DirKV(self, rank)
        if caps == "bytes":
            return _BytesKV(self, rank)
        raise ValueError(
            f"caps must be 'str' | 'dir' | 'bytes', got {caps!r}")

    # -- server-side operations (called from facades) -------------------
    @staticmethod
    def _nbytes(value) -> int:
        return len(value) if isinstance(value, (bytes, bytearray, str)) \
            else 64

    def _put(self, rank: int, key: str, value) -> None:
        link = self.link(rank)
        self.kernel.sleep(link.delay(self._nbytes(value)))
        self._check_up(key)
        self.ops["put"] += 1
        self._store[key] = value
        for token in self._waiters.pop(key, []):
            # capture the value at notification time: the key may be
            # deleted again before the waiter's resume event fires
            self.kernel.notify(token, value=value)
        self.kernel.sleep(link.delay(1))

    def _delete(self, rank: int, key: str) -> None:
        link = self.link(rank)
        self.kernel.sleep(link.delay(len(key)))
        self._check_up(key)
        self.ops["delete"] += 1
        if key.endswith("/"):
            for k in [k for k in self._store if k.startswith(key)]:
                del self._store[k]
        else:
            self._store.pop(key, None)
        self.kernel.sleep(link.delay(1))

    def _try_get(self, rank: int, key: str):
        link = self.link(rank)
        self.kernel.sleep(link.delay(len(key)))
        self._check_up(key)
        self.ops["get"] += 1
        if key not in self._store:
            self.kernel.sleep(link.delay(1))
            raise KeyError(f"NOT_FOUND: {key}")
        value = self._store[key]
        self.kernel.sleep(link.delay(self._nbytes(value)))
        return value

    def _blocking_get(self, rank: int, key: str, timeout_ms: int):
        link = self.link(rank)
        self.kernel.sleep(link.delay(len(key)))
        self._check_up(key)
        self.ops["get"] += 1
        if key in self._store:
            value = self._store[key]
        else:
            token = WaitToken()
            self._waiters.setdefault(key, []).append(token)
            ok = self.kernel.block(
                token, max(0.0, timeout_ms) / 1000.0,
                f"kv.blocking_get({key})")
            if not ok:
                waiting = self._waiters.get(key)
                if waiting is not None:
                    try:
                        waiting.remove(token)
                    except ValueError:
                        pass
                    if not waiting:
                        del self._waiters[key]
                self.ops["get_timeout"] += 1
                raise TimeoutError(
                    f"DEADLINE_EXCEEDED: key {key!r} not posted within "
                    f"{timeout_ms}ms")
            value = token.value
        self.kernel.sleep(link.delay(self._nbytes(value)))
        return value

    def _dir_get(self, rank: int, prefix: str) -> List[Tuple[str, object]]:
        link = self.link(rank)
        self.kernel.sleep(link.delay(len(prefix)))
        self._check_up(prefix)
        self.ops["dir_get"] += 1
        items = [(k, self._store[k])
                 for k in sorted(self._store) if k.startswith(prefix)]
        payload = sum(self._nbytes(v) for _k, v in items) or 1
        self.kernel.sleep(link.delay(payload))
        return items


class _StrKV:
    """Minimal legacy client surface (string values only)."""

    def __init__(self, fabric: SimFabric, rank: int):
        self._fabric = fabric
        self.rank = rank

    def key_value_set(self, key: str, value: str) -> None:
        self._fabric._put(self.rank, key, value)

    def blocking_key_value_get(self, key: str, timeout_ms: int):
        return self._fabric._blocking_get(self.rank, key, timeout_ms)

    def key_value_try_get(self, key: str):
        return self._fabric._try_get(self.rank, key)

    def key_value_delete(self, key: str) -> None:
        self._fabric._delete(self.rank, key)


class _DirKV(_StrKV):
    """Adds the directory read (amortized stall inspector, single-RPC
    request gathers, drain-notice scans).  It returns every key under a
    prefix however deep, as the JAX coordination service does
    (``nested_dir_get``); the port's ``StoreKV`` reads flat prefixes."""

    nested_dir_get = True

    def key_value_dir_get(self, prefix: str):
        return self._fabric._dir_get(self.rank, prefix)


class _BytesKV(_DirKV):
    """Adds the raw-bytes triple (KVTransport's base64-free path)."""

    def key_value_set_bytes(self, key: str, value: bytes) -> None:
        self._fabric._put(self.rank, key, bytes(value))

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int):
        return self._fabric._blocking_get(self.rank, key, timeout_ms)

    def key_value_dir_get_bytes(self, prefix: str):
        return self._fabric._dir_get(self.rank, prefix)

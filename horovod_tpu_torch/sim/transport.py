"""The negotiation transport over a coordination-KV client.

The port's :class:`~horovod_tpu_torch.eager.controller.KVTransport`
talks to a ``torch.distributed`` store: it probes each rank's key with
``check`` and sleeps on the host clock between probes.  The fabric
simulator has no store; its ranks reach the coordination service
through the client surface of ``core/kv.py`` (``key_value_set`` /
``blocking_key_value_get`` / ``key_value_dir_get`` and the raw-bytes
triple), as the JAX coordination service's clients do.
:class:`ClientTransport` carries the controller's request and response
blobs over that surface with the reference's key layout and op pattern
(``horovod_tpu/eager/controller.py`` ``KVTransport``): one blocking get
a key, one directory read a gather, one directory delete a cycle's GC,
and the clock seam (``core/clock.py``) for every deadline and backoff.
That is what makes a simulated negotiation cost the same virtual time,
and log the same events, in both packages.  Everything above the
transport (the negotiation core, the drainer, the coordinator's
service, prediction, the executor) is the port's controller.
"""

from __future__ import annotations

import base64
import threading
from typing import Dict, List, Optional, Tuple

from ..core import clock
from ..core import faults
from ..core import retry as core_retry
from ..eager.controller import TransportClosed
from ..obs import metrics as obs_metrics

__all__ = ["ClientTransport"]


class ClientTransport:
    """Coordination blobs over a coordination-KV client (lockstep
    ``exchange`` and the streamed plane's post / fetch / poll / GC)."""

    supports_streaming = True

    def __init__(self, rank: int, size: int, client,
                 timeout_s: float = 600.0, namespace: str = "hvt_eager",
                 poll_s: float = 1.0):
        self._kv = client
        self.rank = rank
        self.size = size
        self.timeout_ms = int(timeout_s * 1000)
        self.ns = namespace
        # blocking gets are cut into polls of poll_s so close() ends a
        # wait promptly (the service has no cancellable get)
        self.poll_s = poll_s
        self._closed = threading.Event()
        # raw-bytes client: no base64 on the wire
        self._bytes = all(
            hasattr(client, m) for m in
            ("key_value_set_bytes", "blocking_key_value_get_bytes",
             "key_value_dir_get_bytes"))
        # one directory read gathers every posted request blob
        self._dir = self._bytes or hasattr(client, "key_value_dir_get")
        # transient blips (and injected kv.put faults) retry with backoff
        self._put_policy = core_retry.kv_policy()

    def _set(self, key: str, blob: bytes):
        def _put():
            if faults.ACTIVE and faults.inject("kv.put", detail=key):
                return  # dropped writes stay dropped (peer times out)
            if self._bytes:
                self._kv.key_value_set_bytes(key, blob)
            else:
                self._kv.key_value_set(key, base64.b64encode(blob).decode())

        core_retry.call(
            self._put_policy, _put,
            on_retry=lambda a, e: obs_metrics.counter(
                "hvtpu_kv_retries_total").inc())

    def _get(self, key: str, deadline_s: Optional[float] = None) -> bytes:
        deadline = clock.monotonic() + (
            self.timeout_ms / 1000.0 if deadline_s is None else deadline_s)
        poll_ms = max(1, int(min(self.poll_s,
                                 deadline_s if deadline_s else self.poll_s)
                             * 1000))
        while True:
            if self._closed.is_set():
                raise TransportClosed(key)
            try:
                if faults.ACTIVE and faults.inject("kv.get", detail=key):
                    # a dropped read is "not posted yet" this poll
                    raise TimeoutError(f"{key} (dropped by fault injection)")
                if self._bytes:
                    return bytes(
                        self._kv.blocking_key_value_get_bytes(key, poll_ms))
                val = self._kv.blocking_key_value_get(key, poll_ms)
                return base64.b64decode(val)
            except Exception as e:
                msg = str(e)
                if self._closed.is_set() or "CANCELLED" in msg:
                    raise TransportClosed(key) from None
                retryable = (isinstance(e, TimeoutError)
                             or "DEADLINE_EXCEEDED" in msg
                             or "NOT_FOUND" in msg
                             or core_retry.kv_retryable(e))
                if not retryable:
                    raise
                if clock.monotonic() > deadline:
                    raise TimeoutError(
                        f"coordination key {key!r} not posted within "
                        f"{self.timeout_ms / 1000.0:.0f}s") from None

    def _delete(self, key: str):
        try:
            self._kv.key_value_delete(key)
        except Exception:  # noqa: BLE001 — GC only, best effort
            pass

    def _dir_read(self, prefix: str):
        return (self._kv.key_value_dir_get_bytes(prefix) if self._bytes
                else self._kv.key_value_dir_get(prefix))

    def _decode(self, v) -> bytes:
        return bytes(v) if self._bytes else base64.b64decode(v)

    def _gather_requests(self, ctrl, cycle: int):
        """Coordinator-side gather of every rank's request blob for this
        cycle: one directory read a poll, blocking gets without one;
        ingested in rank order (decisions must not depend on arrival
        order)."""
        prefix = f"{self.ns}/c{cycle}/"
        if not self._dir:
            for r in range(self.size):
                ctrl.ingest(self._get(f"{prefix}r{r}"))
            return
        want = {f"{prefix}r{r}": r for r in range(self.size)}
        got: Dict[str, bytes] = {}
        deadline = clock.monotonic() + self.timeout_ms / 1000.0
        sleep = 0.0
        while True:
            if self._closed.is_set():
                raise TransportClosed(prefix)
            try:
                if faults.ACTIVE and faults.inject("kv.get", detail=prefix):
                    entries = []  # dropped directory read: empty poll
                else:
                    entries = self._dir_read(prefix)
            except Exception:
                entries = []
            for k, v in entries:
                if k in want and k not in got:
                    got[k] = self._decode(v)
            if len(got) == len(want):
                break
            if clock.monotonic() > deadline:
                missing = sorted(
                    r for k, r in want.items() if k not in got)
                raise TimeoutError(
                    f"request blobs for cycle {cycle} not posted "
                    f"within {self.timeout_ms / 1000.0:.0f}s "
                    f"(missing ranks {missing})")
            # fast first polls for a sub-ms skew, then back off to poll_s
            sleep = min(self.poll_s, sleep * 2 if sleep else 2e-4)
            clock.sleep(sleep)
        for r in range(self.size):
            ctrl.ingest(got[f"{prefix}r{r}"])

    def exchange(self, ctrl, cycle: int, request_blob: bytes) -> bytes:
        req_key = f"{self.ns}/c{cycle}/r{self.rank}"
        resp_key = f"{self.ns}/c{cycle}/resp"
        self._set(req_key, request_blob)
        if self.rank == 0:
            self._gather_requests(ctrl, cycle)
            resp = ctrl.compute_responses()
            self._set(resp_key, resp)
            # GC the previous cycle in one directory delete: every
            # rank's cycle-N blob proves it consumed cycle N-1
            if cycle > 0:
                self._delete(f"{self.ns}/c{cycle - 1}/")
            return resp
        return self._get(resp_key)

    # ---- the streamed plane ------------------------------------------

    def post_request(self, idx: int, blob: bytes):
        self._set(f"{self.ns}/q/{self.rank}/{idx}", blob)

    def post_response(self, idx: int, blob: bytes):
        self._set(f"{self.ns}/resp/{idx}", blob)

    def fetch_response(self, idx: int) -> Optional[bytes]:
        """Next ResponseList of the stream, or None when none came
        within ``poll_s``; TransportClosed on close()."""
        try:
            return self._get(f"{self.ns}/resp/{idx}", deadline_s=self.poll_s)
        except TimeoutError:
            return None

    def post_ack(self, idx: int):
        """Advertise the highest applied response index (GC input)."""
        self._set(f"{self.ns}/ack/{self.rank}", str(idx).encode())

    def poll_requests(self, next_idx: Dict[int, int]
                      ) -> List[Tuple[int, int, bytes]]:
        """Coordinator-side: newly posted request blobs in (rank, stream
        index) order, each consumed (deleted); ``next_idx`` is every
        rank's read cursor, updated in place."""
        prefix = f"{self.ns}/q/"
        found: Dict[Tuple[int, int], bytes] = {}
        if self._dir:
            try:
                if faults.ACTIVE and faults.inject("kv.get", detail=prefix):
                    entries = []
                else:
                    entries = self._dir_read(prefix)
            except Exception:
                entries = []
            for k, v in entries:
                parts = str(k).rsplit("/", 2)
                try:
                    r, i = int(parts[-2]), int(parts[-1])
                except (ValueError, IndexError):
                    continue
                found[(r, i)] = self._decode(v)
        else:
            for r in range(self.size):
                if r == self.rank:
                    continue
                i = next_idx.get(r, 0)
                while True:
                    try:
                        found[(r, i)] = self._get(
                            f"{prefix}{r}/{i}", deadline_s=0.01)
                    except TimeoutError:
                        break
                    i += 1
        out: List[Tuple[int, int, bytes]] = []
        for r in sorted({r for r, _ in found}):
            i = next_idx.get(r, 0)
            while (r, i) in found:
                out.append((r, i, found[(r, i)]))
                self._delete(f"{prefix}{r}/{i}")
                i += 1
            next_idx[r] = i
        return out

    def gc_responses(self, last_gc: int) -> int:
        """Delete the response-stream entries every other rank has acked
        past; returns the new GC floor (directory clients only)."""
        if not self._dir:
            return last_gc
        try:
            entries = self._dir_read(f"{self.ns}/ack/")
        except Exception:
            return last_gc
        acks = []
        for _k, v in entries:
            try:
                acks.append(int(self._decode(v).decode()))
            except (ValueError, UnicodeDecodeError):
                continue
        if len(acks) < self.size - 1:
            return last_gc  # some rank has never acked yet
        floor = min(acks)
        for i in range(last_gc, floor):
            self._delete(f"{self.ns}/resp/{i}")
        return max(last_gc, floor)

    def close(self):
        self._closed.set()

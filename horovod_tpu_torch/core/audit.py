"""Parameter divergence audit: prove replicas are actually identical.

Counterpart of ``horovod_tpu/core/audit.py``.  Data-parallel training
assumes every rank holds byte-identical parameters and optimizer state
after each step; this module verifies it:

- :func:`digest_tree` hashes a tree per rank: tensors and arrays by
  numpy dtype name, shape and raw bytes; other leaves by ``repr``.  The
  port walks dicts (``state_dict``s included), lists, tuples and
  namedtuples itself, skips ``None`` as ``jax.tree_util`` does, and
  names each leaf by the path ``jax.tree_util.keystr`` would print
  (``['model']['fc.weight']``), so a tensor and the numpy array it was
  made from give the same digest under the same name in both packages.
  A bfloat16 tensor is hashed through an ``int16`` view under the name
  ``bfloat16``.
- :func:`verify` allgathers the digests over the coordination client
  (``core/kv.py``'s ``StoreKV`` under ``core/retry.py``'s resilient
  wrapper) and, on mismatch, produces a per-tensor report naming the
  divergent ranks.
- :func:`maybe_audit` runs :func:`verify` every ``HVTPU_AUDIT_EVERY``
  steps (0 = disabled, the default).

Action on divergence (``HVTPU_AUDIT_ACTION``): ``abort`` (default)
raises :class:`~horovod_tpu_torch.core.exceptions.HvtpuDivergenceError`
(a ``HorovodInternalError``), so an elastic training loop rolls back to
the last commit and the world is relaunched; ``warn`` logs the report.

COLLECTIVE contract: every member rank calls :func:`verify` (or
:func:`maybe_audit` with the same step counter) the same number of
times; each call consumes a fresh per-label sequence number.  A world
of one degrades to a trivially clean local report.

Metrics: ``hvtpu_audit_runs_total`` / ``hvtpu_audit_divergences_total``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import clock
from ..obs import flight
from ..obs import metrics as obs_metrics
from .exceptions import HvtpuDivergenceError

logger = logging.getLogger("horovod_tpu_torch")

_M_RUNS = obs_metrics.counter(
    "hvtpu_audit_runs_total",
    "Parameter divergence audits completed (clean or not).")
_M_DIVERGENCES = obs_metrics.counter(
    "hvtpu_audit_divergences_total",
    "Audits that found at least one tensor diverged across ranks.")

_NS = "hvtaudit"
_seq: Dict[Tuple[int, int, str], int] = {}
_seq_lock = threading.Lock()


def audit_every() -> int:
    """The periodic audit cadence (``HVTPU_AUDIT_EVERY``; 0 = off)."""
    try:
        return int(os.environ.get("HVTPU_AUDIT_EVERY", "0") or 0)
    except ValueError:
        raise ValueError(
            "HVTPU_AUDIT_EVERY must be an integer number of steps, got "
            f"{os.environ.get('HVTPU_AUDIT_EVERY')!r}") from None


def audit_action() -> str:
    """Divergence action (``HVTPU_AUDIT_ACTION``): abort | warn."""
    v = os.environ.get("HVTPU_AUDIT_ACTION", "abort").strip().lower()
    if v in ("", "abort"):
        return "abort"
    if v == "warn":
        return "warn"
    raise ValueError(
        f"HVTPU_AUDIT_ACTION must be 'abort' or 'warn', got {v!r}")


def _tensor_numpy(t: torch.Tensor):
    """``(numpy dtype name, array)`` of a tensor's bytes on the host:
    bfloat16, which numpy lacks, goes through an ``int16`` view of the
    same bytes and keeps the name ``bfloat16``."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy()
    arr = t.numpy()
    return str(arr.dtype), arr


def _leaf_digest(leaf: Any) -> str:
    """Stable short digest of one leaf.

    Tensors and arrays hash dtype + shape + raw bytes (pulled to the
    host: the audit is a periodic probe, not a hot path); everything
    else hashes its ``repr``, which is stable for the scalars and
    strings elastic state tracks."""
    h = hashlib.sha256()
    if isinstance(leaf, torch.Tensor):
        name, arr = _tensor_numpy(leaf)
        h.update(name.encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    elif hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    else:
        h.update(repr(leaf).encode())
    return h.hexdigest()[:16]


def _walk(node: Any, path: str, out: List[Tuple[str, Any]]) -> None:
    """Append ``(keystr path, leaf)`` of every leaf under ``node`` in
    ``jax.tree_util``'s order: dict keys sorted (an ``OrderedDict``
    keeps its order), ``None`` no leaf."""
    if node is None:
        return
    if isinstance(node, dict):
        keys = (list(node) if isinstance(node, collections.OrderedDict)
                else sorted(node))
        for k in keys:
            _walk(node[k], f"{path}[{k!r}]", out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            _walk(getattr(node, f), f"{path}.{f}", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}[{i}]", out)
    else:
        out.append((path, node))


def digest_tree(tree: Any) -> Dict[str, str]:
    """Per-leaf digests keyed by the ``keystr`` path."""
    leaves: List[Tuple[str, Any]] = []
    _walk(tree, "", leaves)
    return {path or "<root>": _leaf_digest(leaf) for path, leaf in leaves}


def _exchange(digests: Dict[str, str], label: str, st,
              timeout_s: float) -> Dict[int, Dict[str, str]]:
    """Allgather every rank's digest map over the process's store client
    (``StoreKV`` over the default group's store; mirrors
    ``obs.metrics.aggregate``'s sequence-numbered exchange)."""
    from . import retry as core_retry

    kv = core_retry.resilient_kv(st.kv, rank=st.rank)
    with _seq_lock:
        key = (st.init_generation, st.rank, label)
        seq = _seq.get(key, 0)
        _seq[key] = seq + 1
    prefix = f"{_NS}/{st.init_generation}/{label}/{seq}/"
    kv.key_value_set(prefix + str(st.rank), json.dumps(digests))

    per_rank: Dict[int, Dict[str, str]] = {st.rank: digests}
    deadline = clock.monotonic() + timeout_s
    for r in range(st.size):
        if r == st.rank:
            continue
        while True:
            remaining = deadline - clock.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"audit digests from rank {r} not posted within "
                    f"{timeout_s:.0f}s (label {label!r})")
            try:
                per_rank[r] = json.loads(kv.blocking_key_value_get(
                    prefix + str(r),
                    max(1, min(int(remaining * 1000), 2000))))
                break
            except Exception as e:  # not-posted-yet or transient blip
                if not core_retry.kv_blocking_retryable(e):
                    raise
    # rolling cleanup: every member posted seq, so nobody still needs
    # this rank's previous round
    if seq > 0:
        try:
            kv.key_value_delete(
                f"{_NS}/{st.init_generation}/{label}/{seq - 1}/"
                f"{st.rank}")
        except Exception:
            pass
    return per_rank


def _find_divergence(per_rank: Dict[int, Dict[str, str]]
                     ) -> Dict[str, Dict[int, str]]:
    """Per-tensor map of rank -> digest for every tensor whose digests
    are not unanimous; a tensor MISSING on some ranks (different tree
    structure) is divergence too, reported with digest '<absent>'."""
    names: List[str] = sorted(
        {n for d in per_rank.values() for n in d})
    divergent: Dict[str, Dict[int, str]] = {}
    for n in names:
        vals = {r: per_rank[r].get(n, "<absent>")
                for r in sorted(per_rank)}
        if len(set(vals.values())) > 1:
            divergent[n] = vals
    return divergent


def _majority_outliers(vals: Dict[int, str]) -> List[int]:
    """Ranks holding a minority digest (ties: the digest of the lowest
    rank wins, so 'rank 1 diverged from rank 0', never the reverse)."""
    counts = collections.Counter(vals.values())
    best = max(counts.values())
    candidates = [d for d, c in counts.items() if c == best]
    reference = next(d for r, d in sorted(vals.items())
                     if d in candidates)
    return [r for r, d in sorted(vals.items()) if d != reference]


def format_report(label: str, divergent: Dict[str, Dict[int, str]]) -> str:
    lines = [f"parameter divergence audit [{label}]: "
             f"{len(divergent)} tensor(s) differ across ranks"]
    for n, vals in divergent.items():
        outliers = _majority_outliers(vals)
        per = ", ".join(f"rank {r}={d}" for r, d in sorted(vals.items()))
        lines.append(f"  {n}: divergent ranks {outliers} ({per})")
    return "\n".join(lines)


def verify(tree: Any, label: str = "params", *, action: Optional[str] = None,
           timeout_s: float = 60.0) -> dict:
    """Audit ``tree`` across all ranks; returns the report dict
    ``{"label", "divergent": {tensor: {rank: digest}}, "ranks": [...]}``.

    COLLECTIVE: every rank must call with the same ``label`` at the
    same point.  ``action`` overrides ``HVTPU_AUDIT_ACTION``."""
    from . import state as core_state

    action = audit_action() if action is None else action
    if action not in ("abort", "warn"):
        raise ValueError(f"audit action must be abort|warn, got {action!r}")
    digests = digest_tree(tree)
    st = core_state.global_state()
    if not st.initialized or st.size <= 1:
        per_rank = {st.rank: digests}
    else:
        per_rank = _exchange(digests, label, st, timeout_s)
    divergent = _find_divergence(per_rank)
    _M_RUNS.inc()
    report = {
        "label": label,
        "divergent": divergent,
        "ranks": sorted({r for vals in divergent.values()
                         for r in _majority_outliers(vals)}),
    }
    if flight.ACTIVE:
        flight.note("audit", label=label, action=action,
                    divergent=len(divergent), ranks=report["ranks"])
    if divergent:
        _M_DIVERGENCES.inc()
        text = format_report(label, divergent)
        if action == "abort":
            flight.dump_postmortem("divergence", label=label,
                                   ranks=report["ranks"])
            raise HvtpuDivergenceError(text)
        logger.warning("%s", text)
    return report


def maybe_audit(tree: Any, step: int, label: str = "params",
                **kw) -> Optional[dict]:
    """Run :func:`verify` when ``step`` is a multiple of
    ``HVTPU_AUDIT_EVERY`` (>0); returns the report or None when not
    due.  ``step`` must advance identically on every rank (the usual
    SPMD step counter), keeping the audit collective-safe."""
    n = audit_every()
    if n <= 0 or step % n != 0:
        return None
    return verify(tree, label=label, **kw)

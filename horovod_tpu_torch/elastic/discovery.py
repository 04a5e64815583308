"""Host discovery for elastic training (the port's copy of
``horovod_tpu/elastic/discovery.py``).

Parity surface: ``horovod/runner/elastic/discovery.py``
(``HostDiscoveryScript``, ``HostManager``) — a user-provided executable
prints the currently-available ``host:slots`` lines; the driver polls it
on an interval and reacts to diffs, maintaining a blacklist of hosts
that failed.

Departure from upstream: the reference blacklist is PERMANENT (a host
that strikes out never runs again, even after a reboot fixes it).
Here blacklisting is a **cooldown** with exponential re-admission —
strike ``k`` sidelines a host for ``base * 2**(k-1)`` seconds (capped),
after which it is probed again; a successful incarnation decays its
strike count.  A flaky-but-recovering host rejoins the world instead of
shrinking it forever, while a persistently bad host backs off toward
the cap and contributes almost no churn.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
from typing import Dict, List, Optional

from ..core import clock
from ..runner import hosts as hosts_mod

logger = logging.getLogger("horovod_tpu_torch")


class HostDiscoveryScript:
    """Runs the user's discovery script and parses its output (parity:
    HostDiscoveryScript.find_available_hosts_and_slots)."""

    def __init__(self, script: str, timeout: float = 30.0):
        self.script = script
        self.timeout = timeout

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.run(
            self.script, shell=True, capture_output=True, text=True,
            timeout=self.timeout,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"host discovery script failed ({out.returncode}): "
                f"{out.stderr.strip()[:500]}"
            )
        slots: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            hs = hosts_mod.parse_host_spec(line)
            for h in hs:
                slots[h.hostname] = slots.get(h.hostname, 0) + h.slots
        return slots


class _BlacklistEntry:
    __slots__ = ("strikes", "until")

    def __init__(self):
        self.strikes = 0
        self.until = 0.0


class HostManager:
    """Tracks current hosts, computes diffs, maintains the cooldown
    blacklist (parity: HostManager + the blacklist in
    horovod/runner/elastic/registration.py, with re-admission added —
    see the module docstring)."""

    def __init__(self, discovery: HostDiscoveryScript,
                 cooldown_base_s: Optional[float] = None,
                 cooldown_max_s: Optional[float] = None):
        self._discovery = discovery
        self.current: Dict[str, int] = {}
        self.last_found: Dict[str, int] = {}
        self._blacklist: Dict[str, _BlacklistEntry] = {}
        self.cooldown_base_s = (
            float(os.environ.get("HVTPU_BLACKLIST_COOLDOWN_SECONDS",
                                 "300"))
            if cooldown_base_s is None else cooldown_base_s)
        self.cooldown_max_s = (
            float(os.environ.get("HVTPU_BLACKLIST_COOLDOWN_MAX_SECONDS",
                                 "3600"))
            if cooldown_max_s is None else cooldown_max_s)

    # -- blacklist ------------------------------------------------------
    def blacklist_host(self, hostname: str,
                       now: Optional[float] = None) -> float:
        """Record a strike: sideline ``hostname`` for ``base *
        2**(strikes-1)`` seconds (capped) before it is probed again.
        Returns the cooldown applied."""
        now = clock.monotonic() if now is None else now
        entry = self._blacklist.setdefault(hostname, _BlacklistEntry())
        entry.strikes += 1
        cooldown = min(
            self.cooldown_max_s,
            self.cooldown_base_s * (2.0 ** (entry.strikes - 1)))
        entry.until = now + cooldown
        return cooldown

    def record_success(self, hostname: str) -> None:
        """Decay one strike after an incarnation where this host's
        workers all exited cleanly (done or reset-requested); at zero
        strikes the entry is forgotten entirely."""
        entry = self._blacklist.get(hostname)
        if entry is None:
            return
        entry.strikes -= 1
        if entry.strikes <= 0:
            del self._blacklist[hostname]

    def blacklisted_now(self, now: Optional[float] = None) -> List[str]:
        """Hosts currently inside a cooldown window."""
        now = clock.monotonic() if now is None else now
        return sorted(h for h, e in self._blacklist.items()
                      if e.until > now)

    def strikes(self, hostname: str) -> int:
        entry = self._blacklist.get(hostname)
        return entry.strikes if entry is not None else 0

    def next_readmission_s(self, now: Optional[float] = None
                           ) -> Optional[float]:
        """Seconds until the soonest cooldown expires, or None when no
        host is currently sidelined."""
        now = clock.monotonic() if now is None else now
        pending = [e.until - now for e in self._blacklist.values()
                   if e.until > now]
        return min(pending) if pending else None

    # -- blacklist-hint persistence ------------------------------------
    # The blacklist lives in driver memory; a driver restart (or a
    # coordinator-loss relaunch that rebuilds the driver's world view)
    # would otherwise forget which hosts were striking out and happily
    # re-elect a bad host as coordinator.  Hints persist strikes plus
    # REMAINING cooldown (``until`` is monotonic-clock relative, so the
    # absolute deadline cannot cross processes) to the elastic state
    # dir and merge conservatively on load (max of strikes/cooldowns).

    def save_hints(self, path: str,
                   now: Optional[float] = None) -> None:
        """Atomically persist the blacklist as restart-survivable
        hints; best-effort (a hint write failure must not fail the
        incarnation bookkeeping that triggered it)."""
        now = clock.monotonic() if now is None else now
        doc = {h: {"strikes": e.strikes,
                   "cooldown_remaining_s": max(0.0, e.until - now)}
               for h, e in sorted(self._blacklist.items())}
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            logger.warning("could not persist blacklist hints to %s",
                           path, exc_info=True)

    def load_hints(self, path: str,
                   now: Optional[float] = None) -> int:
        """Merge persisted hints into the live blacklist (strikes and
        remaining cooldowns take the max of disk vs memory).  Returns
        the number of hosts hinted; missing/corrupt files are zero."""
        now = clock.monotonic() if now is None else now
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return 0
        loaded = 0
        for hostname, hint in doc.items():
            try:
                strikes = int(hint["strikes"])
                remaining = float(hint.get("cooldown_remaining_s", 0.0))
            except (TypeError, KeyError, ValueError):
                continue
            entry = self._blacklist.setdefault(hostname,
                                               _BlacklistEntry())
            entry.strikes = max(entry.strikes, strikes)
            entry.until = max(entry.until, now + max(0.0, remaining))
            loaded += 1
        return loaded

    # -- discovery ------------------------------------------------------
    def refresh(self, now: Optional[float] = None) -> bool:
        """Poll discovery; returns True if the effective host set
        changed (additions, removals, or a cooldown expiring/engaging,
        after blacklist filtering)."""
        found = self._discovery.find_available_hosts_and_slots()
        self.last_found = dict(found)
        cooling = set(self.blacklisted_now(now))
        effective = {
            h: s for h, s in found.items() if h not in cooling
        }
        changed = effective != self.current
        self.current = effective
        return changed

    def exhausted(self, min_np: int,
                  now: Optional[float] = None) -> bool:
        """True when the last discovery succeeded yet EVERY discovered
        host is inside a cooldown window.  Unlike the old permanent
        blacklist this is no longer hopeless — the driver consults
        ``next_readmission_s`` to decide whether waiting out the
        soonest cooldown fits its deadline."""
        del min_np  # reserved for smarter policies
        if not self.last_found:
            return False
        cooling = set(self.blacklisted_now(now))
        return all(h in cooling for h in self.last_found)

    def available_slots(self) -> int:
        return sum(self.current.values())

    def host_spec(self) -> str:
        return ",".join(
            f"{h}:{s}" for h, s in sorted(self.current.items())
        )

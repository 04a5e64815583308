"""Per-virtual-rank context: seam wiring for one simulated rank.

Production runs one rank per process, so core/faults.py and
core/preempt.py keep module-global registries.  The simulator runs N
ranks in one process; each module grew a thread-local override
(``faults.use`` / ``preempt.use``) exactly for this.  RankContext owns
one rank's instances of those seams plus its exit plumbing:

- a :class:`~horovod_tpu_torch.core.faults.FaultRegistry` bound to this
  rank (clauses select on the VIRTUAL rank id, with per-rank seeded
  probability streams), whose ``kill`` action routes to
  :meth:`request_exit` instead of ``os._exit``;
- optionally a :class:`~horovod_tpu_torch.core.preempt._DrainCoordinator`
  with the watcher thread replaced by scenario-pumped
  ``_poll_once()`` calls on virtual time, ``shared_pending=False``
  (N coordinators must not share the module-global fast path), and
  the same exit seam;
- **exit semantics**: called on the rank's own task thread,
  ``request_exit`` raises :class:`~.kernel.VirtualExit` immediately
  (the kill-fault path — ``inject()`` runs inline in the rank's
  call stack); called from a scheduler-thread timer (the drain
  grace-expiry path), it only sets :attr:`exit_code`, which the
  worker loop checks between steps — mirroring how a real signal
  interrupts a process at the next safe point.

``activate()`` is a context manager the rank's task body wraps itself
in; it installs the thread-local seams on entry and uninstalls them on
exit (including the VirtualExit unwind), keeping ``faults.ACTIVE``
truthful across thousands of rank activations.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

from ..core import faults
from ..core import preempt
from .kernel import SimKernel, VirtualExit

__all__ = ["RankContext"]


class RankContext:
    """One virtual rank's seam bundle (faults, drain, exit)."""

    def __init__(self, kernel: SimKernel, rank: int, size: int, *,
                 fault_spec: str = "", generation: int = 0,
                 drain_client=None, drain_grace_s: float = 30.0,
                 with_drain: bool = False):
        self.kernel = kernel
        self.rank = rank
        self.size = size
        self.exit_code: Optional[int] = None
        self.registry: Optional[faults.FaultRegistry] = None
        if fault_spec:
            self.registry = faults.FaultRegistry(
                faults.parse_spec(fault_spec), rank=rank,
                seed=kernel.seed, exit_fn=self.request_exit)
        self.coordinator = None
        if with_drain:
            self.coordinator = preempt._DrainCoordinator(
                rank=rank, size=size, grace_s=drain_grace_s,
                notice_file=None, generation=generation,
                client=drain_client, start_watcher=False,
                shared_pending=False, exit_fn=self.request_exit)

    # -- exit seam ------------------------------------------------------
    def request_exit(self, code: int) -> None:
        """Virtual-process exit: immediate on the rank's own thread,
        deferred to the next worker-loop check otherwise."""
        task = self.kernel.current_task()
        if task is not None and task.thread is threading.current_thread():
            raise VirtualExit(code)
        if self.exit_code is None:
            self.exit_code = code

    def check_exit(self) -> None:
        """Worker-loop safe point: honour a deferred exit request."""
        if self.exit_code is not None:
            raise VirtualExit(self.exit_code)

    # -- seam installation ---------------------------------------------
    @contextlib.contextmanager
    def activate(self) -> Iterator["RankContext"]:
        """Install this rank's thread-local seams for the duration of
        the rank's task body (the task's clock seam is installed by the
        kernel itself)."""
        if self.registry is not None:
            faults.use(self.registry)
        if self.coordinator is not None:
            preempt.use(self.coordinator)
        try:
            yield self
        finally:
            if self.coordinator is not None:
                preempt.use(None)
            if self.registry is not None:
                faults.use(None)

"""Virtual-rank worker building blocks for the fabric simulator.

The scenarios (see :mod:`.scenarios`) compose these pieces:

- :class:`WorldView` — the rank/size/generation triple
  ``core/audit.py`` accepts as an injected world, so N virtual ranks
  can run the REAL digest-allgather in one process without touching
  ``core.state.global_state()``.

- :class:`SimElasticState` — a real
  :class:`~horovod_tpu_torch.elastic.state.ObjectState` whose durable half
  stays in memory (the production ``save()`` writes
  ``HVTPU_ELASTIC_STATE_DIR`` from global rank 0 — meaningless for N
  in-process ranks) and whose audit routes through the injected
  client/world.  Everything that matters to the scenarios —
  ``commit()`` bookkeeping, the drain-boundary agreement, the
  ``worker.step`` fault site, audit cadence — is the REAL
  ``State.commit`` code path, untouched.

- :func:`patch_data_plane` — stubs the eager DATA plane
  (``horovod_tpu_torch.comm.eager`` collectives and the controller's
  fused reduction) with identity functions.  The simulator's subject is
  the CONTROL plane; the data plane needs an initialized process group
  that cannot exist for 256 in-process ranks.  Negotiation, fusion
  grouping, caching, prediction, confirm hashes — all real; only the
  final tensor-moving call is a no-op.

- :func:`elect_and_assign` — the KV-based survivor re-rendezvous the
  rolling-preemption scenario uses between generations: survivors
  register under the NEW generation, the lowest surviving old rank
  computes the dense renumbering and posts the assignment, everyone
  else blocking-gets it.  This mirrors the restart-based elastic
  resize (driver relaunch + rank reassignment) at protocol level.
"""

from __future__ import annotations

import contextlib
import json
from typing import Dict, Iterator, List, Optional

from ..elastic.state import ObjectState

__all__ = [
    "SimElasticState",
    "WorldView",
    "elect_and_assign",
    "patch_data_plane",
]


class WorldView:
    """Injected world for core/audit.py: rank/size/init_generation,
    treated as initialized."""

    __slots__ = ("rank", "size", "init_generation")

    def __init__(self, rank: int, size: int, init_generation: int = 0):
        self.rank = rank
        self.size = size
        self.init_generation = init_generation


class SimElasticState(ObjectState):
    """ObjectState with in-memory durable commits and an injected
    audit world.  ``durable_commits`` counts what production would
    have written to the elastic state dir — the exactly-once
    drain-commit assertion reads it."""

    def __init__(self, client=None, world: Optional[WorldView] = None,
                 **kwargs):
        self._sim_client = client
        self._sim_world = world
        self.durable_commits = 0
        super().__init__(**kwargs)

    def save(self):
        self.save_to_memory()
        self.durable_commits += 1

    def audit(self, label: str = "elastic.state") -> Optional[dict]:
        from ..core import audit as core_audit

        if core_audit.audit_every() <= 0:
            return None
        return core_audit.verify(
            self._capture(), label,
            client=self._sim_client, world=self._sim_world)

    def sync(self):  # pragma: no cover — scenarios resync via audit
        self.save_to_memory()
        self._synced = True


def _identity(tensor, *args, **kwargs):
    return tensor


def _none(*args, **kwargs):
    return None


class _IdentityGroupReduction:
    """Stand-in for the optimizer's ``GroupReduction`` (the port's fused
    allreduce route): every tensor comes back as it went in."""

    def __init__(self, *args, **kwargs):
        pass

    def reduce(self, tensors, names=None):
        return list(tensors)


@contextlib.contextmanager
def patch_data_plane() -> Iterator[None]:
    """Replace the eager data-plane collectives with identity stubs for
    the duration of a scenario (restored on exit).  Process-wide, which
    is safe because every sim rank wants the same stub and no real
    collective can run in a sim process (no process group exists for
    256 in-process ranks).

    Stubbed: the collectives of ``comm/eager.py`` the executor calls
    (``allreduce`` ... ``barrier``), and the two places the port's fused
    allreduce reaches past them: its group reduction (the controller's
    ``GroupReduction``) and the zero-copy route's ``_reduce``, with the
    process-set lookup and the byte counters that need an initialized
    world.  The reference routes every fused group through
    ``comm.eager.allreduce``; the negotiation above is the same in
    both."""
    from ..comm import eager as eager_comm
    from ..eager import controller as eager_controller

    names = ("allreduce", "grouped_allreduce", "allgather", "broadcast",
             "alltoall", "reducescatter", "barrier")
    saved = {n: getattr(eager_comm, n) for n in names}
    inner = {"_reduce": _identity, "_resolve_process_set": _none,
             "count_collective": _none}
    saved_inner = {n: getattr(eager_comm, n) for n in inner}
    saved_group = eager_controller.GroupReduction
    for n in names:
        setattr(eager_comm, n, _none if n == "barrier" else _identity)
    for n, fn in inner.items():
        setattr(eager_comm, n, fn)
    eager_controller.GroupReduction = _IdentityGroupReduction
    try:
        yield
    finally:
        for n, fn in {**saved, **saved_inner}.items():
            setattr(eager_comm, n, fn)
        eager_controller.GroupReduction = saved_group


def elect_and_assign(kv, old_rank: int, survivors: List[int],
                     generation: int, timeout_ms: int = 600000
                     ) -> Dict[int, int]:
    """Survivor re-rendezvous after a membership change: every
    survivor posts its OLD rank under the new generation; the lowest
    surviving old rank computes the dense renumbering (sorted old
    ranks → 0..P'-1) and posts the assignment; everyone blocking-gets
    it.  Returns the full old-rank → new-rank map.

    ``survivors`` is each rank's *local expectation* of the surviving
    set (in production the driver recomputes it from discovery; the
    scenarios derive it from the departure events they injected), so
    the leader knows how many registrations to await.
    """
    ns = f"hvtsim_elect/{generation}"
    kv.key_value_set(f"{ns}/reg/{old_rank}", str(old_rank))
    leader = min(survivors)
    if old_rank == leader:
        got: Dict[int, int] = {}
        for r in survivors:
            got[int(kv.blocking_key_value_get(
                f"{ns}/reg/{r}", timeout_ms))] = 0
        assignment = {old: new for new, old in enumerate(sorted(got))}
        kv.key_value_set(
            f"{ns}/assign",
            json.dumps({str(k): v for k, v in assignment.items()}))
        return assignment
    raw = json.loads(kv.blocking_key_value_get(f"{ns}/assign",
                                               timeout_ms))
    return {int(k): v for k, v in raw.items()}

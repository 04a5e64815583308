"""Fabric simulator: the port's control plane at virtual scale.

Counterpart of ``horovod_tpu/sim``.  One process hosts 256-4096 virtual
ranks on a deterministic discrete-event kernel (virtual time, no real
sleeps); each rank runs the port's own control-plane code — eager
negotiation through the async controller, the drain coordination
protocol, rendezvous audits, heartbeat stall inspection, HostManager
blacklisting, the fleet arbiter — against an in-memory coordination KV
with per-link latency/bandwidth/jitter models, under chaos injected
through ``core/faults.py``.  Same seed ⇒ byte-identical event log, and
the same log as the reference's simulator for the same scenario, ranks
and seed.

Entry points: ``python -m horovod_tpu_torch.sim`` (CLI) and
:func:`~horovod_tpu_torch.sim.scenarios.run_scenario` (tests).  The
controller scenarios put their payloads and controllers on the card
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``).
"""

from .context import RankContext
from .fabric import LinkModel, SimFabric
from .kernel import (DeadlockError, SimKernel, SimTimeBudgetExceeded,
                     VirtualClock, VirtualExit, WaitToken)
from .scenarios import SCENARIOS, run_scenario
from .workers import (SimElasticState, WorldView, elect_and_assign,
                      patch_data_plane)

__all__ = [
    "DeadlockError",
    "LinkModel",
    "RankContext",
    "SCENARIOS",
    "SimElasticState",
    "SimFabric",
    "SimKernel",
    "SimTimeBudgetExceeded",
    "VirtualClock",
    "VirtualExit",
    "WaitToken",
    "WorldView",
    "elect_and_assign",
    "patch_data_plane",
    "run_scenario",
]

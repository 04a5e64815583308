"""The fleet: a multi-job resource arbiter over one elastic pool (the
port's copy of ``horovod_tpu/fleet``, importing nothing of it).

Gang scheduling (full min-world allocations only), priority preemption
through the graceful-drain channel (planned resizes, zero lost steps,
no restart-budget strikes), traffic-driven autoscaling hooks, and a
production front door: indexed journal intake with backpressure
(:mod:`.intake`), per-tenant quotas + weighted fair share + the
starvation guard (:mod:`.admission`), and topology-aware placement on
a virtual host torus (:mod:`.placement`).  The same specs, pool and
clock give the reference's decisions, events, ``state.json`` bytes and
journal bytes.  Jobs run under the port's elastic driver
(:mod:`.runner`); ``python -m horovod_tpu_torch.fleet`` is the CLI
(:mod:`.__main__`).
"""

from .admission import (AdmissionController, TenantConfigError,
                        TenantPolicy)
from .arbiter import FleetArbiter
from .autoscale import Autoscaler, FileSignal
from .intake import QueueFullError, SubmitJournal
from .job import (DONE, DRAINING, FAILED, FleetSpecError, Job, JobSpec,
                  PENDING, RESIZING, RUNNING, STATES, prefixed_client)
from .placement import PlacementPolicy, TorusGrid
from .runner import AllocationDiscovery, ElasticJobRunner

__all__ = [
    "FleetArbiter",
    "AdmissionController",
    "TenantConfigError",
    "TenantPolicy",
    "SubmitJournal",
    "QueueFullError",
    "PlacementPolicy",
    "TorusGrid",
    "Autoscaler",
    "FileSignal",
    "FleetSpecError",
    "Job",
    "JobSpec",
    "prefixed_client",
    "AllocationDiscovery",
    "ElasticJobRunner",
    "STATES",
    "PENDING",
    "RUNNING",
    "DRAINING",
    "RESIZING",
    "DONE",
    "FAILED",
]

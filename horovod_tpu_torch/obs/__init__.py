"""Observability planes of the PyTorch port (counterpart of
``horovod_tpu/obs``): the metrics registry and its HTTP endpoint, the
timeline, cross-rank tracing, the flight recorder, anomaly detection,
the device-trace reader and the step profiler.

The autotuner (``horovod_tpu/obs/autotune.py``, ``gaussian_process.py``)
is not ported yet: it calls the native negotiation core, which comes
with it.
"""

from . import anomaly
from . import flight
from . import metrics
from . import profile
from . import stepprof
from . import timeline
from . import tracing
from .metrics import REGISTRY as metrics_registry
from .profile import (device_time_ms, load_profile, op_summary,
                      plane_names, trace)
from .timeline import Timeline, start_torch_profiler, stop_torch_profiler

__all__ = [
    "Timeline",
    "start_torch_profiler",
    "stop_torch_profiler",
    # device-trace profiling (obs/profile.py)
    "profile",
    "trace",
    "op_summary",
    "device_time_ms",
    "plane_names",
    "load_profile",
    # step-level overlap profiler (obs/stepprof.py)
    "stepprof",
    # flight recorder + postmortems (obs/flight.py)
    "flight",
    # online anomaly detection + incidents (obs/anomaly.py)
    "anomaly",
    # cross-rank tracing (obs/tracing.py)
    "tracing",
    "timeline",
    # metrics registry + Prometheus exposition (obs/metrics.py)
    "metrics",
    "metrics_registry",
]

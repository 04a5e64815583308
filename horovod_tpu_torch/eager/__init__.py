"""The async controller of the PyTorch port (counterpart of
``horovod_tpu/eager``).

Ranks may submit async collectives in any order; the controller
negotiates a globally agreed, deterministically fused schedule (parity:
BackgroundThreadLoop + Controller::ComputeResponseList) — in lockstep
cycles at one rank, over the streamed plane with schedule prediction
past one — and executes it over ``torch.distributed``.
"""

from __future__ import annotations

import threading

from ..core import state as core_state
from .controller import (
    EagerController,
    KVTransport,
    LocalTransport,
    OpFuture,
)

_init_lock = threading.Lock()


def get_controller() -> EagerController:
    """The process-wide controller, started lazily on first use (parity:
    InitializeHorovodOnce starting the background thread), with the
    process sets of the table and the state's timeline.  Thread-safe: concurrent first calls
    create exactly one controller."""
    st = core_state.require_init("async collectives")
    if st.controller is not None:
        return st.controller
    with _init_lock:
        if st.controller is None:
            cfg = st.config
            process_sets = {psid: list(ps.ranks) for psid, ps
                            in st.process_set_table.items().items()}
            controller = EagerController(
                st.rank, st.size,
                cycle_time_ms=cfg.cycle_time_ms,
                fusion_threshold=cfg.fusion_threshold_bytes,
                cache_capacity=cfg.cache_capacity,
                stall_warn_s=(float("inf") if cfg.stall_check_disable
                              else cfg.stall_check_time_seconds),
                stall_abort_s=cfg.stall_shutdown_time_seconds,
                process_sets=process_sets,
                device=st.device,
                timeline=st.timeline,
            )
            controller.start()
            st.controller = controller
    return st.controller


__all__ = [
    "EagerController", "OpFuture", "KVTransport", "LocalTransport",
    "get_controller",
]

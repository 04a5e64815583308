"""Build and runtime queries of the port (parity: ``horovod/common/
basics.py`` ``mpi_built`` / ``nccl_built`` / ...; counterpart of the
queries of ``horovod_tpu/__init__.py``).

Each returns the port's truth in the reference's type: a bool, or for
``nccl_built`` NCCL's version code (``major * 10000 + minor * 100 +
patch``, as ``NCCL_VERSION_CODE``) when torch was built with NCCL, else
0.  The port has no MPI, no DDL, no oneCCL and no XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def gloo_built() -> bool:
    return bool(dist.is_available() and dist.is_gloo_available())


def gloo_enabled() -> bool:
    """True when the running world uses gloo (``init()`` on the CPU);
    before ``init()``, whether gloo is built."""
    from . import state

    st = state.global_state()
    if st.initialized:
        return st.backend == "gloo"
    return gloo_built()


def nccl_built() -> int:
    if not (dist.is_available() and dist.is_nccl_available()):
        return 0
    version = torch.cuda.nccl.version()
    if isinstance(version, int):
        return version
    major, minor, patch = (tuple(version) + (0, 0, 0))[:3]
    return major * 10000 + minor * 100 + patch


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return bool(torch.backends.cuda.is_built())


def rocm_built() -> bool:
    return torch.version.hip is not None


def xla_built() -> bool:
    return False


def ici_built() -> bool:
    """The TPU's interconnect: never on this package's devices."""
    return False

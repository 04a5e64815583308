"""The public names of the port's TensorFlow and Keras frontends against
the JAX package's, module by module: ``tensorflow``, ``keras``,
``tensorflow.keras``, their ``callbacks`` and ``elastic`` modules and the
shared ``_keras`` implementation.  Every name of the reference's
``__all__`` and every public attribute is the port's too (the missing
set is empty), and the surface names are the port's root's.
"""

import importlib

import pytest

pytest.importorskip("tensorflow")
pytest.importorskip("keras")

import horovod_tpu_torch  # noqa: E402
from torch_port_util import no_leaked_reference  # noqa: E402,F401

MODULES = ["tensorflow", "keras", "tensorflow.keras", "tensorflow.elastic",
           "keras.callbacks", "keras.elastic", "tensorflow.keras.callbacks",
           "tensorflow.keras.elastic", "_keras", "_keras.callbacks"]

# public names of a reference module that the port's lacks, and why
MISSING = {}


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("sub", MODULES)
def test_every_reference_name_is_the_ports(sub):
    ref = importlib.import_module(f"horovod_tpu.{sub}")
    port = importlib.import_module(f"horovod_tpu_torch.{sub}")
    assert _public(ref) - _public(port) == MISSING.get(sub, set())
    ref_all = getattr(ref, "__all__", None)
    assert getattr(port, "__all__", None) == ref_all
    for name in ref_all or ():
        assert hasattr(port, name), name


ROOT_NAMES = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "mpi_enabled", "mpi_built",
    "mpi_threads_supported", "gloo_enabled", "gloo_built", "nccl_built",
    "ddl_built", "ccl_built", "cuda_built", "rocm_built", "xla_built",
    "start_timeline", "stop_timeline", "ProcessSet", "add_process_set",
    "remove_process_set", "HorovodInternalError", "HostsUpdatedInterrupt",
    "is_homogeneous", "Sum", "Average", "Adasum", "Min", "Max", "Product",
]


@pytest.mark.parametrize("name", ROOT_NAMES)
def test_surface_names_are_the_roots(name):
    import horovod_tpu_torch.keras as port_keras
    import horovod_tpu_torch.tensorflow as port_tf
    import horovod_tpu_torch.tensorflow.keras as port_tfk

    want = getattr(horovod_tpu_torch, name)
    assert getattr(port_tf, name) is want
    if hasattr(importlib.import_module("horovod_tpu.keras"), name):
        assert getattr(port_keras, name) is want
        assert getattr(port_tfk, name) is want


def test_global_process_set_is_forwarded_and_others_raise():
    import horovod_tpu_torch.tensorflow as port_tf

    assert port_tf.global_process_set is horovod_tpu_torch.global_process_set
    assert not hasattr(port_tf, "no_such_name")

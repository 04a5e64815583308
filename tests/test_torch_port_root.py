"""The package root's public names against the JAX package's root.

``horovod_tpu_torch``'s root is the torch surface (``hvd``) plus the
reference root's other names.  Every name of ``horovod_tpu.__all__`` is
in ``horovod_tpu_torch.__all__`` and resolves, but for the deliberate
exceptions below, each with its reason.
"""

import pytest

import horovod_tpu as ref
import horovod_tpu_torch as port
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

# names of the reference's root that the port's root lacks, and why
MISSING = {}
# names both roots have that are not the same thing, and why
DIFFERENT = {
    "Compression": "the torch frontend's codecs (none, fp16, bf16): the "
                   "root's ops are the torch surface's, which map every "
                   "other codec to none as the reference's torch surface "
                   "does, so a root int8 would send an uncompressed wire "
                   "without a word; the engine's codecs are "
                   "horovod_tpu_torch.comm.compression.Compression",
}


# names of the reference's models that the port's models lack, and why
MODELS_MISSING = {}


def test_every_reference_models_name_is_exported_but_the_exceptions():
    import horovod_tpu.models as ref_models
    import horovod_tpu_torch.models as port_models

    assert (set(ref_models.__all__) - set(port_models.__all__)
            == set(MODELS_MISSING))
    for name in port_models.__all__:
        assert hasattr(port_models, name), name
    assert len(port_models.__all__) == len(set(port_models.__all__))


def test_every_reference_root_name_is_exported_but_the_exceptions():
    assert set(ref.__all__) - set(port.__all__) == set(MISSING)
    for name in set(ref.__all__) - set(MISSING):
        assert hasattr(port, name), name
    assert len(port.__all__) == len(set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name


def test_the_different_compression_is_the_torch_frontends():
    from horovod_tpu_torch.comm.compression import Compression as Engine

    assert port.Compression is port.torch.Compression
    assert not hasattr(port.Compression, "int8")
    assert hasattr(ref.Compression, "int8") and hasattr(Engine, "int8")
    assert set(DIFFERENT) <= set(ref.__all__) & set(port.__all__)


@pytest.mark.parametrize("name,module", [
    ("Config", "horovod_tpu_torch.core.config"),
    ("HorovodTpuError", "horovod_tpu_torch.core.exceptions"),
    ("ReduceOp", "horovod_tpu_torch.comm.reduce_ops"),
    ("allreduce_gradients", "horovod_tpu_torch.api.optimizer"),
    ("ShardedDistributedOptimizer", "horovod_tpu_torch.api.optimizer"),
    ("world_mesh", "horovod_tpu_torch.core.state"),
    ("hierarchical_mesh", "horovod_tpu_torch.core.state"),
    ("mesh", "horovod_tpu_torch.core.state"),
    ("num_devices", "horovod_tpu_torch.core.state"),
    ("local_devices", "horovod_tpu_torch.core.state"),
    ("ici_built", "horovod_tpu_torch.core.basics"),
])
def test_the_new_names_are_the_modules_own(name, module):
    import importlib

    assert getattr(port, name) is getattr(importlib.import_module(module),
                                          name)


def test_modules_and_probes():
    import horovod_tpu_torch.comm.spmd
    import horovod_tpu_torch.data

    assert port.spmd is horovod_tpu_torch.comm.spmd
    assert port.data is horovod_tpu_torch.data
    assert port.ici_built() is False and port.xla_built() is False
    assert port.__version__ == ref.__version__
    assert issubclass(port.HorovodInternalError, port.HorovodTpuError)
    assert [op.name for op in port.ReduceOp] == \
        [op.name for op in ref.ReduceOp]

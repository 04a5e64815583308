"""The first slice of the PyTorch port against the JAX package's torch
frontend, on the CPU.

3 training steps of the narrow ResNet through the port's
``DistributedOptimizer`` (SGD momentum 0.9, predivide 2.0) against the
same model through ``horovod_tpu.torch.DistributedOptimizer`` with the
same settings, its Pallas kernels in interpret mode:

* compression none: parameters **bitwise** equal.  The scales 1/2 and
  2/1 are powers of two, exact in float32, so how the JAX controller
  groups tensors cannot change the result;
* compression fp16: parameters **bitwise** equal, and not equal to the
  run without compression, so the fp16 wire rounded them.  Both
  packages send a group of one tensor through the eager allreduce,
  which at world size 1 skips the fp16 wire, and cast every tensor of a
  larger group through fp16.  The port groups by its fixed bucket plan:
  the narrow ResNet's gradients fill one bucket.  The JAX controller
  groups whatever tensors are ready in a cycle, which depends on timing;
  its burst gate holds a cycle for the whole burst the optimizer
  declares, up to ``8 * HVTPU_CYCLE_TIME``.  A cycle time of
  ``GROUP_CYCLE_MS`` makes that wait outlast any backward, so the
  reference also sends every gradient of a step as one group.
  ``test_torch_port_comm.py`` holds the single-tensor groups bitwise.
"""

import copy

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from torch_port_util import narrow_resnet, synthetic_batches, train_steps
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

STEPS = 3
GROUP_CYCLE_MS = 5000     # the burst gate waits up to 8 x 5 s


@pytest.fixture
def port_cpu():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _ref_frontend(tmp_path, monkeypatch, **env):
    """The JAX package's torch frontend, Pallas kernels interpreted."""
    import horovod_tpu as hvt_mod
    import horovod_tpu.torch as ref_hvd

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HVTPU_PALLAS_INTERPRET", "1")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref_hvd.init()
    yield ref_hvd
    hvt_mod.shutdown()


@pytest.fixture
def ref_torch(tmp_path, monkeypatch):
    yield from _ref_frontend(tmp_path, monkeypatch)


@pytest.fixture
def ref_torch_one_group(tmp_path, monkeypatch):
    """The reference with a step's gradients in one group (docstring)."""
    yield from _ref_frontend(tmp_path, monkeypatch,
                             HVTPU_CYCLE_TIME=str(GROUP_CYCLE_MS))


def _pair(port_compression, ref_hvd, ref_compression):
    model = narrow_resnet(seed=0)
    ref_model = copy.deepcopy(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=port_compression, gradient_predivide_factor=2.0)
    ref_opt = ref_hvd.DistributedOptimizer(
        torch.optim.SGD(ref_model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=ref_model.named_parameters(),
        compression=ref_compression, gradient_predivide_factor=2.0)
    return model, opt, ref_model, ref_opt


def test_slice_bitwise_against_jax_torch_frontend(port_cpu, ref_torch):
    model, opt, ref_model, ref_opt = _pair(
        hvd.Compression.none, ref_torch, ref_torch.Compression.none)
    batches = synthetic_batches(STEPS)
    losses = train_steps(model, opt, batches)
    ref_losses = train_steps(ref_model, ref_opt, batches)
    assert losses == ref_losses
    ref_state = ref_model.state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(t, ref_state[name]), name
    assert all(np.isfinite(losses))


def test_slice_fp16_against_jax_torch_frontend(port_cpu,
                                              ref_torch_one_group):
    ref = ref_torch_one_group
    model, opt, ref_model, ref_opt = _pair(
        hvd.Compression.fp16, ref, ref.Compression.fp16)
    assert len(opt.buckets) == 1 and len(opt.buckets[0]) > 1
    plain = copy.deepcopy(model)
    plain_opt = torch.optim.SGD(plain.parameters(), lr=0.1, momentum=0.9)
    batches = synthetic_batches(STEPS)
    losses = train_steps(model, opt, batches)
    ref_losses = train_steps(ref_model, ref_opt, batches)
    train_steps(plain, plain_opt, batches)
    assert losses == ref_losses
    ref_state = ref_model.state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(t, ref_state[name]), name
    plain_params = dict(plain.named_parameters())
    rounded = [name for name, p in model.named_parameters()
               if not torch.equal(p, plain_params[name])]
    assert rounded, "the fp16 wire rounded no gradient"

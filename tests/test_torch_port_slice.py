"""The first slice of the PyTorch port as a whole, on the CPU.

* 3 steps against ``horovod_tpu.DistributedOptimizer(optax.sgd)`` on the
  eager path over the flax ResNet, weights carried across: losses and
  parameters rtol 1e-4 (float32 sums in another order).
* A 2-process gloo run of the port alone: different grads per rank,
  bitwise-equal reduced grads on both ranks, equal to the numpy mean.
* Optimizer contract, import hygiene and the device rule.

The comparison with the JAX package's torch frontend is in
``test_torch_port_frontend.py``.
"""

import ast
import copy
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import fused_scale_cast
from horovod_tpu_torch.weights import resnet_params_from_jax
from test_torch_port_resnet import make_narrow
from torch_port_util import (
    narrow_resnet,
    synthetic_batches,
    train_steps,
    two_rank_worker,
)
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
STEPS = 3


@pytest.fixture
def port_cpu():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture
def hvt_jax(tmp_path, monkeypatch):
    import horovod_tpu as hvt_mod

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    hvt_mod.init()
    yield hvt_mod
    hvt_mod.shutdown()


def test_slice_against_flax_optax(port_cpu, hvt_jax):
    # Batch 16: at lr 0.1 a batch of 8 makes the third step's loss jump,
    # and rounding differences grow past the tolerance.  The JAX side
    # runs op by op, as the eager optimizer path does: under jax.jit
    # XLA's fusions alone move the third loss by 1.5%.
    flax_model, variables, model, _, _ = make_narrow(32, seed=2)
    batches = synthetic_batches(STEPS, batch=16, seed=11)

    tx = hvt_jax.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                      gradient_predivide_factor=2.0)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    def loss_fn(p, s, x, y):
        logits, new = flax_model.apply({"params": p, "batch_stats": s}, x,
                                       train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, new["batch_stats"]

    jax_losses = []
    for x, y in batches:
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, jnp.asarray(x), jnp.asarray(y))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        jax_losses.append(float(loss))

    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        gradient_predivide_factor=2.0)
    losses = train_steps(model, opt, batches)

    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    want = resnet_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, stats))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# -- 2 ranks over gloo -------------------------------------------------------

@pytest.mark.parametrize("predivide,threshold", [
    (1.0, 64 << 20),   # op=Average, one bucket
    (2.0, 4096),       # predivide split, many buckets
])
def test_two_rank_gloo(tmp_path, predivide, threshold):
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=two_rank_worker,
                         args=(r, 2, store, str(tmp_path), predivide,
                               threshold))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0, 0]

    r0 = np.load(tmp_path / "rank0.npz")
    r1 = np.load(tmp_path / "rank1.npz")
    np.testing.assert_array_equal(r0["summed"], np.full(3, 3.0, np.float32))
    names = [k[len("local/"):] for k in r0.files if k.startswith("local/")]
    assert len(names) == 53
    differ = 0
    for n in names:
        g0, g1 = r0[f"local/{n}"], r1[f"local/{n}"]
        differ += not np.array_equal(g0, g1)
        np.testing.assert_array_equal(r0[f"reduced/{n}"], r1[f"reduced/{n}"],
                                      err_msg=n)
        np.testing.assert_allclose(r0[f"reduced/{n}"], (g0 + g1) / 2,
                                   rtol=1e-6, atol=1e-12, err_msg=n)
        np.testing.assert_array_equal(r0[f"param/{n}"], r1[f"param/{n}"],
                                      err_msg=n)
    assert differ > 20  # the ranks really had different grads


# -- optimizer contract --------------------------------------------------------

def _backward(model, seed=0):
    x, y = synthetic_batches(1, batch=4, seed=seed)[0]
    F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()


def test_optimizer_contract(port_cpu, monkeypatch):
    model = narrow_resnet()
    with pytest.raises(ValueError):
        hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), op=hvd.Sum,
            gradient_predivide_factor=2.0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        gradient_predivide_factor=2.0)
    assert isinstance(opt, torch.optim.SGD)
    assert opt.reduction.prescale == 0.5 and opt.reduction.postscale == 2.0
    before = fused_scale_cast.launches
    _backward(model)
    with pytest.raises(AssertionError):
        opt.zero_grad()              # reduction in flight
    with pytest.raises(AssertionError):
        _backward(model)             # a second backward before step()
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    opt.zero_grad()
    assert fused_scale_cast.launches == before  # CPU: plain version only


def test_backward_passes_per_step(port_cpu):
    model = narrow_resnet()
    twin = copy.deepcopy(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    _backward(model, seed=1)
    assert not opt._pending          # nothing launched after one pass
    _backward(model, seed=2)
    assert opt._pending              # every bucket launched after two
    opt.synchronize()
    _backward(twin, seed=1)
    _backward(twin, seed=2)
    twin_grads = dict(twin.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, twin_grads[n].grad), n


def test_unused_parameter_reduced_as_zeros(port_cpu):
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    model[0](torch.ones(2, 4)).sum().backward()   # model[1] unused
    opt.step()
    assert torch.equal(model[1].weight.grad, torch.zeros(2, 3))


# -- import hygiene and the device rule ---------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in _FORBIDDEN


def test_import_leaves_no_jax_or_reference_module():
    code = ("import sys; import horovod_tpu_torch, horovod_tpu_torch.models,"
            " horovod_tpu_torch.weights, horovod_tpu_torch.ops,"
            " horovod_tpu_torch.ops.ring, horovod_tpu_torch.native,"
            " horovod_tpu_torch.eager, horovod_tpu_torch.api.handles,"
            " horovod_tpu_torch.api.async_ops, horovod_tpu_torch.comm.stall,"
            " horovod_tpu_torch.core.retry, horovod_tpu_torch.core.journal,"
            " horovod_tpu_torch.obs, horovod_tpu_torch.elastic,"
            " horovod_tpu_torch.torch.elastic, horovod_tpu_torch.data,"
            " horovod_tpu_torch.api.checkpoint, horovod_tpu_torch.core.audit,"
            " horovod_tpu_torch.core.preempt, horovod_tpu_torch.core.durable,"
            " horovod_tpu_torch.core.topology, horovod_tpu_torch.core.basics,"
            " horovod_tpu_torch.runner, horovod_tpu_torch.runner.run_task,"
            " horovod_tpu_torch.runner.nic, horovod_tpu_torch.elastic.driver,"
            " horovod_tpu_torch.elastic.discovery,"
            " horovod_tpu_torch.parallel,"
            " horovod_tpu_torch.models.transformer,"
            " horovod_tpu_torch.api.sharded_checkpoint,"
            " horovod_tpu_torch.fleet, horovod_tpu_torch.fleet.__main__,"
            " horovod_tpu_torch.fleet.health, horovod_tpu_torch.sim,"
            " horovod_tpu_torch.sim.__main__;"
            " print('\\n'.join(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert {"horovod_tpu_torch", "horovod_tpu_torch.ops.ring",
            "horovod_tpu_torch.native.fallback",
            "horovod_tpu_torch.eager.controller",
            "horovod_tpu_torch.api.handles",
            "horovod_tpu_torch.comm.stall", "horovod_tpu_torch.comm.wirefault",
            "horovod_tpu_torch.core.faults", "horovod_tpu_torch.core.retry",
            "horovod_tpu_torch.core.clock", "horovod_tpu_torch.core.kv",
            "horovod_tpu_torch.core.journal", "horovod_tpu_torch.obs.metrics",
            "horovod_tpu_torch.obs.timeline", "horovod_tpu_torch.obs.tracing",
            "horovod_tpu_torch.obs.flight", "horovod_tpu_torch.obs.anomaly",
            "horovod_tpu_torch.obs.profile",
            "horovod_tpu_torch.obs.stepprof",
            "horovod_tpu_torch.elastic.state",
            "horovod_tpu_torch.elastic.worker",
            "horovod_tpu_torch.torch.elastic",
            "horovod_tpu_torch.data.loader", "horovod_tpu_torch.data.sharder",
            "horovod_tpu_torch.data.sources",
            "horovod_tpu_torch.api.checkpoint",
            "horovod_tpu_torch.core.audit", "horovod_tpu_torch.core.preempt",
            "horovod_tpu_torch.core.durable", "horovod_tpu_torch.core.topology",
            "horovod_tpu_torch.core.basics", "horovod_tpu_torch.runner.launch",
            "horovod_tpu_torch.runner.hosts",
            "horovod_tpu_torch.runner.secret",
            "horovod_tpu_torch.runner.safe_shell_exec",
            "horovod_tpu_torch.runner.run_task",
            "horovod_tpu_torch.runner.nic",
            "horovod_tpu_torch.elastic.driver",
            "horovod_tpu_torch.elastic.discovery",
            "horovod_tpu_torch.parallel._collectives",
            "horovod_tpu_torch.parallel.mesh",
            "horovod_tpu_torch.parallel.tp",
            "horovod_tpu_torch.parallel.ulysses",
            "horovod_tpu_torch.parallel.ring",
            "horovod_tpu_torch.parallel.pipeline",
            "horovod_tpu_torch.parallel.moe",
            "horovod_tpu_torch.models.transformer",
            "horovod_tpu_torch.models.tpu_norm",
            "horovod_tpu_torch.models._layers",
            "horovod_tpu_torch.models.resnet",
            "horovod_tpu_torch.models.vgg",
            "horovod_tpu_torch.models.inception",
            "horovod_tpu_torch.models.mlp",
            "horovod_tpu_torch.api.sharded_checkpoint",
            "horovod_tpu_torch.fleet.job", "horovod_tpu_torch.fleet.placement",
            "horovod_tpu_torch.fleet.admission",
            "horovod_tpu_torch.fleet.intake",
            "horovod_tpu_torch.fleet.autoscale",
            "horovod_tpu_torch.fleet.health",
            "horovod_tpu_torch.fleet.runner",
            "horovod_tpu_torch.fleet.arbiter",
            "horovod_tpu_torch.fleet.__main__",
            "horovod_tpu_torch.sim", "horovod_tpu_torch.sim.kernel",
            "horovod_tpu_torch.sim.fabric", "horovod_tpu_torch.sim.context",
            "horovod_tpu_torch.sim.workers",
            "horovod_tpu_torch.sim.transport",
            "horovod_tpu_torch.sim.scenarios",
            "horovod_tpu_torch.sim.__main__"} <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def _modules_after(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-c", code + "; print('\\n'.join(sorted("
         "sys.modules)))"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=180, check=True).stdout.split()


def test_root_import_leaves_tensorflow_and_keras_out():
    out = _modules_after("import sys, horovod_tpu_torch")
    assert "horovod_tpu_torch" in out
    assert [m for m in out
            if m.split(".")[0] in ("tensorflow", "keras")] == []


def test_frontends_add_no_jax_or_reference_module():
    """Keras 3 and tensorflow import parts of JAX themselves: the
    frontends may add no forbidden module to what ``import tensorflow,
    keras`` alone leaves, and no module of the JAX package at all."""
    import importlib.util

    if importlib.util.find_spec("tensorflow") is None \
            or importlib.util.find_spec("keras") is None:
        pytest.skip("tensorflow and keras are not installed")
    code = ("import sys, tensorflow, keras;"
            " print('\\n'.join(sorted(sys.modules)));"
            " print('--frontends--');"
            " import horovod_tpu_torch.tensorflow,"
            " horovod_tpu_torch.tensorflow.keras,"
            " horovod_tpu_torch.tensorflow.keras.callbacks,"
            " horovod_tpu_torch.tensorflow.keras.elastic,"
            " horovod_tpu_torch.keras, horovod_tpu_torch.keras.callbacks,"
            " horovod_tpu_torch.keras.elastic, horovod_tpu_torch._keras,"
            " horovod_tpu_torch._keras.callbacks")
    out = _modules_after(code)
    cut = out.index("--frontends--")
    alone, both = set(out[:cut]), set(out[cut + 1:])
    assert {"horovod_tpu_torch.tensorflow.mpi_ops",
            "horovod_tpu_torch.tensorflow.sync_batch_norm",
            "horovod_tpu_torch.tensorflow.elastic",
            "horovod_tpu_torch.tensorflow.compression",
            "horovod_tpu_torch._keras.callbacks",
            "horovod_tpu_torch.keras.elastic"} <= both
    assert sorted(m for m in both - alone if _forbidden(m)) == []
    assert [m for m in both if m.split(".")[0] == "horovod_tpu"] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_ast_scan_finds_no_jax_or_reference_import():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "torch_port_profile.py",
              REPO / "torch_port_watchdog_ab.py"]
    for sub in ("ops/ring.py", "native/wire.py", "native/fallback.py",
                "eager/controller.py", "api/handles.py", "comm/adasum.py",
                "comm/packing.py", "core/clock.py", "core/faults.py",
                "core/retry.py", "core/journal.py", "core/kv.py",
                "comm/stall.py", "comm/wirefault.py", "obs/__init__.py",
                "obs/metrics.py", "obs/timeline.py", "obs/tracing.py",
                "obs/flight.py", "obs/anomaly.py", "obs/profile.py",
                "obs/stepprof.py", "core/durable.py", "core/audit.py",
                "core/preempt.py", "data/loader.py", "data/sharder.py",
                "data/sources.py", "api/checkpoint.py", "elastic/state.py",
                "elastic/worker.py", "torch/elastic.py", "core/topology.py",
                "core/basics.py", "runner/__init__.py", "runner/__main__.py",
                "runner/hosts.py", "runner/secret.py", "runner/nic.py",
                "runner/safe_shell_exec.py", "runner/launch.py",
                "runner/run_task.py", "elastic/driver.py",
                "elastic/discovery.py", "version.py",
                "parallel/__init__.py", "parallel/_collectives.py",
                "parallel/mesh.py", "parallel/tp.py", "parallel/ulysses.py",
                "parallel/ring.py", "parallel/pipeline.py",
                "parallel/moe.py", "models/transformer.py",
                "models/tpu_norm.py", "models/_layers.py", "models/resnet.py",
                "models/vgg.py", "models/inception.py", "models/mlp.py",
                "api/sharded_checkpoint.py", "fleet/__init__.py",
                "fleet/__main__.py", "fleet/job.py", "fleet/placement.py",
                "fleet/admission.py", "fleet/intake.py",
                "fleet/autoscale.py", "fleet/health.py", "fleet/runner.py",
                "fleet/arbiter.py", "sim/__init__.py", "sim/__main__.py",
                "sim/kernel.py", "sim/fabric.py", "sim/context.py",
                "sim/workers.py", "sim/transport.py", "sim/scenarios.py",
                "tensorflow/__init__.py", "tensorflow/compression.py",
                "tensorflow/mpi_ops.py", "tensorflow/sync_batch_norm.py",
                "tensorflow/elastic.py", "tensorflow/keras/__init__.py",
                "tensorflow/keras/callbacks.py",
                "tensorflow/keras/elastic.py", "_keras/__init__.py",
                "_keras/callbacks.py", "keras/__init__.py",
                "keras/callbacks.py", "keras/elastic.py"):
        assert REPO / "horovod_tpu_torch" / sub in files
    assert len(files) > 15
    bad = [(f.name, m) for f in files for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_init_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hvd.init()
    with pytest.raises(RuntimeError):
        hvd.init(device="cuda")
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    try:
        assert hvd.device().type == "cpu"
    finally:
        hvd.shutdown()

"""Worlds launched by the port's launcher (``python -m
horovod_tpu_torch.runner``, ``runner.run``) on the CPU over gloo.

* ``run(fn, np=2, cpu_devices=1)`` returns the ranks' results in rank
  order, every rank rendezvoused on the launcher's coordinator.
* The CLI's 2-rank narrow-ResNet step at ``gradient_predivide_factor=2.0``
  (``tests/torch_port_launch_script.py resnet``) is bitwise the same two
  ranks run through ``two_rank_worker``, which forms its group from a
  ``FileStore``, a route independent of the launcher; neither env names
  ``MASTER_ADDR``.
* A rank that exits 3 makes the launcher exit 3 and terminates its peer.
* One 4-process launch on ``localhost:2,127.0.0.1:2`` under
  ``--hierarchical-allreduce`` (``... hier``): the topology queries equal
  the JAX package's ``SlotInfo`` for that spec; hierarchical Sum and
  Average of float32 inputs are bitwise the JAX package's
  ``allreduce_hier`` program on a ``(2, 2)`` ``("dcn", "ici")`` mesh of
  four of the test's CPU devices (each stage adds two values, so no
  order can differ), hierarchical Adasum within rtol 1e-5 / atol 1e-6
  (``tests/test_torch_port_adasum.py``'s tolerance) of
  ``allreduce_hier_adasum``; integer Average and a layout the launcher
  did not certify uniform stay on the flat route, bitwise; one optimizer
  step's reduced gradients are bitwise the two-stage composition (A1's
  plain pre pass, the local sums, the cross sum, the plain post pass),
  and an Average bucket divides by each stage's group size.
* ``init()`` with a local rank beyond the visible cards raises, naming
  the rank, its local rank and the device count.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_util import launched_rank_info, spawn_world, two_rank_worker
from torch_port_launch_script import HIER_PREDIVIDE, hier_inputs
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

pytestmark = pytest.mark.multiprocess

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"
SCRIPT = TESTS / "torch_port_launch_script.py"
HIER_SPEC = "localhost:2,127.0.0.1:2"
GRADS = 53   # the narrow ResNet's parameters


def _env(tmp, **extra) -> dict:
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "HVTPU_FAULT_SPEC"):
        env.pop(k, None)
    env.update({"PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)]),
                "HVTPU_FLIGHT_DIR": str(tmp), "JAX_PLATFORMS": "cpu"})
    env.update(extra)
    return env


def _launch(tmp, argv, timeout=180, **extra):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *argv],
        env=_env(tmp, **extra), cwd=str(REPO), capture_output=True,
        text=True, timeout=timeout)


# -- runner.run ----------------------------------------------------------------

def test_run_returns_results_by_rank(tmp_path, monkeypatch):
    from horovod_tpu_torch.runner import run

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    out = run(launched_rank_info, kwargs={"scale": 2.0}, np=2,
              cpu_devices=1, timeout=120,
              env={"PYTHONPATH": os.pathsep.join([str(REPO), str(TESTS)])})
    assert [r["rank"] for r in out] == [0, 1]
    assert all(r["size"] == 2 and r["device"] == "cpu"
               and r["sum"] == [6.0, 6.0] and not r["master_addr"]
               for r in out)
    assert [r["local_rank"] for r in out] == [0, 1]


# -- the launched 2-rank step against two_rank_worker ------------------------

@pytest.fixture(scope="module")
def resnet_runs(tmp_path_factory):
    launched = tmp_path_factory.mktemp("launched")
    proc = _launch(launched, ["-np", "2", "--cpu-devices", "1", "--",
                              sys.executable, str(SCRIPT), "resnet",
                              str(launched)],
                   HVTPU_FUSION_THRESHOLD="4096")
    spawned = tmp_path_factory.mktemp("spawned")
    saved = {k: os.environ.pop(k, None) for k in ("MASTER_ADDR",
                                                   "MASTER_PORT")}
    try:
        codes, _ = spawn_world(two_rank_worker, 2, spawned, 2.0, 4096,
                               timeout=120)
    finally:
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    return proc, launched, codes, spawned


def _ranks(d):
    return [np.load(d / f"rank{r}.npz") for r in range(2)]


def test_launched_step_exits_zero(resnet_runs):
    proc, _, codes, _ = resnet_runs
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert codes == [0, 0]


@pytest.mark.parametrize("kind", ["local", "reduced", "param"])
def test_launched_step_bitwise_two_rank_worker(resnet_runs, kind):
    _, launched, _, spawned = resnet_runs
    got, want = _ranks(launched), _ranks(spawned)
    for r in range(2):
        names = [k for k in want[r].files if k.startswith(kind + "/")]
        assert len(names) == GRADS
        for k in names:
            np.testing.assert_array_equal(got[r][k], want[r][k], err_msg=k)


def test_launched_step_sum_and_no_master_addr(resnet_runs):
    _, launched, _, spawned = resnet_runs
    for d in (launched, spawned):
        for z in _ranks(d):
            np.testing.assert_array_equal(z["summed"],
                                          np.full(3, 3.0, np.float32))
            assert not bool(z["master_addr"])


# -- failure propagation -------------------------------------------------------

def test_cli_failure_exit_code(tmp_path):
    proc = _launch(tmp_path, ["-np", "2", "--cpu-devices", "1", "--",
                              sys.executable, str(SCRIPT), "fail",
                              str(tmp_path)],
                   timeout=60, HVTPU_TERM_GRACE_SECONDS="2")
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "rank 1 exited with code 3" in proc.stderr
    pid_file = tmp_path / "survivor.pid"
    if pid_file.exists():   # rank 0 got that far before the teardown
        pid = int(pid_file.read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# -- the hierarchical world ----------------------------------------------------

@pytest.fixture(scope="module")
def hier_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("hier")
    proc = _launch(out, ["-np", "4", "-H", HIER_SPEC,
                         "--hierarchical-allreduce", "--cpu-devices", "1",
                         "--", sys.executable, str(SCRIPT), "hier",
                         str(out)],
                   HVTPU_FUSION_THRESHOLD="4096")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [np.load(out / f"rank{r}.npz") for r in range(4)]


def _stacked(name):
    return np.stack([hier_inputs(r)[name] for r in range(4)])


def _jax_hier(kind, static, x):
    """The JAX package's two-stage program on a (2, 2) ("dcn", "ici")
    mesh of four CPU devices; the stacked rows are the ranks in
    host-major order."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from horovod_tpu.comm import eager as ref_eager

    mesh = Mesh(np.asarray(jax.devices()[:4], dtype=object).reshape(2, 2),
                ("dcn", "ici"))
    stacked = jax.device_put(x, NamedSharding(mesh, P(("dcn", "ici"))))
    fn = ref_eager._jitted(kind, mesh, static)
    return np.asarray(fn(stacked, np.float32(1.0), np.float32(1.0)))


@pytest.mark.parametrize("rank", range(4))
def test_hier_topology_equals_reference_slots(hier_run, rank):
    from horovod_tpu.runner.hosts import get_host_assignments, \
        parse_host_spec

    s = get_host_assignments(parse_host_spec(HIER_SPEC), 4)[rank]
    assert hier_run[rank]["topology"].tolist() == [
        s.rank, s.size, s.local_rank, s.local_size, s.cross_rank,
        s.cross_size, 1]


def test_hier_routes(hier_run):
    for z in hier_run:
        # Sum, Average, Adasum (2 hosts: a power of two) take the route;
        # integer Average does not, nor an uncertified layout
        assert z["routes"].tolist() == [True, True, True, False]
        assert not bool(z["nonuniform_routed"])


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_hier_bitwise_jax_allreduce_hier(hier_run, op):
    from horovod_tpu.comm.compression import NoneCompressor
    from horovod_tpu.comm.reduce_ops import ReduceOp

    rop = ReduceOp.SUM if op == "sum" else ReduceOp.AVERAGE
    want = _jax_hier("allreduce_hier", (rop, NoneCompressor),
                     _stacked("f"))
    for z in hier_run:
        np.testing.assert_array_equal(z[op], want)


def test_hier_adasum_close_to_jax(hier_run):
    from horovod_tpu.comm.compression import NoneCompressor

    want = _jax_hier("allreduce_hier_adasum", (NoneCompressor,),
                     _stacked("f"))
    for z in hier_run:
        np.testing.assert_allclose(z["adasum"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(z["adasum"], hier_run[0]["adasum"])


def test_hier_integer_average_stays_flat(hier_run):
    want = _stacked("i").sum(0) // 4
    for z in hier_run:
        np.testing.assert_array_equal(z["int_avg"], z["flat_int_avg"])
        np.testing.assert_array_equal(z["int_avg"], want)


def test_hier_uncertified_layout_stays_flat(hier_run):
    for z in hier_run:
        np.testing.assert_array_equal(z["nonuniform_sum"], z["flat_sum"])


def test_hier_optimizer_step_is_the_two_stage_composition(hier_run):
    from horovod_tpu_torch.comm.compression import NoneCompressor
    from horovod_tpu_torch.ops.scale_cast import (scale_cast_pack_plain,
                                                  unpack_cast_scale_plain)

    names = [k[len("local/"):] for k in hier_run[0].files
             if k.startswith("local/")]
    assert len(names) == GRADS
    assert len(hier_run[0]["bucket_sizes"]) > 1
    flats = []
    for z in hier_run:
        flat, specs = scale_cast_pack_plain(
            [torch.from_numpy(z[f"local/{n}"]) for n in names],
            1.0 / HIER_PREDIVIDE, NoneCompressor)
        flats.append(flat)
    local_sums = [flats[0] + flats[1], flats[2] + flats[3]]
    cross = local_sums[0] + local_sums[1]
    want = unpack_cast_scale_plain(cross, specs, [torch.float32] * GRADS,
                                   HIER_PREDIVIDE / 4)
    for z in hier_run:
        for n, w in zip(names, want):
            np.testing.assert_array_equal(z[f"reduced/{n}"], w.numpy(),
                                          err_msg=n)


def test_hier_average_bucket_divides_per_stage(hier_run):
    names = [k[len("bucket_avg/"):] for k in hier_run[0].files
             if k.startswith("bucket_avg/")]
    assert len(names) == GRADS
    half = np.float32(0.5)
    for n in names:
        g = [z[f"local/{n}"] for z in hier_run]
        want = ((g[0] + g[1]) * half + (g[2] + g[3]) * half) * half
        for z in hier_run:
            np.testing.assert_array_equal(z[f"bucket_avg/{n}"], want,
                                          err_msg=n)


# -- repair: a local rank beyond the visible cards ----------------------------

def test_init_names_rank_beyond_visible_cards(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in {"HVTPU_RANK": "1", "HVTPU_SIZE": "2",
                 "HVTPU_LOCAL_RANK": "1", "HVTPU_LOCAL_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HVTPU_CPU_DEVICES", raising=False)
    with pytest.raises(RuntimeError,
                       match=r"rank 1 \(local rank 1\) needs cuda:1, but "
                             r"this process sees 1 CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


def test_cpu_devices_env(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HVTPU_CPU_DEVICES", "2")
    with pytest.raises(ValueError, match="one device a process"):
        hvd.init()
    monkeypatch.setenv("HVTPU_CPU_DEVICES", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.init()
    try:
        assert hvd.device().type == "cpu" and hvd.gloo_enabled()
        assert (hvd.local_size(), hvd.cross_rank(), hvd.cross_size()) \
            == (1, 0, 1)
        assert hvd.is_homogeneous()
    finally:
        hvd.shutdown()

"""The meshes (``horovod_tpu_torch/core/topology.py`` ``Meshes``) and
``ProcessSet.device_groups``, at one process on the CPU, against the JAX
package's.

A device is a rank in the port (NCCL takes one rank of a communicator a
card), so a world of one has one device: ``num_devices()`` is 1,
``local_devices()`` the process's device, and every mesh a ``DeviceMesh``
of one rank on the world's backend.  The meshes across ranks (2 and 3
processes) are held in ``tests/test_torch_port_spmd.py``.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import process_set as port_ps
from horovod_tpu_torch.core import state as core_state
from torch_port_util import no_leaked_reference  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def port(tmp_path, monkeypatch):
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_world_of_one_meshes(port):
    assert hvd.num_devices() == 1
    assert hvd.local_devices() == [torch.device("cpu")]
    wm = hvd.world_mesh()
    assert wm is hvd.world_mesh()                   # made once
    assert wm.mesh_dim_names == ("world",) and wm.mesh.tolist() == [0]
    assert wm.device_type == "cpu"
    assert wm.get_group("world") is dist.group.WORLD
    pm = core_state.global_state().meshes.proc_mesh()
    assert pm.mesh_dim_names == ("proc",) and pm.mesh.tolist() == [0]
    hm = hvd.hierarchical_mesh()
    assert hm.mesh_dim_names == ("dcn", "ici")
    assert hm.mesh.tolist() == [[0]]
    nd = hvd.mesh(["dp", "tp"], [1, 1])
    assert nd is hvd.mesh(("dp", "tp"), (1, 1))
    assert nd.mesh_dim_names == ("dp", "tp") and nd.mesh.tolist() == [[0]]
    # the hierarchical mesh's groups are its own Topology's: init() made
    # none (no hierarchical route), and the route stays off
    assert core_state.global_state().topology is None


def test_nd_mesh_refuses_a_shape_that_does_not_cover_the_world(port):
    import horovod_tpu as hvt

    hvt.init()
    try:
        with pytest.raises(ValueError) as want:
            hvt.mesh(("a", "b"), (3, 3))
    finally:
        hvt.shutdown()
    with pytest.raises(ValueError) as got:
        hvd.mesh(("a", "b"), (3, 3))
    n_ref = len(__import__("jax").devices())
    assert str(got.value) == str(want.value).replace(f"{n_ref} devices",
                                                     "1 devices")


def test_shutdown_drops_the_meshes(tmp_path, monkeypatch):
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    hvd.init(device="cpu")
    first = hvd.world_mesh()
    hvd.mesh(("dp", "tp"), (1, 1))
    hvd.shutdown()
    assert core_state.global_state().meshes is None
    hvd.init(device="cpu")
    try:
        again = hvd.world_mesh()
        assert again is not first
        assert again.get_group("world") is dist.group.WORLD
    finally:
        hvd.shutdown()


def test_the_mesh_functions_need_init():
    for fn in (hvd.num_devices, hvd.local_devices, hvd.world_mesh,
               hvd.hierarchical_mesh, lambda: hvd.mesh(("a",), (1,))):
        with pytest.raises(hvd.NotInitializedError):
            fn()


def test_more_than_one_device_a_process_points_to_the_meshes(monkeypatch,
                                                             tmp_path):
    monkeypatch.setenv("HVTPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HVTPU_CPU_DEVICES", "2")
    with pytest.raises(ValueError, match="one device a process") as e:
        hvd.init()
    assert "world_mesh()" in str(e.value)
    assert not hvd.is_initialized()


def _reference_groups(ranks, size):
    from horovod_tpu.core.process_set import ProcessSet as RefProcessSet

    ps = RefProcessSet(ranks)
    ps.ranks = sorted(ranks) if ranks is not None else list(range(size))
    ps._topology = SimpleNamespace(devices=[SimpleNamespace(process_index=i)
                                            for i in range(size)])
    return ps.device_groups()


@pytest.mark.parametrize("size,ranks", [
    (4, [0, 1]), (4, [1, 3]), (5, [1, 3]), (6, [2, 4, 5]), (3, [0, 2]),
    (4, None), (3, [1])])
def test_device_groups_match_the_reference(monkeypatch, size, ranks):
    st = SimpleNamespace(size=size, initialized=True)
    monkeypatch.setattr(core_state, "require_init", lambda name: st)
    ps = port_ps.ProcessSet(ranks)
    ps._bind(7, size)
    assert ps.device_groups() == _reference_groups(ranks, size)


def test_new_modules_import_nothing_of_jax_or_the_reference():
    code = ("import sys; import horovod_tpu_torch,"
            " horovod_tpu_torch.comm.spmd, horovod_tpu_torch.comm.fusion,"
            " horovod_tpu_torch.api.optimizer,"
            " horovod_tpu_torch.torch.sync_batch_norm,"
            " horovod_tpu_torch.core.topology;"
            " print('\\n'.join(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    mods = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout.split()
    assert "horovod_tpu_torch.comm.spmd" in mods
    bad = [m for m in mods if m.split(".")[0] in
           ("jax", "jaxlib", "flax", "optax", "horovod_tpu")]
    assert bad == []
